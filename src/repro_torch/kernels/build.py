"""Builds the CUDA kernels of ``kernels/csrc`` and loads them with ctypes.

Each ``*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, at first use, under
``build/kernels/`` at the repository root.  The library's file name carries
a hash of the sources and flags, so an edit rebuilds.  :func:`build` starts
one ``nvcc`` per missing library, all together, and waits for every one.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("entropy_exit.cu", "flash_attention.cu",
           "flash_attention_bwd.cu", "rwkv_wkv.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (home / "bin" / "nvcc").exists():
        return str(home / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "on PATH); the CUDA kernels cannot be built")
    return found


def library_path(source: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together.  Returns ``{source: library path}``; raises with
    the compiler's output if any build fails.  ``ptxas -v`` (registers,
    shared memory, spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    try:
        for src in sources:
            out = library_path(src)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            log = out.with_suffix(".log")
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                    stdout=f, stderr=subprocess.STDOUT)
            jobs.append((src, proc, tmp, out, log))
    finally:
        failed = []
        for src, proc, tmp, out, log in jobs:
            if proc.wait() == 0:
                os.replace(tmp, out)      # atomic: concurrent builds agree
            else:
                failed.append(f"{src}:\n{log.read_text()}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return {src: library_path(src) for src in sources}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build([source])[source]))
    return _loaded[source]
