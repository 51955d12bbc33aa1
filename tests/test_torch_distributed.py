"""The port's multi-process launch (``repro_torch.launch.distributed``,
``launch.hostdevices`` and ``launch.train``) against the JAX package's.

  * ``resolve_options`` gives the JAX function's result on the same argv
    and environment, and raises where it raises;
  * the port's training CLI on tests/test_distributed.py's ``ARGS`` runs
    as 4 ranks of one host (``--host-devices 4``) and as 2 processes
    (``--distributed``), both from the JAX package's round-0 checkpoint of
    the same run, and both must match the JAX fused engine on it, run in
    this process: final losses within that file's ``TOL`` (1e-4), every
    per-client accuracy exact.  The two processes print the same numbers,
    and only the coordinator writes checkpoints and ``driver.json``.
"""
import argparse
import os
import re
import shutil
import socket
import subprocess
import sys

import pytest

from repro.api import TrainSession as JaxSession
from repro.config import HeteroProfile as JHeteroProfile
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import SplitEEConfig as JSplitEEConfig
from repro.launch import distributed as jdist
from repro.launch import train as jtrain
from repro_torch.launch import distributed as tdist
from repro_torch.launch.mesh import world_size

TOL = 1e-4
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--model", "mlp", "--clients", "4", "--rounds", "4", "--batch", "32",
        "--train-size", "256", "--test-size", "64", "--engine", "spmd",
        "--log-every", "0", "--save-every", "2", "--device", "cpu"]
SPLITS = (1, 2, 3, 1)

ENV_KEYS = ("REPRO_DISTRIBUTED", "REPRO_COORDINATOR", "REPRO_NUM_PROCESSES",
            "REPRO_PROCESS_ID")


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.mark.parametrize("argv,env", [
    (["prog", "--distributed", "--coordinator", "10.0.0.1:1234",
      "--num-processes=4", "--process-id", "2"], {}),
    (["prog", "--rounds", "5"], {}),
    (["prog", "--coordinator=h:1"], {}),
    (["prog"], {"REPRO_DISTRIBUTED": "1", "REPRO_COORDINATOR": "h:99",
                "REPRO_NUM_PROCESSES": "2", "REPRO_PROCESS_ID": "1"}),
    (["prog"], {"REPRO_DISTRIBUTED": "0"}),
    (["prog"], {"REPRO_DISTRIBUTED": "off", "REPRO_NUM_PROCESSES": " "}),
    (["prog", "--num-processes", "nope"], {"REPRO_NUM_PROCESSES": "2"}),
    (["prog", "--process-id=bad"], {"REPRO_NUM_PROCESSES": "2"}),
    (["prog", "--num-processes"], {"REPRO_NUM_PROCESSES": "3"}),
], ids=["argv", "plain", "coordinator-implies", "env", "env-off",
        "env-blank", "bad-argv", "bad-argv-sibling", "dangling-flag"])
def test_resolve_options_matches_jax(clean_env, argv, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    j, t = jdist.resolve_options(argv), tdist.resolve_options(argv)
    assert (t.enabled, t.coordinator, t.num_processes, t.process_id) == \
        (j.enabled, j.coordinator, j.num_processes, j.process_id)


@pytest.mark.parametrize("env", [{"REPRO_NUM_PROCESSES": "two"},
                                 {"REPRO_NUM_PROCESSES": "2",
                                  "REPRO_PROCESS_ID": "zero"}],
                         ids=["processes", "process-id"])
def test_malformed_env_raises_like_jax(clean_env, env):
    for k, v in env.items():
        clean_env.setenv(k, v)
    bad = [k for k in env if not env[k].isdigit()][0]
    with pytest.raises(ValueError, match=bad):
        jdist.resolve_options(["prog"])
    with pytest.raises(ValueError, match=bad):
        tdist.resolve_options(["prog"])


def test_incomplete_distributed_launch_is_refused(clean_env):
    with pytest.raises(ValueError, match="--num-processes, --process-id"):
        tdist.maybe_initialize(tdist.resolve_options(
            ["prog", "--coordinator", "h:1"]))
    assert tdist.maybe_initialize(tdist.resolve_options(["prog"])) is None
    assert tdist.is_coordinator() and world_size() == 1


# ---------------------------------------------------------------------------
# the CLI: 4 host ranks and 2 processes against the JAX fused engine
# ---------------------------------------------------------------------------


def _jax_run(ckdir):
    """The JAX fused run of ``ARGS`` (the JAX entry point's data, model and
    configs), its round-0 checkpoint written to ``ckdir`` first."""
    args = argparse.Namespace(arch="", model="mlp", seed=0, train_size=256,
                              test_size=64, clients=4)
    model, parts, _, (xt, yt) = jtrain.build_model_and_data(args, None)
    js = JaxSession.from_config(
        model, JSplitEEConfig(profile=JHeteroProfile(SPLITS),
                              entropy_threshold=0.5),
        JOptimizerConfig(lr=3e-3, warmup_steps=0, total_steps=4 + 16),
        parts, batch_size=32, engine="fused", seed=0)
    os.makedirs(ckdir)
    js.save(os.path.join(ckdir, "ckpt-00000000"))
    js.train(4)
    ev = js.evaluate(xt, yt, batch_size=512)
    ad = js.evaluate_adaptive(xt, yt, tau=0.5, batch_size=512)
    printed = lambda v: float(f"{float(v):.3f}")  # noqa: E731 (as the CLI)
    accs = [(printed(ev["client_acc"][i]), printed(ev["server_acc"][i]),
             printed(ad["acc"][i])) for i in range(4)]
    m = js.history[-1]
    return m.client_loss, m.server_loss, accs


def _env():
    env = {"PYTHONPATH": "src", "PATH": os.environ.get("PATH", ""),
           "HOME": os.environ.get("HOME", "/tmp")}
    if "TMPDIR" in os.environ:
        env["TMPDIR"] = os.environ["TMPDIR"]
    return env


def _launch(extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS, *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=_env(), cwd=ROOT)


def _finish(proc, timeout=300):
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, _ = proc.communicate()
        raise AssertionError(out[-4000:]) from None
    assert proc.returncode == 0, out[-4000:]
    return out


def _parse(out):
    """(client_loss, server_loss, [(client_acc, server_acc, adaptive)])."""
    m = re.search(r"client_loss ([\d.]+)\s+server_loss ([\d.]+)", out)
    assert m, out[-2000:]
    accs = re.findall(r"client_acc ([\d.]+)\s+server_acc ([\d.]+)\s+"
                      r"adaptive_acc ([\d.]+)", out)
    assert len(accs) == 4, out[-2000:]
    return (float(m.group(1)), float(m.group(2)),
            [tuple(map(float, a)) for a in accs])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    want = _jax_run(str(d / "jax"))
    for name in ("host", "rank0", "rank1"):
        shutil.copytree(d / "jax", d / name)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    host = _launch(["--host-devices", "4", "--resume",
                    "--checkpoint-dir", str(d / "host")])
    common = ["--distributed", "--coordinator", coord, "--num-processes",
              "2", "--resume"]
    p0 = _launch([*common, "--process-id", "0",
                  "--checkpoint-dir", str(d / "rank0")])
    p1 = _launch([*common, "--process-id", "1",
                  "--checkpoint-dir", str(d / "rank1")])
    outs = _finish(host), _finish(p0), _finish(p1)
    return want, outs, d


def test_rank_aware_banners(runs):
    _, (host, out0, out1), _ = runs
    assert "devices=4 (4 processes, rank 0)  engine=spmd  recipe=greedy" \
        in host
    assert "[resumed at round 0]" in host
    assert "devices=2 (2 processes, rank 0)  engine=spmd" in out0
    assert "devices=2 (2 processes, rank 1)  engine=spmd" in out1
    assert "torch.distributed backend=gloo" in out0


@pytest.mark.parametrize("which", [0, 1], ids=["host-devices", "distributed"])
def test_cli_matches_jax_fused(runs, which):
    (jc, js, jaccs), outs, _ = runs
    closs, sloss, accs = _parse(outs[which])
    assert abs(closs - jc) <= TOL and abs(sloss - js) <= TOL, \
        ((closs, sloss), (jc, js))
    assert accs == jaccs


def test_ranks_print_the_same_numbers(runs):
    _, (_, out0, out1), _ = runs
    assert _parse(out0) == _parse(out1)


def test_only_the_coordinator_writes(runs):
    _, _, d = runs
    seeded = ["ckpt-00000000.json", "ckpt-00000000.npz"]
    assert sorted(os.listdir(d / "rank1")) == seeded
    rank0 = sorted(os.listdir(d / "rank0"))
    assert "driver.json" in rank0 and "ckpt-00000004.npz" in rank0
    assert "driver.json" in os.listdir(d / "host")
