"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  * ``csrc/*.cu``           — the kernels, plain C interface, built by
    ``build.py`` with ``nvcc`` for ``sm_90a`` at first use;
  * ``entropy_exit.py`` / ``flash_attention.py`` — the wrappers: checks,
    output allocation, launch on the current stream, launch counts;
  * ``ref.py``              — the plain versions (CPU path and oracle);
  * ``dispatch.py``         — the ``ref``/``cuda`` backends behind
    ``ModelConfig.kernels``.
"""
