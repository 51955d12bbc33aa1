"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  * ``csrc/*.cu``           — the kernels, plain C interface, built by
    ``build.py`` with ``nvcc`` for ``sm_90a`` at first use;
  * ``entropy_exit.py`` / ``flash_attention.py`` — the wrappers: checks,
    output allocation, launch on the current stream, launch counts
    (``flash_attention.py`` holds the forward and the dK/dV and dQ
    backward kernels' wrappers);
  * ``ref.py``              — the plain versions (CPU path and oracle);
  * ``dispatch.py``         — the ``ref``/``cuda`` backends behind
    ``ModelConfig.kernels``, and the autograd Function of the training
    site.
"""
