"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

  * ``csrc/*.cu``           — the kernels, plain C interface, built by
    ``build.py`` with ``nvcc`` for ``sm_90a`` at first use;
  * ``entropy_exit.py`` / ``flash_attention.py`` / ``rwkv_wkv.py`` — the
    wrappers: checks, output allocation, launch on the current stream,
    launch counts (``flash_attention.py`` holds the forward and the dK/dV
    and dQ backward kernels' wrappers, ``rwkv_wkv.py`` the chunked wkv
    forward and backward);
  * ``ref.py``              — the plain versions (CPU path and oracle);
  * ``sites.py``            — the site scopes the wrappers open, which a
    step analysis (``launch/step_analysis.py``) reads;
  * ``dispatch.py``         — the ``ref``/``cuda`` backends behind
    ``ModelConfig.kernels``, and the autograd Functions of the training
    sites.
"""
