"""PyTorch/CUDA port of the Hetero-SplitEE reproduction.

The JAX package ``repro`` is the reference; this package mirrors its module
layout so that each counterpart is found under the same name.  It imports
``torch`` and numpy only — never ``jax``, never ``repro``.  Every TPU
kernel on a ported path is a hand-written CUDA kernel for Hopper
(``kernels/csrc``) next to a plain PyTorch version of the same function.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; with no device given and no CUDA present they raise
(:func:`repro_torch.device.resolve_device`).
"""
