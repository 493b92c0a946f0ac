"""PyTorch + CUDA port of the ``repro`` sparse-convolution stack.

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/<name>/``, ``models/``, ``configs/``, ``data/``,
``serve/``) and holds the hand-written CUDA kernels in ``csrc/``.  It never
imports ``jax`` or ``repro``.  Entry points run on the CUDA device unless the
caller passes ``device="cpu"``; see ``core.device.resolve_device``.
"""
