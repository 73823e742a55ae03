"""visfs_tpu_torch — the PyTorch/CUDA port of the visfs_tpu stereo VO engine.

The JAX package ``visfs_tpu`` is the reference this package is held against
(tests/test_torch_*.py).  This package imports ``torch`` and never ``jax``
nor any module of ``visfs_tpu``; it keeps its own copy of the configuration
registry (``config.py``).

Layout mirrors the reference: ``config.py``, ``core/ ops/ ops/kernels/
solver/ slam/ io/ runtime/ utils/``, with the hand-written CUDA kernel
sources under ``csrc/`` and the native sync runtime's C++ under
``runtime/``.  The public entry points run on "cuda" unless the caller passes
``device="cpu"``; a CUDA tensor goes through the CUDA kernels, a CPU tensor
through the kernels' plain PyTorch versions.
"""
