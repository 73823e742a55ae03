"""visfs_tpu_torch — the PyTorch/CUDA port of the visfs_tpu stereo VO engine.

The JAX package ``visfs_tpu`` is the reference this package is held against
(tests/test_torch_*.py).  This package imports ``torch`` and never ``jax``;
it reuses the jax-free configuration registry ``visfs_tpu.config``.

Layout mirrors the reference: ``core/ ops/ ops/kernels/ solver/ slam/ io/``,
with the hand-written CUDA kernel sources under ``csrc/``.  Every public
entry point takes an explicit ``device``; a CUDA tensor goes through the
CUDA kernel, a CPU tensor through the kernel's plain PyTorch version.
"""
