"""PyTorch port of the ``repro`` package, for one NVIDIA H100.

Mirrors ``repro``'s layout module by module; each module is ported only
as far as the training step of ``launch/train.py`` needs.  The package
imports ``torch`` and never ``jax``: the JAX package is the reference
it is held against, in the ``tests/test_torch_*.py`` parity tests.

Every entry point takes an explicit ``device``.  A CUDA tensor that
reaches a kernel wrapper (``kernels/safeguard_filter/ops.py``) launches
the hand-written CUDA kernel or raises; only a CPU tensor takes the
plain PyTorch version.
"""
