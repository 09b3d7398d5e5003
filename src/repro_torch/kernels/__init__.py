"""Hand-written Hopper kernels of the port.

  * ``safeguard_filter`` — the pairwise-distance pass over the flat
    ``(m, d_pad)`` accumulator buffer, plain and fused with the windowed
    accumulate-and-reset (CUDA C++, ``csrc/safeguard_filter.cu``);
  * ``robust_agg`` — the coordinate-wise median and trimmed mean over the
    worker axis of one stacked gradient leaf (CUDA C++,
    ``csrc/robust_agg.cu``);
  * ``flash_attention`` — causal attention with GQA and a sliding window,
    on the prefill path from ``FLASH_THRESHOLD`` on (CUDA C++,
    ``csrc/flash_attention.cu``).

Each package ships ``csrc/`` (the CUDA source), ``kernel.py`` (build and
ctypes binding), ``ops.py`` (checked wrappers, device dispatch, launch
counts) and ``ref.py`` (the plain PyTorch version).  ``build.py`` compiles
the sources with ``nvcc`` at first use; ``common.py`` holds the wrappers'
shared checks.
"""
