"""Hand-written CUDA kernels for Hopper (``csrc/*.cu``), one module per
TPU kernel of ``paddle_tpu/ops/pallas/`` with the same file names.

Each module holds the kernel's wrapper and its plain PyTorch twin.  The
wrapper takes the twin for a tensor that lies on the CPU; for a CUDA
tensor it launches the kernel or raises, never falls back.  Each kernel
counts its launches (``<module>.KERNEL.launches``).  ``_build`` compiles
the sources with ``nvcc`` at first use."""

from __future__ import annotations

NEG_INF = -1e30  # finite masking sentinel, as in the JAX package


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m
