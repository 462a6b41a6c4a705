"""Tensor ops of the port: plain PyTorch (``nn``, ``attention``) and the
hand-written CUDA kernels with their plain twins (``kernels``)."""
