"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu`` for one
NVIDIA H100.

``paddle_tpu`` (JAX, TPU) stays the reference; this package imports
``torch`` and ``numpy`` and nothing of JAX or ``paddle_tpu``.  Every
Pallas kernel on a ported path has a hand-written CUDA counterpart under
``ops/kernels/csrc/``, built with ``nvcc`` at first use.  Entry points
run on the card unless the caller passes ``device="cpu"``.

Ported so far: online serving of the transformer LM
(``paddle_tpu_torch.serving``)."""

__version__ = "0.1.0"
