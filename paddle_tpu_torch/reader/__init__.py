"""Readers of the port (``paddle_tpu/reader``): decorators and the feeder."""

from paddle_tpu_torch.reader.decorator import batch, firstn, shuffle  # noqa: F401
from paddle_tpu_torch.reader.feeder import DataFeeder  # noqa: F401
