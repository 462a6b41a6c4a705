"""Core runtime pieces of the port: checks, logging, dtype policy and
device selection (own copies; nothing here imports ``paddle_tpu``)."""

from paddle_tpu_torch.core.enforce import EnforceError, enforce  # noqa: F401
from paddle_tpu_torch.core.place import resolve_device  # noqa: F401
