"""Training of the port (``paddle_tpu/trainer``): the v2 ``SGD`` loop,
its train/eval steps and events."""

from paddle_tpu_torch.trainer.trainer import SGD  # noqa: F401
