"""Datasets of the port (the port of ``paddle_tpu/dataset``): the seeded
synthetic CIFAR-10/100 readers, sample for sample the JAX package's."""

from paddle_tpu_torch.dataset import cifar, common  # noqa: F401
