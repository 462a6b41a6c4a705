"""CIFAR-10/100 — the port of ``paddle_tpu/dataset/cifar.py``, schema of
``python/paddle/v2/dataset/cifar.py``: samples are (image [3072] float32
in [0, 1] in CHW order, label).  The data is the JAX package's seeded
synthetic stand-in (class-conditional coloured texture patches), the same
samples in the same order."""

from __future__ import annotations

import numpy as np

from paddle_tpu_torch.dataset import common

TRAIN_SIZE = 4096
TEST_SIZE = 512


def _synthetic(split: str, n: int, num_classes: int):
    rng = common.synthetic_rng(f"cifar{num_classes}", split)
    proto_rng = np.random.default_rng(777)
    protos = proto_rng.uniform(0, 1, (num_classes, 3, 8, 8)).astype(np.float32)
    labels = rng.integers(0, num_classes, n)
    for i in range(n):
        c = int(labels[i])
        base = np.kron(protos[c], np.ones((4, 4), np.float32))  # 3x32x32
        img = np.clip(base + rng.normal(0, 0.1, (3, 32, 32)), 0, 1)
        yield img.reshape(3072).astype(np.float32), c


def train10():
    def reader():
        yield from _synthetic("train", TRAIN_SIZE, 10)

    return reader


def test10():
    def reader():
        yield from _synthetic("test", TEST_SIZE, 10)

    return reader


def train100():
    def reader():
        yield from _synthetic("train", TRAIN_SIZE, 100)

    return reader


def test100():
    def reader():
        yield from _synthetic("test", TEST_SIZE, 100)

    return reader
