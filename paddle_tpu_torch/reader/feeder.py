"""DataFeeder — the port of ``paddle_tpu/reader/feeder.py`` for dense and
integer, non-sequence slots: a Python batch (list of sample tuples)
becomes the feed dict of tensors on the trainer's device.  Dense rows are
float32 [B, dim]; integer values are int64 [B] (PyTorch's index type)."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.layers.data_type import DataKind, SeqType


class DataFeeder:
    def __init__(self, data_types: Mapping[str, object] | Sequence[tuple],
                 feeding: Mapping[str, int] | Sequence[str] | None = None,
                 device=None):
        """data_types: {layer_name: InputType} or [(name, InputType), ...];
        feeding: {layer_name: index in sample tuple} (default: in order)."""
        self.types = dict(data_types)
        for name, itype in self.types.items():
            enforce(itype.seq_type == SeqType.NO_SEQUENCE
                    and itype.kind in (DataKind.DENSE, DataKind.INTEGER),
                    f"data layer {name!r}: only dense and integer "
                    f"non-sequence slots are ported yet, got {itype}")
        if feeding is None:
            self.feeding = {n: i for i, n in enumerate(self.types)}
        elif isinstance(feeding, Mapping):
            self.feeding = dict(feeding)
        else:
            self.feeding = {n: i for i, n in enumerate(feeding)}
        self.device = device

    def __call__(self, batch):
        return self.feed(batch)

    def feed(self, batch) -> dict[str, torch.Tensor]:
        out = {}
        for name, itype in self.types.items():
            enforce(name in self.feeding,
                    f"feeding map is missing data layer {name!r} "
                    f"(feeding keys: {sorted(self.feeding)})")
            idx = self.feeding[name]
            col = [sample[name] if isinstance(sample, Mapping)
                   else sample[idx] for sample in batch]
            if itype.kind == DataKind.DENSE:
                arr = np.asarray(col, dtype=np.float32).reshape(len(col), -1)
                enforce(arr.shape[1] == itype.dim,
                        f"data layer {name!r} expects dim {itype.dim}, got "
                        f"samples of dim {arr.shape[1]}")
            else:
                arr = np.asarray(col, dtype=np.int64).reshape(len(col))
            out[name] = torch.from_numpy(arr).to(self.device)
        return out
