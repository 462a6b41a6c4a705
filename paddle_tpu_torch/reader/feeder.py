"""DataFeeder — the port of ``paddle_tpu/reader/feeder.py`` for dense and
integer slots, plain and as level-1 sequences, and plain sparse slots: a
Python batch (list of sample tuples) becomes the feed dict on the
trainer's device.  Dense rows are float32 [B, dim]; integer values are
int64 [B] (PyTorch's index type); a sparse-binary sample (a list of ids)
or sparse-float sample (a list of (index, value) pairs) is densified on
the host to a float32 [B, dim] row, as in the JAX package; a sequence
slot is a :class:`SequenceBatch` padded to its length bucket."""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import SequenceBatch, bucket_length, from_ragged
from paddle_tpu_torch.layers.data_type import DataKind, SeqType


def _densify_ids(rows, dim: int) -> np.ndarray:
    """Id lists (one a row) -> a dense 0/1 [len(rows), dim] in one flat
    scatter; an id repeated within a row is 1."""
    rows = [r if hasattr(r, "__len__") else list(r) for r in rows]
    n = len(rows)
    dense = np.zeros((n, dim), np.float32)
    counts = np.fromiter((len(r) for r in rows), np.int64, count=n)
    total = int(counts.sum())
    if total:
        cols = np.fromiter((int(j) for r in rows for j in r), np.int64,
                           count=total)
        dense[np.repeat(np.arange(n), counts), cols] = 1.0
    return dense


def _densify_pairs(rows, dim: int) -> np.ndarray:
    """(index, value) pair lists -> a dense [len(rows), dim] in one flat
    assignment; a repeated index within a row keeps its last value.  A
    pair of another arity or a fractional index raises."""
    rows = [r if hasattr(r, "__len__") else list(r) for r in rows]
    n = len(rows)
    dense = np.zeros((n, dim), np.float32)
    counts = np.fromiter((len(r) for r in rows), np.int64, count=n)
    if int(counts.sum()):
        flat = np.concatenate(
            [np.asarray(r, dtype=np.float64).reshape(len(r), 2)
             for r in rows if len(r)], axis=0)
        cols = flat[:, 0].astype(np.int64)
        if not np.array_equal(cols, flat[:, 0]):
            raise IndexError("sparse_float pair indices must be integers; "
                             "got a fractional index")
        dense[np.repeat(np.arange(n), counts),
              cols] = flat[:, 1].astype(np.float32)
    return dense


def _stack_uniform(col, dtype) -> np.ndarray | None:
    """[B] list of equal-length samples -> one stacked [B, T, ...] array,
    or None when the column is ragged: the fast path of sequence slots."""
    try:
        first_len = len(col[0])
        if all(len(s) == first_len for s in col):
            arr = np.asarray(col, dtype=dtype)
            return arr if arr.ndim >= 2 else None
    except (TypeError, ValueError):
        pass
    return None


def padding_stats(feed: Mapping) -> tuple[int, int]:
    """(padded, total) time steps across the sequence slots of a feed."""
    padded = total = 0
    for v in feed.values():
        if isinstance(v, SequenceBatch):
            lens = v.length.cpu().numpy()
            total += int(lens.size) * v.max_len
            padded += int(np.sum(np.maximum(v.max_len - lens, 0)))
    return padded, total


_SPARSE = {DataKind.SPARSE_BINARY: _densify_ids,
           DataKind.SPARSE_FLOAT: _densify_pairs}


class DataFeeder:
    def __init__(self, data_types: Mapping[str, object] | Sequence[tuple],
                 feeding: Mapping[str, int] | Sequence[str] | None = None,
                 device=None, seq_buckets: Sequence[int] | None = None):
        """data_types: {layer_name: InputType} or [(name, InputType), ...];
        feeding: {layer_name: index in sample tuple} (default: in order);
        seq_buckets: the length-quantization table of sequence slots
        (default ``bucket_length``'s)."""
        self.types = dict(data_types)
        dense_kinds = (DataKind.DENSE, DataKind.INTEGER)
        for name, itype in self.types.items():
            enforce((itype.seq_type == SeqType.SEQUENCE
                     and itype.kind in dense_kinds)
                    or (itype.seq_type == SeqType.NO_SEQUENCE
                        and itype.kind in dense_kinds + tuple(_SPARSE)),
                    f"data layer {name!r}: only dense and integer slots, "
                    "plain or as sequences, and plain sparse slots are "
                    f"ported yet, got {itype}")
        if feeding is None:
            self.feeding = {n: i for i, n in enumerate(self.types)}
        elif isinstance(feeding, Mapping):
            self.feeding = dict(feeding)
        else:
            self.feeding = {n: i for i, n in enumerate(feeding)}
        self.device = device
        self.seq_buckets = (tuple(sorted(int(b) for b in seq_buckets))
                            if seq_buckets else None)

    def __call__(self, batch):
        return self.feed(batch)

    def feed(self, batch) -> dict:
        out = {}
        for name, itype in self.types.items():
            enforce(name in self.feeding,
                    f"feeding map is missing data layer {name!r} "
                    f"(feeding keys: {sorted(self.feeding)})")
            idx = self.feeding[name]
            col = [sample[name] if isinstance(sample, Mapping)
                   else sample[idx] for sample in batch]
            out[name] = self._convert(col, itype, name)
        return out

    def _convert(self, col, itype, name):
        dt = np.int64 if itype.kind == DataKind.INTEGER else np.float32
        if itype.seq_type == SeqType.SEQUENCE:
            return self._sequence(col, dt)
        if itype.kind in _SPARSE:
            arr = _SPARSE[itype.kind](col, itype.dim)
        elif itype.kind == DataKind.DENSE:
            arr = np.asarray(col, dtype=np.float32).reshape(len(col), -1)
            enforce(arr.shape[1] == itype.dim,
                    f"data layer {name!r} expects dim {itype.dim}, got "
                    f"samples of dim {arr.shape[1]}")
        else:
            arr = np.asarray(col, dtype=np.int64).reshape(len(col))
        return torch.from_numpy(arr).to(self.device)

    def _sequence(self, col, dt) -> SequenceBatch:
        # equal lengths (the synthetic and bucketed case): one stacked
        # conversion and one bucket-padded copy
        stacked = _stack_uniform(col, dt)
        if stacked is None:
            return from_ragged([np.asarray(s, dtype=dt) for s in col],
                               buckets=self.seq_buckets, device=self.device)
        t_true = stacked.shape[1]
        t = (bucket_length(t_true) if self.seq_buckets is None
             else bucket_length(t_true, self.seq_buckets))
        if t != t_true:
            padded = np.zeros((len(col), t) + stacked.shape[2:], dt)
            padded[:, :t_true] = stacked
            stacked = padded
        return SequenceBatch(
            data=torch.from_numpy(stacked).to(self.device),
            length=torch.full((len(col),), t_true, dtype=torch.int64,
                              device=self.device))
