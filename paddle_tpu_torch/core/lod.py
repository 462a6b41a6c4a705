"""Variable-length sequences — the port of ``paddle_tpu/core/lod.py``
(level-1 sequences; nested sequences are not ported yet).

A batch of sequences is dense padded data ``[B, T, ...]`` plus integer
lengths ``[B]``; masks are derived, never stored.  Ragged Python lists
are padded to the bucket ceiling (:func:`bucket_length`), as the JAX
package does, so a 100-token batch enters the graph as T = 128 with
lengths of 100: the shapes and masks of both packages agree."""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def bucket_length(n: int, buckets: Sequence[int] = (16, 32, 64, 128, 256, 512,
                                                    1024)) -> int:
    """Smallest bucket >= n; doubles beyond the table."""
    for b in buckets:
        if n <= b:
            return b
    b = buckets[-1]
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass(frozen=True)
class SequenceBatch:
    """A batch of level-1 variable-length sequences: ``data`` [B, T, ...]
    padded, ``length`` [B] int64, the true lengths."""

    data: torch.Tensor
    length: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.data.shape[0]

    @property
    def max_len(self) -> int:
        return self.data.shape[1]

    def mask(self, dtype=torch.float32) -> torch.Tensor:
        """[B, T] validity mask."""
        t = torch.arange(self.max_len, device=self.length.device)
        return (t[None, :] < self.length[:, None]).to(dtype)

    def last_step(self) -> torch.Tensor:
        """[B, ...] the last valid step of each sequence (``last_seq``)."""
        idx = torch.clamp(self.length.long() - 1, min=0)
        return self.data[torch.arange(self.batch_size,
                                      device=self.data.device), idx]

    def first_step(self) -> torch.Tensor:
        """[B, ...] the first step (``first_seq``)."""
        return self.data[:, 0]


def pad_sequences(seqs: Sequence[np.ndarray], max_len: int | None = None,
                  bucket: bool = True, pad_value=0,
                  buckets: Sequence[int] | None = None
                  ) -> tuple[np.ndarray, np.ndarray]:
    """Ragged list -> (padded [B, T, ...], lengths [B]), host-side.
    ``buckets`` overrides the default quantization table."""
    lengths = np.asarray([len(s) for s in seqs], dtype=np.int64)
    t = int(max_len if max_len is not None
            else (lengths.max() if len(seqs) else 1) or 1)
    if bucket and max_len is None:
        t = bucket_length(t) if buckets is None else bucket_length(t, buckets)
    first = np.asarray(seqs[0])
    out = np.full((len(seqs), t) + first.shape[1:], pad_value,
                  dtype=first.dtype)
    for i, s in enumerate(seqs):
        s = np.asarray(s)
        out[i, :len(s)] = s[:t]
    return out, np.minimum(lengths, t)


def from_ragged(seqs: Sequence[np.ndarray], max_len: int | None = None,
                buckets: Sequence[int] | None = None,
                device=None) -> SequenceBatch:
    data, length = pad_sequences(seqs, max_len=max_len, buckets=buckets)
    return SequenceBatch(data=torch.from_numpy(data).to(device),
                         length=torch.from_numpy(length).to(device))


def to_ragged(batch: SequenceBatch) -> list[np.ndarray]:
    """Device -> host ragged list."""
    data = batch.data.detach().cpu().numpy()
    length = batch.length.cpu().numpy()
    return [data[i, :length[i]] for i in range(data.shape[0])]
