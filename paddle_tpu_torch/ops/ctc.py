"""CTC loss and greedy decode — the port of ``paddle_tpu/ops/ctc.py``.

The loss is the batched, static-shape forward algorithm: a loop over
input time runs the alpha recursion over the padded extended labels
[B, 2L+1] with masks for the input lengths, the label lengths and the
blank / repeated-label skip rule; autograd gives its gradient.  It is the
oracle of the fused forward-backward (``kernels/ctc.py``).

Saturation is kept exactly as in the JAX package: every step pins
impossible paths at ``NEG_INF`` with a select, so an infeasible row (a
zero-length label is feasible; T < the frames the labels need is not)
reports the finite sentinel loss ``-NEG_INF`` with an exactly-zero
gradient instead of inf or NaN.  The recursion runs in the input's dtype
(float32, or float64 for a witness step)."""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _extend_labels(labels: torch.Tensor, blank: int) -> torch.Tensor:
    """[B, L] -> [B, 2L+1] interleaved with blanks: b, l1, b, l2, ..., b."""
    bsz, l = labels.shape
    ext = torch.full((bsz, 2 * l + 1), blank, dtype=labels.dtype,
                     device=labels.device)
    ext[:, 1::2] = labels
    return ext


def ctc_tables(labels: torch.Tensor, label_lengths: torch.Tensor, blank: int):
    """The per-batch transition tables, built once and shared by the loop
    below and the fused kernel: (ext [B, 2L+1] int32 extended labels,
    ext_valid [B, S] bool, can_skip [B, S] bool — the s-2 skip is allowed
    only onto non-blank positions whose label differs from the one two
    back).  The valid span is ``2 * label_lengths + 1`` wherever the
    labels were padded to."""
    s = 2 * labels.shape[1] + 1
    ext = _extend_labels(labels.to(torch.int32), blank)
    ext_valid = (torch.arange(s, device=labels.device)[None, :]
                 < (2 * label_lengths.to(labels.device)[:, None] + 1))
    prev2 = torch.nn.functional.pad(ext[:, :-2], (2, 0), value=-1)
    can_skip = (ext != blank) & (ext != prev2)
    return ext, ext_valid, can_skip


def emissions(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """[B, T, V] at the extended labels -> [B, T, S].  A label outside
    [0, V) reads class 0; it only ever sits on an invalid position."""
    idx = ext.long().clamp(0, log_probs.shape[2] - 1)
    return torch.gather(log_probs, 2, idx[:, None, :].expand(
        -1, log_probs.shape[1], -1))


def _shift(a: torch.Tensor, k: int) -> torch.Tensor:
    """a[:, s - k] with NEG_INF shifted in at the front."""
    return torch.nn.functional.pad(a[:, :-k], (k, 0), value=NEG_INF)


def ctc_loss(log_probs: torch.Tensor, input_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """Per-sequence CTC negative log-likelihood.

    log_probs [B, T, V] log-softmax outputs; input_lengths [B]; labels
    [B, L] (padded, no blanks); label_lengths [B].  Returns [B] loss =
    -log p(labels | inputs), NEG_INF-saturated as the module says."""
    if log_probs.dtype != torch.float64:
        log_probs = log_probs.float()
    dev = log_probs.device
    t_max = log_probs.shape[1]
    ilen = input_lengths.to(dev)
    llen = label_lengths.to(dev)
    ext, ext_valid, can_skip = ctc_tables(labels.to(dev), llen, blank)
    emit_all = emissions(log_probs, ext)                 # [B, T, S]
    neg = torch.full_like(emit_all[:, 0], NEG_INF)
    alpha = neg.clone()
    alpha[:, 0] = emit_all[:, 0, 0]
    alpha[:, 1] = torch.where(llen > 0, emit_all[:, 0, 1], neg[:, 1])
    for t in range(1, t_max):
        from2 = torch.where(can_skip, _shift(alpha, 2), neg)
        new = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1)),
                              from2) + emit_all[:, t]
        # the select (not a maximum) cuts the gradient of saturated entries
        new = torch.where(ext_valid & (new > NEG_INF), new, neg)
        alpha = torch.where((t < ilen)[:, None], new, alpha)
    idx_last = 2 * llen.long()
    a_last = torch.gather(alpha, 1, idx_last[:, None])[:, 0]
    a_prev = torch.where(
        llen > 0,
        torch.gather(alpha, 1, (idx_last - 1).clamp(min=0)[:, None])[:, 0],
        neg[:, 0])
    ll = torch.logaddexp(a_last, a_prev)
    ll = torch.where(ll > NEG_INF, ll, neg[:, 0])
    return -ll


def ctc_loss_from_probs(probs, input_lengths, labels, label_lengths,
                        blank: int = 0, eps: float = 1e-12) -> torch.Tensor:
    """The CTCLayer-style entry: post-softmax probabilities in."""
    return ctc_loss(torch.log(torch.clamp(probs, min=eps)), input_lengths,
                    labels, label_lengths, blank)


def compact_decoded(best: torch.Tensor, keep: torch.Tensor):
    """Front-compact the kept frames of each row: (best [B, T], keep
    [B, T] bool) -> (ids [B, T] int32 padded with -1, lengths [B] int32).
    Shared by the decode below and the fused decode's CPU twin (the card's
    kernel compacts as it decodes, to the same result)."""
    b, t_max = best.shape
    idx = torch.cumsum(keep.long(), dim=1) - 1
    tgt = torch.where(keep, idx, torch.full_like(idx, t_max))
    out = torch.full((b, t_max + 1), -1, dtype=torch.int32,
                     device=best.device)
    # dropped frames all land in the spare column t_max, cut off below
    out.scatter_(1, tgt, best.to(torch.int32))
    return out[:, :t_max], keep.sum(dim=1).to(torch.int32)


def ctc_greedy_decode(log_probs: torch.Tensor, input_lengths: torch.Tensor,
                      blank: int = 0):
    """Best-path decode: argmax per frame (the first index on ties),
    repeats collapsed, blanks dropped.  Returns (ids [B, T] padded with
    -1, lengths [B])."""
    t_max = log_probs.shape[1]
    best = torch.argmax(log_probs, dim=2).to(torch.int32)
    frame_valid = (torch.arange(t_max, device=log_probs.device)[None, :]
                   < input_lengths.to(log_probs.device)[:, None])
    prev = torch.nn.functional.pad(best[:, :-1], (1, 0), value=-1)
    keep = (best != blank) & (best != prev) & frame_valid
    return compact_decoded(best, keep)
