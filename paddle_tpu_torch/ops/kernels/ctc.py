"""Fused CTC forward-backward and greedy decode (the port of
``paddle_tpu/ops/pallas/ctc.py``'s ``ctc_loss_fused`` and
``ctc_greedy_decode_fused``).

:func:`ctc_loss_fused` is a ``torch.autograd.Function``.  Its forward is
one launch of ``csrc/ctc.cu``'s forward-backward kernel: the alpha
recursion up in t, the beta recursion down in t and the hand-derived
gradient ``-gamma/p`` (log-probs in) or ``y - gamma/p`` (``normalize``:
logits in, the log-softmax folded into the kernel), written as the
[B, T, V] cotangent of the per-row loss.  That slab is the only residual:
the backward is one multiply by the incoming cotangent, as the JAX
package's ``custom_vjp`` does.  Infeasible rows pin at the sentinel loss
``-NEG_INF`` with an exactly-zero gradient; frames past a row's input
length get zero.

:func:`ctc_greedy_decode_fused` is one launch of the decode kernel on the
card: the argmax per frame (first index on ties), the blank/repeat keep
mask and the front-compaction of the kept frames, written as the
(ids, lengths) pair the JAX entry returns.

CPU tensors take the plain twins (:func:`_fwd_bwd_plain`, and
:func:`_decode_plain` then ``ops/ctc.compact_decoded``), which run the same
recursions and the same hand gradient in the input's dtype; CUDA tensors
launch the kernels or raise.
The references are the ``ops/ctc.py`` loop (autograd gives its gradient)
and decode."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops import ctc as ctc_ops
from paddle_tpu_torch.ops.ctc import NEG_INF
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_LOSS = Kernel("ctc", "ctc_fwd_bwd_f32", [_P] * 9 + [_I] * 5 + [_P])
KERNEL_DECODE = Kernel("ctc", "ctc_decode_f32",
                       [_P, _P, _I, _P, _P] + [_I] * 4 + [_P])
#: the dtypes of the decode kernel's lengths, as its ``len64`` flag
_LEN64 = {torch.int32: 0, torch.int64: 1}

#: a row's alpha and emission slabs stay in shared memory up to this size;
#: past it the wrapper hands the kernel a scratch buffer in device memory.
#: The 48 KB a launch takes without an opt-in, less 256 bytes kept for the
#: kernel's static reduction buffer (``kDynSmemMax`` in ``csrc/ctc.cu``)
_SMEM_BUDGET = 48 * 1024 - 256


# -- the plain twins -------------------------------------------------------------


def _lae(a, b):
    """log(exp(a) + exp(b)) in the kernel's form."""
    m = torch.maximum(a, b)
    return m + torch.log1p(torch.exp(torch.minimum(a, b) - m))


def _shift_left(a, k, fill):
    """a[:, s + k], ``fill`` shifted in at the end."""
    return torch.nn.functional.pad(a[:, k:], (0, k), value=fill)


def _fwd_bwd_plain(logp, ext, can_skip, ext_valid, ilen, llen, normalize):
    """Plain twin of the forward-backward kernel: (loss [B], grad
    [B, T, V]), the gradient of each row's loss by its inputs."""
    b, t_max, v = logp.shape
    s_len = ext.shape[1]
    ilen, llen = ilen.long()[:, None], llen.long()[:, None]
    z = logp
    if normalize:
        zm = z.max(dim=-1, keepdim=True).values
        z = z - (zm + torch.log(torch.exp(z - zm).sum(-1, keepdim=True)))
    emit = ctc_ops.emissions(z, ext)                       # [B, T, S]
    s_idx = torch.arange(s_len, device=logp.device)[None, :]
    neg = torch.full((b, s_len), NEG_INF, dtype=logp.dtype,
                     device=logp.device)
    alpha = [torch.where((s_idx == 0) | ((s_idx == 1) & (llen > 0)),
                         emit[:, 0], neg)]
    for t in range(1, t_max):
        prev = alpha[-1]
        from2 = torch.where(can_skip, ctc_ops._shift(prev, 2), neg)
        new = _lae(_lae(prev, ctc_ops._shift(prev, 1)), from2) + emit[:, t]
        new = torch.where(ext_valid, torch.clamp(new, min=NEG_INF), neg)
        alpha.append(torch.where(t < ilen, new, prev))
    last = alpha[-1]
    a_last = torch.gather(last, 1, (2 * llen).clamp(max=s_len - 1))
    a_prev = torch.where(llen > 0, torch.gather(
        last, 1, (2 * llen - 1).clamp(0, s_len - 1)), neg[:, :1])
    ll = torch.clamp(_lae(a_last, a_prev), min=NEG_INF)    # [B, 1]
    feasible = ll > NEG_INF * 0.5
    fin = torch.where((s_idx == 2 * llen) | ((s_idx == 2 * llen - 1)
                                             & (llen > 0)),
                      torch.zeros_like(neg), neg)
    skip2 = _shift_left(can_skip, 2, False)
    in_range = (ext >= 0) & (ext < v)
    cls = ext.long().clamp(0, v - 1)
    grad = [None] * t_max
    beta = None
    for tr in range(t_max - 1, -1, -1):
        if beta is None:
            beta = torch.where(ilen - 1 == tr, fin, neg)
        else:
            term0 = beta + emit[:, tr + 1]
            term2 = torch.where(skip2, _shift_left(term0, 2, NEG_INF), neg)
            trans = torch.clamp(_lae(_lae(term0, _shift_left(term0, 1,
                                                             NEG_INF)),
                                     term2), min=NEG_INF)
            trans = torch.where(ext_valid, trans, neg)
            beta = torch.where(ilen - 1 == tr, fin, trans)
        gam = torch.where(feasible, alpha[tr] + beta - ll, neg)
        post = torch.exp(torch.clamp(gam, max=0.0)) * in_range
        contrib = torch.zeros(b, v, dtype=logp.dtype, device=logp.device
                              ).scatter_add_(1, cls, post)
        if normalize:
            g = torch.exp(z[:, tr]) * contrib.sum(-1, keepdim=True) - contrib
        else:
            g = -contrib
        grad[tr] = torch.where(tr < ilen, g, torch.zeros_like(g))
    return -ll[:, 0], torch.stack(grad, 1)


def _decode_plain(logp, ilen, blank):
    """Plain twin of the decode kernel: (best, keep) [B, T] int32."""
    best = torch.argmax(logp, dim=2).to(torch.int32)
    t_max = logp.shape[1]
    prev = torch.nn.functional.pad(best[:, :-1], (1, 0), value=-1)
    valid = (torch.arange(t_max, device=logp.device)[None, :]
             < ilen.long()[:, None])
    keep = (best != blank) & (best != prev) & valid
    return best, keep.to(torch.int32)


# -- the kernels ---------------------------------------------------------------------


def _check_kernel_args(logp, *ints):
    enforce(logp.dtype == torch.float32,
            "the ctc kernels take float32 log-probs")
    enforce(all(x.dtype == torch.int32 for x in ints),
            "the ctc kernels take int32 tables and lengths")
    enforce(all(x.is_contiguous() for x in (logp,) + ints),
            "the ctc kernels need contiguous operands")
    enforce(len({x.device for x in (logp,) + ints}) == 1,
            f"operands on several devices: "
            f"{[x.device for x in (logp,) + ints]}")


def _fwd_bwd_kernel(logp, ext, can_skip, ext_valid, ilen, llen, normalize):
    """The forward-backward kernel (the contract of :func:`_fwd_bwd_plain`)."""
    tables = [x.to(torch.int32).contiguous()
              for x in (ext, can_skip, ext_valid, ilen, llen)]
    _check_kernel_args(logp, *tables)
    b, t, v = logp.shape
    s = ext.shape[1]
    loss = torch.empty(b, device=logp.device)
    grad = torch.empty_like(logp)
    # per row: alpha and emissions [T, S], the frames' log-normalizers [T],
    # two beta rows and the posteriors [S]
    per_row = 2 * t * s + t + 3 * s
    scratch = (None if 4 * per_row <= _SMEM_BUDGET
               else torch.empty(b * per_row, device=logp.device))
    KERNEL_LOSS.launch_on(
        logp.device.index, logp.data_ptr(), *(x.data_ptr() for x in tables),
        loss.data_ptr(), grad.data_ptr(),
        0 if scratch is None else scratch.data_ptr(), b, t, v, s,
        int(normalize))
    return loss, grad


def _decode_kernel(logp, ilen, blank):
    """The decode kernel, one launch: the contract of
    ``compact_decoded(*_decode_plain(logp, ilen, blank))``, (ids [B, T]
    int32 padded with -1, lengths [B] int32), both views of one
    allocation.  The lengths are read as int32 or int64, as they come."""
    b, t, v = logp.shape
    len64 = _LEN64.get(ilen.dtype)
    if len64 is None:
        ilen, len64 = ilen.to(torch.int32), 0
    logp = logp if logp.is_contiguous() else logp.contiguous()
    ilen = ilen if ilen.is_contiguous() else ilen.contiguous()
    enforce(logp.dtype == torch.float32,
            "the ctc decode kernel takes float32 log-probs, got %s",
            logp.dtype)
    if not (ilen.shape == (b,) and ilen.device == logp.device):
        enforce(False, "the ctc decode kernel needs lengths [B] on the "
                "log-probs' device, got %s on %s for %s on %s",
                tuple(ilen.shape), ilen.device, tuple(logp.shape),
                logp.device)
    out = torch.empty(b * t + b, dtype=torch.int32, device=logp.device)
    base = out.data_ptr()
    KERNEL_DECODE.launch_on(
        logp.device.index, logp.data_ptr(), ilen.data_ptr(), len64, base,
        base + 4 * b * t, b, t, v, int(blank))
    ids, lens = out.split([b * t, b])
    return ids.view(b, t), lens


class _CtcFused(torch.autograd.Function):
    """JAX: ``_ctc_fused``'s ``custom_vjp``.  The residual is the kernel's
    [B, T, V] gradient; the backward scales it by the cotangent."""

    @staticmethod
    def forward(ctx, logp, ext, can_skip, ext_valid, ilen, llen, normalize):
        run = _fwd_bwd_plain if logp.device.type == "cpu" else _fwd_bwd_kernel
        loss, grad = run(logp, ext, can_skip, ext_valid, ilen, llen,
                         normalize)
        ctx.save_for_backward(grad)
        return loss

    @staticmethod
    def backward(ctx, g):
        (grad,) = ctx.saved_tensors
        return g[:, None, None] * grad, None, None, None, None, None, None


def ctc_loss_fused(log_probs, input_lengths, labels, label_lengths,
                   blank: int = 0, normalize: bool = False) -> torch.Tensor:
    """Fused CTC negative log-likelihood with a hand-derived gradient: the
    contract of ``ops/ctc.ctc_loss`` ([B] losses), plus ``normalize=True``
    to take raw logits and fold the log-softmax in (the warp-ctc form).
    Float32 on the card; the CPU twin also keeps float64."""
    enforce(log_probs.dim() == 3 and labels.dim() == 2,
            f"ctc_loss_fused: log_probs [B, T, V] and labels [B, L], got "
            f"{tuple(log_probs.shape)} and {tuple(labels.shape)}")
    dev = log_probs.device
    ext, ext_valid, can_skip = ctc_ops.ctc_tables(
        labels.to(dev), label_lengths.to(dev), blank)
    if log_probs.dtype != torch.float64:
        log_probs = log_probs.float()
    return _CtcFused.apply(log_probs.contiguous(), ext, can_skip, ext_valid,
                           input_lengths.to(dev, torch.int32),
                           label_lengths.to(dev, torch.int32),
                           bool(normalize))


def ctc_loss_fused_reference(log_probs, input_lengths, labels, label_lengths,
                             blank: int = 0, normalize: bool = False):
    """Oracle of :func:`ctc_loss_fused`: the ``ops/ctc.py`` loop (autograd
    gives its gradient), the log-softmax applied outside for
    ``normalize``."""
    if normalize:
        log_probs = torch.log_softmax(log_probs, dim=-1)
    return ctc_ops.ctc_loss(log_probs, input_lengths, labels, label_lengths,
                            blank)


def ctc_greedy_decode_fused(log_probs, input_lengths, blank: int = 0):
    """Fused best-path decode: on the card one kernel reads the [B, T, V]
    slab once and writes the front-compacted ids and the lengths.
    Returns (ids [B, T] int32 padded with -1, lengths [B] int32), as
    ``ops/ctc.ctc_greedy_decode``."""
    enforce(log_probs.dim() == 3,
            f"ctc_greedy_decode_fused: log_probs [B, T, V], got "
            f"{tuple(log_probs.shape)}")
    dev = log_probs.device
    ilen = (input_lengths if input_lengths.device == dev
            else input_lengths.to(dev))
    if dev.type != "cpu":
        return _decode_kernel(log_probs, ilen, blank)
    best, keep = _decode_plain(log_probs, ilen, blank)
    return ctc_ops.compact_decoded(best, keep.bool())


def ctc_greedy_decode_fused_reference(log_probs, input_lengths,
                                      blank: int = 0):
    """Oracle of :func:`ctc_greedy_decode_fused`: ``ops/ctc``'s decode."""
    return ctc_ops.ctc_greedy_decode(log_probs, input_lengths, blank)
