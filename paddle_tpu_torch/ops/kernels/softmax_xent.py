"""Fused softmax cross-entropy over a large vocabulary (the port of
``paddle_tpu/ops/pallas/softmax_xent.py``'s ``softmax_xent``).

:func:`softmax_xent` is a ``torch.autograd.Function``: the per-row
negative log-likelihood ``logsumexp(logits[i]) - logits[i, targets[i]]``
[N] f32 (float64 for float64 logits); callers take its mean.  On the
card its forward is one launch of ``csrc/softmax_xent.cu``'s forward
kernel (one read of the logits, an online max and sum-exp in f32, the
row's lse kept for the backward), and its backward one launch of the
backward kernel, ``d_logits = (exp(x - lse) - onehot(target)) * g_row``
in one read and one write, computed in f32 and rounded to the logits'
dtype once.  f32 and bf16 logits each take their own form, counted
apart, as the JAX package feeds its kernel either (``softmax_xent.py``
:106-108, :126).  CPU tensors take the plain twins (:func:`_fwd_plain`,
:func:`_bwd_plain`), which round where the kernels round; the backward
twin writes ``(softmax - onehot) * g`` out by hand, so a float64
``gradcheck`` tests the hand backward.  The TPU kernel's tile sizes
(``block_rows``, ``block_v``) have no meaning here and are not taken.

:func:`softmax_xent_reference` is the unfused form (autograd gives its
backward), the oracle.  Nothing in the port routes the LM loss through
this op (``models/transformer.loss_fn``), as in the JAX package."""

from __future__ import annotations

import ctypes

import torch

from paddle_tpu_torch.core.dtype import at_least_f32
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_FWD = Kernel("softmax_xent", "softmax_xent_fwd_f32",
                    [_P] * 4 + [_I] * 2 + [_P])
KERNEL_BWD = Kernel("softmax_xent", "softmax_xent_bwd_f32",
                    [_P] * 5 + [_I] * 2 + [_P])
KERNEL_FWD_BF16 = Kernel("softmax_xent", "softmax_xent_fwd_bf16",
                         [_P] * 4 + [_I] * 2 + [_P])
KERNEL_BWD_BF16 = Kernel("softmax_xent", "softmax_xent_bwd_bf16",
                         [_P] * 5 + [_I] * 2 + [_P])
#: {logits dtype: (forward, backward) form}
FORMS = {torch.float32: (KERNEL_FWD, KERNEL_BWD),
         torch.bfloat16: (KERNEL_FWD_BF16, KERNEL_BWD_BF16)}


def _in_range(logits, targets):
    """(targets clamped into [0, V), [N, 1] whether each was in range)."""
    v = logits.shape[-1]
    ok = (targets >= 0) & (targets < v)
    return targets.clamp(0, v - 1)[:, None], ok[:, None]


def _fwd_plain(logits, targets):
    """Plain twin of the forward kernel: (nll [N], lse [N]) in f32 (the
    logits upcast, as JAX's ``_lse_kernel`` reads them; float64 stays); a
    target outside [0, V) gives a NaN NLL."""
    x = at_least_f32(logits)
    lse = torch.logsumexp(x, dim=-1)
    idx, ok = _in_range(x, targets)
    picked = torch.gather(x, -1, idx)[:, 0]
    return torch.where(ok[:, 0], lse - picked, float("nan")), lse


def _bwd_plain(logits, targets, lse, g):
    """Plain twin of the backward kernel: (exp(x - lse) - onehot) * g in
    f32 (float64 stays), rounded to the logits' dtype once (JAX
    ``softmax_xent.py:126``); no onehot term for a target outside [0, V)."""
    x = at_least_f32(logits)
    p = torch.exp(x - lse[:, None])
    idx, ok = _in_range(x, targets)
    onehot = torch.zeros_like(p).scatter_(-1, idx, ok.to(p.dtype))
    return ((p - onehot) * g.to(p.dtype)[:, None]).to(logits.dtype)


def _check_kernel_args(logits, targets):
    enforce(logits.dtype in FORMS,
            f"the softmax_xent kernels take float32 or bfloat16 logits, got "
            f"{logits.dtype}")
    enforce(targets.dtype == torch.int64 and logits.is_contiguous()
            and targets.is_contiguous(),
            "the softmax_xent kernels take contiguous logits and int64 "
            "targets")
    enforce(logits.device == targets.device,
            f"logits on {logits.device}, targets on {targets.device}")


def _fwd_kernel(logits, targets):
    """The forward kernel of the logits' dtype (the contract of
    :func:`_fwd_plain`): lse and the NLL f32 for f32 and bf16 logits."""
    _check_kernel_args(logits, targets)
    n, v = logits.shape
    lse = torch.empty(n, device=logits.device)
    nll = torch.empty(n, device=logits.device)
    FORMS[logits.dtype][0].launch_on(
        logits.device.index, logits.data_ptr(), targets.data_ptr(),
        lse.data_ptr(), nll.data_ptr(), n, v)
    return nll, lse


def _bwd_kernel(logits, targets, lse, g):
    """The backward kernel of the logits' dtype (the contract of
    :func:`_bwd_plain`): dlogits in the logits' dtype."""
    _check_kernel_args(logits, targets)
    n, v = logits.shape
    g = g.to(torch.float32).contiguous()
    dlogits = torch.empty_like(logits)
    FORMS[logits.dtype][1].launch_on(
        logits.device.index, logits.data_ptr(), targets.data_ptr(),
        lse.data_ptr(), g.data_ptr(), dlogits.data_ptr(), n, v)
    return dlogits


class _SoftmaxXent(torch.autograd.Function):
    """JAX: ``softmax_xent``'s ``custom_vjp``.  Residuals: the logits,
    targets and each row's lse."""

    @staticmethod
    def forward(ctx, logits, targets):
        fwd = _fwd_plain if logits.device.type == "cpu" else _fwd_kernel
        nll, lse = fwd(logits, targets)
        ctx.save_for_backward(logits, targets, lse)
        return nll

    @staticmethod
    def backward(ctx, g):
        logits, targets, lse = ctx.saved_tensors
        bwd = _bwd_plain if logits.device.type == "cpu" else _bwd_kernel
        return bwd(logits, targets, lse, g), None


def softmax_xent(logits, targets):
    """Per-row NLL ``logsumexp(logits[i]) - logits[i, targets[i]]``.

    logits [N, V] float (f32 or bf16 on the card; accumulation in f32),
    targets [N] int in [0, V) (a row whose target is outside gets a NaN
    NLL and no onehot term in its gradient, on either device).  Returns
    [N] f32 (float64 for float64 logits), as JAX's kernel does; the
    logits' gradient comes back in their dtype."""
    enforce(logits.dim() == 2 and logits.shape[0] >= 1 and logits.shape[1] >= 1
            and targets.shape == logits.shape[:1],
            f"softmax_xent: logits must be [N>=1, V>=1] with targets [N], got "
            f"logits {tuple(logits.shape)}, targets {tuple(targets.shape)}")
    return _SoftmaxXent.apply(logits.contiguous(),
                              targets.to(torch.int64).contiguous())


def softmax_xent_reference(logits, targets):
    """Oracle of :func:`softmax_xent`: the unfused ``logsumexp - picked
    logit`` in f32 or wider (autograd gives its backward)."""
    lf = logits if logits.dtype == torch.float64 else logits.float()
    picked = torch.gather(lf, -1, targets.long()[:, None])[:, 0]
    return torch.logsumexp(lf, dim=-1) - picked
