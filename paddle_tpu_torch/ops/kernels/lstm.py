"""Fused LSTM sequence kernel (the port of ``paddle_tpu/ops/pallas/lstm.py``'s
``lstm_seq``: forward, stored-gates backward and remat backward).

:func:`lstm_seq` is a ``torch.autograd.Function``.  On the card its forward
is one cooperative launch of ``csrc/lstm_seq.cu``'s forward kernel over
every time step, and its backward one launch of the backward kernel
(remat on: the gates are recomputed from xw and the shifted h/c stacks;
off: read from the slab the forward stored; the two give the same bits).
``dW_h`` is one large ``torch.matmul`` over the [B*T] rows outside the
kernel, as the JAX package leaves it to XLA.  CPU tensors take the plain
twins (:func:`_fwd_plain`, :func:`_bwd_plain`), which compute each step as
the kernels do, so the two backward forms give the same bits there too.

:func:`lstm_seq_reference` is the plain scan (autograd gives its
backward): the oracle of the whole Function."""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_FWD = Kernel("lstm_seq", "lstm_fwd_f32", [_P] * 11 + [_I] * 5 + [_P])
KERNEL_BWD = Kernel("lstm_seq", "lstm_bwd_f32", [_P] * 17 + [_I] * 6 + [_P])

#: the kernels' tiling: a block owns U <= 16 hidden units with 32U threads
_MAX_UNITS = 16


# -- the plain twins -----------------------------------------------------------


def _cell(x_t, h, c, w_h, peep):
    """One step's gate bundle: pre = x_t + h @ w_h, gate order [i, f, g, o],
    peepholes i/f on c_{t-1}, o on c_t.  Returns (i, f, g, o, c, h)."""
    d = h.shape[-1]
    pre = x_t + torch.matmul(h, w_h)
    i = torch.sigmoid(pre[:, :d] + peep[0] * c)
    f = torch.sigmoid(pre[:, d:2 * d] + peep[1] * c)
    g = torch.tanh(pre[:, 2 * d:3 * d])
    c_new = f * c + i * g
    o = torch.sigmoid(pre[:, 3 * d:] + peep[2] * c_new)
    return i, f, g, o, c_new, o * torch.tanh(c_new)


def _steps(t: int, reverse: bool):
    """Array indices in the order a run visits them."""
    return range(t - 1, -1, -1) if reverse else range(t)


def _fwd_plain(xw, mask, w_h, peep, h0, c0, reverse, emit_gates):
    """Plain twin of the forward kernel: (hs, cs, gates or None, h_T, c_T),
    hs/cs [B, T, D], gates [B, T, 4D]."""
    t = xw.shape[1]
    h, c = h0, c0
    hs, cs, gates = [None] * t, [None] * t, [None] * t
    for k in _steps(t, reverse):
        i, f, g, o, c_new, h_new = _cell(xw[:, k], h, c, w_h, peep)
        m = mask[:, k, None]
        h = m * h_new + (1.0 - m) * h
        c = m * c_new + (1.0 - m) * c
        hs[k], cs[k] = h, c
        if emit_gates:
            gates[k] = torch.cat([i, f, g, o], dim=-1)
    return (torch.stack(hs, 1), torch.stack(cs, 1),
            torch.stack(gates, 1) if emit_gates else None, h, c)


def _bwd_plain(xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
               reverse, remat):
    """Plain twin of the backward kernel: (dgates [B, T, 4D], dh0, dc0,
    dpeep [3, D]).  Remat recomputes each step's gates with the forward's
    own per-step product, so both forms give the same bits."""
    t, d = hs.shape[1], w_h.shape[0]
    dh, dc = dhT, dcT
    dpeep = torch.zeros_like(peep)
    dgates = [None] * t
    boot = t - 1 if reverse else 0      # the first index a run computes
    for k in _steps(t, not reverse):
        kp = k + 1 if reverse else k - 1
        m = mask[:, k, None]
        dh = dh + dhs[:, k]
        # contiguous, as the forward's carries were: the same layouts take
        # the same vectorized loops, so the recomputed gates match bits
        c_prev = c0 if k == boot else cs[:, kp].contiguous()
        if remat:
            h_prev = h0 if k == boot else hs[:, kp].contiguous()
            i, f, g, o = _cell(xw[:, k], h_prev, c_prev, w_h, peep)[:4]
        else:
            i, f, g, o = gates[:, k].split(d, dim=-1)
        c = cs[:, k]
        tanh_c = torch.tanh(c)
        do = dh * tanh_c * o * (1.0 - o) * m
        dc_t = (dc + dh * o * (1.0 - tanh_c * tanh_c)) * m + do * peep[2]
        di = dc_t * g * i * (1.0 - i)
        df = dc_t * c_prev * f * (1.0 - f)
        dg = dc_t * i * (1.0 - g * g)
        dgates[k] = torch.cat([di, df, dg, do], dim=-1)
        dpeep = dpeep + torch.stack([(di * c_prev).sum(0),
                                     (df * c_prev).sum(0),
                                     (do * c).sum(0)])
        dh = torch.matmul(dgates[k], w_h.t()) + (1.0 - m) * dh
        dc = dc_t * f + di * peep[0] + df * peep[1] + (1.0 - m) * dc
    return torch.stack(dgates, 1), dh, dc, dpeep


# -- the kernels -------------------------------------------------------------------


def _units(device, d: int) -> int:
    """Hidden units a block owns: one block per SM at most, so the grid
    of the cooperative launch can be co-resident."""
    enforce(d % 4 == 0, f"lstm kernels: D={d} must be a multiple of 4 "
            "(16-byte copies)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    u = -(-d // sms)
    enforce(u <= _MAX_UNITS, f"lstm kernels: D={d} needs {u} units a block "
            f"on {sms} SMs, more than the {_MAX_UNITS} the tiling covers")
    return u


def _pack_columns(w_h, u: int):
    """[D, 4D] -> [blocks, D, U, 4]: block j's entry [k, uu, g] is
    W_h[k, g*D + j*U + uu] (zero past D), the slice it keeps in shared
    memory, the four gates of a unit side by side."""
    d = w_h.shape[0]
    nb = -(-d // u)
    w = F.pad(w_h.reshape(d, 4, d), (0, nb * u - d))
    return w.reshape(d, 4, nb, u).permute(2, 0, 3, 1).contiguous()


def _check_kernel_args(*tensors):
    enforce(all(x.dtype == torch.float32 for x in tensors),
            "the lstm kernels take float32 operands")
    enforce(all(x.is_contiguous() for x in tensors),
            "the lstm kernels need contiguous operands")
    enforce(len({x.device for x in tensors}) == 1,
            f"operands on several devices: {[x.device for x in tensors]}")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _fwd_kernel(xw, mask, w_h, peep, h0, c0, reverse, emit_gates):
    """The forward kernel (the contract of :func:`_fwd_plain`)."""
    _check_kernel_args(xw, mask, w_h, peep, h0, c0)
    b, t, _ = xw.shape
    d = w_h.shape[0]
    u = _units(xw.device, d)
    wpack = _pack_columns(w_h, u)
    hs = torch.empty(b, t, d, device=xw.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xw) if emit_gates else None
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    KERNEL_FWD.launch(xw.data_ptr(), mask.data_ptr(), wpack.data_ptr(),
                      peep.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                      hs.data_ptr(), cs.data_ptr(), _ptr(gates),
                      h_t.data_ptr(), c_t.data_ptr(), b, t, d, u,
                      int(reverse), torch.cuda.current_stream().cuda_stream)
    return hs, cs, gates, h_t, c_t


def _bwd_kernel(xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
                reverse, remat):
    """The backward kernel (the contract of :func:`_bwd_plain`)."""
    _check_kernel_args(mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
                       xw if remat else gates)
    b, t, _ = hs.shape
    d = w_h.shape[0]
    u = _units(hs.device, d)
    wpack = _pack_columns(w_h, u)
    dgates = torch.empty(b, t, 4 * d, device=hs.device)
    dh, dc = torch.empty_like(dhT), torch.empty_like(dcT)
    dpeep = torch.empty_like(peep)
    # each block's share of dh_{t-1}, two buffers by step parity
    part = torch.empty(2 * wpack.shape[0] * d * b, device=hs.device)
    KERNEL_BWD.launch(_ptr(xw if remat else None),
                      _ptr(None if remat else gates), mask.data_ptr(),
                      wpack.data_ptr(), peep.data_ptr(), h0.data_ptr(),
                      c0.data_ptr(), hs.data_ptr(), cs.data_ptr(),
                      dhs.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
                      dgates.data_ptr(), dh.data_ptr(), dc.data_ptr(),
                      dpeep.data_ptr(), part.data_ptr(), b, t, d, u,
                      int(reverse), int(remat),
                      torch.cuda.current_stream().cuda_stream)
    return dgates, dh, dc, dpeep


def _shift_prev(stack, boot, reverse):
    """[B, T, D] -> the state each index's step started from: ``boot`` at
    the first index a run computes (0 forward, T-1 reverse), the stack
    shifted by one elsewhere."""
    boot = boot.to(stack.dtype)[:, None]
    if reverse:
        return torch.cat([stack[:, 1:], boot], dim=1)
    return torch.cat([boot, stack[:, :-1]], dim=1)


class _LstmSeq(torch.autograd.Function):
    """JAX: ``lstm_seq``'s ``custom_vjp``.  Residuals: mask, w_h, peep, h0,
    c0, hs, cs and either the gates slab (remat off) or xw (remat on)."""

    @staticmethod
    def forward(ctx, xw, mask, w_h, peep, h0, c0, reverse, remat):
        fwd = _fwd_plain if xw.device.type == "cpu" else _fwd_kernel
        hs, cs, gates, h_t, c_t = fwd(xw, mask, w_h, peep, h0, c0, reverse,
                                      not remat)
        ctx.save_for_backward(xw if remat else None, gates, mask, w_h, peep,
                              h0, c0, hs, cs)
        ctx.cfg = (reverse, remat)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        xw, gates, mask, w_h, peep, h0, c0, hs, cs = ctx.saved_tensors
        reverse, remat = ctx.cfg
        bwd = _bwd_plain if hs.device.type == "cpu" else _bwd_kernel
        dgates, dh0, dc0, dpeep = bwd(
            xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs.contiguous(),
            dh_t.contiguous(), dc_t.contiguous(), reverse, remat)
        d = w_h.shape[0]
        h_prev = _shift_prev(hs, h0, reverse)
        dw_h = torch.matmul(h_prev.reshape(-1, d).t(),
                            dgates.reshape(-1, 4 * d))
        return dgates, None, dw_h, dpeep, dh0, dc0, None, None


def lstm_seq(xw, mask, w_h, peephole, h0, c0, reverse=False, remat=False):
    """Fused LSTM over a whole sequence.

    xw [B, T, 4D] (x @ W_x + bias, gate order [i, f, g, o]); mask [B, T]
    (1.0 while t < length, rows freeze afterwards); w_h [D, 4D]; peephole
    [3, D] ([W_ci, W_cf, W_co]; zeros for a plain LSTM); h0, c0 [B, D];
    reverse: iterate T-1..0; remat: keep no gates slab for the backward,
    recompute the gates there.  Returns (hs [B, T, D], (h_T, c_T))."""
    enforce(xw.dim() == 3 and xw.shape[1] >= 1
            and xw.shape[2] == 4 * w_h.shape[0],
            f"lstm_seq: xw must be [B, T>=1, 4D] for w_h {tuple(w_h.shape)},"
            f" got {tuple(xw.shape)}")
    hs, h_t, c_t = _LstmSeq.apply(
        xw.contiguous(), mask.to(xw.dtype).contiguous(), w_h.contiguous(),
        peephole.contiguous(), h0.contiguous(), c0.contiguous(),
        bool(reverse), bool(remat))
    return hs, (h_t, c_t)


def lstm_seq_reference(xw, mask, w_h, peephole, h0, c0, reverse=False):
    """Plain scan of the same cell, peepholes and freeze mask (autograd
    gives its backward).  Returns (hs [B, T, D], (h_T, c_T))."""
    hs, _, _, h_t, c_t = _fwd_plain(xw, mask.to(xw.dtype), w_h, peephole, h0,
                                    c0, reverse, False)
    return hs, (h_t, c_t)
