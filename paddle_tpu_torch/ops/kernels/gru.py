"""Fused GRU sequence kernels (the port of ``paddle_tpu/ops/pallas/gru.py``'s
``gru_seq``: forward, stored-gates backward and remat backward;
``gru_seq_fi``: the forward with the input projection inside the loop;
and ``bigru_seq``: both directions of a fused-input BiGRU in one forward).

The cell is Paddle's (``ops/rnn.gru_cell``), not cuDNN's: the reset gate
acts on h *before* the candidate product, and the gates are ordered
[update, reset, candidate]::

    u, r = sigmoid(xw[:, :2D] + h @ W_h)
    c    = tanh(xw[:, 2D:] + (r * h) @ W_hc)
    h'   = u * h + (1 - u) * c

:func:`gru_seq` is a ``torch.autograd.Function``.  On the card its forward
is one cooperative launch of ``csrc/gru_seq.cu``'s forward kernel over
every time step, and its backward one launch of the backward kernel
(remat on: u, r and c are recomputed from xw and the shifted h stack with
the forward's own code; off: read from the slab the forward stored; the
two give the same bits).  The backward kernel also hands back r * h_{t-1}
for every step, so ``dW_hc`` is one large ``torch.matmul`` over the
[B*T] rows outside the kernel, as ``dW_h`` is (the JAX package leaves both
to XLA).  CPU tensors take the plain twins (:func:`_fwd_plain`,
:func:`_bwd_plain`), which compute each step as the kernels do, so the
two backward forms give the same bits there too.

:func:`gru_seq_fi` is a ``torch.autograd.Function`` over raw inputs.  On
the card its forward is one launch of the forward kernel in its
fused-input form (``x @ W_x + b`` inside the loop, the [B, T, 3D]
gate-input slab never in device memory; the u/r/c slab written when remat
is off), and its backward recomputes xw with one ``torch.matmul``
(remat on) and launches the backward kernel above; ``dW_x``, ``db`` and
``dx`` are products outside.  Its CPU twin (:func:`_fi_fwd_plain`)
projects step by step, as the kernel does.  :func:`fi_fits` says, from
the device and the shapes alone, whether the kernels take a shape.

:func:`bigru_seq` is a ``torch.autograd.Function`` too.  On the card its
forward is one launch of ``csrc/bigru_seq.cu``, which runs both
directions and computes ``x @ W_x + b`` inside its loop, so the [B, T, 3D]
gate-input slab never reaches device memory.  Its backward recomputes
that slab per direction with one ``torch.matmul`` and launches the
backward kernel above with remat on, the form the JAX package's TPU
branch runs: two launches.  ``dW_x``, ``db``, ``dW_h``, ``dW_hc`` and
``dx`` are products and sums outside, as in the JAX backward.

:func:`gru_seq_reference` is the plain scan (autograd gives its
backward): the oracle of the whole Function; :func:`bigru_seq_reference`
composes it per direction over the projected input."""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel
from paddle_tpu_torch.ops.kernels.lstm import (_card, _project_xw,
                                               _shift_prev, tiling_refusal)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_FWD = Kernel("gru_seq", "gru_fwd_f32", [_P] * 10 + [_I] * 5 + [_P])
KERNEL_BWD = Kernel("gru_seq", "gru_bwd_f32", [_P] * 18 + [_I] * 6 + [_P])
#: the same entry point in its stored-gates form, counted apart
KERNEL_BWD_STORED = Kernel("gru_seq", "gru_bwd_f32",
                           [_P] * 18 + [_I] * 6 + [_P])
KERNEL_BI = Kernel("bigru_seq", "bigru_fwd_f32", [_P] * 17 + [_I] * 5 + [_P])
KERNEL_FI = Kernel("gru_seq", "gru_fi_fwd_f32", [_P] * 11 + [_I] * 6 + [_P])

#: the kernels' tiling: a block owns U <= 8 hidden units with 64U threads
_MAX_UNITS = 8
#: floats of the kernels' staging area: the larger of three 64 x 36 stages
#: of the A operand and the 4-way k-split sums [4][64][3U + 1]
_STAGE = 3 * 64 * 36


# -- the plain twins ---------------------------------------------------------


def _gates(x_t, h, w_h, w_hc):
    """One step's gate bundle from the gate input x_t [B, 3D] and the carry
    h [B, D]: (u, r, c, r * h)."""
    d = h.shape[-1]
    ur = x_t[:, :2 * d] + torch.matmul(h, w_h)
    u = torch.sigmoid(ur[:, :d])
    r = torch.sigmoid(ur[:, d:])
    rh = r * h
    c = torch.tanh(x_t[:, 2 * d:] + torch.matmul(rh, w_hc))
    return u, r, c, rh


def _steps(t: int, reverse: bool):
    """Array indices in the order a run visits them."""
    return range(t - 1, -1, -1) if reverse else range(t)


def _fwd_plain(xw, mask, w_h, w_hc, h0, reverse, emit_gates):
    """Plain twin of the forward kernel: (hs [B, T, D], urc [B, T, 3D] or
    None, h_T [B, D])."""
    return _run(lambda k: xw[:, k], xw.shape[1], mask, w_h, w_hc, h0,
                reverse, emit_gates)


def _fi_fwd_plain(x, mask, w_x, b, w_h, w_hc, h0, reverse, emit_gates):
    """Plain twin of the fused-input forward kernel: each step's gate input
    x_t @ W_x + b inside the loop, as the kernel computes it; the contract
    of :func:`_fwd_plain`."""
    return _run(lambda k: torch.matmul(x[:, k], w_x) + b, x.shape[1], mask,
                w_h, w_hc, h0, reverse, emit_gates)


def _run(step_input, t, mask, w_h, w_hc, h0, reverse, emit_gates):
    """The forward recurrence over the gate inputs ``step_input(k)``
    [B, 3D]."""
    h = h0
    hs, urc = [None] * t, [None] * t
    for k in _steps(t, reverse):
        u, r, c, _ = _gates(step_input(k), h, w_h, w_hc)
        m = mask[:, k, None]
        h = m * (u * h + (1.0 - u) * c) + (1.0 - m) * h
        hs[k] = h
        if emit_gates:
            urc[k] = torch.cat([u, r, c], dim=-1)
    return (torch.stack(hs, 1), torch.stack(urc, 1) if emit_gates else None,
            h)


def _bwd_plain(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse, remat):
    """Plain twin of the backward kernel: (dxw [B, T, 3D] = [du, dr, dc]
    pre-activation cotangents, dh0 [B, D], rh [B, T, D] = r * h_{t-1}).
    Frozen rows pass dh through.  Remat recomputes each step's gates with
    the forward's own per-step products, so both forms give the same
    bits."""
    t, d = hs.shape[1], w_hc.shape[0]
    dh = dhT
    dxw, rhs = [None] * t, [None] * t
    boot = t - 1 if reverse else 0      # the first index a run computes
    for k in _steps(t, not reverse):
        kp = k + 1 if reverse else k - 1
        m = mask[:, k, None]
        dh = dh + dhs[:, k]
        # contiguous, as the forward's carry was: the same layouts take
        # the same vectorized loops, so the recomputed gates match bits
        h_prev = h0 if k == boot else hs[:, kp].contiguous()
        if remat:
            u, r, c, rh = _gates(xw[:, k], h_prev, w_h, w_hc)
        else:
            u, r, c = urc[:, k].split(d, dim=-1)
            rh = r * h_prev
        du = dh * (h_prev - c) * u * (1.0 - u) * m
        dpc = dh * (1.0 - u) * m * (1.0 - c * c)
        drh = torch.matmul(dpc, w_hc.t())
        dr = drh * h_prev * r * (1.0 - r)
        dur = torch.cat([du, dr], dim=-1)
        dxw[k] = torch.cat([dur, dpc], dim=-1)
        rhs[k] = rh
        dh_prev = dh * u * m + drh * r + torch.matmul(dur, w_h.t())
        dh = dh_prev + (1.0 - m) * dh
    return torch.stack(dxw, 1), dh, torch.stack(rhs, 1)


# -- the kernels -------------------------------------------------------------


def _units(device, d: int, share: int = 1) -> int:
    """Hidden units a block owns: one block per SM at most (the SMs split
    ``share`` ways), so the grid of the cooperative launch can be
    co-resident."""
    enforce(d % 4 == 0, f"gru kernels: D={d} must be a multiple of 4 "
            "(16-byte copies)")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per = sms // share
    u = -(-d // per)
    enforce(u <= _MAX_UNITS, f"gru kernels: D={d} needs {u} units a block "
            f"on {per} SMs, more than the {_MAX_UNITS} the tiling covers")
    return u


def _check_smem(device, floats: int, what: str) -> None:
    """Refuse a tiling whose shared memory exceeds the card's opt-in."""
    limit = _card(device)[1]
    enforce(4 * floats <= limit, f"{what} needs {4 * floats} bytes of "
            f"shared memory a block, more than the {limit} the card allows")


def _fi_smem_floats(e: int, d: int, u: int) -> int:
    """The fused-input forward's block: 3 (E + D) U weight floats and the
    staging area."""
    return 3 * (e + d) * u + _STAGE


#: (E, D, SMs, opt-in bytes) -> why :func:`gru_seq_fi` refuses, or None
_fi_refusal = functools.partial(tiling_refusal, "gru_seq_fi", _MAX_UNITS,
                                _fi_smem_floats)


def fi_fits(device, e: int, d: int) -> bool:
    """Whether :func:`gru_seq_fi`'s kernels take input width E and hidden
    width D on the card ``device``: decided from the card's SM count and
    shared-memory opt-in before any launch."""
    return _fi_refusal(e, d, *_card(device)) is None


def _pack_columns(w, d: int, u: int, n: int):
    """[K, n*D] -> [blocks, K, U, n]: block j's entry [k, uu, g] is
    w[k, g*D + j*U + uu] (zero past D), the column slice it keeps in
    shared memory, the n gates of a unit side by side."""
    k = w.shape[0]
    nb = -(-d // u)
    w = F.pad(w.reshape(k, n, d), (0, nb * u - d))
    return w.reshape(k, n, nb, u).permute(2, 0, 3, 1).contiguous()


def _check_kernel_args(*tensors):
    enforce(all(x.dtype == torch.float32 for x in tensors),
            "the gru kernels take float32 operands")
    enforce(all(x.is_contiguous() for x in tensors),
            "the gru kernels need contiguous operands")
    enforce(len({x.device for x in tensors}) == 1,
            f"operands on several devices: {[x.device for x in tensors]}")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _fwd_kernel(xw, mask, w_h, w_hc, h0, reverse, emit_gates):
    """The forward kernel (the contract of :func:`_fwd_plain`)."""
    _check_kernel_args(xw, mask, w_h, w_hc, h0)
    b, t, _ = xw.shape
    d = w_hc.shape[0]
    u = _units(xw.device, d)
    _check_smem(xw.device, 3 * d * u + _STAGE, f"gru forward: D={d}")
    hs = torch.empty(b, t, d, device=xw.device)
    urc = torch.empty_like(xw) if emit_gates else None
    h_t = torch.empty_like(h0)
    scratch = torch.empty(2, b, d, device=xw.device)    # r * h and u
    # the packs stay referenced until the launch is queued: a freed
    # temporary's memory would be handed to the next allocation
    packs = (_pack_columns(w_h, d, u, 2), _pack_columns(w_hc, d, u, 1))
    KERNEL_FWD.launch(xw.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
                      packs[1].data_ptr(), h0.data_ptr(),
                      hs.data_ptr(), _ptr(urc), h_t.data_ptr(),
                      scratch[0].data_ptr(), scratch[1].data_ptr(), b, t, d,
                      u, int(reverse), _stream())
    return hs, urc, h_t


def _fi_fwd_kernel(x, mask, w_x, b, w_h, w_hc, h0, reverse, emit_gates):
    """The fused-input forward kernel (the contract of
    :func:`_fi_fwd_plain`)."""
    _check_kernel_args(x, mask, w_x, b, w_h, w_hc, h0)
    bsz, t, e = x.shape
    d = w_hc.shape[0]
    sms, optin = _card(x.device)
    refusal = _fi_refusal(e, d, sms, optin)
    enforce(refusal is None, refusal or "")
    u = -(-d // sms)
    hs = torch.empty(bsz, t, d, device=x.device)
    urc = torch.empty(bsz, t, 3 * d, device=x.device) if emit_gates else None
    h_t = torch.empty_like(h0)
    scratch = torch.empty(3, bsz, d, device=x.device)   # r*h, u, xw_c
    packs = (_pack_columns(w_x, d, u, 3), _pack_columns(w_h, d, u, 2),
             _pack_columns(w_hc, d, u, 1))     # referenced until queued
    KERNEL_FI.launch(x.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
                     b.data_ptr(), packs[1].data_ptr(), packs[2].data_ptr(),
                     h0.data_ptr(), hs.data_ptr(), _ptr(urc),
                     h_t.data_ptr(), scratch.data_ptr(), bsz, t, e, d, u,
                     int(reverse), _stream())
    return hs, urc, h_t


def _bwd_kernel(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse, remat):
    """The backward kernel (the contract of :func:`_bwd_plain`)."""
    _check_kernel_args(mask, w_h, w_hc, h0, hs, dhs, dhT,
                       xw if remat else urc)
    b, t, d = hs.shape
    u = _units(hs.device, d)
    _check_smem(hs.device, 3 * d * u + _STAGE, f"gru backward: D={d}")
    dev = hs.device
    dxw = torch.empty(b, t, 3 * d, device=dev)
    dh = torch.empty_like(dhT)
    rh = torch.empty(b, t, d, device=dev)
    # the remat form's recomputed gate slab; the step exchange buffers
    # (dc pre-activation and [du, dr], two of each by step parity) and
    # the reset product drh, kept between the step's phases
    gates = torch.empty(b, t, 3 * d, device=dev) if remat else None
    dpc, dur = (torch.empty(2, b, n * d, device=dev) for n in (1, 2))
    drh = torch.empty(b, d, device=dev)
    # the column slices (for the remat pass) and the row slices, kept
    # referenced until the launch is queued
    packs = (_pack_columns(w_h, d, u, 2), _pack_columns(w_hc, d, u, 1),
             _pack_columns(w_h.t(), d, u, 1), _pack_columns(w_hc.t(), d, u, 1))
    (KERNEL_BWD if remat else KERNEL_BWD_STORED).launch(
                      _ptr(xw if remat else None),
                      _ptr(None if remat else urc), mask.data_ptr(),
                      *(p.data_ptr() for p in packs), h0.data_ptr(),
                      hs.data_ptr(), dhs.data_ptr(), dhT.data_ptr(),
                      dxw.data_ptr(), dh.data_ptr(),
                      rh.data_ptr(), _ptr(gates), dpc.data_ptr(),
                      dur.data_ptr(), drh.data_ptr(), b, t, d, u,
                      int(reverse), int(remat), _stream())
    return dxw, dh, rh


class _GruSeq(torch.autograd.Function):
    """JAX: ``gru_seq``'s ``custom_vjp``.  Residuals: mask, w_h, w_hc, h0,
    hs and either the u/r/c slab (remat off) or xw (remat on)."""

    @staticmethod
    def forward(ctx, xw, mask, w_h, w_hc, h0, reverse, remat):
        fwd = _fwd_plain if xw.device.type == "cpu" else _fwd_kernel
        hs, urc, h_t = fwd(xw, mask, w_h, w_hc, h0, reverse, not remat)
        ctx.save_for_backward(xw if remat else None, urc, mask, w_h, w_hc,
                              h0, hs)
        ctx.cfg = (reverse, remat)
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        xw, urc, mask, w_h, w_hc, h0, hs = ctx.saved_tensors
        reverse, remat = ctx.cfg
        bwd = _bwd_plain if hs.device.type == "cpu" else _bwd_kernel
        dxw, dh0, rh = bwd(xw, urc, mask, w_h, w_hc, h0, hs,
                           dhs.contiguous(), dh_t.contiguous(), reverse,
                           remat)
        dw_h, dw_hc = _recurrent_grads(dxw, hs, h0, rh, reverse)
        return dxw, None, dw_h, dw_hc, dh0, None, None


def _recurrent_grads(dxw, hs, h0, rh, reverse):
    """dW_h = h_{t-1}^T [du, dr] and dW_hc = (r h_{t-1})^T dc, each one
    product over the [B*T] rows."""
    d = hs.shape[-1]
    dg = dxw.reshape(-1, 3 * d)
    h_prev = _shift_prev(hs, h0, reverse).reshape(-1, d)
    return (torch.matmul(h_prev.t(), dg[:, :2 * d]),
            torch.matmul(rh.reshape(-1, d).t(), dg[:, 2 * d:]))


def gru_seq(xw, mask, w_h, w_hc, h0, reverse=False, remat=False):
    """Fused GRU over a whole sequence.

    xw [B, T, 3D] (x @ W_x + bias, gate order [u, r, c]); mask [B, T]
    (1.0 while t < length, rows freeze afterwards); w_h [D, 2D]; w_hc
    [D, D]; h0 [B, D]; reverse: iterate T-1..0; remat: keep no u/r/c slab
    for the backward, recompute the gates there.  Returns (hs [B, T, D],
    h_T)."""
    d = w_hc.shape[0]
    enforce(xw.dim() == 3 and xw.shape[1] >= 1 and xw.shape[2] == 3 * d
            and tuple(w_h.shape) == (d, 2 * d),
            f"gru_seq: xw must be [B, T>=1, 3D] with w_h [D, 2D] and w_hc "
            f"[D, D], got xw {tuple(xw.shape)}, w_h {tuple(w_h.shape)}, "
            f"w_hc {tuple(w_hc.shape)}")
    return _GruSeq.apply(xw.contiguous(), mask.to(xw.dtype).contiguous(),
                         w_h.contiguous(), w_hc.contiguous(), h0.contiguous(),
                         bool(reverse), bool(remat))


def gru_seq_reference(xw, mask, w_h, w_hc, h0, reverse=False):
    """Plain scan of the same cell and freeze mask (autograd gives its
    backward).  Returns (hs [B, T, D], h_T)."""
    hs, _, h_t = _fwd_plain(xw, mask.to(xw.dtype), w_h, w_hc, h0, reverse,
                            False)
    return hs, h_t


# -- the fused-input bidirectional entry -------------------------------------


def _bi_fwd_plain(x, mask, fw, bw):
    """Plain twin of the bigru kernel, the unfused composition: per
    direction the projection as one product, then the forward twin over
    it.  ``fw``/``bw`` = (w_x, b, w_h, w_hc, h0); returns ((hs, h_T)
    forward, the same reverse)."""
    outs = []
    for (w_x, b, w_h, w_hc, h0), reverse in ((fw, False), (bw, True)):
        hs, _, h_t = _fwd_plain(_project_xw(x, w_x, b), mask, w_h, w_hc, h0,
                                reverse, False)
        outs.append((hs, h_t))
    return tuple(outs)


def _bi_fwd_kernel(x, mask, fw, bw):
    """The bigru kernel (the contract of :func:`_bi_fwd_plain`)."""
    _check_kernel_args(x, mask, *fw, *bw)
    b, t, e = x.shape
    d = fw[3].shape[0]
    enforce(e % 4 == 0, f"bigru kernel: E={e} must be a multiple of 4 "
            "(16-byte copies)")
    u = _units(x.device, d, share=2)
    _check_smem(x.device, 3 * (e + d) * u + _STAGE,
                f"bigru kernel: D={d}, E={e}")
    # the backward kernel's tiling must take this D too
    _check_smem(x.device, 3 * d * _units(x.device, d) + _STAGE,
                f"gru backward: D={d}")
    args = [x.data_ptr(), mask.data_ptr()]
    outs, packs = [], []     # referenced until the launch is queued
    for w_x, bias, w_h, w_hc, h0 in (fw, bw):
        hs = torch.empty(b, t, d, device=x.device)
        outs.append((hs, torch.empty(b, d, device=x.device)))
        packs += [_pack_columns(w_x, d, u, 3), _pack_columns(w_h, d, u, 2),
                  _pack_columns(w_hc, d, u, 1)]
        args += [packs[-3].data_ptr(), bias.data_ptr(), packs[-2].data_ptr(),
                 packs[-1].data_ptr(), h0.data_ptr(), hs.data_ptr(),
                 outs[-1][1].data_ptr()]
    scratch = torch.empty(2, 3, b, d, device=x.device)   # r*h, u, xw_c
    KERNEL_BI.launch(*args, scratch.data_ptr(), b, t, e, d, u, _stream())
    return tuple(outs)


class _BiGruSeq(torch.autograd.Function):
    """JAX: ``bigru_seq``'s ``custom_vjp`` with remat on.  Residuals: x,
    mask, both directions' weights and h0, and hs; the backward recomputes
    the gates from them."""

    @staticmethod
    def forward(ctx, x, mask, w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b, w_h_b,
                w_hc_b, h0f, h0b):
        fw = (w_x_f, b_f, w_h_f, w_hc_f, h0f)
        bw = (w_x_b, b_b, w_h_b, w_hc_b, h0b)
        run = _bi_fwd_plain if x.device.type == "cpu" else _bi_fwd_kernel
        (hsf, hTf), (hsb, hTb) = run(x, mask, fw, bw)
        ctx.save_for_backward(x, mask, *fw, *bw, hsf, hsb)
        return hsf, hsb, hTf, hTb

    @staticmethod
    def backward(ctx, dhsf, dhsb, dhTf, dhTb):
        saved = ctx.saved_tensors
        x, mask = saved[:2]
        fw, bw, (hsf, hsb) = saved[2:7], saved[7:12], saved[12:]
        bwd = _bwd_plain if x.device.type == "cpu" else _bwd_kernel
        bsz, t, e = x.shape
        x2 = x.reshape(bsz * t, e)
        dx, grads = 0.0, {}
        for key, (w_x, bias, w_h, w_hc, h0), hs, cts, reverse in (
                ("f", fw, hsf, (dhsf, dhTf), False),
                ("b", bw, hsb, (dhsb, dhTb), True)):
            d = w_hc.shape[0]
            dxw, dh0, rh = bwd(_project_xw(x, w_x, bias), None, mask, w_h,
                               w_hc, h0, hs, *(c.contiguous() for c in cts),
                               reverse, True)
            dg = dxw.reshape(-1, 3 * d)
            dx = dx + torch.matmul(dg, w_x.t())
            grads[key] = (torch.matmul(x2.t(), dg), dg.sum(0),
                          *_recurrent_grads(dxw, hs, h0, rh, reverse), dh0)
        f, b = grads["f"], grads["b"]
        return (dx.reshape(bsz, t, e), None, *f[:4], *b[:4], f[4], b[4])


def bigru_seq(x, mask, w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b, w_h_b, w_hc_b,
              h0f, h0b):
    """Fused bidirectional GRU over raw inputs: both recurrences, their
    input projections inside the loop, in one forward; the backward
    recomputes the gates (no gates slab is kept).

    x [B, T, E]; mask [B, T]; per direction w_x [E, 3D], b [3D], w_h
    [D, 2D], w_hc [D, D], h0 [B, D] (the reverse direction iterates
    T-1..0).  Returns (hs_f, hs_b, h_T_f, h_T_b); the BiGRU output is hs_f
    and hs_b concatenated on the feature axis."""
    d = w_hc_f.shape[0]
    enforce(x.dim() == 3 and x.shape[1] >= 1
            and all(tuple(w.shape) == (x.shape[2], 3 * d)
                    for w in (w_x_f, w_x_b))
            and all(tuple(w.shape) == (d, 2 * d) for w in (w_h_f, w_h_b)),
            f"bigru_seq: x must be [B, T>=1, E] with w_x [E, 3D] and w_h "
            f"[D, 2D], got x {tuple(x.shape)}, w_x {tuple(w_x_f.shape)}, w_h "
            f"{tuple(w_h_f.shape)}")
    return _BiGruSeq.apply(
        x.contiguous(), mask.to(x.dtype).contiguous(),
        *(w.contiguous() for w in (w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b,
                                   w_h_b, w_hc_b, h0f, h0b)))


class _GruSeqFi(torch.autograd.Function):
    """JAX: ``gru_seq_fi``'s ``custom_vjp``.  Residuals: x, mask, the
    weights, h0, hs and the u/r/c slab (remat off); with remat on the
    backward recomputes xw with one product (JAX's ``_project_xw``) and
    the gates from it."""

    @staticmethod
    def forward(ctx, x, mask, w_x, b, w_h, w_hc, h0, reverse, remat):
        fwd = _fi_fwd_plain if x.device.type == "cpu" else _fi_fwd_kernel
        hs, urc, h_t = fwd(x, mask, w_x, b, w_h, w_hc, h0, reverse,
                           not remat)
        ctx.save_for_backward(x, urc, mask, w_x, b, w_h, w_hc, h0, hs)
        ctx.cfg = (reverse, remat)
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        x, urc, mask, w_x, b, w_h, w_hc, h0, hs = ctx.saved_tensors
        reverse, remat = ctx.cfg
        bwd = _bwd_plain if x.device.type == "cpu" else _bwd_kernel
        xw = _project_xw(x, w_x, b) if remat else None
        dxw, dh0, rh = bwd(xw, urc, mask, w_h, w_hc, h0, hs,
                           dhs.contiguous(), dh_t.contiguous(), reverse,
                           remat)
        dw_h, dw_hc = _recurrent_grads(dxw, hs, h0, rh, reverse)
        bsz, t, e = x.shape
        dg = dxw.reshape(-1, 3 * w_hc.shape[0])
        return (torch.matmul(dg, w_x.t()).reshape(bsz, t, e), None,
                torch.matmul(x.reshape(bsz * t, e).t(), dg), dg.sum(0), dw_h,
                dw_hc, dh0, None, None)


def gru_seq_fi(x, mask, w_x, b, w_h, w_hc, h0, reverse=False, remat=False):
    """Fused-input GRU over a whole sequence: ``x @ W_x + b`` runs inside
    the recurrence (the cell and mask as :func:`gru_seq`).

    x [B, T, E]; w_x [E, 3D]; b [3D] (zeros for no bias); w_h [D, 2D];
    w_hc [D, D]; h0 [B, D]; remat: keep no u/r/c slab, recompute xw and
    the gates in the backward.  Returns (hs [B, T, D], h_T)."""
    d = w_hc.shape[0]
    enforce(x.dim() == 3 and x.shape[1] >= 1
            and tuple(w_x.shape) == (x.shape[2], 3 * d)
            and tuple(b.shape) == (3 * d,)
            and tuple(w_h.shape) == (d, 2 * d),
            f"gru_seq_fi: x must be [B, T>=1, E] with w_x [E, 3D], b [3D], "
            f"w_h [D, 2D] and w_hc [D, D], got x {tuple(x.shape)}, w_x "
            f"{tuple(w_x.shape)}, b {tuple(b.shape)}, w_h {tuple(w_h.shape)}"
            f", w_hc {tuple(w_hc.shape)}")
    return _GruSeqFi.apply(
        x.contiguous(), mask.to(x.dtype).contiguous(),
        *(w.contiguous() for w in (w_x, b, w_h, w_hc, h0)), bool(reverse),
        bool(remat))


def gru_seq_fi_reference(x, mask, w_x, b, w_h, w_hc, h0, reverse=False):
    """The projection as one product, then :func:`gru_seq_reference`."""
    return gru_seq_reference(_project_xw(x, w_x, b), mask, w_h, w_hc, h0,
                             reverse)


def bigru_seq_reference(x, mask, w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b,
                        w_h_b, w_hc_b, h0f, h0b):
    """Oracle of :func:`bigru_seq`: the two plain directions composed
    (autograd gives the backward); the same return contract."""
    hs_f, h_t_f = gru_seq_fi_reference(x, mask, w_x_f, b_f, w_h_f, w_hc_f,
                                       h0f, False)
    hs_b, h_t_b = gru_seq_fi_reference(x, mask, w_x_b, b_b, w_h_b, w_hc_b,
                                       h0b, True)
    return hs_f, hs_b, h_t_f, h_t_b
