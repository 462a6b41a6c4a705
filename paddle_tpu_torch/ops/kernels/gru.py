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
projects step by step, as the kernel does, in the cell's dtype: with
bf16 operands an f32 product plus an f32 bias, never rounded (JAX
``gru.py:418-420``).  :func:`fi_fits` says, from the device, the dtype
and the shapes alone, whether the kernels take a shape.

:func:`bigru_seq` is a ``torch.autograd.Function`` too.  On the card its
forward is one launch of ``csrc/bigru_seq.cu``, which runs both
directions and computes ``x @ W_x + b`` inside its loop, so the [B, T, 3D]
gate-input slab never reaches device memory.  Its backward recomputes
that slab per direction with one ``torch.matmul`` and launches the
backward kernel above with remat on, the form the JAX package's TPU
branch runs: two launches.  ``dW_x``, ``db``, ``dW_h``, ``dW_hc`` and
``dx`` are products and sums outside, as in the JAX backward.

bf16 weights take the bf16 forms (``gru_fwd_bf16``, ``gru_bwd_bf16``
with remat or stored gates and xw in bf16 or f32, ``gru_fi_fwd_bf16``:
the forward with W_x's slices beside W_h's and W_hc's, ``bigru_fwd_bf16``:
tensor-core products from each block's bf16 weight slices, the cell in
f32), counted apart from the f32 forms; the twins round where the JAX
kernels round with bf16 operands (r h before the candidate product, the
h carry every step, dc and [du, dr] before their transposed products),
so a bf16 CUDA tensor launches a bf16 form or raises, never an f32 one.

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
from paddle_tpu_torch.ops.kernels.lstm import (_acc, _card, _check_typed,
                                               _project_xw, _rounded,
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
KERNEL_FWD_BF16 = Kernel("gru_seq", "gru_fwd_bf16", [_P] * 10 + [_I] * 5 + [_P])
KERNEL_BWD_BF16 = Kernel("gru_seq", "gru_bwd_bf16", [_P] * 19 + [_I] * 7 + [_P])
#: the bf16 entry point in its stored-gates form, counted apart
KERNEL_BWD_STORED_BF16 = Kernel("gru_seq", "gru_bwd_bf16",
                                [_P] * 19 + [_I] * 7 + [_P])
KERNEL_BI_BF16 = Kernel("bigru_seq", "bigru_fwd_bf16",
                        [_P] * 20 + [_I] * 5 + [_P])
KERNEL_FI_BF16 = Kernel("gru_seq", "gru_fi_fwd_bf16",
                        [_P] * 13 + [_I] * 6 + [_P])

#: the kernels' tiling: a block owns U <= 8 hidden units with 64U threads
_MAX_UNITS = 8
#: floats of the kernels' staging area: the larger of three 64 x 36 stages
#: of the A operand and the 4-way k-split sums [4][64][3U + 1]
_STAGE = 3 * 64 * 36
#: the bf16 forms' tiling (csrc/gru_bf16.cuh): a block of 8 warps owns at
#: most 16 units; A streams in 64-row slices 64 deep (rows padded to 72
#: bf16), two stages at least; the halves' f32 sums take 512 floats an
#: n8 tile
_BF_MAX_UNITS = 16
_BF_STAGE_BYTES = 64 * 72 * 2


# -- the plain twins ---------------------------------------------------------


def _gates(x_t, h, w_h, w_hc):
    """One step's gate bundle from the gate input x_t [B, 3D] and the carry
    h [B, D] (in W_h's storage dtype), with w_h, w_hc already in the
    cell's dtype: (u, r, c, r * h).  The cell runs in that dtype (f32 for
    bf16 operands: their products are exact, summed in f32); r * h is
    rounded to the carry's dtype before the candidate product, as the JAX
    kernel rounds it (``gru.py:41``)."""
    d = h.shape[-1]
    hf = h.to(w_h.dtype)
    ur = x_t[:, :2 * d].to(w_h.dtype) + torch.matmul(hf, w_h)
    u = torch.sigmoid(ur[:, :d])
    r = torch.sigmoid(ur[:, d:])
    rh = _rounded(r * hf, h.dtype)
    c = torch.tanh(x_t[:, 2 * d:].to(w_h.dtype) + torch.matmul(rh, w_hc))
    return u, r, c, rh


def _steps(t: int, reverse: bool):
    """Array indices in the order a run visits them."""
    return range(t - 1, -1, -1) if reverse else range(t)


def _fwd_plain(xw, mask, w_h, w_hc, h0, reverse, emit_gates):
    """Plain twin of the forward kernel: (hs [B, T, D], urc [B, T, 3D] or
    None, h_T [B, D])."""
    return _run(lambda k: xw[:, k], xw.shape[1], xw.dtype, mask, w_h, w_hc,
                h0, reverse, emit_gates)


def _fi_fwd_plain(x, mask, w_x, b, w_h, w_hc, h0, reverse, emit_gates):
    """Plain twin of the fused-input forward kernel: each step's gate input
    x_t @ W_x + b inside the loop, as the kernel computes it, with
    :func:`_project_xw`'s numerics (in the cell's dtype and never rounded:
    f32 for bf16 operands, JAX ``gru.py:418-420``); the contract of
    :func:`_fwd_plain`."""
    return _run(lambda k: _project_xw(x[:, k, None], w_x, b)[:, 0],
                x.shape[1], x.dtype, mask, w_h, w_hc, h0, reverse,
                emit_gates)


def _run(step_input, t, io, mask, w_h, w_hc, h0, reverse, emit_gates):
    """The forward recurrence over the gate inputs ``step_input(k)``
    [B, 3D], rounding where the JAX kernel rounds (``gru.py:48-76``,
    ``_fwd_call`` :165): the cell in f32 (the weights' dtype where wider),
    the h carry in W_h's dtype (rounded every step; the freeze keeps the
    rounded carry), hs and the u/r/c slab in ``io``, h_T in the cell's
    dtype (unrounded)."""
    acc = _acc(w_h.dtype)
    w_a, w_c = w_h.to(acc), w_hc.to(acc)
    h = h0.to(w_h.dtype)
    hs, urc = [None] * t, [None] * t
    for k in _steps(t, reverse):
        u, r, c, _ = _gates(step_input(k), h, w_a, w_c)
        hf = h.to(acc)
        m = mask[:, k, None]
        h_new = m * (u * hf + (1.0 - u) * c) + (1.0 - m) * hf
        h = h_new.to(w_h.dtype)
        hs[k] = h_new.to(io)
        if emit_gates:
            urc[k] = torch.cat([u, r, c], dim=-1).to(io)
    return (torch.stack(hs, 1), torch.stack(urc, 1) if emit_gates else None,
            h_new)


def _bwd_plain(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse, remat):
    """Plain twin of the backward kernel: (dxw [B, T, 3D] = [du, dr, dc]
    pre-activation cotangents, dh0 [B, D], rh [B, T, D] = r * h_{t-1}),
    dxw and dh0 in the cell's dtype, rh in W_hc's.  Frozen rows pass dh
    through.  Rounds where the JAX kernels round (``gru.py:79-160``,
    ``_gru_dxw_bwd`` :349): the dh carry in the cell's dtype; u, r, c read
    from the slab or, remat on, recomputed with the forward's own per-step
    products and rounded through hs's dtype, so both forms give the same
    bits; dc and [du, dr] rounded to the weights' dtype before their W_hc^T
    and W_h^T products; rh from the rounded r (``:373``).  xw may be f32
    under bf16 weights (the BiGRU's projection)."""
    t, d = hs.shape[1], w_hc.shape[0]
    acc = _acc(w_h.dtype)
    w_a, w_c = w_h.to(acc), w_hc.to(acc)
    narrow = hs.dtype != acc
    dh = dhT.to(acc)
    dxw, rhs = [None] * t, [None] * t
    boot = t - 1 if reverse else 0      # the first index a run computes
    for k in _steps(t, not reverse):
        kp = k + 1 if reverse else k - 1
        m = mask[:, k, None]
        dh = dh + dhs[:, k].to(acc)
        # contiguous, as the forward's carry was: the same layouts take
        # the same vectorized loops, so the recomputed gates match bits
        h_prev = h0.to(hs.dtype) if k == boot else hs[:, kp].contiguous()
        hpf = h_prev.to(acc)
        if remat:
            u, r, c, _ = _gates(xw[:, k], h_prev.to(w_h.dtype), w_a, w_c)
            if narrow:
                u, r, c = (z.contiguous() for z in torch.cat(
                    [u, r, c], dim=-1).to(hs.dtype).to(acc).split(d, -1))
        else:
            u, r, c = (z.contiguous() for z in urc[:, k].to(acc).split(d, -1))
        du = dh * (hpf - c) * u * (1.0 - u) * m
        dpc = dh * (1.0 - u) * m * (1.0 - c * c)
        drh = torch.matmul(_rounded(dpc, w_hc.dtype), w_c.t())
        dr = drh * hpf * r * (1.0 - r)
        dur = torch.cat([du, dr], dim=-1)
        dxw[k] = torch.cat([dur, dpc], dim=-1)
        rhs[k] = (r * hpf).to(w_hc.dtype)
        dh_prev = (dh * u * m + drh * r
                   + torch.matmul(_rounded(dur, w_h.dtype), w_a.t()))
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


def fi_fits(device, e: int, d: int, dtype=torch.float32) -> bool:
    """Whether :func:`gru_seq_fi`'s kernels of ``dtype`` (f32 or bf16)
    take input width E and hidden width D on the card ``device``: decided
    from the card's SM count and shared-memory opt-in before any
    launch."""
    refusal = {torch.float32: _fi_refusal,
               torch.bfloat16: fi_bf16_refusal}.get(dtype)
    return refusal is not None and refusal(e, d, *_card(device)) is None


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
            "the gru kernels take float32 operands (bf16 weights take the "
            "bf16 forms)")
    enforce(all(x.is_contiguous() for x in tensors),
            "the gru kernels need contiguous operands")
    enforce(len({x.device for x in tensors}) == 1,
            f"operands on several devices: {[x.device for x in tensors]}")


# The bf16 forms' plan (csrc/gru_bf16.cuh).  A block owns U = ceil(D /
# SMs) units (the BiGRU: half the SMs a direction) and keeps its weight
# slices as bf16 rows [8 NT][LDK], the reduction contiguous: the update
# and reset columns of its units as 2U rows (row 2 uu + g), the
# candidate's (or, in the backward, the rows of W_h and W_hc its units
# own) as U rows, each padded with zero rows to whole n8 tiles of the
# tensor-core product, and the reduction with zeros to a multiple of 16,
# then 8 more (an odd count of 16-byte groups: the 8 rows an ldmatrix
# phase reads fall in distinct banks).


def _ldk(k: int) -> int:
    return 16 * -(-k // 16) + 8


def _tiles(cols: int) -> int:
    return -(-cols // 8)


def _bf16_units(d: int, sms: int) -> int:
    return -(-d // sms)


def _bf16_region(stages: int, nt: int) -> int:
    """Bytes of the staging region: the ring of A slices, or the halves'
    f32 sums [4 row tiles][NT][4][32 lanes]."""
    return max(stages * _BF_STAGE_BYTES, 512 * nt * 4)


def _bf16_smem_bytes(d: int, u: int, stages: int) -> int:
    """Shared memory of a block of the GRU forward or backward bf16 form,
    the larger of the two: the column slices (W_h's 2U, W_hc's U; the
    forward and the remat pass) or the row slices (W_h's [U][2D] and
    W_hc's [U][D]; the backward's loop), then the staging region."""
    nta, ntb = _tiles(2 * u), _tiles(u)
    cols = 8 * (nta + ntb) * _ldk(d)
    rows = 8 * ntb * (_ldk(2 * d) + _ldk(d))
    return 2 * max(cols, rows) + _bf16_region(stages, nta)


def bf16_refusal(d: int, sms: int, optin: int) -> str | None:
    """Why the bf16 forms of the GRU forward and backward cannot take
    hidden width D on a card of ``sms`` SMs and ``optin`` bytes of shared
    memory a block (two stages at least); None when they can."""
    if d % 8:
        return (f"gru bf16 kernels: D={d} must be a multiple of 8 "
                "(16-byte copies of bf16)")
    u = _bf16_units(d, sms)
    if u > _BF_MAX_UNITS:
        return (f"gru bf16 kernels: D={d} needs {u} units a block on {sms} "
                f"SMs, more than the {_BF_MAX_UNITS} the tiling covers")
    need = _bf16_smem_bytes(d, u, 2)
    if need > optin:
        return (f"gru bf16 kernels: D={d} needs {need} bytes of shared "
                f"memory a block, more than the {optin} the card allows")
    return None


def bi_bf16_smem_bytes(e: int, d: int, u: int, stages: int) -> int:
    """Shared memory of a block of ``bigru_fwd_bf16``: the column slices of
    W_x (K = E) and of W_h and W_hc (K = D) of its direction's units, then
    the staging region."""
    nta, ntb = _tiles(2 * u), _tiles(u)
    return (2 * 8 * (nta + ntb) * (_ldk(e) + _ldk(d))
            + _bf16_region(stages, nta))


def bi_bf16_refusal(e: int, d: int, sms: int, optin: int) -> str | None:
    """Why ``bigru_fwd_bf16`` (half the SMs a direction), or the bf16
    backward it is paired with (all of them), cannot take input width E
    and hidden width D; None when both can."""
    if e % 8 or d % 8:
        return (f"bigru bf16 kernel: E={e} and D={d} must be multiples of 8 "
                "(16-byte copies of bf16)")
    u = _bf16_units(d, sms // 2)
    if u > _BF_MAX_UNITS:
        return (f"bigru bf16 kernel: D={d} needs {u} units a block on "
                f"{sms // 2} SMs a direction, more than the {_BF_MAX_UNITS} "
                "the tiling covers")
    need = bi_bf16_smem_bytes(e, d, u, 2)
    if need > optin:
        return (f"bigru bf16 kernel: E={e}, D={d} needs {need} bytes of "
                f"shared memory a block, more than the {optin} the card "
                "allows")
    return bf16_refusal(d, sms, optin)


def fi_bf16_refusal(e: int, d: int, sms: int, optin: int) -> str | None:
    """Why ``gru_fi_fwd_bf16`` (a block a U = ceil(D / SMs) units, W_x's
    slices beside W_h's and W_hc's: the BiGRU's block on every SM), or the
    bf16 backward it is paired with, cannot take input width E and hidden
    width D; None when both can."""
    if e % 8 or d % 8:
        return (f"gru_seq_fi bf16: E={e} and D={d} must be multiples of 8 "
                "(16-byte copies of bf16)")
    u = _bf16_units(d, sms)
    if u > _BF_MAX_UNITS:
        return (f"gru_seq_fi bf16: D={d} needs {u} units a block on {sms} "
                f"SMs, more than the {_BF_MAX_UNITS} the tiling covers")
    need = bi_bf16_smem_bytes(e, d, u, 2)
    if need > optin:
        return (f"gru_seq_fi bf16: E={e}, D={d} needs {need} bytes of "
                f"shared memory a block, more than the {optin} the card "
                "allows")
    return bf16_refusal(d, sms, optin)


def _pack_bf16(w, d: int, u: int, n: int):
    """[K, n*D] -> [blocks, 8 ceil(nU / 8), LDK] bf16: block j's row n uu + g
    holds w[:, g*D + j*U + uu] (zero past D, past nU and past K).  Two
    launches at most a pack (the zeros and one strided copy), three where
    D is not a multiple of U: the wrapper's host time shows in a call."""
    k = w.shape[0]
    nb = -(-d // u)
    out = torch.zeros(nb, 8 * _tiles(n * u), _ldk(k), dtype=torch.bfloat16,
                      device=w.device)
    w = w.reshape(k, n, d)
    if nb * u != d:
        w = F.pad(w, (0, nb * u - d))
    out[:, :n * u, :k].view(nb, u, n, k).copy_(
        w.reshape(k, n, nb, u).permute(2, 3, 1, 0))
    return out


def _bf16_plan(device, d: int) -> int:
    """U of the GRU bf16 forms on the card ``device``, or raise why not."""
    sms, optin = _card(device)
    refusal = bf16_refusal(d, sms, optin)
    enforce(refusal is None, refusal or "")
    return _bf16_units(d, sms)


def _check_aligned(name: str, **operands):
    """The operands a bf16 form stages with 16-byte copies start on 16
    bytes."""
    for arg, x in operands.items():
        enforce(x.data_ptr() % 16 == 0,
                f"{name}: {arg} must start on 16 bytes")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _fwd_kernel(xw, mask, w_h, w_hc, h0, reverse, emit_gates):
    """The forward kernel of W_h's dtype (the contract of
    :func:`_fwd_plain`)."""
    if w_h.dtype == torch.bfloat16:
        return _fwd_kernel_bf16(xw, mask, w_h, w_hc, h0, reverse, emit_gates)
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
    KERNEL_FWD.launch_on(
        xw.device.index, xw.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        packs[1].data_ptr(), h0.data_ptr(), hs.data_ptr(), _ptr(urc),
        h_t.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(), b, t, d,
        u, int(reverse))
    return hs, urc, h_t


def _fwd_kernel_bf16(xw, mask, w_h, w_hc, h0, reverse, emit_gates):
    """``gru_fwd_bf16``: xw, W_h, W_hc and h0 (the carry, in W_h's dtype)
    bf16, the mask f32; hs and the u/r/c slab bf16, h_T f32, as the JAX
    kernel writes them."""
    bf, f32 = torch.bfloat16, torch.float32
    h0 = h0.to(bf).contiguous()
    _check_typed("gru_fwd_bf16", xw=(xw, bf), mask=(mask, f32),
                 w_h=(w_h, bf), w_hc=(w_hc, bf), h0=(h0, bf))
    _check_aligned("gru_fwd_bf16", h0=h0)
    b, t, _ = xw.shape
    d = w_hc.shape[0]
    u = _bf16_plan(xw.device, d)
    dev = xw.device
    hs = torch.empty(b, t, d, dtype=bf, device=dev)
    urc = torch.empty_like(xw) if emit_gates else None
    h_t = torch.empty(b, d, dtype=f32, device=dev)
    rh = torch.empty(b, d, dtype=bf, device=dev)       # r * h_{t-1}
    ug = torch.empty(b, d, dtype=f32, device=dev)      # u, from (A) to (B)
    packs = (_pack_bf16(w_h, d, u, 2), _pack_bf16(w_hc, d, u, 1))
    KERNEL_FWD_BF16.launch_on(
        xw.device.index, xw.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        packs[1].data_ptr(), h0.data_ptr(), hs.data_ptr(), _ptr(urc),
        h_t.data_ptr(), rh.data_ptr(), ug.data_ptr(), b, t, d, u, int(reverse))
    return hs, urc, h_t


def _fi_fwd_kernel(x, mask, w_x, b, w_h, w_hc, h0, reverse, emit_gates):
    """The fused-input forward kernel of W_h's dtype (the contract of
    :func:`_fi_fwd_plain`)."""
    if w_h.dtype == torch.bfloat16:
        return _fi_fwd_kernel_bf16(x, mask, w_x, b, w_h, w_hc, h0, reverse,
                                   emit_gates)
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
    KERNEL_FI.launch_on(
        x.device.index, x.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        b.data_ptr(), packs[1].data_ptr(), packs[2].data_ptr(), h0.data_ptr(),
        hs.data_ptr(), _ptr(urc), h_t.data_ptr(), scratch.data_ptr(), bsz, t,
        e, d, u, int(reverse))
    return hs, urc, h_t


def _fi_fwd_kernel_bf16(x, mask, w_x, b, w_h, w_hc, h0, reverse,
                        emit_gates):
    """``gru_fi_fwd_bf16``: x, W_x, W_h, W_hc and h0 (the carry) bf16, the
    bias and the mask f32 (a bf16 bias is read as f32, as JAX's kernel
    reads it); hs and the u/r/c slab bf16, h_T f32, as the JAX kernel
    writes them."""
    bf, f32 = torch.bfloat16, torch.float32
    h0, b = h0.to(bf).contiguous(), b.to(f32).contiguous()
    _check_typed("gru_fi_fwd_bf16", x=(x, bf), mask=(mask, f32),
                 w_x=(w_x, bf), b=(b, f32), w_h=(w_h, bf), w_hc=(w_hc, bf),
                 h0=(h0, bf))
    _check_aligned("gru_fi_fwd_bf16", x=x, h0=h0)
    bsz, t, e = x.shape
    d = w_hc.shape[0]
    sms, optin = _card(x.device)
    refusal = fi_bf16_refusal(e, d, sms, optin)
    enforce(refusal is None, refusal or "")
    u = _bf16_units(d, sms)
    dev = x.device
    hs = torch.empty(bsz, t, d, dtype=bf, device=dev)
    urc = (torch.empty(bsz, t, 3 * d, dtype=bf, device=dev) if emit_gates
           else None)
    h_t = torch.empty(bsz, d, dtype=f32, device=dev)
    rh = torch.empty(bsz, d, dtype=bf, device=dev)     # r * h_{t-1}
    ug = torch.empty(bsz, d, dtype=f32, device=dev)    # u, from (A) to (B)
    # packed temporaries stay referenced until the launch is queued
    packs = (_pack_bf16(w_x[:, :2 * d], d, u, 2),
             _pack_bf16(w_x[:, 2 * d:], d, u, 1), _pack_bf16(w_h, d, u, 2),
             _pack_bf16(w_hc, d, u, 1))
    KERNEL_FI_BF16.launch_on(
        x.device.index, x.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        packs[1].data_ptr(), b.data_ptr(), packs[2].data_ptr(),
        packs[3].data_ptr(), h0.data_ptr(), hs.data_ptr(), _ptr(urc),
        h_t.data_ptr(), rh.data_ptr(), ug.data_ptr(), bsz, t, e, d, u,
        int(reverse))
    return hs, urc, h_t


def _bwd_kernel(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse, remat):
    """The backward kernel of W_h's dtype (the contract of
    :func:`_bwd_plain`)."""
    if w_h.dtype == torch.bfloat16:
        return _bwd_kernel_bf16(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT,
                                reverse, remat)
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
    (KERNEL_BWD if remat else KERNEL_BWD_STORED).launch_on(
        mask.device.index, _ptr(xw if remat else None),
        _ptr(None if remat else urc), mask.data_ptr(),
        *(p.data_ptr() for p in packs), h0.data_ptr(), hs.data_ptr(),
        dhs.data_ptr(), dhT.data_ptr(), dxw.data_ptr(), dh.data_ptr(),
        rh.data_ptr(), _ptr(gates), dpc.data_ptr(), dur.data_ptr(),
        drh.data_ptr(), b, t, d, u, int(reverse), int(remat))
    return dxw, dh, rh


def _bwd_kernel_bf16(xw, urc, mask, w_h, w_hc, h0, hs, dhs, dhT, reverse,
                     remat):
    """``gru_bwd_bf16``: W_h, W_hc, h0, hs, dhs and the u/r/c slab (remat
    off) in bf16; xw (remat on) in bf16 (``grumemory``) or f32 (the
    BiGRU's projection), read as it is; the mask and dh_T in f32.  dxw and
    dh0 come out f32, rh bf16."""
    bf, f32 = torch.bfloat16, torch.float32
    h0 = h0.to(bf).contiguous()
    dhs, dhT = dhs.to(bf).contiguous(), dhT.to(f32).contiguous()
    slab = {"xw": (xw, (bf, f32))} if remat else {"urc": (urc, bf)}
    _check_typed("gru_bwd_bf16", mask=(mask, f32), w_h=(w_h, bf),
                 w_hc=(w_hc, bf), h0=(h0, bf), hs=(hs, bf), dhs=(dhs, bf),
                 dhT=(dhT, f32), **slab)
    _check_aligned("gru_bwd_bf16", h0=h0, hs=hs)
    b, t, d = hs.shape
    u = _bf16_plan(hs.device, d)
    dev = hs.device
    dxw = torch.empty(b, t, 3 * d, dtype=f32, device=dev)
    dh = torch.empty(b, d, dtype=f32, device=dev)
    rh = torch.empty(b, t, d, dtype=bf, device=dev)
    # the remat form's recomputed gate slab and the forward's r * h_{t-1};
    # the step exchange buffers (dc and [du, dr], bf16, two of each by step
    # parity) and the reset product drh, kept between the step's phases
    gates = torch.empty(b, t, 3 * d, dtype=bf, device=dev) if remat else None
    rh_f = torch.empty(b, t, d, dtype=bf, device=dev) if remat else None
    dpc, dur = (torch.empty(2, b, n * d, dtype=bf, device=dev) for n in (1, 2))
    drh = torch.empty(b, d, dtype=f32, device=dev)
    # the column slices (the remat passes) and the row slices, kept
    # referenced until the launch is queued
    cols = ((_pack_bf16(w_h, d, u, 2), _pack_bf16(w_hc, d, u, 1)) if remat
            else (None, None))
    rows = (_pack_bf16(w_h.t(), d, u, 1), _pack_bf16(w_hc.t(), d, u, 1))
    (KERNEL_BWD_BF16 if remat else KERNEL_BWD_STORED_BF16).launch_on(
        mask.device.index, _ptr(xw if remat else None),
        _ptr(None if remat else urc), mask.data_ptr(),
        *(_ptr(p) for p in cols + rows), h0.data_ptr(), hs.data_ptr(),
        dhs.data_ptr(), dhT.data_ptr(), dxw.data_ptr(), dh.data_ptr(),
        rh.data_ptr(), _ptr(gates), _ptr(rh_f), dpc.data_ptr(), dur.data_ptr(),
        drh.data_ptr(), b, t, d, u, int(reverse), int(remat),
        int(remat and xw.dtype == f32))
    return dxw, dh, rh


class _GruSeq(torch.autograd.Function):
    """JAX: ``gru_seq``'s ``custom_vjp``.  Residuals: mask, w_h, w_hc, h0,
    hs and either the u/r/c slab (remat off) or xw (remat on).  The
    gradients come back in their inputs' dtypes (JAX ``gru.py:380-389``):
    dxw from the f32 cotangents, dW_h and dW_hc products of bf16 operands
    with f32 sums, dh0 from the f32 carry."""

    @staticmethod
    def forward(ctx, xw, mask, w_h, w_hc, h0, reverse, remat):
        fwd = _fwd_plain if xw.device.type == "cpu" else _fwd_kernel
        hs, urc, h_t = fwd(xw, mask, w_h, w_hc, h0, reverse, not remat)
        ctx.save_for_backward(xw if remat else None, urc, mask, w_h, w_hc,
                              h0, hs)
        ctx.cfg = (reverse, remat, xw.dtype)
        return hs, h_t

    @staticmethod
    def backward(ctx, dhs, dh_t):
        xw, urc, mask, w_h, w_hc, h0, hs = ctx.saved_tensors
        reverse, remat, xw_dtype = ctx.cfg
        bwd = _bwd_plain if hs.device.type == "cpu" else _bwd_kernel
        dxw, dh0, rh = bwd(xw, urc, mask, w_h, w_hc, h0, hs,
                           dhs.contiguous(), dh_t.contiguous(), reverse,
                           remat)
        dw_h, dw_hc = _recurrent_grads(dxw, hs, h0, rh, reverse, w_h.dtype)
        return (dxw.to(xw_dtype), None, dw_h, dw_hc, dh0.to(h0.dtype), None,
                None)


def _recurrent_grads(dxw, hs, h0, rh, reverse, dtype):
    """dW_h = h_{t-1}^T [du, dr] and dW_hc = (r h_{t-1})^T dc, each one
    product over the [B*T] rows of operands in the weights' ``dtype``
    (bf16 operands: f32 sums, one rounding; JAX ``gru.py:368-376``)."""
    d = hs.shape[-1]
    dg = dxw.reshape(-1, 3 * d).to(dtype)
    h_prev = _shift_prev(hs, h0, reverse).reshape(-1, d).to(dtype)
    return (torch.matmul(h_prev.t(), dg[:, :2 * d]),
            torch.matmul(rh.reshape(-1, d).to(dtype).t(), dg[:, 2 * d:]))


def gru_seq(xw, mask, w_h, w_hc, h0, reverse=False, remat=False):
    """Fused GRU over a whole sequence.

    xw [B, T, 3D] (x @ W_x + bias, gate order [u, r, c]); mask [B, T]
    (1.0 while t < length, rows freeze afterwards); w_h [D, 2D]; w_hc
    [D, D]; h0 [B, D]; reverse: iterate T-1..0; remat: keep no u/r/c slab
    for the backward, recompute the gates there.  Returns (hs [B, T, D],
    h_T): hs in xw's dtype; with bf16 operands the cell runs in f32 and
    h_T is f32 (unrounded), as the JAX kernel gives it."""
    d = w_hc.shape[0]
    enforce(xw.dim() == 3 and xw.shape[1] >= 1 and xw.shape[2] == 3 * d
            and tuple(w_h.shape) == (d, 2 * d),
            f"gru_seq: xw must be [B, T>=1, 3D] with w_h [D, 2D] and w_hc "
            f"[D, D], got xw {tuple(xw.shape)}, w_h {tuple(w_h.shape)}, "
            f"w_hc {tuple(w_hc.shape)}")
    return _GruSeq.apply(xw.contiguous(),
                         mask.to(_acc(w_h.dtype)).contiguous(),
                         w_h.contiguous(), w_hc.contiguous(), h0.contiguous(),
                         bool(reverse), bool(remat))


def gru_seq_reference(xw, mask, w_h, w_hc, h0, reverse=False):
    """Plain scan of the same cell and freeze mask (autograd gives its
    backward).  Returns (hs [B, T, D], h_T)."""
    hs, _, h_t = _fwd_plain(xw, mask.to(_acc(w_h.dtype)), w_h, w_hc, h0,
                            reverse, False)
    return hs, h_t


# -- the fused-input bidirectional entry -------------------------------------


def _bi_fwd_plain(x, mask, fw, bw):
    """Plain twin of the bigru kernel, the unfused composition: per
    direction the projection as one product (in the cell's dtype and never
    rounded: f32 for bf16 operands, the kernel's in-loop projection, JAX
    ``gru.py:578-580``), then the forward recurrence over it with hs in
    x's dtype.  ``fw``/``bw`` = (w_x, b, w_h, w_hc, h0); returns ((hs, h_T)
    forward, the same reverse)."""
    outs = []
    for (w_x, b, w_h, w_hc, h0), reverse in ((fw, False), (bw, True)):
        xw = _project_xw(x, w_x, b)
        hs, _, h_t = _run(lambda k: xw[:, k], x.shape[1], x.dtype, mask, w_h,
                          w_hc, h0, reverse, False)
        outs.append((hs, h_t))
    return tuple(outs)


def _bi_fwd_kernel(x, mask, fw, bw):
    """The bigru kernel of W_h's dtype (the contract of
    :func:`_bi_fwd_plain`)."""
    if fw[2].dtype == torch.bfloat16:
        return _bi_fwd_kernel_bf16(x, mask, fw, bw)
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
    KERNEL_BI.launch_on(
        scratch.device.index, *args, scratch.data_ptr(), b, t, e, d, u)
    return tuple(outs)


def _bi_fwd_kernel_bf16(x, mask, fw, bw):
    """``bigru_fwd_bf16``: x, W_x, W_h, W_hc and h0 in bf16, the biases and
    the mask in f32; hs bf16, h_T f32."""
    bf, f32 = torch.bfloat16, torch.float32
    b, t, e = x.shape
    d = fw[3].shape[0]
    sms, optin = _card(x.device)
    refusal = bi_bf16_refusal(e, d, sms, optin)
    enforce(refusal is None, refusal or "")
    u = _bf16_units(d, sms // 2)
    args, outs, keep = [x.data_ptr(), mask.data_ptr()], [], []
    for w_x, bias, w_h, w_hc, h0 in (fw, bw):
        h0 = h0.to(bf).contiguous()
        _check_typed("bigru_fwd_bf16", x=(x, bf), mask=(mask, f32),
                     w_x=(w_x, bf), b=(bias, f32), w_h=(w_h, bf),
                     w_hc=(w_hc, bf), h0=(h0, bf))
        _check_aligned("bigru_fwd_bf16", x=x, h0=h0)
        # packed temporaries stay referenced until the launch is queued
        packed = (_pack_bf16(w_x[:, :2 * d], d, u, 2),
                  _pack_bf16(w_x[:, 2 * d:], d, u, 1), bias,
                  _pack_bf16(w_h, d, u, 2), _pack_bf16(w_hc, d, u, 1), h0)
        keep.append(packed)
        out = (torch.empty(b, t, d, dtype=bf, device=x.device),
               torch.empty(b, d, dtype=f32, device=x.device))
        outs.append(out)
        args += [p.data_ptr() for p in packed] + [o.data_ptr() for o in out]
    rh = torch.empty(2, b, d, dtype=bf, device=x.device)   # r * h_{t-1}
    ug = torch.empty(2, b, d, dtype=f32, device=x.device)  # u, (A) to (B)
    KERNEL_BI_BF16.launch_on(
        rh.device.index, *args, rh.data_ptr(), ug.data_ptr(), b, t, e, d, u)
    return tuple(outs)


class _BiGruSeq(torch.autograd.Function):
    """JAX: ``bigru_seq``'s ``custom_vjp`` with remat on.  Residuals: x,
    mask, both directions' weights and h0, and hs; the backward recomputes
    the gates from them over the projection, unrounded (JAX's
    ``_project_xw``: f32 for bf16 operands).  dW_x is a product of bf16
    operands with f32 sums, db the f32 sum of dxw, dx the two directions'
    f32 products of dxw rounded to W_x's dtype, summed, then rounded once
    (``gru.py:698-728``)."""

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
            dg_w = dg.to(w_x.dtype)
            dx = dx + torch.matmul(dg_w.to(dg.dtype), w_x.to(dg.dtype).t())
            grads[key] = (torch.matmul(x2.t(), dg_w), dg.sum(0).to(bias.dtype),
                          *_recurrent_grads(dxw, hs, h0, rh, reverse,
                                            w_h.dtype), dh0.to(h0.dtype))
        f, b = grads["f"], grads["b"]
        return (dx.reshape(bsz, t, e).to(x.dtype), None, *f[:4], *b[:4], f[4],
                b[4])


def bigru_seq(x, mask, w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b, w_h_b, w_hc_b,
              h0f, h0b):
    """Fused bidirectional GRU over raw inputs: both recurrences, their
    input projections inside the loop, in one forward; the backward
    recomputes the gates (no gates slab is kept).

    x [B, T, E]; mask [B, T]; per direction w_x [E, 3D], b [3D], w_h
    [D, 2D], w_hc [D, D], h0 [B, D] (the reverse direction iterates
    T-1..0).  With bf16 operands the projection stays f32 (pass b in f32,
    as the JAX entry does), the cell runs in f32, hs is bf16 and h_T f32.
    Returns (hs_f, hs_b, h_T_f, h_T_b); the BiGRU output is hs_f and hs_b
    concatenated on the feature axis."""
    d = w_hc_f.shape[0]
    enforce(x.dim() == 3 and x.shape[1] >= 1
            and all(tuple(w.shape) == (x.shape[2], 3 * d)
                    for w in (w_x_f, w_x_b))
            and all(tuple(w.shape) == (d, 2 * d) for w in (w_h_f, w_h_b)),
            f"bigru_seq: x must be [B, T>=1, E] with w_x [E, 3D] and w_h "
            f"[D, 2D], got x {tuple(x.shape)}, w_x {tuple(w_x_f.shape)}, w_h "
            f"{tuple(w_h_f.shape)}")
    return _BiGruSeq.apply(
        x.contiguous(), mask.to(_acc(w_h_f.dtype)).contiguous(),
        *(w.contiguous() for w in (w_x_f, b_f, w_h_f, w_hc_f, w_x_b, b_b,
                                   w_h_b, w_hc_b, h0f, h0b)))


class _GruSeqFi(torch.autograd.Function):
    """JAX: ``gru_seq_fi``'s ``custom_vjp``.  Residuals: x, mask, the
    weights, h0, hs and the u/r/c slab (remat off); with remat on the
    backward recomputes xw with one product (JAX's ``_project_xw``: f32
    for bf16 operands) and the gates from it.  The gradients come back in
    their inputs' dtypes (JAX ``gru.py:525-539``): dW_x a product of bf16
    operands with f32 sums, db the f32 sum of dxw, dx the f32 product of
    dxw rounded to W_x's dtype, rounded once."""

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
        dw_h, dw_hc = _recurrent_grads(dxw, hs, h0, rh, reverse,
                                       w_h.dtype)
        bsz, t, e = x.shape
        dg = dxw.reshape(-1, 3 * w_hc.shape[0])
        dg_w = dg.to(w_x.dtype)
        dx = torch.matmul(dg_w.to(dg.dtype), w_x.to(dg.dtype).t())
        return (dx.reshape(bsz, t, e).to(x.dtype), None,
                torch.matmul(x.reshape(bsz * t, e).to(w_x.dtype).t(), dg_w),
                dg.sum(0).to(b.dtype), dw_h, dw_hc, dh0.to(h0.dtype), None,
                None)


def gru_seq_fi(x, mask, w_x, b, w_h, w_hc, h0, reverse=False, remat=False):
    """Fused-input GRU over a whole sequence: ``x @ W_x + b`` runs inside
    the recurrence (the cell and mask as :func:`gru_seq`).

    x [B, T, E]; w_x [E, 3D]; b [3D] (zeros for no bias); w_h [D, 2D];
    w_hc [D, D]; h0 [B, D]; remat: keep no u/r/c slab, recompute xw and
    the gates in the backward.  Returns (hs [B, T, D], h_T): hs in x's
    dtype; with bf16 operands the projection stays f32 (the bias read as
    f32), the cell runs in f32 and h_T is f32, as the JAX kernel gives
    it."""
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
        x.contiguous(), mask.to(_acc(w_h.dtype)).contiguous(),
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
