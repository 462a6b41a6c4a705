"""Fused LSTM sequence kernels (the port of ``paddle_tpu/ops/pallas/lstm.py``'s
``lstm_seq``: forward, stored-gates backward and remat backward;
``lstm_seq_fi``: the forward with the input projection inside the loop;
and ``bilstm_seq``: both directions of a fused-input BiLSTM in one forward).

:func:`lstm_seq` is a ``torch.autograd.Function``.  On the card its forward
is one cooperative launch of ``csrc/lstm_seq.cu``'s forward kernel over
every time step, and its backward one launch of the backward kernel
(remat on: the gates are recomputed from xw and the shifted h/c stacks;
off: read from the slab the forward stored; the two give the same bits,
and each form has its own launch count: ``KERNEL_BWD`` and
``KERNEL_BWD_STORED``, in bf16 ``KERNEL_BWD_BF16`` and
``KERNEL_BWD_STORED_BF16``).
``dW_h`` is one large ``torch.matmul`` over the [B*T] rows outside the
kernel, as the JAX package leaves it to XLA.  In f32 the forward's
recurrent product and the remat backward's (one routine, so both give the
same gates) run on the tensor cores as 3xTF32.  CPU tensors take the plain
twins (:func:`_fwd_plain`, :func:`_bwd_plain`), which compute each step as
the kernels do (in f32 FMAs), so the two backward forms give the same
bits there too.

:func:`lstm_seq_fi` is a ``torch.autograd.Function`` over raw inputs.  On
the card its forward is one launch of the forward kernel in its
fused-input form: each block keeps its W_x columns beside its W_h slice
and computes ``b + x_t @ W_x`` inside the loop, so the [B, T, 4D]
gate-input slab never reaches device memory (the gates slab is written
when remat is off).  Its backward recomputes xw with one ``torch.matmul``
(remat on) and launches the backward kernel above; ``dW_x``, ``db`` and
``dx`` are products outside.  Its CPU twin (:func:`_fi_fwd_plain`)
projects step by step, as the kernel does, in the cell's dtype: with
bf16 operands the projection ``b + x_t @ W_x`` is an f32 product plus
an f32 bias, never rounded (JAX ``lstm.py:633-635``).  bf16 operands take
the bf16 form ``lstm_fi_fwd_bf16`` (W_x's and W_h's slices in bf16, the
tensor-core products of the bf16 forward) and the bf16 remat backward
over the f32 projection, counted apart from the f32 forms.
:func:`fi_fits` says, from the device, the dtype and the shapes alone,
whether the kernels take a shape.

:func:`bilstm_seq` is a ``torch.autograd.Function`` too.  On the card its
forward is one launch of ``csrc/bilstm_seq.cu``, which runs both
directions and computes ``x @ W_x + b`` inside its loop, step by step, so
the [B, T, 4D] gate-input slab never reaches device memory.  Its backward
recomputes that slab per direction with one ``torch.matmul`` (the JAX
package's ``_project_xw``) and launches the backward kernel above with
remat on, the form the JAX package's TPU branch runs: two launches.
``dW_x``, ``db``, ``dW_h`` and ``dx`` are products and sums outside, as in
the JAX backward.

:func:`lstm_seq_reference` is the plain scan (autograd gives its
backward): the oracle of the whole Function; :func:`bilstm_seq_reference`
composes it per direction over the projected input."""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.ops.kernels._build import Kernel

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL_FWD = Kernel("lstm_seq", "lstm_fwd_f32", [_P] * 11 + [_I] * 5 + [_P])
KERNEL_BWD = Kernel("lstm_seq", "lstm_bwd_f32", [_P] * 17 + [_I] * 6 + [_P])
#: the same entry point in its stored-gates form, counted apart
KERNEL_BWD_STORED = Kernel("lstm_seq", "lstm_bwd_f32",
                           [_P] * 17 + [_I] * 6 + [_P])
KERNEL_BI = Kernel("bilstm_seq", "bilstm_fwd_f32", [_P] * 22 + [_I] * 7 + [_P])
KERNEL_FI = Kernel("lstm_seq", "lstm_fi_fwd_f32", [_P] * 13 + [_I] * 6 + [_P])
KERNEL_FWD_BF16 = Kernel("lstm_seq", "lstm_fwd_bf16",
                         [_P] * 11 + [_I] * 5 + [_P])
KERNEL_BWD_BF16 = Kernel("lstm_seq", "lstm_bwd_bf16",
                         [_P] * 20 + [_I] * 7 + [_P])
#: the bf16 entry point in its stored-gates form, counted apart
KERNEL_BWD_STORED_BF16 = Kernel("lstm_seq", "lstm_bwd_bf16",
                                [_P] * 20 + [_I] * 7 + [_P])
KERNEL_BI_BF16 = Kernel("bilstm_seq", "bilstm_fwd_bf16",
                        [_P] * 22 + [_I] * 4 + [_P])
KERNEL_FI_BF16 = Kernel("lstm_seq", "lstm_fi_fwd_bf16",
                        [_P] * 13 + [_I] * 6 + [_P])

#: the kernels' tiling: a block owns U <= 16 hidden units with 32U threads
#: (the f32 forward more where its product's walk wants them)
_MAX_UNITS = 16
#: the f32 bilstm kernel's plan (``bi_plan``): 256 threads a CTA, clusters
#: of at most 8 (the portable size), row tiles of 4 or 8, a product's
#: reduction in at most 16 shares
_BI_THREADS, _BI_MAX_CLUSTER, _BI_ROW_TILES = 256, 8, (4, 8)
_BI_MAX_SPLITS = 16
#: csrc/lstm_seq.cu's staging: 64-row chunks of 32-deep stages (rows
#: padded to 36 floats), 16 row groups a half-block
_ROWS, _RG, _STAGE = 64, 16, 64 * 36
#: the bf16 forms' tiling (``PlanFwdBf16``, ``PlanBwdBf16`` and
#: ``SplitBf16`` of csrc/lstm_seq.cu): 64-row chunks of h staged 128 deep in
#: the forward, 64 in the remat backward (rows padded by 8 bf16), at least
#: two stages; the backward's dh product over chunks of 32 k of the rounded
#: dgates, split among groups of at most 8 blocks; bilstm_seq.cu's bf16
#: form: a block owns one direction and 16 batch rows, 8 warps of at most
#: 4 n8 tiles (D <= 64)
_BF_KC_FWD, _BF_KC_BWD = 128, 64
_BF_CHUNK_K, _BF_GROUP_K = 32, 8
_BI_BF_ROWS, _BI_BF_MAX_D = 16, 64


# -- the plain twins -----------------------------------------------------------


def _acc(dtype) -> torch.dtype:
    """The dtype the cell computes in: float32 for bf16 or f32 operands
    (the JAX kernels' f32 gate math), float64 for a float64 witness."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _rounded(x, dtype):
    """``x`` rounded to ``dtype`` and back where the two differ (the bf16
    operand of a product), else ``x`` itself."""
    return x.to(dtype).to(x.dtype) if dtype != x.dtype else x


def _cell(x_t, h, c, w_a, peep):
    """One step's gate bundle: pre = x_t + h @ w_h in the cell's dtype (bf16
    operands give exact products summed in f32), gate order [i, f, g, o],
    peepholes i/f on c_{t-1}, o on c_t.  ``w_a`` and ``peep`` are already in
    the cell's dtype; ``h`` is the carry in W_h's dtype.  Returns (i, f, g,
    o, c, h)."""
    d = h.shape[-1]
    pre = x_t.to(w_a.dtype) + torch.matmul(h.to(w_a.dtype), w_a)
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
    return _run(lambda k: xw[:, k], xw.shape[1], xw.dtype, mask, w_h, peep,
                h0, c0, reverse, emit_gates)


def _fi_fwd_plain(x, mask, w_x, b, w_h, peep, h0, c0, reverse, emit_gates):
    """Plain twin of the fused-input forward kernel: each step's gate input
    x_t @ W_x + b inside the loop, as the kernel computes it, with
    :func:`_project_xw`'s numerics (in the cell's dtype and never rounded:
    f32 for bf16 operands, JAX ``lstm.py:633-635``); the contract of
    :func:`_fwd_plain`."""
    return _run(lambda k: _project_xw(x[:, k, None], w_x, b)[:, 0],
                x.shape[1], x.dtype, mask, w_h, peep, h0, c0, reverse,
                emit_gates)


def _run(step_input, t, io, mask, w_h, peep, h0, c0, reverse, emit_gates):
    """The forward recurrence over the gate inputs ``step_input(k)``
    [B, 4D], rounding where the JAX kernels round (``lstm.py:94-132``,
    ``_fwd_call`` :212): the cell in f32 (the input dtype where wider),
    the h carry in W_h's dtype (rounded every step, and the freeze keeps
    the rounded carry), hs and the gates in ``io``, cs and the final
    (h_T, c_T) in the cell's dtype, h_T unrounded."""
    acc = _acc(w_h.dtype)
    w_a, peep = w_h.to(acc), peep.to(acc)
    h, c = h0.to(w_h.dtype), c0.to(acc)
    hs, cs, gates = [None] * t, [None] * t, [None] * t
    for k in _steps(t, reverse):
        i, f, g, o, c_new, h_new = _cell(step_input(k), h, c, w_a, peep)
        m = mask[:, k, None]
        h_new = m * h_new + (1.0 - m) * h.to(acc)
        c = m * c_new + (1.0 - m) * c
        h = h_new.to(w_h.dtype)
        hs[k], cs[k] = h_new.to(io), c
        if emit_gates:
            gates[k] = torch.cat([i, f, g, o], dim=-1).to(io)
    return (torch.stack(hs, 1), torch.stack(cs, 1),
            torch.stack(gates, 1) if emit_gates else None, h_new, c)


def _bwd_plain(xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
               reverse, remat):
    """Plain twin of the backward kernel: (dgates [B, T, 4D], dh0, dc0,
    dpeep [3, D]), all in the cell's dtype (f32 for bf16 operands).  Remat
    recomputes each step's gates with the forward's own per-step product
    and rounds them through hs's dtype (JAX ``lstm.py:392``), so both
    forms give the same bits; dh_{t-1} takes dgates rounded to W_h's
    dtype (``:196``, ``:410``).  xw may be f32 under bf16 weights (the
    BiLSTM's projection)."""
    t, d = hs.shape[1], w_h.shape[0]
    acc = _acc(w_h.dtype)
    w_a, peep = w_h.to(acc), peep.to(acc)
    narrow = hs.dtype != acc
    dh, dc = dhT.to(acc), dcT.to(acc)
    dpeep = torch.zeros_like(peep)
    dgates = [None] * t
    boot = t - 1 if reverse else 0      # the first index a run computes
    for k in _steps(t, not reverse):
        kp = k + 1 if reverse else k - 1
        m = mask[:, k, None]
        dh = dh + dhs[:, k].to(acc)
        # contiguous, as the forward's carries were: the same layouts take
        # the same vectorized loops, so the recomputed gates match bits
        c_prev = c0.to(acc) if k == boot else cs[:, kp].contiguous()
        if remat:
            h_prev = h0.to(hs.dtype) if k == boot else hs[:, kp].contiguous()
            i, f, g, o = _cell(xw[:, k], h_prev.to(w_h.dtype), c_prev, w_a,
                               peep)[:4]
            if narrow:
                i, f, g, o = (z.contiguous() for z in torch.cat(
                    [i, f, g, o], dim=-1).to(hs.dtype).to(acc).split(d, -1))
        elif narrow:
            i, f, g, o = (z.to(acc).contiguous()
                          for z in gates[:, k].split(d, dim=-1))
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
        dh = (torch.matmul(_rounded(dgates[k], w_h.dtype), w_a.t())
              + (1.0 - m) * dh)
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


def _card(device) -> tuple[int, int]:
    """(SMs, shared-memory bytes a block may opt in to) of the card."""
    props = torch.cuda.get_device_properties(device)
    return (props.multi_processor_count,
            getattr(props, "shared_memory_per_block_optin", 232448))


def _smem_floats(k: int, u: int, stages: int) -> int:
    """Shared memory of a block in floats, ``Plan`` of csrc/lstm_seq.cu:
    k rows of [U][4] weight slices, then the staging area (``stages``
    chunks of A, or the halves' sums, or the backward's tiles)."""
    ld = 4 * u + 4
    return k * 4 * u + max(stages * _STAGE, 2 * _ROWS * ld,
                           _ROWS * ld + 6 * _RG * u)


def tiling_refusal(name: str, max_units: int, smem_floats, e: int, d: int,
                   sms: int, optin: int) -> str | None:
    """Why the fused-input forward ``name``, or the backward it is paired
    with, cannot take E, D on a card of ``sms`` SMs and ``optin`` bytes of
    shared memory a block; None when both can.  A block owns U =
    ceil(D / SMs) <= ``max_units`` units and keeps ``smem_floats(E, D, U)``
    floats (the backward: fewer)."""
    if d % 4 or e % 4:
        return (f"{name}: E={e} and D={d} must each be a multiple of 4 "
                "(16-byte copies)")
    u = -(-d // sms)
    if u > max_units:
        return (f"{name}: D={d} needs {u} units a block on {sms} SMs, "
                f"more than the {max_units} the tiling covers")
    need = 4 * smem_floats(e, d, u)
    if need > optin:
        return (f"{name}: E={e}, D={d} needs {need} bytes of shared "
                f"memory a block, more than the {optin} the card allows")
    return None


def _fi_smem_floats(e: int, d: int, u: int) -> int:
    """The fused-input forward's block: (E + D) 4U weight floats and at
    least two staging chunks."""
    return _smem_floats(e + d, u, 2)


#: (E, D, SMs, opt-in bytes) -> why :func:`lstm_seq_fi` refuses, or None
_fi_refusal = functools.partial(tiling_refusal, "lstm_seq_fi", _MAX_UNITS,
                                _fi_smem_floats)


def fi_fits(device, e: int, d: int, dtype=torch.float32) -> bool:
    """Whether :func:`lstm_seq_fi`'s kernels of ``dtype`` (f32 or bf16)
    take input width E and hidden width D on the card ``device``: decided
    from the card's SM count and shared-memory opt-in before any
    launch."""
    refusal = {torch.float32: _fi_refusal,
               torch.bfloat16: fi_bf16_refusal}.get(dtype)
    return refusal is not None and refusal(e, d, *_card(device)) is None


def _pack_columns(w, u: int):
    """[K, 4D] -> [blocks, K, U, 4]: block j's entry [k, uu, g] is
    w[k, g*D + j*U + uu] (zero past D), the slice it keeps in shared
    memory, the four gates of a unit side by side (W_h: K = D; W_x:
    K = E)."""
    k, d = w.shape[0], w.shape[1] // 4
    nb = -(-d // u)
    w = F.pad(w.reshape(k, 4, d), (0, nb * u - d))
    return w.reshape(k, 4, nb, u).permute(2, 0, 3, 1).contiguous()


# The bf16 forms' plan (``PlanFwdBf16`` / ``PlanBwdBf16`` of
# csrc/lstm_seq.cu): a block owns an even number U of units, so its 4U gate
# columns are whole n8 tiles of the tensor-core product (2 units a tile),
# and keeps W_h's slice as [4U][LDK] bf16: row 4 uu + g (gate g of unit
# uu), D columns (zero past D up to a multiple of 16, then 8 more: an odd
# count of 16-byte groups, so the 8 rows an ldmatrix phase reads fall in
# distinct banks).  The backward's blocks also build a part of W_h each for
# the dh product (``_bf16_split``), in shared memory where it fits.


def _bf16_units(d: int, sms: int) -> int:
    """Units a block owns in the bf16 forms: ceil(D / SMs) made even."""
    u = -(-d // sms)
    return u + u % 2


def _bf16_ldk(d: int) -> int:
    return 16 * -(-d // 16) + 8


def _bf16_stage_bytes(kc: int) -> int:
    return _ROWS * (kc + 8) * 2


def _bf16_split(d: int, u: int, blocks: int) -> tuple[int, int, int, int]:
    """``SplitBf16``: (P, MP, KR, LDP): the blocks in groups of P (the
    largest divisor of the grid up to 8), block kk of a group taking the
    rounded dgates' chunks [kk nch / P, (kk + 1) nch / P) of nch = 4D / 32
    for the group's MP = P U units; its part of W_h [MP][LDP] bf16, KR its
    most k, LDP = KR rounded up to 64, + 32."""
    p = next((q for q in range(_BF_GROUP_K, 1, -1) if blocks % q == 0), 1)
    kr = _BF_CHUNK_K * -(-(4 * d // _BF_CHUNK_K) // p)
    return p, p * u, kr, 64 * -(-kr // 64) + 32


def _bf16_fwd_bytes(d: int, u: int, stages: int, e: int = 0) -> int:
    """``PlanFwdBf16``: W_x's slice [4U][LDK(E)] (the fused-input form) and
    W_h's [4U][LDK(D)], then the ring of h slices or the halves' f32 sums."""
    return (4 * u * (_bf16_ldk(e) if e else 0) * 2 + 4 * u * _bf16_ldk(d) * 2
            + max(stages * _bf16_stage_bytes(_BF_KC_FWD), _ROWS * 4 * u * 4))


def _bf16_bwd_bytes(d: int, u: int, stages: int, remat: bool,
                    part: bool) -> int:
    """``PlanBwdBf16``: W_h's column slice (remat), the region (the remat
    ring, or the halves' f32 sums and the dpeep terms), then the block's
    part of W_h for the dh product where ``part``."""
    _, mp, _, ldp = _bf16_split(d, u, -(-d // u))
    return ((4 * u * _bf16_ldk(d) * 2 if remat else 0)
            + max(stages * _bf16_stage_bytes(_BF_KC_BWD) if remat else 0,
                  _ROWS * 4 * u * 4 + 3 * _ROWS * u * 4)
            + (mp * ldp * 2 if part else 0))


def _bf16_smem_bytes(d: int, u: int, stages: int) -> int:
    """The least shared memory a block of the bf16 forward or of the remat
    backward takes at ``stages`` (the backward's part of W_h read where it
    lies)."""
    return max(_bf16_fwd_bytes(d, u, stages),
               _bf16_bwd_bytes(d, u, stages, True, False))


def bf16_refusal(d: int, sms: int, optin: int) -> str | None:
    """Why the bf16 forms of the LSTM forward and backward cannot take
    hidden width D on a card of ``sms`` SMs and ``optin`` bytes of shared
    memory a block (two stages at least); None when they can."""
    if d % 8:
        return (f"lstm bf16 kernels: D={d} must be a multiple of 8 "
                "(16-byte copies of bf16)")
    u = _bf16_units(d, sms)
    if u > _MAX_UNITS:
        return (f"lstm bf16 kernels: D={d} needs {u} units a block on "
                f"{sms} SMs, more than the {_MAX_UNITS} the tiling covers")
    need = _bf16_smem_bytes(d, u, 2)
    if need > optin:
        return (f"lstm bf16 kernels: D={d} needs {need} bytes of shared "
                f"memory a block, more than the {optin} the card allows")
    return None


def _pack_rows_bf16(w, u: int):
    """W [K, 4D] (W_h: K = D; W_x: K = E) -> [blocks, 4U, LDK(K)]: block
    j's row 4 uu + g holds w[:, g*D + j*U + uu] (zero past D and past K's
    columns)."""
    k, d = w.shape[0], w.shape[1] // 4
    nb = -(-d // u)
    w = F.pad(w.reshape(k, 4, d), (0, nb * u - d))
    w = w.reshape(k, 4, nb, u).permute(2, 3, 1, 0).reshape(nb, 4 * u, k)
    return F.pad(w, (0, _bf16_ldk(k) - k)).contiguous()


def fi_bf16_smem_bytes(e: int, d: int, u: int) -> int:
    """Shared memory of a block of ``lstm_fi_fwd_bf16`` (``PlanFwdBf16``
    with E) at two stages."""
    return _bf16_fwd_bytes(d, u, 2, e)


def fi_bf16_refusal(e: int, d: int, sms: int, optin: int) -> str | None:
    """Why ``lstm_fi_fwd_bf16``, or the bf16 backward it is paired with,
    cannot take input width E and hidden width D on a card of ``sms`` SMs
    and ``optin`` bytes of shared memory a block; None when both can."""
    if e % 8 or d % 8:
        return (f"lstm_seq_fi bf16: E={e} and D={d} must each be a multiple "
                "of 8 (16-byte copies of bf16)")
    u = _bf16_units(d, sms)
    if u > _MAX_UNITS:
        return (f"lstm_seq_fi bf16: D={d} needs {u} units a block on {sms} "
                f"SMs, more than the {_MAX_UNITS} the tiling covers")
    need = fi_bf16_smem_bytes(e, d, u)
    if need > optin:
        return (f"lstm_seq_fi bf16: E={e}, D={d} needs {need} bytes of "
                f"shared memory a block, more than the {optin} the card "
                "allows")
    return bf16_refusal(d, sms, optin)


def _check_kernel_args(*tensors):
    dev = tensors[0].device
    if all(x.dtype == torch.float32 and x.is_contiguous() and x.device == dev
           for x in tensors):
        return      # the common case in one pass; else say what is wrong
    enforce(all(x.dtype == torch.float32 for x in tensors),
            "the lstm kernels take float32 operands")
    enforce(all(x.is_contiguous() for x in tensors),
            "the lstm kernels need contiguous operands")
    enforce(len({x.device for x in tensors}) == 1,
            f"operands on several devices: {[x.device for x in tensors]}")


def _check_typed(name: str, **operands):
    """Each operand (tensor, dtype or tuple of dtypes) contiguous, on one
    device and of the dtype the bf16 kernel ``name`` reads it as."""
    for arg, (x, want) in operands.items():
        want = want if isinstance(want, tuple) else (want,)
        enforce(x.dtype in want, f"{name}: {arg} must be "
                f"{' or '.join(map(str, want))}, got {x.dtype}")
    tensors = [x for x, _ in operands.values()]
    enforce(all(x.is_contiguous() for x in tensors),
            f"{name} needs contiguous operands")
    enforce(len({x.device for x in tensors}) == 1,
            f"operands on several devices: {[x.device for x in tensors]}")


def _ptr(x):
    return 0 if x is None else x.data_ptr()


def _bf16_plan(device, d: int) -> int:
    """U of the bf16 forms on the card ``device``, or raise why not."""
    sms, optin = _card(device)
    refusal = bf16_refusal(d, sms, optin)
    enforce(refusal is None, refusal or "")
    return _bf16_units(d, sms)


def _fwd_kernel(xw, mask, w_h, peep, h0, c0, reverse, emit_gates):
    """The forward kernel of W_h's dtype (the contract of
    :func:`_fwd_plain`): f32, or bf16 (hs and the gates slab in bf16, cs,
    h_T and c_T in f32, as the JAX kernel writes them)."""
    if w_h.dtype == torch.bfloat16:
        return _fwd_kernel_bf16(xw, mask, w_h, peep, h0, c0, reverse,
                                emit_gates)
    _check_kernel_args(xw, mask, w_h, peep, h0, c0)
    b, t, _ = xw.shape
    d = w_h.shape[0]
    u = _units(xw.device, d)
    wpack = _pack_columns(w_h, u)
    hs = torch.empty(b, t, d, device=xw.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xw) if emit_gates else None
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    KERNEL_FWD.launch_on(
        xw.device.index, xw.data_ptr(), mask.data_ptr(), wpack.data_ptr(),
        peep.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), _ptr(gates), h_t.data_ptr(), c_t.data_ptr(), b, t, d, u,
        int(reverse))
    return hs, cs, gates, h_t, c_t


def _fwd_kernel_bf16(xw, mask, w_h, peep, h0, c0, reverse, emit_gates):
    """``lstm_fwd_bf16``: xw, W_h, the peepholes and h0 in bf16 (h0 is
    the carry, in W_h's dtype), the mask and c0 in f32."""
    bf, f32 = torch.bfloat16, torch.float32
    h0, c0 = h0.to(bf).contiguous(), c0.to(f32).contiguous()
    _check_typed("lstm_fwd_bf16", xw=(xw, bf), mask=(mask, f32),
                 w_h=(w_h, bf), peep=(peep, bf), h0=(h0, bf), c0=(c0, f32))
    b, t, _ = xw.shape
    d = w_h.shape[0]
    u = _bf16_plan(xw.device, d)
    wpack = _pack_rows_bf16(w_h, u)
    hs = torch.empty(b, t, d, dtype=bf, device=xw.device)
    cs = torch.empty(b, t, d, dtype=f32, device=xw.device)
    gates = torch.empty_like(xw) if emit_gates else None
    h_t = torch.empty(b, d, dtype=f32, device=xw.device)
    c_t = torch.empty_like(h_t)
    KERNEL_FWD_BF16.launch_on(
        xw.device.index, xw.data_ptr(), mask.data_ptr(), wpack.data_ptr(),
        peep.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), _ptr(gates), h_t.data_ptr(), c_t.data_ptr(), b, t, d, u,
        int(reverse))
    return hs, cs, gates, h_t, c_t


def _fi_fwd_kernel(x, mask, w_x, b, w_h, peep, h0, c0, reverse, emit_gates):
    """The fused-input forward kernel of W_h's dtype (the contract of
    :func:`_fi_fwd_plain`)."""
    if w_h.dtype == torch.bfloat16:
        return _fi_fwd_kernel_bf16(x, mask, w_x, b, w_h, peep, h0, c0,
                                   reverse, emit_gates)
    _check_kernel_args(x, mask, w_x, b, w_h, peep, h0, c0)
    bsz, t, e = x.shape
    d = w_h.shape[0]
    sms, optin = _card(x.device)
    refusal = _fi_refusal(e, d, sms, optin)
    enforce(refusal is None, refusal or "")
    u = -(-d // sms)
    packs = (_pack_columns(w_x, u), _pack_columns(w_h, u))  # kept to launch
    hs = torch.empty(bsz, t, d, device=x.device)
    cs = torch.empty_like(hs)
    gates = (torch.empty(bsz, t, 4 * d, device=x.device) if emit_gates
             else None)
    h_t, c_t = torch.empty_like(h0), torch.empty_like(c0)
    KERNEL_FI.launch_on(
        x.device.index, x.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        b.data_ptr(), packs[1].data_ptr(), peep.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), _ptr(gates),
        h_t.data_ptr(), c_t.data_ptr(), bsz, t, e, d, u, int(reverse))
    return hs, cs, gates, h_t, c_t


def _fi_fwd_kernel_bf16(x, mask, w_x, b, w_h, peep, h0, c0, reverse,
                        emit_gates):
    """``lstm_fi_fwd_bf16``: x, W_x, W_h, the peepholes and h0 (the carry)
    in bf16, the bias, the mask and c0 in f32 (a bf16 bias is read as
    f32, as JAX's kernel reads it); hs and the gates slab bf16, cs, h_T
    and c_T f32, as the JAX kernel writes them (``_fwd_fi_call``
    :659-715)."""
    bf, f32 = torch.bfloat16, torch.float32
    h0, c0 = h0.to(bf).contiguous(), c0.to(f32).contiguous()
    b = b.to(f32).contiguous()
    _check_typed("lstm_fi_fwd_bf16", x=(x, bf), mask=(mask, f32),
                 w_x=(w_x, bf), b=(b, f32), w_h=(w_h, bf), peep=(peep, bf),
                 h0=(h0, bf), c0=(c0, f32))
    enforce(x.data_ptr() % 16 == 0,
            "lstm_fi_fwd_bf16: x must start on 16 bytes (16-byte copies)")
    bsz, t, e = x.shape
    d = w_h.shape[0]
    sms, optin = _card(x.device)
    refusal = fi_bf16_refusal(e, d, sms, optin)
    enforce(refusal is None, refusal or "")
    u = _bf16_units(d, sms)
    packs = (_pack_rows_bf16(w_x, u), _pack_rows_bf16(w_h, u))  # kept
    dev = x.device
    hs = torch.empty(bsz, t, d, dtype=bf, device=dev)
    cs = torch.empty(bsz, t, d, dtype=f32, device=dev)
    gates = (torch.empty(bsz, t, 4 * d, dtype=bf, device=dev) if emit_gates
             else None)
    h_t = torch.empty(bsz, d, dtype=f32, device=dev)
    c_t = torch.empty_like(h_t)
    KERNEL_FI_BF16.launch_on(
        x.device.index, x.data_ptr(), mask.data_ptr(), packs[0].data_ptr(),
        b.data_ptr(), packs[1].data_ptr(), peep.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), _ptr(gates),
        h_t.data_ptr(), c_t.data_ptr(), bsz, t, e, d, u, int(reverse))
    return hs, cs, gates, h_t, c_t


def _part_floats(blocks, d, b):
    """The f32 backward's scratch: each block's share of dh_{t-1}, two
    buffers by step parity, the rows padded to a multiple of 4 for the
    sum's 16-byte loads."""
    return 2 * blocks * d * (-(-b // 4) * 4)


def _bwd_kernel(xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
                reverse, remat):
    """The backward kernel of W_h's dtype (the contract of
    :func:`_bwd_plain`)."""
    if w_h.dtype == torch.bfloat16:
        return _bwd_kernel_bf16(xw, gates, mask, w_h, peep, h0, c0, hs, cs,
                                dhs, dhT, dcT, reverse, remat)
    _check_kernel_args(mask, w_h, peep, h0, c0, hs, cs, dhs, dhT, dcT,
                       xw if remat else gates)
    b, t, _ = hs.shape
    d = w_h.shape[0]
    u = _units(hs.device, d)
    wpack = _pack_columns(w_h, u)
    dgates = torch.empty(b, t, 4 * d, device=hs.device)
    dh, dc = torch.empty_like(dhT), torch.empty_like(dcT)
    dpeep = torch.empty_like(peep)
    part = torch.empty(_part_floats(wpack.shape[0], d, b), device=hs.device)
    (KERNEL_BWD if remat else KERNEL_BWD_STORED).launch_on(
        mask.device.index, _ptr(xw if remat else None),
        _ptr(None if remat else gates), mask.data_ptr(), wpack.data_ptr(),
        peep.data_ptr(), h0.data_ptr(), c0.data_ptr(), hs.data_ptr(),
        cs.data_ptr(), dhs.data_ptr(), dhT.data_ptr(), dcT.data_ptr(),
        dgates.data_ptr(), dh.data_ptr(), dc.data_ptr(), dpeep.data_ptr(),
        part.data_ptr(), b, t, d, u, int(reverse), int(remat))
    return dgates, dh, dc, dpeep


def _bwd_kernel_bf16(xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs, dhT,
                     dcT, reverse, remat):
    """``lstm_bwd_bf16``: W_h, the peepholes, h0, hs, dhs and the gates
    slab (remat off) in bf16; xw (remat on) in bf16 (``lstmemory``) or f32
    (the BiLSTM's projection), read as it is; the mask, c0, cs and the
    final cotangents in f32.  dgates, dh0, dc0 and dpeep come out f32."""
    bf, f32 = torch.bfloat16, torch.float32
    h0, c0 = h0.to(bf).contiguous(), c0.to(f32).contiguous()
    dhs, dhT, dcT = (dhs.to(bf).contiguous(), dhT.to(f32).contiguous(),
                     dcT.to(f32).contiguous())
    slab = {"xw": (xw, (bf, f32))} if remat else {"gates": (gates, bf)}
    _check_typed("lstm_bwd_bf16", mask=(mask, f32), w_h=(w_h, bf),
                 peep=(peep, bf), h0=(h0, bf), c0=(c0, f32), hs=(hs, bf),
                 cs=(cs, f32), dhs=(dhs, bf), dhT=(dhT, f32),
                 dcT=(dcT, f32), **slab)
    b, t, _ = hs.shape
    d = w_h.shape[0]
    u = _bf16_plan(hs.device, d)
    wpack = _pack_rows_bf16(w_h, u) if remat else None   # the remat product
    dev, blocks = hs.device, -(-d // u)
    _, mp, _, ldp = _bf16_split(d, u, blocks)
    # the blocks' parts of W_h for the dh product, built by the kernel in
    # shared memory where they fit beside the rest (``plan_bwd_bf16``), else
    # here
    parts = torch.empty(blocks * mp * ldp, dtype=bf, device=dev)
    dgates = torch.empty(b, t, 4 * d, dtype=f32, device=dev)
    dh, dc = torch.empty_like(dhT), torch.empty_like(dcT)
    dpeep = torch.empty(3, d, dtype=f32, device=dev)
    # the step's dgates rounded to bf16, and the dh product's first pass
    xg = torch.empty(b, 4 * d, dtype=bf, device=dev)
    pp = torch.empty(blocks * mp * 64 * -(-b // 64), dtype=f32, device=dev)
    (KERNEL_BWD_BF16 if remat else KERNEL_BWD_STORED_BF16).launch_on(
        mask.device.index, _ptr(xw if remat else None),
        _ptr(None if remat else gates), mask.data_ptr(), _ptr(wpack),
        w_h.data_ptr(), parts.data_ptr(), peep.data_ptr(), h0.data_ptr(),
        c0.data_ptr(), hs.data_ptr(), cs.data_ptr(), dhs.data_ptr(),
        dhT.data_ptr(), dcT.data_ptr(), dgates.data_ptr(), dh.data_ptr(),
        dc.data_ptr(), dpeep.data_ptr(), xg.data_ptr(), pp.data_ptr(), b, t,
        d, u, int(reverse), int(remat), int(remat and xw.dtype == f32))
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
    c0, hs, cs and either the gates slab (remat off) or xw (remat on).
    The gradients come back in their inputs' dtypes: dxw from the f32
    dgates, dW_h one product of hs_prev and dgates rounded to W_h's dtype
    with f32 sums (JAX ``lstm.py:553-569``)."""

    @staticmethod
    def forward(ctx, xw, mask, w_h, peep, h0, c0, reverse, remat):
        fwd = _fwd_plain if xw.device.type == "cpu" else _fwd_kernel
        hs, cs, gates, h_t, c_t = fwd(xw, mask, w_h, peep, h0, c0, reverse,
                                      not remat)
        ctx.save_for_backward(xw if remat else None, gates, mask, w_h, peep,
                              h0, c0, hs, cs)
        ctx.cfg = (reverse, remat, xw.dtype)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        xw, gates, mask, w_h, peep, h0, c0, hs, cs = ctx.saved_tensors
        reverse, remat, xw_dtype = ctx.cfg
        bwd = _bwd_plain if hs.device.type == "cpu" else _bwd_kernel
        dgates, dh0, dc0, dpeep = bwd(
            xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs.contiguous(),
            dh_t.contiguous(), dc_t.contiguous(), reverse, remat)
        d = w_h.shape[0]
        h_prev = _shift_prev(hs, h0, reverse).to(w_h.dtype)
        dw_h = torch.matmul(h_prev.reshape(-1, d).t(),
                            dgates.to(w_h.dtype).reshape(-1, 4 * d))
        return (dgates.to(xw_dtype), None, dw_h, dpeep.to(peep.dtype),
                dh0.to(h0.dtype), dc0.to(c0.dtype), None, None)


def lstm_seq(xw, mask, w_h, peephole, h0, c0, reverse=False, remat=False):
    """Fused LSTM over a whole sequence.

    xw [B, T, 4D] (x @ W_x + bias, gate order [i, f, g, o]); mask [B, T]
    (1.0 while t < length, rows freeze afterwards); w_h [D, 4D]; peephole
    [3, D] ([W_ci, W_cf, W_co]; zeros for a plain LSTM); h0, c0 [B, D];
    reverse: iterate T-1..0; remat: keep no gates slab for the backward,
    recompute the gates there.  Returns (hs [B, T, D], (h_T, c_T)): hs in
    xw's dtype; with bf16 operands the cell runs in f32 and h_T, c_T are
    f32 (h_T unrounded), as the JAX kernel gives them."""
    enforce(xw.dim() == 3 and xw.shape[1] >= 1
            and xw.shape[2] == 4 * w_h.shape[0],
            f"lstm_seq: xw must be [B, T>=1, 4D] for w_h {tuple(w_h.shape)},"
            f" got {tuple(xw.shape)}")
    hs, h_t, c_t = _LstmSeq.apply(
        xw.contiguous(), mask.to(_acc(w_h.dtype)).contiguous(),
        w_h.contiguous(), peephole.contiguous(), h0.contiguous(),
        c0.contiguous(), bool(reverse), bool(remat))
    return hs, (h_t, c_t)


def lstm_seq_reference(xw, mask, w_h, peephole, h0, c0, reverse=False):
    """Plain scan of the same cell, peepholes and freeze mask (autograd
    gives its backward).  Returns (hs [B, T, D], (h_T, c_T))."""
    hs, _, _, h_t, c_t = _fwd_plain(xw, mask.to(_acc(w_h.dtype)), w_h,
                                    peephole, h0, c0, reverse, False)
    return hs, (h_t, c_t)


# -- the fused-input bidirectional entry -------------------------------------


def _project_xw(x, w_x, b):
    """x @ W_x + b over every step, one product: [B, T, E] -> [B, T, 4D]
    (the JAX package's ``_project_xw`` and unfused projection): in the
    cell's dtype, never rounded, so bf16 operands give an f32 slab."""
    bsz, t, e = x.shape
    acc = _acc(w_x.dtype)
    return (torch.matmul(x.reshape(bsz * t, e).to(acc), w_x.to(acc))
            + b.to(acc)).reshape(bsz, t, -1)


def _bi_fwd_plain(x, mask, fw, bw):
    """Plain twin of the bilstm kernel, the unfused composition: per
    direction the projection as one product (f32, unrounded, for bf16
    operands: the kernel's in-loop projection, JAX ``lstm.py:833-835``),
    then the forward recurrence over it with hs in x's dtype.
    ``fw``/``bw`` = (w_x, b, w_h, peep, h0, c0); returns ((hs, cs, h_T,
    c_T) forward, the same reverse)."""
    outs = []
    for (w_x, b, w_h, peep, h0, c0), reverse in ((fw, False), (bw, True)):
        xw = _project_xw(x, w_x, b)
        hs, cs, _, h_t, c_t = _run(lambda k: xw[:, k], x.shape[1], x.dtype,
                                   mask, w_h, peep, h0, c0, reverse, False)
        outs.append((hs, cs, h_t, c_t))
    return tuple(outs)


class BiPlan(NamedTuple):
    """The f32 bilstm kernel's launch: clusters of ``cluster`` CTAs, each a
    row tile of ``rows`` and D / cluster units; W_x's slice in shared
    memory when ``resident``; ``ctas`` in the grid, ``smem_bytes`` each."""
    cluster: int
    rows: int
    resident: bool
    ctas: int
    smem_bytes: int


def bi_smem_floats(e: int, d: int, cluster: int, rows: int,
                   resident: bool) -> int:
    """Shared memory of a CTA of the f32 bilstm kernel in floats,
    ``cl_smem_floats`` of csrc/bilstm_seq.cu: the W_h slice [D][4U], the
    resident W_x slice [E][4U] and x_t's rows, the two h buffers of the
    tile, the c carry of the CTA's U = D / cluster units, the partial sums
    [2][splits][rows][4U], the bias slice, the peepholes and two steps'
    mask."""
    u = d // cluster
    splits = min(_BI_MAX_SPLITS, max(1, _BI_THREADS // u))
    lx = e if resident else 0
    return ((lx + d) * 4 * u + rows * lx + 2 * rows * d + rows * u
            + 2 * splits * rows * 4 * u + 4 * u + 3 * u + 2 * rows)


def _bi_candidates(b: int, e: int, d: int, optin: int):
    for resident in (True, False):
        for rows in _BI_ROW_TILES:
            for cluster in (8, 4, 2, 1):
                if d % cluster:
                    continue
                need = 4 * bi_smem_floats(e, d, cluster, rows, resident)
                if need <= optin:
                    yield BiPlan(cluster, rows, resident,
                                 2 * cluster * -(-b // rows), need)


def bi_plan(b: int, e: int, d: int, sms: int, optin: int,
            clusters=None) -> BiPlan:
    """The f32 bilstm kernel's plan for batch B, input width E and hidden
    width D on a card of ``sms`` SMs and ``optin`` bytes of shared memory
    a CTA, or raise why it cannot take them.  ``clusters(cluster, rows,
    resident)``: how many clusters of a plan the card holds at once (its
    GPCs bound that below SMs / cluster; default: SMs / cluster).  W_x's
    slice resident first; then one wave of at most one CTA an SM where
    any plan has one (else the fewest waves), the most CTAs, the smaller
    row tile and the smaller cluster.  The BiLSTM's backward
    (``lstm_seq``'s kernel) takes D too: a multiple of 4, ceil(D / SMs) <=
    16 units a block."""
    enforce(d % 4 == 0 and e > 0 and b > 0,
            "bilstm kernel: D=%s must be a multiple of 4 (the backward's "
            "16-byte copies)", d)
    u = -(-d // sms)
    enforce(u <= _MAX_UNITS, "bilstm kernel: D=%s needs %s units a block of "
            "the backward on %s SMs, more than the %s its tiling covers",
            d, u, sms, _MAX_UNITS)
    plans = list(_bi_candidates(b, e, d, optin))
    if not plans:
        least = min(4 * bi_smem_floats(e, d, c, _BI_ROW_TILES[0], False)
                    for c in (8, 4, 2, 1) if d % c == 0)
        widest = next((w for w in range(d - 4, 0, -4)
                       if any(_bi_candidates(b, e, w, optin))), 0)
        enforce(False, "bilstm kernel: E=%s, D=%s needs at least %s bytes "
                "of shared memory a CTA (W_h's slice, in clusters of at "
                "most %s), more than the %s the card allows; at E=%s the "
                "widest D it takes is %s", e, d, least, _BI_MAX_CLUSTER,
                optin, e, widest)
    resident = any(p.resident for p in plans)
    held = clusters or (lambda c, rows, res: sms // c)

    def waves(p):
        at_once = max(1, min(held(p.cluster, p.rows, p.resident),
                             sms // p.cluster))
        return -(-(p.ctas // p.cluster) // at_once)

    return min((p for p in plans if p.resident == resident),
               key=lambda p: (waves(p), -p.ctas, p.rows, p.cluster))


def _max_clusters(device: torch.device, e: int, d: int):
    """``clusters`` of :func:`bi_plan` from the card ``device`` itself
    (``bilstm_f32_max_clusters`` in csrc/bilstm_seq.cu)."""
    from paddle_tpu_torch.ops.kernels import _build

    fn = _build.load("bilstm_seq").bilstm_f32_max_clusters
    fn.argtypes, fn.restype = [_I] * 5 + [_P], _I

    def held(cluster: int, rows: int, resident: bool) -> int:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            code = fn(e, d, cluster, rows, int(resident), ctypes.byref(n))
        enforce(code == 0, "bilstm_f32_max_clusters: CUDA error %s", code)
        return n.value

    return held


@functools.lru_cache(maxsize=None)
def _bi_launch(device: torch.device, b: int, t: int, e: int, d: int):
    """The plan and the trailing arguments of a launch, once a (device, B,
    T, E, D): no device query a call."""
    p = bi_plan(b, e, d, *_card(device), _max_clusters(device, e, d))
    return p, (b, t, e, d, p.cluster, p.rows, int(p.resident))


def _bi_fwd_kernel(x, mask, fw, bw):
    """The bilstm kernel of W_h's dtype (the contract of
    :func:`_bi_fwd_plain`).  The f32 form's eight outputs are views of one
    allocation."""
    if fw[2].dtype == torch.bfloat16:
        return _bi_fwd_kernel_bf16(x, mask, fw, bw)
    _check_kernel_args(x, mask, *fw, *bw)
    b, t, e = x.shape
    d = fw[2].shape[0]
    _, ints = _bi_launch(x.device, b, t, e, d)
    n, m = b * t * d, b * d
    out = torch.empty(4 * (n + m), device=x.device)
    seqs, last = out.split([4 * n, 4 * m])
    hsf, csf, hsb, csb = seqs.view(4, b, t, d).unbind(0)
    htf, ctf, htb, ctb = last.view(4, b, d).unbind(0)
    base = out.data_ptr()
    seq = [base + 4 * n * k for k in range(4)]
    fin = [base + 16 * n + 4 * m * k for k in range(4)]
    KERNEL_BI.launch_on(
        x.device.index, x.data_ptr(), mask.data_ptr(),
        *(w.data_ptr() for w in fw), *seq[:2], *fin[:2],
        *(w.data_ptr() for w in bw), *seq[2:], *fin[2:], *ints)
    return (hsf, csf, htf, ctf), (hsb, csb, htb, ctb)


def _bi_ld(k: int) -> int:
    """bilstm_seq.cu's bf16 row stride of a [4D][K] weight slice: K padded
    to a multiple of 16, then 8 more (an odd count of 16-byte groups)."""
    return 16 * -(-k // 16) + 8


def bi_bf16_smem_bytes(e: int, d: int) -> int:
    """Shared memory of a block of ``bilstm_fwd_bf16``: W_x^T and W_h^T of
    its direction [4D][E or D, padded] and the x (two stages) and h tiles
    of its 16 rows, bf16."""
    return 2 * (4 * d * (_bi_ld(e) + _bi_ld(d))
                + _BI_BF_ROWS * (2 * _bi_ld(e) + _bi_ld(d)))


def bi_bf16_refusal(e: int, d: int, sms: int, optin: int) -> str | None:
    """Why ``bilstm_fwd_bf16`` (or the bf16 backward it is paired with)
    cannot take input width E and hidden width D; None when both can."""
    if d % 8 or e % 8 or d > _BI_BF_MAX_D:
        return (f"bilstm bf16 kernel: E={e} and D={d} must be multiples of "
                f"8 (16-byte copies), D at most {_BI_BF_MAX_D} (8 warps of "
                "4 n8 tiles)")
    need = bi_bf16_smem_bytes(e, d)
    if need > optin:
        return (f"bilstm bf16 kernel: E={e}, D={d} needs {need} bytes of "
                f"shared memory a block, more than the {optin} the card "
                "allows")
    return bf16_refusal(d, sms, optin)


def _pack_t_bf16(w, ld: int):
    """[K, 4D] -> [4D, ld]: row 4 u + g holds w[:, g*D + u], zero past K."""
    k, d = w.shape[0], w.shape[1] // 4
    w = w.reshape(k, 4, d).permute(2, 1, 0).reshape(4 * d, k)
    return F.pad(w, (0, ld - k)).contiguous()


def _bi_fwd_kernel_bf16(x, mask, fw, bw):
    """``bilstm_fwd_bf16``: x, W_x, W_h, the peepholes and h0 in bf16, the
    biases, the mask and c0 in f32; hs in bf16, cs, h_T and c_T in f32."""
    bf, f32 = torch.bfloat16, torch.float32
    b, t, e = x.shape
    d = fw[2].shape[0]
    refusal = bi_bf16_refusal(e, d, *_card(x.device))
    enforce(refusal is None, refusal or "")
    args, outs, keep = [x.data_ptr(), mask.data_ptr()], [], []
    for w_x, bias, w_h, peep, h0, c0 in (fw, bw):
        h0, c0 = h0.to(bf).contiguous(), c0.to(f32).contiguous()
        _check_typed("bilstm_fwd_bf16", x=(x, bf), mask=(mask, f32),
                     w_x=(w_x, bf), b=(bias, f32), w_h=(w_h, bf),
                     peep=(peep, bf), h0=(h0, bf), c0=(c0, f32))
        # packed temporaries stay referenced until the launch is queued
        packed = (_pack_t_bf16(w_x, _bi_ld(e)),
                  bias.reshape(4, d).t().contiguous(),
                  _pack_t_bf16(w_h, _bi_ld(d)), peep, h0, c0)
        keep.append(packed)
        out = (torch.empty(b, t, d, dtype=bf, device=x.device),
               torch.empty(b, t, d, dtype=f32, device=x.device),
               torch.empty(b, d, dtype=f32, device=x.device),
               torch.empty(b, d, dtype=f32, device=x.device))
        outs.append(out)
        args += [w.data_ptr() for w in packed] + [o.data_ptr() for o in out]
    KERNEL_BI_BF16.launch_on(
        x.device.index, *args, b, t, e, d)
    return tuple(outs)


class _BiLstmSeq(torch.autograd.Function):
    """JAX: ``bilstm_seq``'s ``custom_vjp`` with remat on.  Residuals: x,
    mask, both directions' weights and h0/c0, hs and cs; the backward
    recomputes the gates from them over the projection, unrounded (JAX's
    ``_project_xw``: f32 for bf16 operands).  dW_x and dW_h are products
    of bf16 operands with f32 sums, dx the two directions' f32 products
    summed, then rounded once (``lstm.py:984-1004``)."""

    @staticmethod
    def forward(ctx, x, mask, w_x_f, b_f, w_h_f, peep_f, w_x_b, b_b, w_h_b,
                peep_b, h0f, c0f, h0b, c0b):
        fw = (w_x_f, b_f, w_h_f, peep_f, h0f, c0f)
        bw = (w_x_b, b_b, w_h_b, peep_b, h0b, c0b)
        run = _bi_fwd_plain if x.device.type == "cpu" else _bi_fwd_kernel
        (hsf, csf, hTf, cTf), (hsb, csb, hTb, cTb) = run(x, mask, fw, bw)
        ctx.save_for_backward(x, mask, *fw, *bw, hsf, csf, hsb, csb)
        return hsf, hsb, hTf, cTf, hTb, cTb

    @staticmethod
    def backward(ctx, dhsf, dhsb, dhTf, dcTf, dhTb, dcTb):
        saved = ctx.saved_tensors
        x, mask = saved[:2]
        fw, bw, states = saved[2:8], saved[8:14], saved[14:]
        bwd = _bwd_plain if x.device.type == "cpu" else _bwd_kernel
        bsz, t, e = x.shape
        x2 = x.reshape(bsz * t, e)
        dx, grads = 0.0, {}
        for key, weights, (hs, cs), cts, reverse in (
                ("f", fw, states[:2], (dhsf, dhTf, dcTf), False),
                ("b", bw, states[2:], (dhsb, dhTb, dcTb), True)):
            w_x, bias, w_h, peep, h0, c0 = weights
            d = w_h.shape[0]
            dgates, dh0, dc0, dpeep = bwd(
                _project_xw(x, w_x, bias), None, mask, w_h, peep, h0, c0, hs,
                cs, *(c.contiguous() for c in cts), reverse, True)
            dg = dgates.reshape(-1, 4 * d)
            dg_w = dg.to(w_x.dtype)
            h_prev = _shift_prev(hs, h0, reverse).reshape(-1, d)
            dx = dx + torch.matmul(dg_w.to(dg.dtype), w_x.to(dg.dtype).t())
            grads[key] = (torch.matmul(x2.t(), dg_w), dg.sum(0).to(bias.dtype),
                          torch.matmul(h_prev.to(w_h.dtype).t(), dg_w),
                          dpeep.to(peep.dtype), dh0.to(h0.dtype),
                          dc0.to(c0.dtype))
        f, b = grads["f"], grads["b"]
        return (dx.reshape(bsz, t, e).to(x.dtype), None, *f[:4], *b[:4],
                *f[4:], *b[4:])


def bilstm_seq(x, mask, w_x_f, b_f, w_h_f, peep_f, w_x_b, b_b, w_h_b, peep_b,
               h0f, c0f, h0b, c0b):
    """Fused bidirectional LSTM over raw inputs: both recurrences, their
    input projections inside the loop, in one forward; the backward
    recomputes the gates (no gates slab is kept).

    x [B, T, E]; mask [B, T]; per direction w_x [E, 4D], b [4D], w_h
    [D, 4D], peep [3, D], h0/c0 [B, D] (the reverse direction iterates
    T-1..0).  With bf16 operands the projection stays f32 (pass b in
    f32, as the JAX entry does), the cell runs in f32, hs is bf16 and the
    final states f32.  Returns (hs_f, hs_b, (h_T_f, c_T_f), (h_T_b,
    c_T_b)); the BiLSTM output is hs_f and hs_b concatenated on the
    feature axis."""
    d = w_h_f.shape[0]
    enforce(x.dim() == 3 and x.shape[1] >= 1
            and all(tuple(w.shape) == (x.shape[2], 4 * d)
                    for w in (w_x_f, w_x_b))
            and all(tuple(w.shape) == (d, 4 * d) for w in (w_h_f, w_h_b)),
            f"bilstm_seq: x must be [B, T>=1, E] with w_x [E, 4D] and w_h "
            f"[D, 4D], got x {tuple(x.shape)}, w_x {tuple(w_x_f.shape)}, w_h "
            f"{tuple(w_h_f.shape)}")
    hsf, hsb, hTf, cTf, hTb, cTb = _BiLstmSeq.apply(
        x.contiguous(), mask.to(_acc(w_h_f.dtype)).contiguous(),
        *(w.contiguous() for w in (w_x_f, b_f, w_h_f, peep_f, w_x_b, b_b,
                                   w_h_b, peep_b, h0f, c0f, h0b, c0b)))
    return hsf, hsb, (hTf, cTf), (hTb, cTb)


class _LstmSeqFi(torch.autograd.Function):
    """JAX: ``lstm_seq_fi``'s ``custom_vjp``.  Residuals: x, mask, the
    weights, h0, c0, hs, cs and the gates slab (remat off); with remat on
    the backward recomputes xw with one product (JAX's ``_project_xw``:
    f32 for bf16 operands) and the gates from it.  The gradients come
    back in their inputs' dtypes (JAX ``lstm.py:767-780``): dW_x and dW_h
    products of bf16 operands with f32 sums, db the f32 sum of dgates,
    dx the f32 product of dgates rounded to W_x's dtype, rounded once."""

    @staticmethod
    def forward(ctx, x, mask, w_x, b, w_h, peep, h0, c0, reverse, remat):
        fwd = _fi_fwd_plain if x.device.type == "cpu" else _fi_fwd_kernel
        hs, cs, gates, h_t, c_t = fwd(x, mask, w_x, b, w_h, peep, h0, c0,
                                      reverse, not remat)
        ctx.save_for_backward(x, gates, mask, w_x, b, w_h, peep, h0, c0, hs,
                              cs)
        ctx.cfg = (reverse, remat)
        return hs, h_t, c_t

    @staticmethod
    def backward(ctx, dhs, dh_t, dc_t):
        x, gates, mask, w_x, b, w_h, peep, h0, c0, hs, cs = ctx.saved_tensors
        reverse, remat = ctx.cfg
        bwd = _bwd_plain if x.device.type == "cpu" else _bwd_kernel
        xw = _project_xw(x, w_x, b) if remat else None
        dgates, dh0, dc0, dpeep = bwd(
            xw, gates, mask, w_h, peep, h0, c0, hs, cs, dhs.contiguous(),
            dh_t.contiguous(), dc_t.contiguous(), reverse, remat)
        bsz, t, e = x.shape
        d = w_h.shape[0]
        dg = dgates.reshape(-1, 4 * d)
        dg_w = dg.to(w_x.dtype)
        h_prev = _shift_prev(hs, h0, reverse).reshape(-1, d)
        dx = torch.matmul(dg_w.to(dg.dtype), w_x.to(dg.dtype).t())
        return (dx.reshape(bsz, t, e).to(x.dtype), None,
                torch.matmul(x.reshape(bsz * t, e).to(w_x.dtype).t(), dg_w),
                dg.sum(0).to(b.dtype),
                torch.matmul(h_prev.to(w_h.dtype).t(), dg.to(w_h.dtype)),
                dpeep.to(peep.dtype), dh0.to(h0.dtype), dc0.to(c0.dtype),
                None, None)


def lstm_seq_fi(x, mask, w_x, b, w_h, peephole, h0, c0, reverse=False,
                remat=False):
    """Fused-input LSTM over a whole sequence: ``x @ W_x + b`` runs inside
    the recurrence (the cell, peepholes and mask as :func:`lstm_seq`).

    x [B, T, E]; w_x [E, 4D]; b [4D] (zeros for no bias); w_h [D, 4D];
    peephole [3, D]; h0, c0 [B, D]; remat: keep no gates slab, recompute
    xw and the gates in the backward.  Returns (hs [B, T, D], (h_T,
    c_T)): hs in x's dtype; with bf16 operands the projection stays f32
    (the bias read as f32), the cell runs in f32 and h_T, c_T are f32, as
    the JAX kernel gives them."""
    d = w_h.shape[0]
    enforce(x.dim() == 3 and x.shape[1] >= 1
            and tuple(w_x.shape) == (x.shape[2], 4 * d)
            and tuple(b.shape) == (4 * d,)
            and tuple(w_h.shape) == (d, 4 * d),
            f"lstm_seq_fi: x must be [B, T>=1, E] with w_x [E, 4D], b [4D] "
            f"and w_h [D, 4D], got x {tuple(x.shape)}, w_x "
            f"{tuple(w_x.shape)}, b {tuple(b.shape)}, w_h {tuple(w_h.shape)}")
    hs, h_t, c_t = _LstmSeqFi.apply(
        x.contiguous(), mask.to(_acc(w_h.dtype)).contiguous(),
        *(w.contiguous() for w in (w_x, b, w_h, peephole, h0, c0)),
        bool(reverse), bool(remat))
    return hs, (h_t, c_t)


def lstm_seq_fi_reference(x, mask, w_x, b, w_h, peephole, h0, c0,
                          reverse=False):
    """The projection as one product, then :func:`lstm_seq_reference`."""
    return lstm_seq_reference(_project_xw(x, w_x, b), mask, w_h, peephole,
                              h0, c0, reverse)


def bilstm_seq_reference(x, mask, w_x_f, b_f, w_h_f, peep_f, w_x_b, b_b,
                         w_h_b, peep_b, h0f, c0f, h0b, c0b):
    """Oracle of :func:`bilstm_seq`: the two plain directions composed
    (autograd gives the backward); the same return contract."""
    hs_f, last_f = lstm_seq_fi_reference(x, mask, w_x_f, b_f, w_h_f, peep_f,
                                         h0f, c0f, False)
    hs_b, last_b = lstm_seq_fi_reference(x, mask, w_x_b, b_b, w_h_b, peep_b,
                                         h0b, c0b, True)
    return hs_f, hs_b, last_f, last_b
