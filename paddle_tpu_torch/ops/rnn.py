"""Recurrent cells and masked scans of the port (``paddle_tpu/ops/rnn.py``:
the LSTM pieces ``lstmemory`` and ``bilstm`` need, the GRU pieces of
``grumemory``, ``bigru`` and ``gru_step_layer``, and the raw-input
recurrences :func:`lstm` and :func:`gru` with their fused-input routes).

The input projection x @ W_x (+ bias) is one large product outside the
recurrence, and only h @ W_h runs inside it, except on the fused-input
route: on the card, with the standard activations and a shape the
kernels take (:func:`fused_input_fits`), :func:`lstm` and :func:`gru` run
the projection inside the recurrence kernel (:func:`lstm_fi`,
:func:`gru_fi`), as the JAX package does on the TPU.  Ragged batches
freeze each row's state past its length.  The one-direction sequence
kernels' backward (:func:`lstm_fused`, :func:`gru_fused`) reads the gates
slab its forward stored where that slab fits the card's memory
(:func:`stored_slab_fits`), and recomputes the gates (remat) past it.
LSTM gates are ordered [input, forget, cell (candidate), output]; GRU
gates [update, reset, candidate], with Paddle's reset-before-product cell
(:func:`gru_cell`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from paddle_tpu_torch.core.dtype import cast_for_matmul, matmul_dtype
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.ops import activations as act
from paddle_tpu_torch.ops.kernels import gru as gru_kernels
from paddle_tpu_torch.ops.kernels import lstm as lstm_kernels
from paddle_tpu_torch.ops.math import matmul


class LSTMState(NamedTuple):
    h: torch.Tensor  # [B, D]
    c: torch.Tensor  # [B, D]


def lstm_cell(xw, state: LSTMState, w_h, gate_act=act.sigmoid,
              state_act=act.tanh, out_act=None, peephole=None) -> LSTMState:
    """One step: xw [B, 4D] (x @ W_x + bias), w_h [D, 4D], peephole [3D]
    flat [W_ci, W_cf, W_co] (i and f see c_{t-1}, o sees c_t);
    ``out_act`` (default ``state_act``) acts on c before the output gate."""
    d = state.h.shape[-1]
    gates = xw + matmul(state.h, w_h)
    gi, gf, gg, go = (gates[:, k * d:(k + 1) * d] for k in range(4))
    if peephole is not None:
        gi = gi + peephole[0 * d:1 * d] * state.c
        gf = gf + peephole[1 * d:2 * d] * state.c
    i = gate_act(gi)
    f = gate_act(gf)
    g = state_act(gg)
    c = f * state.c + i * g
    if peephole is not None:
        go = go + peephole[2 * d:3 * d] * c
    o = gate_act(go)
    h = o * (out_act or state_act)(c)
    return LSTMState(h=h, c=c)


def gru_cell(xw, h, w_h, w_hc, gate_act=act.sigmoid, state_act=act.tanh):
    """One step: xw [B, 3D] (x @ W_x + bias, [u, r, c]), h [B, D], w_h
    [D, 2D] (update and reset), w_hc [D, D] (candidate):
    u, r = gate_act(xw[:, :2D] + h W_h); c = state_act(xw[:, 2D:] +
    (r h) W_hc); h' = u h + (1 - u) c (``hl_gpu_gru.cuh`` frameOutput)."""
    d = h.shape[-1]
    ur = xw[:, :2 * d] + matmul(h, w_h)
    u = gate_act(ur[:, :d])
    r = gate_act(ur[:, d:2 * d])
    c = state_act(xw[:, 2 * d:] + matmul(r * h, w_hc))
    return u * h + (1.0 - u) * c


def _masked_scan(step, x: SequenceBatch, init_state, reverse: bool = False):
    """Run ``step(state, x_t) -> state`` over time, each row frozen past
    its length; the state is a tensor (the GRU's h) or a tuple of them
    (``LSTMState``).  Returns (last state, stacked states [B, T, ...])."""
    mask = x.mask(x.data.dtype)
    t = x.max_len
    bare = isinstance(init_state, torch.Tensor)
    state, outs = init_state, [None] * t
    for k in (range(t - 1, -1, -1) if reverse else range(t)):
        new = step(state, x.data[:, k])
        m = mask[:, k, None]
        if bare:
            state = m * new + (1.0 - m) * state
        else:
            state = type(state)(*(m * n + (1.0 - m) * o
                                  for n, o in zip(new, state)))
        outs[k] = state
    if bare:
        return state, torch.stack(outs, 1)
    return state, type(state)(*(torch.stack(z, 1) for z in zip(*outs)))


def lstm(x: SequenceBatch, w_x, w_h, b, reverse: bool = False,
         gate_act=act.sigmoid, state_act=act.tanh, init: LSTMState | None = None):
    """Full LSTM over a ragged batch of raw inputs: x [B, T, E], w_x
    [E, 4D], w_h [D, 4D], b [4D] or None, init zeros when None.  Routes:
    the fused-input kernel (:func:`lstm_fi`) when :func:`fused_input_on`
    and :func:`fused_input_fits` say so and the activations are the
    standard ones; else one projection product, then the sequence kernel
    (:func:`lstm_fused`) for the standard activations or the plain masked
    scan.  Returns (SequenceBatch of h, last LSTMState)."""
    b_, t = x.batch_size, x.max_len
    d = w_h.shape[0]
    data = x.data
    if init is None:
        zeros = torch.zeros(b_, d, dtype=data.dtype, device=data.device)
        init = LSTMState(h=zeros, c=zeros)
    standard = gate_act is act.sigmoid and state_act is act.tanh
    if (standard and fused_input_on(data.device)
            and fused_input_fits(data, lstm_kernels, w_x, w_h)):
        return lstm_fi(x, w_x, b, w_h, init, reverse=reverse)
    xw = matmul(data.reshape(b_ * t, -1), w_x)
    if b is not None:
        xw = xw + b
    xw = SequenceBatch(xw.reshape(b_, t, 4 * d), x.length)
    if standard:
        return lstm_fused(xw, w_h, init, reverse=reverse)

    def step(state, xt):
        return lstm_cell(xt, state, w_h, gate_act, state_act)

    last, ys = _masked_scan(step, xw, init, reverse=reverse)
    return SequenceBatch(data=ys.h, length=x.length), last


def fused_input_on(device) -> bool:
    """True where the fused-input recurrence kernels may engage: on the
    card.  CPU tensors keep the unfused composition (one projection
    product, then the sequence Function over it), the JAX package's route
    off the TPU."""
    return torch.device(device).type == "cuda"


def fused_input_fits(x, kernels, w_x, *weights) -> bool:
    """Whether the fused-input kernels of ``kernels`` (the module
    ``kernels/lstm`` or ``kernels/gru``) take these operands (the port's
    stand-in for the JAX package's VMEM budget ``_fused_fits``): the
    dtype the operands cast to (``cast_for_matmul``, as :func:`lstm_fi` /
    :func:`gru_fi` cast them) has a form, f32 or bf16, and the tiling of
    that form of the fused-input forward and of the backward it is paired
    with takes the shapes on the card of ``x`` (the module's ``fi_fits``:
    the refusal of that dtype is None).  A pure function of the device,
    the dtypes and the shapes; ``weights`` are the recurrent ones."""
    dtype = matmul_dtype(x.dtype, w_x.dtype, *(w.dtype for w in weights))
    return kernels.fi_fits(x.device, w_x.shape[0], weights[-1].shape[0],
                           dtype)


def lstm_fi(x: SequenceBatch, w_x, b, w_h, init: LSTMState, peephole=None,
            reverse: bool = False):
    """Fused-input LSTM: raw x [B, T, E] through ``kernels/lstm.lstm_seq_fi``
    with remat on, as the JAX package runs it (on the card one launch
    with x @ W_x inside the loop; the CPU twin projects step by step).
    b [4D] or None, peephole [3D] flat or None.  The operands cast as
    JAX's ``lstm_fi`` casts them (``ops/rnn.py:233-245``): x and both
    weights to one dtype (``cast_for_matmul``), the bias to f32 (the
    in-loop projection is never rounded), the peepholes and the h carry
    in the weights' dtype, c as given; the outputs come back in x's
    dtype.  A shape the kernels do not take raises on the card (callers
    check :func:`fused_input_fits`).  Returns (SequenceBatch of h, last
    LSTMState)."""
    d = w_h.shape[0]
    data, w_x_c, w_h_c = cast_for_matmul(x.data, w_x, w_h)
    acc = torch.promote_types(w_h_c.dtype, torch.float32)
    bias = (torch.zeros(4 * d, dtype=acc, device=w_x.device)
            if b is None else b.to(acc))
    peep = (torch.zeros(3, d, dtype=w_h_c.dtype, device=w_h.device)
            if peephole is None else peephole.reshape(3, d).to(w_h_c.dtype))
    hs, (h_t, c_t) = lstm_kernels.lstm_seq_fi(
        data, x.mask(), w_x_c, bias, w_h_c, peep, init.h.to(w_h_c.dtype),
        init.c, reverse=reverse, remat=True)
    out = x.data.dtype
    return (SequenceBatch(data=hs.to(out), length=x.length),
            LSTMState(h=h_t.to(out), c=c_t.to(out)))


#: the largest share of the card's memory still open to the process
#: (:func:`card_memory_open`) that one stored gates slab may take.  A
#: quarter leaves the backward room for its own f32 dgates (as large as an
#: f32 slab) and for the layers after this one.
STORED_SLAB_SHARE = 0.25


def gates_slab_bytes(b: int, t: int, gates: int, d: int, dtype) -> int:
    """Bytes of the [B, T, G·D] gates slab the forward stores for the
    stored-gates backward, in the kernels' io dtype (G = 4 for the LSTM,
    3 for the GRU)."""
    return b * t * gates * d * torch.finfo(dtype).bits // 8


def stored_slab_fits(slab_bytes: int, open_bytes: int) -> bool:
    """The route rule of the one-direction recurrences' backward: the
    stored-gates form where the slab takes at most STORED_SLAB_SHARE of
    ``open_bytes`` (the card's memory still open to the process), else
    remat.  Both forms give the same bits, so the rule moves memory and
    time, never a number."""
    return slab_bytes <= STORED_SLAB_SHARE * open_bytes


def card_memory_open(device) -> int:
    """Bytes the process can still allocate on ``device``'s card: the
    driver's free memory (``torch.cuda.mem_get_info``) plus what the
    caching allocator holds reserved but unallocated."""
    free, _ = torch.cuda.mem_get_info(device)
    return (free + torch.cuda.memory_reserved(device)
            - torch.cuda.memory_allocated(device))


def on_card(device) -> bool:
    """Whether ``device`` is a CUDA card (where ``remat=None`` asks the
    route rule)."""
    return torch.device(device).type == "cuda"


def backward_remat(data, gates: int) -> bool:
    """``remat=None``'s form for the kernels' io tensor ``data`` [B, T,
    G·D] (already in the kernels' dtype): CPU tensors keep the stored form
    (the JAX package's route off the TPU); on the card,
    :func:`stored_slab_fits` against :func:`card_memory_open` decides."""
    if not on_card(data.device):
        return False
    b, t, gd = data.shape
    slab = gates_slab_bytes(b, t, gates, gd // gates, data.dtype)
    return not stored_slab_fits(slab, card_memory_open(data.device))


def lstm_fused(xw: SequenceBatch, w_h, init: LSTMState, peephole=None,
               reverse: bool = False, remat: bool | None = None):
    """Standard-activation LSTM over precomputed gate inputs through the
    sequence kernel (``kernels/lstm.lstm_seq``): xw a SequenceBatch of
    [B, T, 4D], peephole optional [3D] flat.  ``remat`` recomputes the
    gates in the backward instead of keeping the [B, T, 4D] slab; None
    asks :func:`backward_remat` (stored on the CPU; on the card stored
    where the slab fits, else remat).  Returns (SequenceBatch of h, last
    LSTMState)."""
    d = w_h.shape[0]
    # the product's operands in one dtype by the JAX package's rule
    # (``ops/rnn.py:197``): a bf16 weight or xw makes both bf16; the h
    # carry in that dtype, c0 as given (the kernels keep c in f32)
    data, w_h_c = cast_for_matmul(xw.data, w_h)
    if remat is None:
        remat = backward_remat(data, 4)
    peep = (torch.zeros(3, d, dtype=w_h_c.dtype, device=w_h.device)
            if peephole is None else peephole.reshape(3, d).to(w_h_c.dtype))
    hs, (h_t, c_t) = lstm_kernels.lstm_seq(
        data, xw.mask(), w_h_c, peep, init.h.to(w_h_c.dtype), init.c,
        reverse=reverse, remat=remat)
    # the outputs keep the caller's dtype, as a product's does
    out = xw.data.dtype
    return (SequenceBatch(data=hs.to(out), length=xw.length),
            LSTMState(h=h_t.to(out), c=c_t.to(out)))


def bilstm_fused(x: SequenceBatch, fw: tuple, bw: tuple):
    """Bidirectional LSTM over raw inputs through ``kernels/lstm.bilstm_seq``:
    on the card one launch runs both directions with the input projections
    inside its loop, remat on, as the JAX package's TPU branch runs; CPU
    tensors take its twin, the unfused composition (one projection product
    and the plain scan per direction: in f32 the route the JAX package runs
    off the TPU; with bf16 operands the projection stays f32, unrounded, as
    in the kernel).  ``fw``/``bw`` are (w_x [E, 4D], bias [4D] | None,
    w_h [D, 4D], peephole [3D] | None).  A shape past the kernel's tiling
    raises on the card.  Returns the concatenated SequenceBatch [B, T, 2D]
    (forward features first)."""
    d = fw[2].shape[0]
    # JAX ``ops/rnn.py:285``: x and the four weights in one dtype; the
    # biases in f32 (the in-loop projection is never rounded), the
    # peepholes and the h carry in the weights' dtype, c in f32
    data, w_x_f, w_h_f, w_x_b, w_h_b = cast_for_matmul(
        x.data, fw[0], fw[2], bw[0], bw[2])
    acc = torch.promote_types(w_h_f.dtype, torch.float32)
    h0 = torch.zeros(x.batch_size, d, dtype=w_h_f.dtype, device=data.device)
    c0 = torch.zeros(x.batch_size, d, dtype=acc, device=data.device)

    def prep(w_x, bias, w_h, peephole):
        bias = (torch.zeros(4 * d, dtype=acc, device=w_x.device)
                if bias is None else bias.to(acc))
        peep = (torch.zeros(3, d, dtype=w_h.dtype, device=w_h.device)
                if peephole is None else peephole.reshape(3, d).to(w_h.dtype))
        return w_x, bias, w_h, peep

    hs_f, hs_b, _, _ = lstm_kernels.bilstm_seq(
        data, x.mask(), *prep(w_x_f, fw[1], w_h_f, fw[3]),
        *prep(w_x_b, bw[1], w_h_b, bw[3]), h0, c0, h0, c0)
    return SequenceBatch(data=torch.cat([hs_f, hs_b], dim=-1).to(x.data.dtype),
                         length=x.length)


def gru_fused(xw: SequenceBatch, w_h, w_hc, init, reverse: bool = False,
              remat: bool | None = None):
    """Standard-activation GRU over precomputed gate inputs through the
    sequence kernel (``kernels/gru.gru_seq``): xw a SequenceBatch of
    [B, T, 3D], w_h [D, 2D], w_hc [D, D], init [B, D].  ``remat``
    recomputes the gates in the backward instead of keeping the
    [B, T, 3D] slab; None asks :func:`backward_remat` (stored on the CPU;
    on the card stored where the slab fits, else remat).  The operands
    cast as JAX's ``gru_fused`` casts them (``ops/rnn.py:309-338``): xw
    and both weights to one dtype, the carry to W_h's; hs and the last h
    come back in xw's dtype.  A D past the kernel's tiling raises on the
    card.  Returns (SequenceBatch of h, last h)."""
    data, w_h_c, w_hc_c = cast_for_matmul(xw.data, w_h, w_hc)
    if remat is None:
        remat = backward_remat(data, 3)
    hs, h_t = gru_kernels.gru_seq(data, xw.mask(), w_h_c, w_hc_c,
                                  init.to(w_h_c.dtype), reverse=reverse,
                                  remat=remat)
    return (SequenceBatch(data=hs.to(xw.data.dtype), length=xw.length),
            h_t.to(xw.data.dtype))


def gru(x: SequenceBatch, w_x, w_h, w_hc, b, reverse: bool = False,
        gate_act=act.sigmoid, state_act=act.tanh, init=None):
    """Full GRU over a ragged batch of raw inputs: x [B, T, E], w_x
    [E, 3D], w_h [D, 2D], w_hc [D, D], b [3D] or None, init [B, D] zeros
    when None.  Routes as :func:`lstm`: :func:`gru_fi`, else one
    projection product and :func:`gru_fused` or the plain masked scan.
    Returns (SequenceBatch of h, last h)."""
    b_, t = x.batch_size, x.max_len
    d = w_h.shape[0]
    data = x.data
    if init is None:
        init = torch.zeros(b_, d, dtype=data.dtype, device=data.device)
    standard = gate_act is act.sigmoid and state_act is act.tanh
    if (standard and fused_input_on(data.device)
            and fused_input_fits(data, gru_kernels, w_x, w_h, w_hc)):
        return gru_fi(x, w_x, b, w_h, w_hc, init, reverse=reverse)
    xw = matmul(data.reshape(b_ * t, -1), w_x)
    if b is not None:
        xw = xw + b
    xw = SequenceBatch(xw.reshape(b_, t, 3 * d), x.length)
    if standard:
        return gru_fused(xw, w_h, w_hc, init, reverse=reverse)

    def step(h, xt):
        return gru_cell(xt, h, w_h, w_hc, gate_act, state_act)

    last, ys = _masked_scan(step, xw, init, reverse=reverse)
    return SequenceBatch(data=ys, length=x.length), last


def gru_fi(x: SequenceBatch, w_x, b, w_h, w_hc, init, reverse: bool = False):
    """Fused-input GRU: raw x [B, T, E] through ``kernels/gru.gru_seq_fi``
    with remat on, as the JAX package runs it (on the card one launch
    with x @ W_x + b inside the loop; the CPU twin projects step by
    step).  b [3D] or None.  The operands cast as JAX's ``gru_fi`` casts
    them (``ops/rnn.py:354-362``): x and the three weights to one dtype,
    the bias to f32, the carry in W_h's dtype; hs and the last h come
    back in x's dtype.  A shape the kernels do not take raises on the
    card (callers check :func:`fused_input_fits`).  Returns
    (SequenceBatch of h, last h)."""
    d = w_hc.shape[0]
    data, w_x_c, w_h_c, w_hc_c = cast_for_matmul(x.data, w_x, w_h, w_hc)
    acc = torch.promote_types(w_h_c.dtype, torch.float32)
    bias = (torch.zeros(3 * d, dtype=acc, device=w_x.device)
            if b is None else b.to(acc))
    hs, h_t = gru_kernels.gru_seq_fi(data, x.mask(), w_x_c, bias, w_h_c,
                                     w_hc_c, init.to(w_h_c.dtype),
                                     reverse=reverse, remat=True)
    out = x.data.dtype
    return SequenceBatch(data=hs.to(out), length=x.length), h_t.to(out)


def bigru_fused(x: SequenceBatch, fw: tuple, bw: tuple):
    """Bidirectional GRU over raw inputs through ``kernels/gru.bigru_seq``:
    on the card one launch runs both directions with the input projections
    inside its loop, remat on, as the JAX package's TPU branch runs; CPU
    tensors take its twin, the unfused composition (one projection product
    and the plain scan per direction).  ``fw``/``bw`` are (w_x [E, 3D],
    bias [3D] | None, w_h [D, 2D], w_hc [D, D]).  The operands cast as
    JAX's ``bigru_fused`` casts them (``ops/rnn.py:407-418``): x and the
    six weights to one dtype, the biases to f32 (the in-loop projection is
    never rounded), the zero carry in W_h's dtype.  A shape past the
    kernel's tiling raises on the card.  Returns the concatenated
    SequenceBatch [B, T, 2D] (forward features first)."""
    d = fw[3].shape[0]
    data, wxf, whf, whcf, wxb, whb, whcb = cast_for_matmul(
        x.data, fw[0], fw[2], fw[3], bw[0], bw[2], bw[3])
    acc = torch.promote_types(whf.dtype, torch.float32)
    zeros = torch.zeros(x.batch_size, d, dtype=whf.dtype, device=data.device)

    def bias(b):
        return (torch.zeros(3 * d, dtype=acc, device=data.device) if b is None
                else b.to(acc))

    hs_f, hs_b, _, _ = gru_kernels.bigru_seq(
        data, x.mask(), wxf, bias(fw[1]), whf, whcf, wxb, bias(bw[1]), whb,
        whcb, zeros, zeros)
    return SequenceBatch(data=torch.cat([hs_f, hs_b], dim=-1).to(x.data.dtype),
                         length=x.length)
