#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port builds, is right, serves and
trains (ResNet-50, the transformer LM, the LSTM text classifier, the
OCR CRNN, the attention NMT, the CIFAR-10 VGG and the benchmark image
nets).

Run from the root of a checkout, on a machine with one card and nvcc:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. The card (``nvidia-smi`` name and power limit, torch's name and
   device count).  Every kernel is built from ``paddle_tpu_torch/ops/
   kernels/csrc`` (one ``nvcc`` per source, all at once; timed).
2. Each kernel against its plain PyTorch twin on the card, at the shapes
   its path gives it: flash prefill [8, 512, 12, 64] causal (and an odd
   T=333), paged decode B=32, H=12, D=64, page_size=16, 36 pages per row,
   ragged lengths including 0, 1, 16, 17 and 576; the BRGEMM kernel on
   ResNet-50's res2 branch2c 1x1 conv at batch 64 (M=200,704, K=64,
   N=256) with the stats epilogue and with affine+ReLU, and on res3_1's
   stride-2 1x1 projection (x [64, 56, 56, 256] -> 512, strided row map)
   with stats; the direct conv kernel on res2's 3x3 (x [64, 56, 56, 64],
   s1 p1) with stats and with affine+ReLU, and on the 7x7 s2 p3 stem
   (x [64, 224, 224, 3]) with stats.  Max abs error <= 1e-4 (f32
   round-off of another summation order; TF32 off); the BN statistics
   are compared as the moments they feed (sum / count, sumsq / count).
   The flash forward and the backward's dQ and dK/dV kernels at the LM
   training shape [16, 1024, 12, 64] causal (and T=333; the forward gets
   a row of its own at this shape), each against its plain twin
   (max abs error <= 1e-4, relative to the largest entry where that is
   above 1), and the whole backward through the autograd Function against
   float64 autograd of exact attention on the card (relative norm <=
   1e-5), with a backward that drops delta = rowsum(dO * O) as a planted
   fault that must exceed it.
   Times are CUDA-event means over many launches with the 50 MB L2
   flushed before each launch, beside the plain twin, one PyTorch library
   call used only here as a yardstick (``scaled_dot_product_attention``
   and its backward, ``torch.matmul``, channels_last ``F.conv2d``) and
   the bound: the larger
   of bytes moved / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM f32 FMA,
   the tensor cores would need TF32), counting only the taps of a conv
   that fall inside the image.  cuDNN's conv backward (dx, dw) at res2's
   3x3 and the stem against float64 on the CPU: relative error <= 5e-5,
   and the same call with TF32 allowed (a planted fault) above it.
3. The serving engine end to end at the GPT-2-small width of the repo's
   LM config (vocab 50257, 12 layers, 12 heads, 768 wide, MLP 3072, f32,
   random weights from a seeded generator): 64 greedy requests with
   prompts of 16-512 tokens plus 8 at temperature 0.8, 64 new tokens
   each, 32 slots.  Kernel launch counts are zeroed just before and read
   just after: flash must run once per layer per prefill pass and paged
   attention once per layer per decode step.  Two greedy requests must
   equal the argmax of one full-context forward pass on the card.
4. ResNet-50 training through the v2 ``trainer.SGD`` (224x224x3, 1000
   classes, Momentum 0.9 at lr 0.1/64, random weights from a seeded
   generator, seeded synthetic data): one step at batch 2 from the same
   parameters on the CPU (plain twins) and on the card (kernels), each
   held against a float64 step on the CPU: cost within 1e-4 relative, and
   per parameter and BN statistic ||x32 - x64|| / ||x64 - x0|| <= 0.1
   (see ``witness_ratio``; the float64 step's own move under a 1e-6 input
   nudge is reported beside it).  A card step whose BN backward drops the
   batch mean's term is a planted fault that must exceed that limit, and
   the card's step must repeat bit for bit.  Then 10 steps at batch 64
   after 2 warm-up steps (img/s, step ms, peak memory), with the launch
   counts zeroed just before and read just after: exactly 36 BRGEMM and
   17 direct-conv launches per step; then 3 steps under ``torch.profiler``
   (device time by kernel class, busy share); then 20 steps with
   deterministic cuDNN on and off in turn (its cost in step time); then
   ``test`` on 2 batches, again exactly 36 and 17 per batch.
5. The LM training path, ``transformer.build_train_step``, at the width
   of phase 3 in f32 (flash attention, no remat), Adam at lr 1e-4 with
   bf16 moments (as the repo's LM benchmark): one step at batch 2 x 128
   on the card (kernels) and on the CPU (plain twins), each against the
   CPU's plain twins in float64 by the loss (relative 1e-5) and every
   gradient leaf (||g32 - g64|| / ||g64|| <= 1e-4), with TF32 allowed in
   cuBLAS and the flash backward's delta dropped as planted faults that
   must exceed it, and the card's step repeated bit for bit.  Then 2
   warm-up and 10 timed steps at batch 16 x 1024 on one fixed batch
   (tokens/s, step ms, peak memory, the f32 MFU against 67 TFLOP/s by
   ``bench.py``'s FLOP count), losses finite and falling, with the launch
   counts zeroed just before and read just after: exactly 12 flash
   forward, 12 dQ and 12 dK/dV launches per step; then 3 steps under
   ``torch.profiler`` (device time by kernel class, the optimizer split
   out, busy share).
6. The LSTM text classifier (``bench.py``'s ``_lstm_classify_cost`` and
   ``bench_lstm``'s batch and optimizer: embedding 128 over a 30,000-id
   vocabulary, fc to 4 x 1280, ``lstmemory`` with peepholes, ``last_seq``,
   a 2-way softmax fc, ``classification_cost``; f32, Adam at lr 2e-3 with
   bf16 moments).  Its kernels against their plain twins at the path's
   shapes (LSTM forward and backward at B 64, T 128, D 1280, lengths 100;
   the gather and the table gradient of 8,192 ids into [30000, 128]; max
   abs error <= 1e-4 x max(1, |ref|)), the backward's remat and
   stored-gates forms and a rerun equal in bits, each timed beside its
   twin, its bound and a library call (cuDNN's ``nn.LSTM`` forward and
   backward, which has no peepholes and includes the input projection:
   the fc plus the forward kernel is timed beside it; ``F.embedding`` and
   ``embedding_dense_backward``).  Then a batch-2 step (ragged lengths,
   T = 16) on the card and on the CPU against a float64 witness by the
   loss (relative 1e-5) and every gradient leaf (1e-4), with TF32 allowed
   in cuBLAS on the card and a CPU backward whose dc carry drops its
   peephole terms as planted faults that must exceed it, and the card's
   step repeated bit for bit.  Then ``trainer.SGD``: the first step twice
   from the same parameters (bit for bit), 2 warm-up and 10 timed steps
   at batch 64 of 100-token sequences (T = 128 after the feeder's
   bucketing; sequences/s, step ms, peak memory, finite losses, the
   classification error from the events) with exactly one launch each of
   the LSTM forward, the LSTM backward, the gather and the scatter-add
   per step; 3 steps under ``torch.profiler``; ``test`` on 2 batches
   (one forward and one gather per batch).
7. The OCR CRNN (``models/ocr_crnn.crnn_ctc_cost`` at ``bench_crnn``'s
   configuration: 32x96x1 images, two 3x3 ``img_conv_bn`` layers 1->16
   and 16->32 each with a 2x2 pool, ``layer.bilstm`` of 64, a 27-way
   softmax fc, ``ctc_layer``; f32, Adam at lr 1e-3 with bf16 moments).
   Its kernels against their plain twins at the path's shapes: the
   BiLSTM forward (x [64, 24, 256], D 64, both directions), the LSTM
   backward kernel in its remat form at the BiLSTM's shapes (xw
   [64, 24, 256], D 64) in both directions, the CTC
   forward-backward on log-probs [64, 24, 27] with labels of 5 in a
   16-slot (S = 33), in both ``normalize`` forms, the greedy decode of the
   same slab (bit-equal), the direct conv with its BN statistics epilogue
   at the two 3x3 shapes (Cin = 1 and 16); max abs error <= 1e-4 x
   max(1, |ref|), reruns equal in bits; each timed beside its twin, its
   bound and a library call the port never makes (cuDNN's bidirectional
   ``nn.LSTM``, input projection included and no peepholes, and the
   backward of its one-direction form; ``F.ctc_loss`` forward and backward by the log-probs; ``torch.argmax``
   over the slab as the decode's read floor).  Then a batch-2 step on the
   card and on the CPU against ``SGD.step_f64`` (plain SGD at lr 1, so
   the update is the gradient): cost within 1e-5 relative, and per
   parameter and BN statistic the witness ratio within 10x the float64
   step's own move under a 1e-6 input nudge (at least 1e-4); TF32 on the
   card and a CPU CTC twin whose beta recursion drops the s-2 skip are
   planted faults that must exceed it, and the card's step repeats bit
   for bit.  Then ``trainer.SGD``: 2 warm-up and 10 timed steps at batch
   64 (samples/s, step ms, peak memory, finite falling costs) with
   exactly 2 direct-conv, 1 BiLSTM, 2 LSTM-backward and 1 CTC launches
   per step and no other; 3 steps under ``torch.profiler``;
   ``paddle.infer`` on 64 samples and ``ocr_crnn.ctc_decode``, exactly 1
   BiLSTM, 2 conv and 1 decode launch; and the slow JAX test's
   convergence recipe (8 classes, rnn_size 32, Adam 3e-3, 25 passes of
   512 samples at batch 32): the last cost under 5% of the first and the
   greedy decode of 16 fresh samples exact on at least 13.
8. The attention NMT (``models/seqtoseq.seqtoseq_net`` at ``bench_nmt``'s
   configuration: vocab 30,000 both sides, word, encoder and decoder 512,
   32-token sequences, batch 64; 53,458,224 parameters; f32, Adam at lr
   5e-4 with bf16 moments).  Its kernels against their plain twins at the
   path's shapes (B 64, T 32, E = D = 512, half the rows ragged): the
   BiGRU forward (both directions), the GRU forward, the GRU backward in
   its remat form and its stored-gates form (the same bits), the GRU
   kernels in both directions; max abs error
   <= 1e-4 x max(1, |ref|), reruns equal in bits; each timed beside its
   twin, its bound and cuDNN's ``nn.GRU`` (another cell: the reset gate
   after the product; a yardstick of scale only).  Then a batch-2 step
   (ragged source and target lengths, T = 16) on the card and on the CPU
   against the CPU's plain twins in float64: cost within 1e-5 relative,
   and every gradient leaf (||g32 - g64|| / ||g64||) within 10x the
   float64 gradient's own move under a 1e-6 nudge of the embedding tables
   (at least 1e-4); TF32 on the card, a CPU cell with cuDNN's reset
   convention and an attention that does not mask the source padding are
   planted faults that must exceed it, and the card's step repeats bit
   for bit.  Then
   ``trainer.SGD``: the first step twice (bit for bit), 2 warm-up and 10
   timed steps (sequences/s, step ms, peak memory) with exactly 1 BiGRU
   forward, 2 GRU remat backward, 0 GRU forward, 2 gathers and 2
   scatter-adds per step; 3 steps under ``torch.profiler``; ``test`` on
   2 batches (1 BiGRU forward and 2 gathers each); and ``layer.bigru``
   against the composed ``simple_gru2`` pair on the card (forward and
   every gradient within 1e-4 x max(1, |ref|)), then each ``grumemory``
   of the pair as ``gru_seq`` on the pair's own inputs with the remat and
   the stored-gates backward (equal in bits), whose launches count the
   GRU forward and stored-gates rows.
9. The CIFAR-10 VGG with batch norm and dropout (``layers/networks.
   small_vgg``, the book's ``vgg_bn_drop``: 46 tensors, 7,909,450
   parameters, 11 batch norms; batch 128 of the port's seeded CIFAR-10;
   Momentum 0.9 at lr 0.1 / 128 with L2 0.0002 x 128; f32).
   ``channel_stats`` against its twin at small_vgg's five [R, C] views
   ([131072, 64] to [128, 512]; max abs error <= 1e-4 x max(1, |ref|), a
   rerun in the same bits), each timed beside its twin, its bound and
   ``torch.var_mean``, and its two passes' own device time from a trace;
   the direct conv kernel against its twin at AlexNet's conv1 (11x11
   stride 4, Cin 3, 227x227) and conv2 (5x5) at batch 64.  Then a
   batch-4 train-mode step with dropout on, on the card and on the CPU,
   each against the float64 run on the same device (the same masks):
   cost within 1e-5 relative, every gradient leaf within 10x the float64
   gradient's own move under a 1e-6 image nudge (at least 1e-4), every
   BN moving statistic within 1e-5; TF32 on the card, dropout without
   its 1 / keep scaling and ``F.batch_norm``'s unbiased running variance
   are planted faults that must exceed them, and the card's step repeats
   bit for bit.  Then ``trainer.SGD``: the first step twice (bit for
   bit), 2 warm-up and 10 timed steps (images/s, step ms, peak memory)
   with exactly 11 ``channel_stats`` and 10 direct-conv launches a step,
   finite falling costs, a 3-step profile, and ``test`` on 2 batches (no
   ``channel_stats``).  Last, ``bench.py``'s image nets under its
   ``_image_step`` configuration at batch 64 (Momentum 0.9 at lr 0.01 /
   64): smallnet, AlexNet and GoogLeNet 2 warm-up and 5 timed steps each
   (ms a batch), VGG-19 one step, each with its exact direct-conv and
   BRGEMM launches a step.
10. ``{"kernels": [...]}`` and then, as the last line, ``{"ok": true,
   "device": {...}}``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL = 1e-4
STEP_COST_RTOL = 1e-4    # f32 ResNet-50 step vs the f64 witness: cost, and
STEP_LEAF_LIMIT = 0.1    # per leaf ||x32 - x64|| / ||x64 - x0|| (below)
STEP_FLOOR = 1e-2        # of the leaf's share of the whole f64 update
CONV_BWD_RTOL = 5e-5     # cuDNN conv backward at the f32 policy vs f64
FLASH_BWD_F64_LIMIT = 1e-5  # flash backward kernels vs f64 exact attention
LM_LOSS_RTOL = 1e-5      # f32 LM step on the card vs the f64 witness: loss,
LM_GRAD_LIMIT = 1e-4     # per leaf ||g32 - g64|| / ||g64||
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Mean CUDA-event time of ``fn`` with L2 flushed before each launch."""

    def __init__(self, device):
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device=device)

    def __call__(self, fn, iters: int = 20) -> float:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_flash(dev, timer) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(1)
    b, h, d = 8, 12, 64
    scale = d ** -0.5
    err, row = 0.0, None
    for t in (512, 333):
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   for _ in range(3))
        o, lse = FA.flash_attention_fwd(q, k, v, causal=True)
        qp, kp, vp = FA._prep(q, k, v)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        torch.cuda.synchronize()
        err = max(err,
                  (o - FA._from_bh(o_ref, b, h, t, d)).abs().max().item(),
                  (lse - lse_ref[:, :t]).abs().max().item())
        if t != 512:
            continue
        ms = timer(lambda: FA._fwd_kernel(qp, kp, vp, t, True, scale))
        plain_ms = timer(lambda: FA._fwd_plain(qp, kp, vp, t, True, scale))
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library_ms = timer(lambda: F.scaled_dot_product_attention(
            qh, kh, vh, is_causal=True))
        pairs = b * h * t * (t + 1) // 2       # causal (query, key) pairs
        flops = 4.0 * pairs * d                # q.k and p.v, 2 flops/FMA
        nbytes = 4.0 * (4 * b * t * h * d + b * h * t)  # q, k, v, o, lse
        bound_ms, by = bound(nbytes, flops)
        row = {"name": "flash_attention_fwd", "route": "cuda",
               "source": "paddle_tpu_torch/ops/kernels/csrc/"
                         "flash_attention.cu",
               "replaces": "paddle_tpu/ops/pallas/flash_attention.py:307",
               "shape": [b, t, h, d], "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": by,
               "library_ms": library_ms}
    row["max_abs_err"] = err
    if not err <= TOL:
        raise AssertionError(f"flash kernel vs plain: max abs err {err}")
    return row


def rel_norm(got, want) -> float:
    """||got - want|| / ||want|| in float64 on the CPU."""
    want = want.detach().cpu().double()
    return float(torch.linalg.norm(got.detach().cpu().double() - want)
                 / torch.linalg.norm(want))


def check_flash_backward(dev, timer) -> tuple[list, dict]:
    """The flash kernels at the LM training shape [16, 1024, 12, 64] causal
    and at an odd T=333.  The forward, and the dQ and dK/dV kernels, each
    against its plain twin on the same inputs (max abs error <= TOL,
    relative to the largest entry where that is above 1), and the whole
    backward through the autograd Function against float64 autograd of
    exact attention on the card (relative norm <= FLASH_BWD_F64_LIMIT),
    with a backward that drops delta as the planted fault that must exceed
    it.  Times at the training shape: the forward, each backward kernel,
    the whole backward (delta + both kernels), the plain twins and
    ``scaled_dot_product_attention`` forward and backward (a yardstick
    only; the kernels it ran are named, and its math backend, plain f32
    products with TF32 off, is timed beside it)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    gen = torch.Generator(device=dev).manual_seed(6)
    h, d = 12, 64
    scale = d ** -0.5
    summary = {"phase": "flash_backward", "tol": TOL,
               "f64_limit": FLASH_BWD_F64_LIMIT}
    # name, kernel, plain twin, products of the function it computes (dQ:
    # S, dP, dQ; dK/dV: S, dP, dV, dK), outputs of [B, T, H, D]
    kernels = (("flash_attention_bwd_dq", FA._bwd_dq_kernel,
                FA._bwd_dq_plain, 3, 1),
               ("flash_attention_bwd_dkv", FA._bwd_dkv_kernel,
                FA._bwd_dkv_plain, 4, 2))
    err = {name: 0.0 for name, *_ in kernels}
    fwd_err = 0.0
    rows = []
    plain_delta = FA._delta
    for b, t in ((16, 1024), (16, 333)):
        q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                      for _ in range(4))
        qp, kp, vp = FA._prep(q, k, v)
        dop = FA._prep(g, g, g)[0]
        o, lse = FA._fwd_kernel(qp, kp, vp, t, True, scale)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        fwd_err = max(fwd_err, (o - o_ref)[:, :t].abs().max().item(),
                      (lse - lse_ref)[:, :t].abs().max().item())
        del o_ref, lse_ref
        delta = FA._delta(dop, o).contiguous()
        args = (qp, kp, vp, lse, dop, delta, t, True, scale)
        for name, kern, plain, _, _ in kernels:
            got, want = kern(*args), plain(*args)
            for x, y in zip(*((r,) if torch.is_tensor(r) else r
                              for r in (got, want))):
                e = (x - y).abs().max().item()
                err[name] = max(err[name], e)
                if not e <= TOL * max(1.0, y.abs().max().item()):
                    raise AssertionError(f"flash bwd {name} [{b},{t},{h},"
                                         f"{d}]: kernel vs plain {e}")
        # the whole backward, as training reaches it, against float64
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        wide = [x.double().requires_grad_() for x in (q, k, v)]
        want = torch.autograd.grad(FA.flash_attention_reference(
            *wide, causal=True), wide, g.double())
        readings = {}
        for label in ("f32", "delta_dropped_control"):
            if label == "delta_dropped_control":
                FA._delta = lambda do, o: torch.zeros_like(plain_delta(do, o))
            try:
                got = torch.autograd.grad(FA.flash_attention(
                    *leaves, causal=True), leaves, g)
            finally:
                FA._delta = plain_delta
            readings[label] = max(rel_norm(x, y) for x, y in zip(got, want))
        summary[f"vs_f64_T{t}"] = readings
        if not (readings["f32"] <= FLASH_BWD_F64_LIMIT
                < readings["delta_dropped_control"]):
            raise AssertionError(f"flash backward vs f64: {summary}")
        del wide, want, leaves
        if t != 1024:
            continue
        pairs_n = b * h * t * (t + 1) // 2     # causal (query, key) pairs
        act = 4.0 * b * t * h * d              # one [B, T, H, D] f32 tensor
        rowvec = 4.0 * b * h * t               # lse or delta
        qh, kh, vh = (x.transpose(1, 2).contiguous().requires_grad_()
                      for x in (q, k, v))
        # the forward as training runs it: q.k and p.v over the causal
        # pairs against q, k, v in and o, lse out
        bound_ms, by = bound(4 * act + rowvec, 4.0 * pairs_n * d)
        rows.append({
            "name": "flash_attention_fwd_lm_train", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/flash_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/flash_attention.py:307",
            "shape": [b, t, h, d],
            "ms": timer(lambda: FA._fwd_kernel(qp, kp, vp, t, True, scale)),
            "plain_ms": timer(lambda: FA._fwd_plain(qp, kp, vp, t, True,
                                                    scale)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=True))})
        for name, kern, plain, products, outs in kernels:
            # reads q, k, v, dO, lse, delta; writes the outputs
            bound_ms, by = bound(act * (4 + outs) + 2 * rowvec,
                                 2.0 * products * pairs_n * d)
            rows.append({
                "name": name, "route": "cuda",
                "source": "paddle_tpu_torch/ops/kernels/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "paddle_tpu/ops/pallas/flash_attention.py:331",
                "shape": [b, t, h, d],
                "ms": timer(lambda: kern(*args)),
                "plain_ms": timer(lambda: plain(*args)),
                "bound_ms": bound_ms, "bound_by": by,
                # no PyTorch call computes dQ (or dK, dV) alone
                "library_ms": None, "max_abs_err": err[name]})
        # the whole function: five products over the causal pairs against
        # q, k, v, o, dO in and dq, dk, dv out
        bound_ms, by = bound(8 * act + rowvec, 10.0 * pairs_n * d)
        out = F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
        gh = g.transpose(1, 2).contiguous()
        with sdpa_kernel(SDPBackend.MATH):
            out_math = F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)

        def library_step():
            F.scaled_dot_product_attention(qh, kh, vh, is_causal=True)
            torch.autograd.grad(out, (qh, kh, vh), gh, retain_graph=True)

        # which backend SDPA picks for f32 (its kernels decide whether it
        # uses the tensor cores, as the flash kernels do not)
        summary["library_kernels"] = [
            k["name"] for k in profile_window(library_step, 1).get(
                "top_kernels", [])]
        summary["whole_backward"] = {
            "shape": [b, t, h, d], "gflop": 10.0 * pairs_n * d / 1e9,
            "gbytes": (8 * act + rowvec) / 1e9,
            "ms": timer(lambda: FA._bwd_kernel(qp, kp, vp, o, lse, dop, t,
                                               True, scale)),
            "plain_ms": timer(lambda: FA._bwd_plain(qp, kp, vp, o, lse, dop,
                                                    t, True, scale)),
            "library_ms": timer(lambda: torch.autograd.grad(
                out, (qh, kh, vh), gh, retain_graph=True)),
            "library_math_ms": timer(lambda: torch.autograd.grad(
                out_math, (qh, kh, vh), gh, retain_graph=True)),
            "bound_ms": bound_ms, "bound_by": by}
        del qh, kh, vh, out, out_math
    if not fwd_err <= TOL:
        raise AssertionError(f"flash forward at the training shapes: kernel "
                             f"vs plain max abs err {fwd_err}")
    err["flash_attention_fwd_lm_train"] = fwd_err
    for row in rows:       # the worst over both shapes
        row["max_abs_err"] = err[row["name"]]
    summary["max_abs_err"] = err
    torch.cuda.synchronize()
    return rows, summary


def check_paged(dev, timer) -> dict:
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    b, h, d, ps, maxp = 32, 12, 64, 16, 36
    rng = np.random.default_rng(2)
    lens = np.concatenate([[0, 1, 16, 17, maxp * ps],
                           rng.integers(1, maxp * ps + 1, size=b - 5)])
    num_pages = 1 + b * maxp
    table = np.zeros((b, maxp), np.int32)
    ids = rng.permutation(np.arange(1, num_pages))
    nxt = 0
    for i, n in enumerate(lens):
        need = -(-int(n) // ps)
        table[i, :need] = ids[nxt:nxt + need]
        nxt += need
    gen = torch.Generator(device=dev).manual_seed(2)
    kp, vp = (torch.randn(h, num_pages, ps, d, generator=gen, device=dev)
              for _ in range(2))
    q = torch.randn(b, h, d, generator=gen, device=dev)
    pt = torch.from_numpy(table).to(dev)
    sl = torch.from_numpy(lens.astype(np.int32)).to(dev)
    out = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    ref = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    if not err <= TOL:
        raise AssertionError(f"paged kernel vs plain: max abs err {err}")
    idle = sl == 0
    if not torch.equal(out[idle], torch.zeros_like(out[idle])):
        raise AssertionError("paged kernel: idle rows are not exactly 0")
    ms = timer(lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl))
    plain_ms = timer(
        lambda: PA.ragged_paged_attention_reference(q, kp, vp, pt, sl))
    # the library yardstick: SDPA over the gathered dense K/V
    kd = kp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    vd = vp[:, pt.long()].transpose(0, 1).reshape(b, h, maxp * ps, d)
    mask = (torch.arange(maxp * ps, device=dev)[None, :]
            < sl[:, None])[:, None, None, :]
    library_ms = timer(lambda: F.scaled_dot_product_attention(
        q[:, :, None, :], kd, vd, attn_mask=mask))
    resident = float(lens.sum())
    nbytes = 4.0 * (2 * resident * h * d + 2 * b * h * d + b * maxp + b)
    bound_ms, by = bound(nbytes, 4.0 * resident * h * d)
    return {"name": "ragged_paged_attention", "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/paged_attention.cu",
            "replaces": "paddle_tpu/ops/pallas/paged_attention.py:274",
            "shape": [b, h, d, ps, maxp], "resident_tokens": int(resident),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "library_ms": library_ms}


def gemm_row(name, source, replaces, shape, got, want, count, kernel_fn,
             plain_fn, library_fn, nbytes, flops, timer) -> dict:
    """One kernel-vs-plain row of the conv path.  ``got``/``want`` are y or
    (y, sum, sumsq); the sums are compared as the BN moments they feed
    (divided by the ``count`` of rows)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = (got[0] - want[0]).abs().max().item()
    for a, b in zip(got[1:], want[1:]):
        err = max(err, ((a - b).abs().max() / count).item())
    if not err <= TOL:
        raise AssertionError(f"{name} {shape}: kernel vs plain max abs "
                             f"err {err}")
    bound_ms, by = bound(nbytes, flops)
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "shape": shape, "max_abs_err": err,
            "ms": timer(kernel_fn), "plain_ms": timer(plain_fn),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": timer(library_fn)}


def check_brgemm(dev, timer) -> list[dict]:
    """res2 branch2c: 1x1 conv 64 -> 256 on [64, 56, 56, 64], with the
    stats and with the affine + ReLU epilogue; res3_1 branch1: the stride-2
    1x1 projection 256 -> 512 on [64, 56, 56, 256] (strided row map)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import brgemm as BR

    gen = torch.Generator(device=dev).manual_seed(3)
    n, h, w, cin, cout = 64, 56, 56, 64, 256
    m = n * h * w
    x = torch.randn(n, h, w, cin, generator=gen, device=dev)
    wt = torch.randn(1, 1, cin, cout, generator=gen, device=dev) * (
        2.0 / cin) ** 0.5                     # msra scale, as initialized
    scale = 1 + 0.1 * torch.randn(cout, generator=gen, device=dev)
    shift = 0.1 * torch.randn(cout, generator=gen, device=dev)
    a, b = x.reshape(1, m, cin), wt.reshape(1, cin, cout)
    rows = []
    for mode, kw in (("stats", dict(stats=True)),
                     ("affine_relu", dict(scale=scale, shift=shift,
                                          act="relu"))):
        got = BR.conv1x1(x, wt, (1, 1), **kw)
        if isinstance(got, tuple):
            got = (got[0].reshape(m, cout), *got[1:])
        else:
            got = got.reshape(m, cout)
        rows.append(gemm_row(
            "brgemm", "paddle_tpu_torch/ops/kernels/csrc/brgemm.cu",
            "paddle_tpu/ops/pallas/tpp/brgemm.py:155",
            {"res2_2c": [m, cin, cout], "epilogue": mode}, got,
            BR.brgemm_reference(a, b, **kw), m,
            lambda: BR.conv1x1(x, wt, (1, 1), **kw),
            lambda: BR.brgemm_reference(a, b, **kw),
            lambda: torch.matmul(a[0], b[0]),
            4.0 * (m * cin + cin * cout + m * cout + 2 * cout),
            2.0 * m * cin * cout, timer))
    del x, a
    # the stride-2 projection reads every other pixel row of x by index;
    # the rows it reads are the bytes it must move
    n, h, w, cin, cout = 64, 56, 56, 256, 512
    x = torch.randn(n, h, w, cin, generator=gen, device=dev)
    wt = torch.randn(1, 1, cin, cout, generator=gen, device=dev) * (
        2.0 / cin) ** 0.5
    xs = x[:, ::2, ::2]
    m = n * (h // 2) * (w // 2)
    got = BR.conv1x1(x, wt, (2, 2), stats=True)
    xl, wl = x.permute(0, 3, 1, 2), wt.permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    rows.append(gemm_row(
        "brgemm", "paddle_tpu_torch/ops/kernels/csrc/brgemm.cu",
        "paddle_tpu/ops/pallas/tpp/brgemm.py:155",
        {"res3_1_branch1_s2": [m, cin, cout], "epilogue": "stats"},
        (got[0].reshape(m, cout), *got[1:]),
        BR.brgemm_reference(xs.reshape(1, m, cin), wt.reshape(1, cin, cout),
                            stats=True), m,
        lambda: BR.conv1x1(x, wt, (2, 2), stats=True),
        lambda: BR.brgemm_reference(xs.reshape(1, m, cin),
                                    wt.reshape(1, cin, cout), stats=True),
        lambda: F.conv2d(xl, wl, None, 2, 0),
        4.0 * (m * cin + cin * cout + m * cout + 2 * cout),
        2.0 * m * cin * cout, timer))
    torch.cuda.synchronize()
    return rows


def in_range_taps(size: int, k: int, s: int, p: int) -> int:
    """Taps of a k-wide window (stride s, padding p) that fall inside an
    axis of ``size``, summed over the output positions: the multiply-adds
    a convolution needs along that axis; a tap on the zero padding needs
    none."""
    out = (size + 2 * p - k) // s + 1
    return sum(min(o * s - p + k, size) - max(o * s - p, 0)
               for o in range(out))


def check_conv(dev, timer) -> list[dict]:
    """The direct kernel on res2's 3x3 (the stats epilogue of training and
    the affine + ReLU epilogue of ``test``) and on the stem (stats)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import conv as CV

    gen = torch.Generator(device=dev).manual_seed(4)
    rows = []
    for label, (n, h, w, cin), (k, cout, s, p), mode in (
            ("res2_3x3", (64, 56, 56, 64), (3, 64, 1, 1), "stats"),
            ("res2_3x3", (64, 56, 56, 64), (3, 64, 1, 1), "affine_relu"),
            ("stem_7x7", (64, 224, 224, 3), (7, 64, 2, 3), "stats")):
        x = torch.randn(n, h, w, cin, generator=gen, device=dev)
        wt = torch.randn(k, k, cin, cout, generator=gen, device=dev) * (
            2.0 / (k * k * cin)) ** 0.5
        if mode == "stats":
            kw = dict(stats=True)
        else:
            kw = dict(scale=1 + 0.1 * torch.randn(cout, generator=gen,
                                                  device=dev),
                      shift=0.1 * torch.randn(cout, generator=gen,
                                              device=dev), act="relu")
        m = n * nn_ops.conv_out(h, k, s, p) * nn_ops.conv_out(w, k, s, p)
        xl = x.permute(0, 3, 1, 2)               # channels_last NCHW view
        wl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        macs = (n * in_range_taps(h, k, s, p) * in_range_taps(w, k, s, p)
                * cin * cout)
        rows.append(gemm_row(
            "conv2d_direct",
            "paddle_tpu_torch/ops/kernels/csrc/conv2d_direct.cu",
            "paddle_tpu/ops/pallas/tpp/conv.py:240",
            {label: [n, h, w, cin, k, cout, s, p], "epilogue": mode},
            CV.fwd_raw(x, wt, (s, s), (p, p), **kw),
            CV.fwd_raw_reference(x, wt, (s, s), (p, p), **kw), m,
            lambda: CV.fwd_raw(x, wt, (s, s), (p, p), **kw),
            lambda: CV.fwd_raw_reference(x, wt, (s, s), (p, p), **kw),
            lambda: F.conv2d(xl, wl, None, s, p),
            # x, w, y, and (sum, sumsq) out or (scale, shift) in
            4.0 * (x.numel() + wt.numel() + m * cout + 2 * cout),
            2.0 * macs, timer))
        del x, xl
    torch.cuda.synchronize()
    return rows


def check_conv_backward(dev) -> dict:
    """The backward of every conv on the training path (``CV.
    conv_input_grads``: cuDNN's dx and dw on NCHW views of the NHWC
    tensors) at the port's f32 policy, against the same call in float64 on
    the CPU, at res2's 3x3 and the stem: relative norm error of dx and dw
    <= CONV_BWD_RTOL.  The same call with TF32 allowed in cuDNN is the
    planted fault that must exceed it."""
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import conv as CV

    gen = torch.Generator().manual_seed(5)
    out = {"phase": "conv_backward", "limit": CONV_BWD_RTOL}
    for label, (n, h, w, cin), (k, cout, s, p) in (
            ("res2_3x3", (8, 56, 56, 64), (3, 64, 1, 1)),
            ("stem_7x7", (4, 224, 224, 3), (7, 64, 2, 3))):
        x = torch.randn(n, h, w, cin, generator=gen)
        wt = torch.randn(k, k, cin, cout, generator=gen) * (
            2.0 / (k * k * cin)) ** 0.5
        dy = torch.randn(n, nn_ops.conv_out(h, k, s, p),
                         nn_ops.conv_out(w, k, s, p), cout, generator=gen)
        want = CV.conv_input_grads(x.double(), wt.double(), dy.double(),
                                   (s, s), (p, p))
        row = {"shape": [n, h, w, cin, k, cout, s, p]}
        for mode in ("f32", "tf32_control"):
            torch.backends.cudnn.allow_tf32 = mode == "tf32_control"
            try:
                got = CV.conv_input_grads(x.to(dev), wt.to(dev), dy.to(dev),
                                          (s, s), (p, p))
            finally:
                set_f32_policy()
            row[mode] = max(rel_norm(g, r) for g, r in zip(got, want))
        out[label] = row
        if not (row["f32"] <= CONV_BWD_RTOL < row["tf32_control"]):
            raise AssertionError(f"conv backward vs f64: {out}")
    return out


def fine_buckets() -> tuple:
    """1%-geometric bucket edges from 0.01 ms to ~100 s, so histogram
    percentiles are exact to ~1%."""
    return tuple(0.01 * 1.01 ** i for i in range(1620))


def serve_end_to_end(dev) -> tuple[dict, int, int]:
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.ops.kernels import paged_attention as PA
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    from paddle_tpu_torch.telemetry import MetricsRegistry

    cfg = T.TransformerConfig(
        vocab_size=50257, num_layers=12, num_heads=12, embed_dim=768,
        mlp_dim=3072, max_seq_len=2048, dtype=torch.float32, remat=False,
        attn_impl="flash")
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(params)
    scfg = ServingConfig(max_slots=32, page_size=16, max_prompt_len=512,
                         max_new_tokens=64, prefill_batch=8,
                         num_pages=32 * 36 + 1, seed=0)
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(0, cfg.vocab_size, size=n))
               for n in rng.integers(16, 513, size=72)]
    temps = [0.0] * 64 + [0.8] * 8

    # warm-up on its own engine: cuBLAS handles, allocator, the kernels'
    # first loads — set-up cost, kept out of the measured run
    ServingEngine(cfg, params, scfg, registry=MetricsRegistry("warmup"),
                  device=dev).generate(prompts[:2], max_new_tokens=2)
    setup_s = time.perf_counter() - t0

    reg = MetricsRegistry("chip_smoke")
    for name in ("serve_prefill_ms", "serve_decode_step_ms"):
        reg.histogram(name, buckets=fine_buckets())
    eng = ServingEngine(cfg, params, scfg, registry=reg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    FA.KERNEL.launches = 0
    PA.KERNEL.launches = 0
    t0 = time.perf_counter()
    ids = [eng.submit(p, temperature=tt) for p, tt in zip(prompts, temps)]
    eng.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    flash_n, paged_n = FA.KERNEL.launches, PA.KERNEL.launches
    got = {r.id: r for r in eng.results()}

    if sorted(got) != sorted(ids):
        raise AssertionError(f"served {len(got)} of {len(ids)} requests")
    for r in got.values():
        if len(r.tokens) != scfg.max_new_tokens or r.finish_reason != "length":
            raise AssertionError(f"request {r.id}: {len(r.tokens)} tokens, "
                                 f"{r.finish_reason}")
    prefills = reg.get("serve_prefill_ms").summary()["count"]
    steps = reg.get("serve_decode_step_ms").summary()["count"]
    if flash_n != cfg.num_layers * prefills or flash_n == 0:
        raise AssertionError(f"flash launches {flash_n} != "
                             f"{cfg.num_layers} x {prefills} prefill passes")
    if paged_n != cfg.num_layers * steps or paged_n == 0:
        raise AssertionError(f"paged launches {paged_n} != "
                             f"{cfg.num_layers} x {steps} decode steps")
    for rid in ids[:2]:   # greedy requests: tokens = full-context argmax
        r = got[rid]
        full = torch.tensor([r.prompt + r.tokens], device=dev)
        logits = T.forward(cfg, params, full)
        if not torch.isfinite(logits).all():
            raise AssertionError("non-finite logits")
        want = logits[0, len(r.prompt) - 1:-1].argmax(-1).tolist()
        if r.tokens != want:
            raise AssertionError(f"request {rid}: engine tokens differ from "
                                 "the full-context argmax")
    ttft = np.array([got[i].metrics["ttft_ms"] for i in ids])
    new_tokens = sum(len(r.tokens) for r in got.values())
    return ({"phase": "serve", "params": n_params, "requests": len(ids),
             "new_tokens": new_tokens,
             "prompt_tokens": sum(len(p) for p in prompts),
             "wall_s": wall, "tokens_per_s": new_tokens / wall,
             "ttft_ms_p50": float(np.percentile(ttft, 50)),
             "ttft_ms_p99": float(np.percentile(ttft, 99)),
             "decode_step_ms_p50":
                 reg.get("serve_decode_step_ms").percentile(50),
             "prefill_ms_p50": reg.get("serve_prefill_ms").percentile(50),
             "prefill_passes": prefills, "decode_steps": steps,
             "flash_launches": flash_n, "paged_launches": paged_n,
             "max_memory_allocated_bytes":
                 torch.cuda.max_memory_allocated(dev),
             "setup_s": setup_s}, flash_n, paged_n)


def kernel_class(name: str) -> str:
    """Coarse class of a device kernel by its (mangled) name."""
    low = name.lower()
    for mine in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "paged",
                 "bilstm_fwd", "lstm_fwd", "lstm_bwd", "bigru_fwd",
                 "gru_fwd", "gru_bwd", "ctc_fwd_bwd", "ctc_decode"):
        if mine in low:
            return f"{mine} (ours)"
    if "::scatter_add_kernel(" in low:    # csrc/embedding.cu
        return "embedding_scatter_add (ours)"
    if "::gather_kernel(" in low:
        return "embedding_gather (ours)"
    if "radixsort" in low or "sort" in low:
        return "sort/unique (library)"
    if "brgemma" in low:
        return "brgemm (ours)"
    if "conva" in low:
        return "conv2d_direct (ours)"
    if "::partial_kernel(" in low or "::finish_kernel(" in low:
        return "channel_stats (ours)"     # csrc/channel_stats.cu
    if "stats_reduce" in low:
        return "stats_reduce (ours)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(k in low for k in ("dgrad", "wgrad", "cudnn", "convolve")):
        return "cudnn conv backward"
    if "gemm" in low or "splitk" in low:
        return "other gemm (cuBLAS/cuDNN)"
    return "elementwise and reductions"


def profile_window(fn, steps: int, split: str | None = None) -> dict:
    """Device time by kernel class over ``fn()`` (``steps`` train steps)
    under ``torch.profiler``; busy = the sum of kernel times (one stream).
    The kernels launched inside the ``record_function`` ranges named
    ``split`` form a class of their own.  The profiler's own host cost
    inflates the traced wall many times over, so the caller sets the idle
    share against an untraced step.  An empty trace reports "not
    measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_class: dict[str, float] = {}
    kernels = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or not e.self_device_time_total:
            continue
        if e.key.startswith("train_step/"):
            continue     # a range's device-side span, not a kernel
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms / steps
        kernels.append((ms / steps, e.count // steps, e.key[:100], cls))
    if not kernels:
        return {"steps": steps, "device_time": "not measured"}
    if split:
        moved = range_device_ms(prof, split, steps)
        for cls, ms in moved.items():
            by_class[cls] -= ms
        by_class[split] = sum(moved.values())
    busy = sum(by_class.values())
    kernels.sort(reverse=True)
    return {"steps": steps, "traced_wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy,
            "kernels_per_step": sum(k[1] for k in kernels),
            "by_class_ms_per_step": by_class,
            "top_kernels": [{"ms_per_step": k[0], "per_step": k[1],
                             "name": k[2], "class": k[3]}
                            for k in kernels[:12]]}


#: the GRU kernels' names in a trace, by the launch ``device_ms`` reads
GRU_KERNEL_NAMES = {"bi": "bigru_fwd_kernel", "fwd": "::gru_fwd_kernel",
                    "remat": "gru_bwd_kernel<true",
                    "stored": "gru_bwd_kernel<false"}


def device_ms(fns, key: str, rounds: int = 5):
    """The device time of one launch of the kernel whose name holds
    ``key``, averaged over ``rounds`` calls of each of ``fns`` under
    ``torch.profiler``: the kernel's own time, without the wrapper's
    weight packing and allocations (and without an L2 flush).  None when
    the trace holds no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            for fn in fns:
                fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and key in e.key]
    n = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / n if n else None


def witness_ratio(start: dict, wide: dict, got: dict) -> tuple:
    """The worst leaf of an f32 step against the f64 witness: per leaf
    ||got - wide|| / max(||wide - start||, STEP_FLOOR * u * sqrt(size)),
    u the per-element RMS of the whole f64 update.  The floor keeps a leaf
    whose exact update is zero from dividing by round-off: conv1's BN
    shift is one (pool1's maxima are positive, so a shift of it reaches
    res2_1's two 1x1 convs as a constant that their BNs remove).  Returns
    (ratio, leaf, the same ratio over all leaves at once)."""
    sq = sum(float(np.sum((wide[n] - start[n]) ** 2)) for n in wide)
    u = (sq / sum(wide[n].size for n in wide)) ** 0.5
    worst, err_sq = (0.0, ""), 0.0
    for n in wide:
        err = float(np.linalg.norm(got[n] - wide[n]))
        err_sq += err * err
        den = max(float(np.linalg.norm(wide[n] - start[n])),
                  STEP_FLOOR * u * wide[n].size ** 0.5)
        worst = max(worst, (err / den, n))
    return worst + ((err_sq / sq) ** 0.5,)


def train_end_to_end(dev) -> tuple[dict, int, int]:
    """ResNet-50 through the v2 flow: the CPU-vs-card step, then the
    batch-64 run and ``test``, with exact launch counts."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    bs, steps, side, classes = 64, 10, 224, 1000
    t0 = time.perf_counter()
    reset_name_counters()
    cost = paddle.models.image.resnet_cost(depth=50, class_num=classes,
                                           height=side, width=side)[0]
    created = paddle.parameters.create(cost)   # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    rng = np.random.default_rng(0)

    def batches(k, b):
        return [[(rng.standard_normal(3 * side * side, dtype=np.float32),
                  int(rng.integers(0, classes))) for _ in range(b)]
                for _ in range(k)]

    def trainer(where):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / bs), device=where)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return costs

    # (a) one step at batch 2 from the same parameters: the CPU's plain
    # twins and the card's kernels, both f32, each held against a float64
    # step on the CPU (the witness).  The witness's own move under a 1e-6
    # relative nudge of the input is measured beside them: at full depth
    # the step is that sensitive (pool1's max routing, amplified through
    # 16 BN blocks), so f32 round-off alone moves it by a few percent.  A
    # card step whose BN backward drops the batch mean's term is the
    # planted fault the limit must catch.
    small = batches(1, 2)
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape,
                                                    dtype=np.float32)), y)
              for x, y in small[0]]
    witness = trainer("cpu")
    p64, s64, c64 = witness.step_f64(small[0])
    start = (carried, {k: v.numpy() for k, v in witness.states.items()})
    p_n, s_n, c_n = witness.step_f64(nudged)
    sides = {"f64_nudged": (c_n, p_n, s_n)}
    del witness
    plain_bn = CV.bn_act_train

    def bn_mean_term_dropped(y_conv, gamma, beta, eps, act):
        mean, var = nn_ops.moments(y_conv)
        return CV.bn_apply(y_conv, mean.detach(), var, gamma, beta, eps, act)

    for label, where in (("cpu", "cpu"), ("card", dev), ("card_rerun", dev),
                         ("card_bn_vjp_control", dev)):
        tr = trainer(where)
        if label == "card_bn_vjp_control":
            CV.bn_act_train = bn_mean_term_dropped
        try:
            c = run(tr, small)[0]
        finally:
            CV.bn_act_train = plain_bn
        sides[label] = (c, {n: tr.parameters[n] for n in carried},
                        {k: v.cpu().numpy() for k, v in tr.states.items()})
        del tr
    # the card's step repeats bit for bit: the kernels' stats use no
    # atomics and cuDNN is held to deterministic algorithms
    (c_a, p_a, s_a), (c_b, p_b, s_b) = sides["card"], sides["card_rerun"]
    if not (c_a == c_b and all(np.array_equal(p_a[n], p_b[n]) for n in p_a)
            and all(np.array_equal(s_a[k], s_b[k]) for k in s_a)):
        raise AssertionError("the card's train step is not bit-identical "
                             "on a rerun")
    del sides["card_rerun"]
    witness_rows = {}
    for label, (c, p_side, s_side) in sides.items():
        pr, pn, pg = witness_ratio(start[0], p64, p_side)
        sr, sn, sg = witness_ratio(start[1], s64, s_side)
        witness_rows[label] = {
            "cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
            "param_worst": pr, "param_worst_leaf": pn, "param_global": pg,
            "state_worst": sr, "state_worst_leaf": sn, "state_global": sg}
    for label in ("cpu", "card"):
        w = witness_rows[label]
        if not (np.isfinite(w["cost"]) and w["cost_rel_err"] <= STEP_COST_RTOL
                and max(w["param_worst"], w["state_worst"])
                <= STEP_LEAF_LIMIT):
            raise AssertionError(f"{label} f32 step vs the f64 witness "
                                 f"(cost {c64}): {witness_rows}")
    control = witness_rows["card_bn_vjp_control"]
    if max(control["param_worst"], control["state_worst"]) <= STEP_LEAF_LIMIT:
        raise AssertionError("the f64 witness limit does not catch a BN "
                             f"backward without its mean term: {witness_rows}")

    # (b) the batch-64 run, after 2 warm-up steps (allocator growth, the
    # kernels' first loads, cuDNN handles: set-up)
    tr = trainer(dev)
    warm, data, test_data = batches(2, bs), batches(steps, bs), batches(2, bs)
    traced = batches(3, bs)
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    BR.KERNEL.launches = 0
    CV.KERNEL.launches = 0
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    br_n, cv_n = BR.KERNEL.launches, CV.KERNEL.launches
    peak = torch.cuda.max_memory_allocated(dev)
    if (br_n, cv_n) != (36 * steps, 17 * steps):
        raise AssertionError(f"train launches brgemm {br_n}, conv {cv_n} != "
                             f"36 x {steps}, 17 x {steps}")
    if len(costs) != steps or not all(np.isfinite(costs)):
        raise AssertionError(f"train costs {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    profile = profile_window(lambda: run(tr, traced), len(traced))

    # (c) what deterministic cuDNN costs: steps in blocks of 5 with it on,
    # off, off, on, so a drift of the machine falls on both sides
    det_ms: dict[bool, list] = {True: [], False: []}
    for det in (True, False, False, True):
        torch.backends.cudnn.deterministic = det
        marks.clear()
        run(tr, data[:5], stamp)
        det_ms[det] += [1e3 * (b - a) for a, b in marks.values()]
    set_f32_policy()

    # (d) test on 2 batches: the eval epilogue (affine + ReLU)
    BR.KERNEL.launches = 0
    CV.KERNEL.launches = 0
    result = tr.test(reader=lambda: iter(test_data))
    test_n = (BR.KERNEL.launches, CV.KERNEL.launches)
    if test_n != (36 * 2, 17 * 2) or not np.isfinite(result.cost):
        raise AssertionError(f"test launches {test_n} != 72, 34 or cost "
                             f"{result.cost}")
    if "device_busy_ms_per_step" in profile:
        profile["idle_share_vs_step_p50"] = (
            1 - profile["device_busy_ms_per_step"] / np.percentile(step_ms, 50))
    return ({"phase": "train", "model": "resnet50", "params":
             int(sum(v.size for v in carried.values())),
             "step_vs_f64_witness": {"batch": 2, "cost_f64": c64,
                                     "limit": STEP_LEAF_LIMIT,
                                     **witness_rows,
                                     "card_rerun_bit_identical": True},
             "batch": bs, "steps": steps, "wall_s": wall,
             "img_per_s": bs * steps / wall,
             "step_ms_p50": float(np.percentile(step_ms, 50)),
             "step_ms": step_ms, "costs": costs,
             "max_memory_allocated_bytes": peak,
             "train_launches": {"brgemm": br_n, "conv2d_direct": cv_n},
             "test_launches": {"brgemm": test_n[0],
                               "conv2d_direct": test_n[1]},
             "test_batches": 2, "test_cost": result.cost,
             "cudnn_deterministic_step_ms": {
                 "on_p50": float(np.percentile(det_ms[True], 50)),
                 "off_p50": float(np.percentile(det_ms[False], 50)),
                 "on": det_ms[True], "off": det_ms[False]},
             "setup_s": setup_s, "profile": profile}, br_n, cv_n)


def named_leaves(tree_, prefix="") -> dict:
    """{"blocks/wq": leaf, ...} of a nested params dict."""
    out = {}
    for k in sorted(tree_):
        if isinstance(tree_[k], dict):
            out.update(named_leaves(tree_[k], f"{prefix}{k}/"))
        else:
            out[prefix + k] = tree_[k]
    return out


def range_device_ms(prof, name: str, steps: int) -> dict:
    """{kernel class: device ms per step} of the kernels launched inside
    the ``record_function`` ranges called ``name``."""
    from torch.autograd import DeviceType

    out: dict[str, float] = {}

    def walk(e):
        for k in e.kernels:
            cls = kernel_class(k.name)
            out[cls] = out.get(cls, 0.0) + k.duration / 1e3 / steps
        for c in e.cpu_children:
            walk(c)

    for e in prof.events():
        if e.name == name and e.device_type == DeviceType.CPU:
            walk(e)
    return out


def train_lm(dev) -> tuple[dict, tuple]:
    """The GPT-2-small-shape LM through ``transformer.build_train_step``
    in f32 with Adam: the batch-2 step against a float64 witness, a
    bit-identical rerun, then 10 timed steps at batch 16 x 1024 with
    exact launch counts and a 3-step profile."""
    from paddle_tpu_torch.core import tree
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.models import transformer as T
    from paddle_tpu_torch.ops.kernels import flash_attention as FA
    from paddle_tpu_torch.optimizer import Adam

    cfg = T.TransformerConfig(
        vocab_size=50257, num_layers=12, num_heads=12, embed_dim=768,
        mlp_dim=3072, max_seq_len=2048, dtype=torch.float32, remat=False,
        attn_impl="flash")
    bs, seqlen, steps = 16, 1024, 10
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator().manual_seed(0), dev)
    n_params = T.count_params(params)
    rng = np.random.default_rng(0)

    # (a) one step at batch 2 x 128 from the same weights: the card's
    # kernels in f32 and the CPU's plain twins in f32, each against the
    # CPU's plain twins in float64 (the witness), by the loss and every
    # gradient leaf (Adam's first update is about lr * sign(g), which
    # round-off can flip, so the gradient is what is compared).  The same
    # card step with TF32 allowed in cuBLAS, and with the flash backward's
    # delta dropped, are the planted faults the limit must catch.
    small = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(2, 129)))

    def cast(dtype, where):
        return tree.unflatten(params, [p.detach().to(where, dtype)
                                       for p in tree.leaves(params)])

    loss64, g64 = T.loss_and_grads(cfg, cast(torch.float64, "cpu"), small)
    g64 = named_leaves(g64)
    sides = {"cpu": T.loss_and_grads(cfg, cast(torch.float32, "cpu"),
                                     small)}
    plain_delta = FA._delta

    def card_step():
        return T.loss_and_grads(cfg, params, small.to(dev))

    sides["card"] = card_step()
    rerun = card_step()
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["card_tf32_control"] = card_step()
    finally:
        set_f32_policy()
    FA._delta = lambda do, o: torch.zeros_like(plain_delta(do, o))
    try:
        sides["card_delta_dropped_control"] = card_step()
    finally:
        FA._delta = plain_delta
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(a, b) for a, b in zip(tree.leaves(rerun[1]),
                                              tree.leaves(sides["card"][1])))):
        raise AssertionError("the card's LM step is not bit-identical on a "
                             "rerun")
    witness = {"batch": [2, 128], "loss_f64": float(loss64),
               "loss_rtol": LM_LOSS_RTOL, "grad_limit": LM_GRAD_LIMIT,
               "card_rerun_bit_identical": True}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(x, g64[n])
                  for n, x in named_leaves(grads).items()}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"loss": float(loss),
                          "loss_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst,
                          "grad_median": float(np.median(list(
                              ratios.values())))}
    del sides, rerun, g64
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["loss_rel_err"] <= LM_LOSS_RTOL
                and w["grad_worst"] <= LM_GRAD_LIMIT):
            raise AssertionError(f"{label} LM step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "card_delta_dropped_control"):
        if witness[label]["grad_worst"] <= LM_GRAD_LIMIT:
            raise AssertionError(f"the LM witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) the timed run: Adam lr 1e-4 with bf16 moments (as the repo's LM
    # benchmark), 2 warm-up steps (allocator growth, cuBLAS handles:
    # set-up), then 10 steps on one fixed batch with the launch counts
    # zeroed just before and read just after
    opt = Adam(learning_rate=1e-4, moment_dtype=torch.bfloat16)
    state = opt.init_tree(params)
    step = T.build_train_step(cfg, opt)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                        size=(bs, seqlen + 1))).to(dev)
    losses = []
    for _ in range(2):
        params, state, loss = step(params, state, ids)
        losses.append(float(loss))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    kernels = (FA.KERNEL, FA.KERNEL_BWD_DQ, FA.KERNEL_BWD_DKV)
    for k in kernels:
        k.launches = 0
    step_ms = []
    t1 = time.perf_counter()
    for _ in range(steps):
        a = time.perf_counter()
        params, state, loss = step(params, state, ids)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - a))
        losses.append(float(loss))
    wall = time.perf_counter() - t1
    launches = tuple(k.launches for k in kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != (cfg.num_layers * steps,) * 3:
        raise AssertionError(f"LM train launches (fwd, dq, dkv) {launches} "
                             f"!= {cfg.num_layers} x {steps} each")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"LM losses not finite and falling: {losses}")

    # (c) 3 steps under torch.profiler: device time by kernel class, the
    # optimizer's kernels (its record_function range) split out; the step
    # updates params and state in place
    prof = profile_window(lambda: [step(params, state, ids)
                                   for _ in range(3)], 3,
                          split="train_step/optimizer")
    p50 = float(np.percentile(step_ms, 50))
    tokens = bs * seqlen
    flops = (6.0 * n_params * tokens + 12.0 * cfg.num_layers * bs * seqlen
             * seqlen * cfg.embed_dim / 2)        # bench.py's count
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    out = {"phase": "train_lm", "model": "transformer LM, GPT-2-small shape",
           "params": n_params, "dtype": "float32", "adam_moments": "bfloat16",
           "lr": 1e-4, "step_vs_f64_witness": witness,
           "batch": [bs, seqlen], "steps": steps, "wall_s": wall,
           "tokens_per_s": tokens * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "losses": losses,
           "flop_per_step": flops,
           "mfu_f32_vs_67tflops": flops / (p50 / 1e3) / F32_FLOPS_PER_S,
           "max_memory_allocated_bytes": peak,
           "train_launches": dict(zip(("flash_fwd", "flash_bwd_dq",
                                       "flash_bwd_dkv"), launches)),
           "setup_s": setup_s, "profile": prof}
    del params, state
    return out, launches


TEXT_LOSS_RTOL = 1e-5    # f32 text step vs the f64 witness: loss,
TEXT_GRAD_LIMIT = 1e-4   # per leaf ||g32 - g64|| / ||g64||


def text_classifier(hidden: int, vocab: int, embed: int):
    """``bench.py``'s ``_lstm_classify_cost`` in the port: embedding ->
    fc(4 * hidden, linear) -> lstmemory -> last_seq -> fc(2, softmax) ->
    classification_cost."""
    import paddle_tpu_torch as paddle

    L, A, D = paddle.layer, paddle.activation, paddle.data_type
    data = L.data(name="data", type=D.integer_value_sequence(vocab))
    net = L.embedding(input=data, size=embed)
    net = L.fc(input=net, size=hidden * 4, act=A.LinearActivation())
    net = L.lstmemory(input=net)
    net = L.last_seq(input=net)
    net = L.fc(input=net, size=2, act=A.SoftmaxActivation())
    label = L.data(name="label", type=D.integer_value(2))
    return L.classification_cost(input=net, label=label)


def check_text_kernels(dev, timer, b=64, t=128, d=1280, length=100,
                       n_ids=8192, vocab=30000, embed=128) -> tuple:
    """The text path's kernels at its shapes, each against its plain twin
    (max abs error <= TOL * max(1, |ref|)): the LSTM forward (no gates
    slab, as the card's remat path runs it) and backward (remat, and the
    stored-gates form, which must give the same bits) at B 64, T 128,
    D 1280 with lengths 100; the gather of 8,192 ids from [30000, 128]
    and the table gradient (zeros plus the scatter-add of 8,192 rows), a
    rerun bit-identical.  Library yardsticks: cuDNN's ``nn.LSTM``
    (no peepholes, input projection included; the fc plus the kernel is
    timed beside it), ``F.embedding`` and its backward."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=dev).manual_seed(7)
    lens = torch.full((b,), length, device=dev)
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = torch.zeros(b, d, device=dev)
    c0 = torch.zeros(b, d, device=dev)
    dhs = torch.randn(b, t, d, generator=gen, device=dev)
    dh_t, dc_t = torch.zeros(b, d, device=dev), torch.zeros(b, d, device=dev)

    def worst(got, want):
        e = 0.0
        for x, y in zip(got, want):
            err = (x - y).abs().max().item()
            if not err <= TOL * max(1.0, y.abs().max().item()):
                raise AssertionError(f"text kernel vs plain: {err}")
            e = max(e, err)
        return e

    fwd = lambda: LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, False)
    fwd_plain = lambda: LK._fwd_plain(xw, mask, w_h, peep, h0, c0, False,
                                      False)
    hs, cs, _, _, _ = got = fwd()
    fwd_err = worst([g for g in got if g is not None],
                    [w for w in fwd_plain() if w is not None])
    gates = LK._fwd_kernel(xw, mask, w_h, peep, h0, c0, False, True)[2]
    args = (mask, w_h, peep, h0, c0, hs, cs, dhs, dh_t, dc_t, False)
    bwd = lambda: LK._bwd_kernel(xw, None, *args, True)
    remat = bwd()
    stored = LK._bwd_kernel(None, gates, *args, False)
    again = bwd()
    torch.cuda.synchronize()
    if not all(torch.equal(x, y) and torch.equal(x, z)
               for x, y, z in zip(remat, stored, again)):
        raise AssertionError("lstm backward: remat, stored gates and a rerun "
                             "differ in bits on the card")
    bwd_plain = lambda: LK._bwd_plain(xw, None, *args, True)
    bwd_err = worst(remat, bwd_plain())
    del gates, stored, again

    # yardsticks: cuDNN's LSTM over the 128-wide embeddings, and the
    # port's fc (x @ W_x + b) plus the forward kernel over the same input
    x_emb = torch.randn(b, t, embed, generator=gen, device=dev)
    w_x = torch.randn(embed, 4 * d, generator=gen, device=dev) / embed ** 0.5
    bias = torch.zeros(4 * d, device=dev)
    cudnn = torch.nn.LSTM(embed, d, batch_first=True).to(dev)
    x_lib = x_emb.clone().requires_grad_()
    out_lib, _ = cudnn(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *cudnn.parameters())
    def lib_fwd():
        with torch.no_grad():
            return cudnn(x_emb)

    fc_fwd = lambda: LK._fwd_kernel(
        (x_emb.reshape(-1, embed) @ w_x + bias).reshape(b, t, 4 * d), mask,
        w_h, peep, h0, c0, False, False)
    steps = float(lens.sum().item())          # the steps the data needs
    cell = 25.0 * steps * d                   # gate bundle per unit-step
    f32 = 4.0
    rows = [{
        "name": "lstm_seq_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:489",
        "shape": [b, t, d], "max_abs_err": fwd_err,
        "ms": timer(fwd), "plain_ms": timer(fwd_plain),
        # xw, W_h, peep, h0, c0, mask in; hs, cs, h_T, c_T out
        "bytes_flops": (f32 * (b * t * 4 * d + d * 4 * d + 3 * d + 4 * b * d
                               + b * t + 2 * b * t * d),
                        2.0 * steps * d * 4 * d + cell),
        "library_ms": timer(lib_fwd),
        "fc_plus_kernel_ms": timer(fc_fwd)}, {
        "name": "lstm_seq_bwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:426",
        "shape": [b, t, d], "max_abs_err": bwd_err,
        "ms": timer(bwd), "plain_ms": timer(bwd_plain),
        # xw, mask, W_h, peep, h0, c0, hs, cs, dhs, dh_T, dc_T in; dgates,
        # dh0, dc0, dpeep out; the remat product and dgates @ W_h^T
        "bytes_flops": (f32 * (2 * b * t * 4 * d + d * 4 * d + 6 * d
                               + 6 * b * d + b * t + 3 * b * t * d),
                        4.0 * steps * d * 4 * d + 2 * cell),
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}]
    del xw, dhs, hs, cs, remat, out_lib, g_lib, lib_params, x_lib, cudnn

    ids = torch.randint(0, vocab, (n_ids,), generator=gen, device=dev)
    table = torch.randn(vocab, embed, generator=gen, device=dev)
    ct = torch.randn(n_ids, embed, generator=gen, device=dev)
    uniq = float(torch.unique(ids).numel())
    got = EK.embedding_gather(table, ids)
    torch.cuda.synchronize()
    if not torch.equal(got, EK.embedding_gather_reference(table, ids)):
        raise AssertionError("gather kernel differs from its twin")
    grad = EK.table_grad(ids, ct, vocab)
    if not torch.equal(grad, EK.table_grad(ids, ct, vocab)):
        raise AssertionError("table gradient: a rerun differs in bits")
    zeros = torch.zeros(vocab, embed, device=dev)
    scatter_err = worst([grad], [EK.embedding_scatter_add_reference(
        zeros, ids, ct)])
    rows += [{
        "name": "embedding_gather", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:120",
        "shape": [n_ids, vocab, embed], "unique_ids": int(uniq),
        "max_abs_err": 0.0,
        "ms": timer(lambda: EK.embedding_gather(table, ids)),
        "plain_ms": timer(lambda: EK.embedding_gather_reference(table, ids)),
        # the unique rows read once, every output row written, the ids
        "bytes_flops": (f32 * (uniq + n_ids) * embed + 8.0 * n_ids, 0.0),
        "library_ms": timer(lambda: F.embedding(ids, table))}, {
        "name": "embedding_scatter_add", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/embedding.cu",
        "replaces": "paddle_tpu/ops/pallas/tpp/embedding.py:192",
        "shape": [n_ids, vocab, embed], "unique_ids": int(uniq),
        "max_abs_err": scatter_err,
        # as the backward runs it: zeros, the sort by id, the kernel
        "ms": timer(lambda: EK.table_grad(ids, ct, vocab)),
        "plain_ms": timer(lambda: EK.embedding_scatter_add_reference(
            torch.zeros(vocab, embed, device=dev), ids, ct)),
        # the cotangent rows and ids read, the dense gradient written
        "bytes_flops": (f32 * (n_ids * embed + vocab * embed) + 8.0 * n_ids,
                        float(n_ids * embed)),
        "library_ms": timer(lambda: torch.ops.aten.embedding_dense_backward(
            ct, ids, vocab, -1, False))}]
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"))
    summary = {"phase": "text_kernels", "tol": TOL,
               "lstm_bwd_remat_stored_rerun_bit_identical": True,
               "table_grad_rerun_bit_identical": True,
               "gather_bit_identical_to_twin": True}
    torch.cuda.synchronize()
    return rows, summary


def text_loss_and_grads(topo, cost_name, params, feed):
    """(loss, {name: gradient}) of one train-mode forward of ``topo``."""
    leaves = {n: p.detach().requires_grad_() for n, p in params.items()}
    values, _ = topo.forward(leaves, {}, feed, True)
    loss = values[cost_name]
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), dict(zip(leaves, grads))


def train_text(dev, hidden=1280, vocab=30000, embed=128, bs=64, seqlen=100,
               steps=10) -> tuple[dict, tuple]:
    """The LSTM text classifier through the v2 flow (``bench_lstm``'s
    configuration): the batch-2 step against a float64 witness, then
    2 warm-up and ``steps`` timed ``trainer.SGD`` steps at batch 64 with
    exact launch counts, a bit-identical rerun, a 3-step profile, and
    ``test`` on 2 batches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import lstm as LK
    from paddle_tpu_torch.reader.feeder import DataFeeder

    t0 = time.perf_counter()
    reset_name_counters()
    cost = text_classifier(hidden, vocab, embed)
    topo = Topology(cost)
    created = paddle.parameters.create(cost)       # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the LSTM's gate biases and peepholes start at 0; make them nonzero
    # so the witness sees every term of the cell
    rng = np.random.default_rng(0)
    for n in carried:
        if n.startswith("___lstmemory") and n.endswith(".wbias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def batches(k, b, lo=seqlen, hi=seqlen):
        return [[(rng.integers(0, vocab, size=int(rng.integers(lo, hi + 1))
                               ).tolist(), int(rng.integers(0, 2)))
                 for _ in range(b)] for _ in range(k)]

    # (a) one step at batch 2 with ragged lengths (T = 16 after bucketing)
    # from the same weights: the card's kernels in f32 and the CPU's plain
    # twins in f32, each against the CPU's plain twins in float64, by the
    # loss and every gradient leaf.  TF32 allowed in cuBLAS on the card,
    # and a CPU backward whose dc carry drops its peephole terms, are the
    # planted faults the limit must catch.
    small = batches(1, 2, 7, 12)[0]
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}

    def side(where, dtype=torch.float32):
        feed = DataFeeder(types, device=where)(small)
        params = {n: torch.from_numpy(v).to(where, dtype)
                  for n, v in carried.items()}
        return text_loss_and_grads(topo, cost.name, params, feed)

    loss64, g64 = side("cpu", torch.float64)
    sides = {"cpu": side("cpu"), "card": side(dev)}
    rerun = side(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        sides["card_tf32_control"] = side(dev)
    finally:
        set_f32_policy()
    plain_bwd = LK._bwd_plain

    def dc_peephole_dropped(xw, gates, mask, w_h, peep, *rest):
        keep_o = torch.tensor([[0.0], [0.0], [1.0]], dtype=peep.dtype)
        return plain_bwd(xw, gates, mask, w_h, peep * keep_o, *rest)

    LK._bwd_plain = dc_peephole_dropped
    try:
        sides["cpu_dc_peephole_dropped_control"] = side("cpu")
    finally:
        LK._bwd_plain = plain_bwd
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's text step is not bit-identical on "
                             "a rerun")
    witness = {"batch": 2, "lengths": [len(x) for x, _ in small],
               "loss_f64": float(loss64), "loss_rtol": TEXT_LOSS_RTOL,
               "grad_limit": TEXT_GRAD_LIMIT}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(grads[n], g64[n]) for n in g64}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"loss": float(loss),
                          "loss_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst}
    del sides, rerun, g64
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["loss_rel_err"] <= TEXT_LOSS_RTOL
                and w["grad_worst"] <= TEXT_GRAD_LIMIT):
            raise AssertionError(f"{label} text step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "cpu_dc_peephole_dropped_control"):
        if witness[label]["grad_worst"] <= TEXT_GRAD_LIMIT:
            raise AssertionError(f"the text witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) trainer.SGD at the bench's configuration: Adam 2e-3 with bf16
    # moments, batch 64 of 100-token sequences (T = 128 after bucketing)
    def trainer():
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Adam(
                learning_rate=2e-3, moment_dtype=torch.bfloat16),
            device=dev)

    def run(tr, data, handler=None):
        out = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                out.append((e.cost, e.metrics[
                    "classification_error_evaluator"]))
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return out

    warm, data, test_data = batches(2, bs), batches(steps, bs), batches(2, bs)
    one = [data[0]]
    first = [trainer() for _ in range(2)]
    reruns = [(run(tr, one), {n: tr.parameters[n] for n in carried})
              for tr in first]
    if not (reruns[0][0] == reruns[1][0] and all(
            np.array_equal(reruns[0][1][n], reruns[1][1][n])
            for n in carried)):
        raise AssertionError("trainer.SGD's first text step is not "
                             "bit-identical on a rerun")
    del first, reruns
    tr = trainer()
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = (LK.KERNEL_FWD, LK.KERNEL_BWD, EK.KERNEL_GATHER,
               EK.KERNEL_SCATTER)
    for k in kernels:
        k.launches = 0
    t1 = time.perf_counter()
    events = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = tuple(k.launches for k in kernels)
    peak = torch.cuda.max_memory_allocated(dev)
    if launches != (steps,) * 4:
        raise AssertionError(f"text train launches (lstm fwd, bwd, gather, "
                             f"scatter-add) {launches} != {steps} each")
    losses = [c for c, _ in events]
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"text train losses {losses}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    traced = batches(3, bs)
    prof = profile_window(lambda: run(tr, traced), 3)
    for k in kernels:
        k.launches = 0
    result = tr.test(reader=lambda: iter(test_data))
    test_n = tuple(k.launches for k in kernels)
    if test_n != (2, 0, 2, 0) or not np.isfinite(result.cost):
        raise AssertionError(f"text test launches {test_n} != (2, 0, 2, 0) "
                             f"or cost {result.cost}")
    p50 = float(np.percentile(step_ms, 50))
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    out = {"phase": "train_text", "model": "LSTM text classifier "
           "(bench.py _lstm_classify_cost)", "params": n_params,
           "hidden": hidden, "vocab": vocab, "embed": embed,
           "dtype": "float32", "adam_moments": "bfloat16", "lr": 2e-3,
           "step_vs_f64_witness": witness, "rerun_bit_identical": True,
           "batch": bs, "tokens_per_sequence": seqlen,
           "bucketed_T": tr._feeder(None)(data[0])["data"].max_len,
           "steps": steps, "wall_s": wall,
           "sequences_per_s": bs * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "losses": losses,
           "classification_error": [m for _, m in events],
           "max_memory_allocated_bytes": peak,
           "train_launches": dict(zip(("lstm_fwd", "lstm_bwd", "gather",
                                       "scatter_add"), launches)),
           "test_launches": dict(zip(("lstm_fwd", "lstm_bwd", "gather",
                                      "scatter_add"), test_n)),
           "test_batches": 2, "test_cost": result.cost,
           "test_metrics": result.metrics, "setup_s": setup_s,
           "profile": prof}
    return out, launches


CRNN_COST_RTOL = 1e-5    # f32 CRNN step vs the f64 witness: cost, and per
CRNN_LEAF_FLOOR = 1e-4   # leaf the witness ratio's least limit (see below)


def crnn_feed_batches(rng, k, bs, classes):
    """``bench_crnn``'s synthetic batches: N(0, 1) 32x96 images and labels
    of 5 ids (the feeder pads the label slot to its bucket, 16)."""
    return [[(rng.standard_normal(32 * 96, dtype=np.float32),
              rng.integers(0, classes, size=5).tolist())
             for _ in range(bs)] for _ in range(k)]


def check_crnn_kernels(dev, timer, b=64, t=24, e=256, d=64, v=27, l=16,
                       label_len=5) -> tuple:
    """The OCR CRNN's kernels at its shapes, each against its plain twin
    (max abs error <= TOL * max(1, |ref|); the decode bit for bit), a rerun
    bit-identical: the BiLSTM forward (x [64, 24, 256], D 64, both
    directions); the LSTM backward kernel in the remat form the BiLSTM's
    backward launches, once per direction, over the forward's own hs/cs
    and the recomputed projection (xw [64, 24, 256]); the CTC
    forward-backward on log-probs [64, 24, 27] with
    labels of 5 in a 16-slot (S = 33), in both ``normalize`` forms; the
    greedy decode of the same slab; and the direct conv with the BN
    statistics epilogue at the CRNN's two 3x3 convs (conv1's Cin = 1).
    Library yardsticks: cuDNN's bidirectional ``nn.LSTM`` (input
    projection included, no peepholes) and the backward of its
    one-direction form, ``F.ctc_loss`` forward and
    backward by the log-probs, and ``torch.argmax`` over the slab (the
    decode's read floor; no single call decodes)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import ctc as ctc_ops
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=dev).manual_seed(8)
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)  # noqa: E731

    def worst(got, want, what):
        err = 0.0
        for x, y in zip(got, want):
            if x is None:
                continue
            m = (x - y).abs().max().item()
            if not m <= TOL * max(1.0, y.abs().max().item()):
                raise AssertionError(f"{what} kernel vs plain: {m}")
            err = max(err, m)
        return err

    # the BiLSTM forward: zero initial states, every row the full T
    x = rnd(b, t, e)
    mask = torch.ones(b, t, device=dev)
    zeros = torch.zeros(b, d, device=dev)
    fw, bw = ((rnd(e, 4 * d, k=e ** -0.5), rnd(4 * d, k=0.1),
               rnd(d, 4 * d, k=d ** -0.5), rnd(3, d, k=0.3), zeros, zeros)
              for _ in range(2))
    bi = lambda: LK._bi_fwd_kernel(x, mask, fw, bw)  # noqa: E731
    bi_plain = lambda: LK._bi_fwd_plain(x, mask, fw, bw)  # noqa: E731
    got, again = bi(), bi()
    torch.cuda.synchronize()
    if not all(torch.equal(p, q) for g, a in zip(got, again)
               for p, q in zip(g, a)):
        raise AssertionError("bilstm kernel: a rerun differs in bits")
    bi_err = max(worst(g, w, "bilstm") for g, w in zip(got, bi_plain()))
    cudnn = torch.nn.LSTM(e, d, batch_first=True, bidirectional=True).to(dev)

    def lib_lstm():
        with torch.no_grad():
            return cudnn(x)

    # the LSTM backward kernel as the BiLSTM's backward launches it: remat,
    # over the recomputed projection and the forward kernel's hs/cs, with
    # a random cotangent on hs and zeros on (h_T, c_T), once per direction
    bwd_calls, bwd_err = {}, 0.0
    for (w_x, bias, w_h, peep, h0, c0), (hs, cs, _, _), reverse in (
            (fw, got[0], False), (bw, got[1], True)):
        xw = LK._project_xw(x, w_x, bias)
        args = (mask, w_h, peep, h0, c0, hs, cs, rnd(b, t, d), zeros, zeros,
                reverse)
        bwd_calls[reverse] = (
            lambda xw=xw, args=args: LK._bwd_kernel(xw, None, *args, True),
            lambda xw=xw, args=args: LK._bwd_plain(xw, None, *args, True))
        first, rerun = bwd_calls[reverse][0](), bwd_calls[reverse][0]()
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(first, rerun)):
            raise AssertionError("lstm backward at the crnn shapes: a rerun "
                                 "differs in bits")
        bwd_err = max(bwd_err, worst(first, bwd_calls[reverse][1](),
                                     "lstm backward (crnn)"))
    del first, rerun
    cudnn1 = torch.nn.LSTM(e, d, batch_first=True).to(dev)
    x_lib = x.clone().requires_grad_()
    out_lib, _ = cudnn1(x_lib)
    g_lib = torch.randn_like(out_lib)
    lib_params = (x_lib, *cudnn1.parameters())

    steps = float(mask.sum().item())          # row-steps of one direction
    f32 = 4.0
    cell = 25.0 * steps * d                   # gate bundle per unit-step
    bwd_ms = {r: timer(calls[0]) for r, calls in bwd_calls.items()}
    bwd_plain_ms = {r: timer(calls[1]) for r, calls in bwd_calls.items()}
    rows = [{
        "name": "bilstm_seq", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bilstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:934",
        "shape": [b, t, e, d], "max_abs_err": bi_err,
        "ms": timer(bi), "plain_ms": timer(bi_plain),
        # x, mask, both directions' W_x, b, W_h, peep, h0, c0 in; hs, cs,
        # h_T, c_T of both out.  The products over the valid row-steps of
        # both directions, and the cell
        "bytes_flops": (f32 * (b * t * e + b * t + 2 * (e * 4 * d + 4 * d
                                                        + d * 4 * d + 3 * d
                                                        + 2 * b * d)
                               + 2 * (2 * b * t * d + 2 * b * d)),
                        2 * (2.0 * steps * (e + d) * 4 * d + cell)),
        "library_ms": timer(lib_lstm)}, {
        "name": "lstm_seq_bwd_crnn", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/lstm_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/lstm.py:426",
        "shape": [b, t, d], "max_abs_err": bwd_err,
        # one launch: the mean of the two directions' times
        "ms": (bwd_ms[False] + bwd_ms[True]) / 2,
        "plain_ms": (bwd_plain_ms[False] + bwd_plain_ms[True]) / 2,
        "ms_by_direction": {"forward": bwd_ms[False],
                            "reverse": bwd_ms[True]},
        # xw, mask, W_h, peep, h0, c0, hs, cs, dhs, dh_T, dc_T in; dgates,
        # dh0, dc0, dpeep out; the remat product and dgates @ W_h^T
        "bytes_flops": (f32 * (2 * b * t * 4 * d + d * 4 * d + 6 * d
                               + 6 * b * d + b * t + 3 * b * t * d),
                        4.0 * steps * d * 4 * d + 2 * cell),
        # cuDNN's one-direction LSTM backward (input and weight gradients)
        "library_ms": timer(lambda: torch.autograd.grad(
            out_lib, lib_params, g_lib, retain_graph=True))}]
    del got, again, cudnn, cudnn1, bwd_calls, out_lib, g_lib, lib_params
    del x_lib

    # the CTC forward-backward and the decode, on one log-prob slab
    lp = torch.log_softmax(rnd(b, t, v, k=2.0), -1)
    labels = torch.zeros(b, l, dtype=torch.int64, device=dev)
    labels[:, :label_len] = torch.randint(0, v - 1, (b, label_len),
                                          generator=gen, device=dev)
    ilen = torch.full((b,), t, dtype=torch.int64, device=dev)
    llen = torch.full((b,), label_len, dtype=torch.int64, device=dev)
    ext, valid, skip = ctc_ops.ctc_tables(labels, llen, v - 1)
    tables = (ext, skip, valid, ilen.to(torch.int32), llen.to(torch.int32))
    ctc_err = 0.0
    for normalize, slab in ((False, lp), (True, rnd(b, t, v, k=2.0))):
        got, again = (KC._fwd_bwd_kernel(slab, *tables, normalize)
                      for _ in range(2))
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError("ctc kernel: a rerun differs in bits")
        ctc_err = max(ctc_err, worst(got, KC._fwd_bwd_plain(
            slab, *tables, normalize), "ctc"))
    lp_lib = lp.detach().transpose(0, 1).contiguous().requires_grad_()

    def lib_ctc():
        loss = F.ctc_loss(lp_lib, labels, ilen, llen, blank=v - 1,
                          reduction="sum")
        return torch.autograd.grad(loss, (lp_lib,))

    best, keep = KC._decode_kernel(lp, ilen, v - 1)
    want = KC._decode_plain(lp, ilen, v - 1)
    torch.cuda.synchronize()
    if not (torch.equal(best, want[0]) and torch.equal(keep, want[1])):
        raise AssertionError("ctc decode kernel differs from its twin")
    s = ext.shape[1]
    rows += [{
        "name": "ctc_loss_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/ctc.cu",
        "replaces": "paddle_tpu/ops/pallas/ctc.py:248",
        "shape": [b, t, v, s], "max_abs_err": ctc_err,
        "ms": timer(lambda: KC._fwd_bwd_kernel(lp, *tables, False)),
        "plain_ms": timer(lambda: KC._fwd_bwd_plain(lp, *tables, False)),
        # the slab in, its gradient out, the tables and lengths, the losses;
        # the recursions' log-adds are a few flops per (t, s): bytes bound
        "bytes_flops": (f32 * (2 * b * t * v + 3 * b * s + 3 * b),
                        2 * 12.0 * b * t * s),
        "library_ms": timer(lib_ctc)}, {
        "name": "ctc_greedy_decode_fused", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/ctc.cu",
        "replaces": "paddle_tpu/ops/pallas/ctc.py:310",
        "shape": [b, t, v], "max_abs_err": 0.0,
        "ms": timer(lambda: KC._decode_kernel(lp, ilen, v - 1)),
        "plain_ms": timer(lambda: KC._decode_plain(lp, ilen, v - 1)),
        # the slab and the lengths in, the ids and the keep mask out
        "bytes_flops": (f32 * (b * t * v + b + 2 * b * t), float(b * t * v)),
        "library_ms": timer(lambda: torch.argmax(lp, dim=2))}]
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"))

    # the direct conv at the CRNN's two 3x3 s1 p1 shapes, BN stats epilogue
    conv_err = 0.0
    for shape, cout in (((b, 32, 96, 1), 16), ((b, 16, 48, 16), 32)):
        xc = rnd(*shape)
        wc = rnd(3, 3, shape[-1], cout, k=0.3)
        got = CV.fwd_raw(xc, wc, (1, 1), (1, 1), stats=True)
        again = CV.fwd_raw(xc, wc, (1, 1), (1, 1), stats=True)
        want = CV.fwd_raw_reference(xc, wc, (1, 1), (1, 1), stats=True)
        torch.cuda.synchronize()
        if not all(torch.equal(p, q) for p, q in zip(got, again)):
            raise AssertionError("crnn conv: a rerun differs in bits")
        count = got[0].numel() // cout
        conv_err = max(conv_err, worst(
            [got[0], got[1] / count, got[2] / count],
            [want[0], want[1] / count, want[2] / count], "crnn conv"))
    summary = {"phase": "crnn_kernels", "tol": TOL,
               "reruns_bit_identical": True,
               "decode_bit_identical_to_twin": True,
               "ctc_normalize_forms": [False, True],
               "conv2d_direct_crnn_shapes_max_abs_err": conv_err}
    torch.cuda.synchronize()
    return rows, summary


def train_crnn(dev, bs=64, steps=10) -> tuple[dict, tuple]:
    """The OCR CRNN through the v2 flow (``bench_crnn``'s configuration):
    the batch-2 step against a float64 witness, ``trainer.SGD`` at batch
    64 with exact launch counts and a profile, ``paddle.infer`` and
    ``ocr_crnn.ctc_decode`` with exact launch counts, then the slow JAX
    test's convergence recipe."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import ocr_crnn
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV
    from paddle_tpu_torch.ops.kernels import ctc as KC
    from paddle_tpu_torch.ops.kernels import lstm as LK

    classes, rnn = 26, 64
    t0 = time.perf_counter()
    reset_name_counters()
    cost, probs, order = ocr_crnn.crnn_ctc_cost(num_classes=classes,
                                                rnn_size=rnn)
    feeding = {n: i for i, n in enumerate(order)}
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the BiLSTM's gate biases and peepholes start at 0; make them nonzero
    # so the witness sees every term of the cell
    rng = np.random.default_rng(0)
    for n in carried:
        if n.startswith("_crnn_bilstm") and n.endswith(".wbias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def trainer(where, opt=None):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=opt or paddle.optimizer.Adam(
                learning_rate=1e-3, moment_dtype=torch.bfloat16),
            device=where)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h,
                 feeding=feeding)
        return costs

    # (a) one step at batch 2 from the same parameters: the CPU's plain
    # twins and the card's kernels, both f32, each held against a float64
    # step on the CPU (``SGD.step_f64``) by the cost and, per parameter
    # and BN statistic, ||x32 - x64|| / ||x64 - x0||.  The witness step
    # takes plain SGD at lr 1, so its update is the gradient itself
    # (Adam's first update is lr * sign(g), blind to the gradient's
    # error, and a small lr would drown it in the f32 rounding of the
    # update).  The float64 step's own move under a 1e-6 relative nudge of
    # the input sets the limit: 10x that move, at least CRNN_LEAF_FLOOR.
    # TF32 allowed on the card, and a CPU CTC twin whose beta recursion
    # drops the s-2 skip, are the planted faults that must exceed it.
    small = crnn_feed_batches(rng, 1, 2, classes)[0]
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape,
                                                    dtype=np.float32)), y)
              for x, y in small]
    sgd = lambda: paddle.optimizer.SGD(learning_rate=1.0)  # noqa: E731
    witness = trainer("cpu", sgd())
    p64, s64, c64 = witness.step_f64(small, feeding)
    start = (carried, {k: v.numpy() for k, v in witness.states.items()})
    p_n, s_n, c_n = witness.step_f64(nudged, feeding)
    sides = {"f64_nudged": (c_n, p_n, s_n)}
    del witness
    plain_shift = KC._shift_left

    def beta_skip_dropped(a, k, fill):
        out = plain_shift(a, k, fill)
        return torch.zeros_like(out) if out.dtype == torch.bool else out

    for label, where in (("cpu", "cpu"), ("card", dev), ("card_rerun", dev),
                         ("card_tf32_control", dev),
                         ("cpu_ctc_beta_skip_dropped_control", "cpu")):
        tr = trainer(where, sgd())
        if label == "card_tf32_control":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        if label.startswith("cpu_ctc"):
            KC._shift_left = beta_skip_dropped
        try:
            c = run(tr, [small])[0]
        finally:
            set_f32_policy()
            KC._shift_left = plain_shift
        sides[label] = (c, {n: tr.parameters[n] for n in carried},
                        {k: v.cpu().numpy() for k, v in tr.states.items()})
        del tr
    (c_a, p_a, s_a), (c_b, p_b, s_b) = sides["card"], sides.pop("card_rerun")
    if not (c_a == c_b and all(np.array_equal(p_a[n], p_b[n]) for n in p_a)
            and all(np.array_equal(s_a[k], s_b[k]) for k in s_a)):
        raise AssertionError("the card's CRNN step is not bit-identical on a "
                             "rerun")
    witness_rows = {}
    for label, (c, p_side, s_side) in sides.items():
        pr, pn, pg = witness_ratio(start[0], p64, p_side)
        sr, sn, sg = witness_ratio(start[1], s64, s_side)
        witness_rows[label] = {
            "cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
            "param_worst": pr, "param_worst_leaf": pn, "param_global": pg,
            "state_worst": sr, "state_worst_leaf": sn, "state_global": sg,
            "worst": max(pr, sr)}
    limit = max(CRNN_LEAF_FLOOR, 10 * witness_rows["f64_nudged"]["worst"])
    for label in ("cpu", "card"):
        w = witness_rows[label]
        if not (np.isfinite(w["cost"]) and w["cost_rel_err"] <= CRNN_COST_RTOL
                and w["worst"] <= limit):
            raise AssertionError(f"{label} CRNN step vs the f64 witness "
                                 f"(cost {c64}, limit {limit}): "
                                 f"{witness_rows}")
    for label in ("card_tf32_control", "cpu_ctc_beta_skip_dropped_control"):
        if witness_rows[label]["worst"] <= limit:
            raise AssertionError(f"the CRNN witness limit {limit} does not "
                                 f"catch {label}: {witness_rows}")

    # (b) trainer.SGD at bench_crnn's configuration: Adam 1e-3 with bf16
    # moments, batch 64, 2 warm-up steps (set-up), 10 timed steps with the
    # launch counts zeroed just before and read just after
    tr = trainer(dev)
    warm, data = (crnn_feed_batches(rng, k, bs, classes) for k in (2, steps))
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = {"conv2d_direct": CV.KERNEL, "bilstm_fwd": LK.KERNEL_BI,
               "lstm_fwd": LK.KERNEL_FWD, "lstm_bwd": LK.KERNEL_BWD,
               "ctc_fwd_bwd": KC.KERNEL_LOSS, "ctc_decode": KC.KERNEL_DECODE,
               "brgemm": BR.KERNEL}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    zero()
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"conv2d_direct": 2, "bilstm_fwd": 1, "lstm_fwd": 0,
            "lstm_bwd": 2, "ctc_fwd_bwd": 1, "ctc_decode": 0, "brgemm": 0}
    if train_n != {n: c * steps for n, c in want.items()}:
        raise AssertionError(f"CRNN train launches {train_n} != {want} "
                             f"x {steps}")
    if not (len(costs) == steps and all(np.isfinite(costs))
            and costs[-1] < costs[0]):
        raise AssertionError(f"CRNN costs not finite and falling: {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    traced = crnn_feed_batches(rng, 3, bs, classes)
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)

    # (c) paddle.infer on 64 samples, then the greedy decode: one BiLSTM
    # forward, the two convs (eval epilogue) and one decode launch
    samples = crnn_feed_batches(rng, 1, bs, classes)[0]
    zero()
    out = paddle.infer(output_layer=probs, parameters=tr.parameters,
                       input=samples, feeding=feeding, device=dev)
    lp = torch.log(torch.from_numpy(np.stack(out)).to(dev) + 1e-9)
    lens = torch.full((len(out),), lp.shape[1], dtype=torch.int64, device=dev)
    ids, ids_len = ocr_crnn.ctc_decode(lp, lens, blank=classes)
    torch.cuda.synchronize()
    infer_n = counts()
    want_infer = dict(want, bilstm_fwd=1, lstm_bwd=0, ctc_fwd_bwd=0,
                      ctc_decode=1)
    if infer_n != want_infer or ids.shape != (bs, lp.shape[1]):
        raise AssertionError(f"CRNN infer/decode launches {infer_n} != "
                             f"{want_infer} or ids {tuple(ids.shape)}")
    del tr

    # (d) the slow JAX test's convergence recipe (tests/test_ocr_crnn.py):
    # 8 classes, rnn_size 32, Adam 3e-3, 25 passes of 512 synthetic
    # samples at batch 32; the last cost under 5% of the first, and the
    # greedy decode of 16 fresh samples (seed 123) exact on >= 13
    reset_name_counters()
    c8, p8, o8 = ocr_crnn.crnn_ctc_cost(num_classes=8, rnn_size=32)
    feed8 = {n: i for i, n in enumerate(o8)}
    tr8 = paddle.trainer.SGD(
        cost=c8, parameters=paddle.parameters.create(c8),
        update_equation=paddle.optimizer.Adam(learning_rate=3e-3),
        device=dev)
    reader = ocr_crnn.synthetic_ocr_reader(n_samples=512, num_classes=8)
    conv_costs = []
    t2 = time.perf_counter()
    tr8.train(reader=paddle.batch(reader, 32), num_passes=25,
              feeding=feed8,
              event_handler=lambda e: conv_costs.append(e.cost)
              if isinstance(e, paddle.event.EndIteration) else None)
    conv_s = time.perf_counter() - t2
    fresh = list(ocr_crnn.synthetic_ocr_reader(n_samples=16, num_classes=8,
                                               seed=123)())
    out8 = paddle.infer(output_layer=p8, parameters=tr8.parameters,
                        input=fresh, feeding=feed8, device=dev)
    lp8 = torch.log(torch.from_numpy(np.stack(out8)).to(dev) + 1e-9)
    dec, dec_len = ocr_crnn.ctc_decode(
        lp8, torch.full((16,), lp8.shape[1], dtype=torch.int64, device=dev),
        blank=8)
    dec, dec_len = dec.cpu().numpy(), dec_len.cpu().numpy()
    exact = sum(dec[i, :dec_len[i]].tolist() == labels
                for i, (_, labels) in enumerate(fresh))
    if not (conv_costs[-1] < 0.05 * conv_costs[0] and exact >= 13):
        raise AssertionError(f"CRNN convergence: cost {conv_costs[0]} -> "
                             f"{conv_costs[-1]}, {exact}/16 decoded exactly")
    del tr8

    result = {"phase": "train_crnn",
              "model": "OCR CRNN (models/ocr_crnn.crnn_ctc_cost, bench_crnn)",
              "params": n_params, "image": [32, 96, 1], "classes": classes,
              "rnn_size": rnn, "dtype": "float32", "adam_moments": "bfloat16",
              "lr": 1e-3,
              "step_vs_f64_witness": {"batch": 2, "cost_f64": c64,
                                      "optimizer": "SGD lr 1",
                                      "limit": limit,
                                      "card_rerun_bit_identical": True,
                                      **witness_rows},
              "batch": bs, "steps": steps, "wall_s": wall,
              "samples_per_s": bs * steps / wall, "step_ms_p50": p50,
              "step_ms": step_ms, "costs": costs,
              "max_memory_allocated_bytes": peak,
              "train_launches": train_n, "infer_launches": infer_n,
              "infer_samples": bs, "decoded_mean_len":
                  float(ids_len.float().mean().item()),
              "convergence": {"classes": 8, "rnn_size": 32, "lr": 3e-3,
                              "passes": 25, "samples": 512, "batch": 32,
                              "steps": len(conv_costs), "seconds": conv_s,
                              "first_cost": conv_costs[0],
                              "last_cost": conv_costs[-1],
                              "decoded_exact": f"{exact}/16"},
              "setup_s": setup_s, "profile": prof}
    return result, (train_n["bilstm_fwd"], train_n["lstm_bwd"],
                    train_n["ctc_fwd_bwd"], infer_n["ctc_decode"])


NMT_COST_RTOL = 1e-5     # f32 NMT step vs the f64 witness: cost, and per
NMT_GRAD_FLOOR = 1e-4    # gradient leaf ||g32 - g64|| / ||g64||' least limit


def nmt_inputs(dev, gen, b, t, e, d):
    """x [b, t, e], a mask with half the rows full and half ragged (a
    length-1 row among them) and both directions' (w_x, b, w_h, w_hc,
    h0)."""
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)  # noqa: E731
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    mask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    dirs = [(rnd(e, 3 * d, k=e ** -0.5), rnd(3 * d, k=0.1),
             rnd(d, 2 * d, k=d ** -0.5), rnd(d, d, k=d ** -0.5),
             rnd(b, d, k=0.5)) for _ in range(2)]
    return rnd(b, t, e), mask, dirs[0], dirs[1]


def check_nmt_kernels(dev, timer, b=64, t=32, e=512, d=512) -> tuple:
    """The NMT's kernels at its shapes (B 64, T 32, E = D = 512, half the
    rows full and half ragged), each against its plain twin (max abs error
    <= TOL * max(1, |ref|)) with a rerun bit-identical: the BiGRU forward
    (both directions, x @ W_x + b inside); the GRU forward (no gate slab,
    as the card runs it), the GRU backward in its remat form (the BiGRU's
    backward launches it once per direction) and in its stored-gates form
    (which must give the remat form's bits), each over both directions'
    inputs (reverse off and on) and timed per launch, with its own device
    time from a trace beside the wrapper's.  Library yardstick: cuDNN's
    ``nn.GRU``, which is NOT the same cell (its reset gate acts after the
    candidate product, r * (h W_hn + b_hn); the gate order is [r, z, n])
    and includes the input projection: bidirectional for the BiGRU row,
    one direction forward and backward for the GRU rows."""
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    gen = torch.Generator(device=dev).manual_seed(9)
    x, mask, fw, bw = nmt_inputs(dev, gen, b, t, e, d)

    def worst(got, want, what):
        err = 0.0
        for g, w in zip(got, want):
            if g is None:
                continue
            m = (g - w).abs().max().item()
            if not m <= TOL * max(1.0, w.abs().max().item()):
                raise AssertionError(f"{what} kernel vs plain: {m}")
            err = max(err, m)
        return err

    def same_bits(a, c, what):
        if not all(torch.equal(p, q) for p, q in zip(a, c)
                   if p is not None):
            raise AssertionError(f"{what}: a rerun differs in bits")

    bi = lambda: GK._bi_fwd_kernel(x, mask, fw, bw)  # noqa: E731
    bi_plain = lambda: GK._bi_fwd_plain(x, mask, fw, bw)  # noqa: E731
    got, again = bi(), bi()
    torch.cuda.synchronize()
    same_bits([p for g in got for p in g], [p for a in again for p in a],
              "bigru forward")
    bi_err = max(worst(g, w, "bigru") for g, w in zip(got, bi_plain()))

    # the GRU kernels over each direction's projected input, as the
    # BiGRU's backward launches them: fw with reverse off, bw with reverse
    # on; the backward over the forward kernel's hs, with a random
    # cotangent on hs and zeros on h_T
    calls, dh_t = {}, torch.zeros(b, d, device=dev)
    fwd_err = bwd_err = stored_err = 0.0
    for (w_x, bias, w_h, w_hc, h0), reverse in ((fw, False), (bw, True)):
        xw = LK._project_xw(x, w_x, bias)
        fa = (xw, mask, w_h, w_hc, h0, reverse)
        got = GK._fwd_kernel(*fa, False)
        same_bits(got, GK._fwd_kernel(*fa, False), "gru forward")
        fwd_err = max(fwd_err, worst(got, GK._fwd_plain(*fa, False),
                                     "gru forward"))
        hs, urc, _ = GK._fwd_kernel(*fa, True)
        if not torch.equal(hs, got[0]):
            raise AssertionError("gru forward: the gate slab changes hs")
        args = (mask, w_h, w_hc, h0, hs,
                torch.randn(b, t, d, generator=gen, device=dev), dh_t,
                reverse)
        calls[reverse] = {
            "fwd": (lambda fa=fa: GK._fwd_kernel(*fa, False),
                    lambda fa=fa: GK._fwd_plain(*fa, False)),
            "remat": (
                lambda xw=xw, a=args: GK._bwd_kernel(xw, None, *a, True),
                lambda xw=xw, a=args: GK._bwd_plain(xw, None, *a, True)),
            "stored": (
                lambda u=urc, a=args: GK._bwd_kernel(None, u, *a, False),
                lambda u=urc, a=args: GK._bwd_plain(None, u, *a, False))}
        remat, stored = calls[reverse]["remat"], calls[reverse]["stored"]
        r1, r2, s1, s2 = remat[0](), remat[0](), stored[0](), stored[0]()
        torch.cuda.synchronize()
        same_bits(r1, r2, "gru backward (remat)")
        same_bits(s1, s2, "gru backward (stored)")
        same_bits(r1, s1, "gru backward: remat vs stored gates")
        bwd_err = max(bwd_err, worst(r1, remat[1](), "gru backward"))
        stored_err = max(stored_err, worst(s1, stored[1](),
                                           "gru backward (stored)"))
        del r1, r2, s1, s2, got
    del again

    def per_launch(kind):
        """(mean ms of a launch over both directions, ms by direction,
        the twin's mean ms, the kernel's own device ms a launch)."""
        ms = {r: timer(c[kind][0]) for r, c in calls.items()}
        plain = [timer(c[kind][1]) for c in calls.values()]
        own = device_ms([c[kind][0] for c in calls.values()],
                        GRU_KERNEL_NAMES[kind])
        return ((ms[False] + ms[True]) / 2,
                {"forward": ms[False], "reverse": ms[True]},
                sum(plain) / 2, own)

    # yardsticks: cuDNN's GRU (another cell), bidirectional over x, and one
    # direction over a D-wide input, forward and backward
    cudnn_bi = torch.nn.GRU(e, d, batch_first=True, bidirectional=True).to(dev)
    cudnn1 = torch.nn.GRU(d, d, batch_first=True).to(dev)
    x1 = torch.randn(b, t, d, generator=gen, device=dev).requires_grad_()
    out1, _ = cudnn1(x1)
    g1 = torch.randn_like(out1)
    lib_params = (x1, *cudnn1.parameters())

    def lib_bi():
        with torch.no_grad():
            return cudnn_bi(x)

    def lib_fwd():
        with torch.no_grad():
            return cudnn1(x1)

    steps = float(mask.sum().item())          # row-steps of one direction
    f32 = 4.0
    cell = 20.0 * steps * d                   # gate bundle per unit-step
    rec = 2.0 * steps * 3 * d * d             # h W_h and (r h) W_hc
    io = f32 * (b * t + 2 * d * d + d * d + b * d)   # mask, W_h, W_hc, h0
    lib_note = "cuDNN nn.GRU: not the same cell"
    lib_bwd = lambda: torch.autograd.grad(  # noqa: E731
        out1, lib_params, g1, retain_graph=True)
    gru_bwd_bytes = (f32 * (2 * b * t * 3 * d + 3 * b * t * d + 2 * b * d)
                     + io)
    rows = [{
        "name": "bigru_seq_fwd", "route": "cuda",
        "source": "paddle_tpu_torch/ops/kernels/csrc/bigru_seq.cu",
        "replaces": "paddle_tpu/ops/pallas/gru.py:663",
        "shape": [b, t, e, d], "max_abs_err": bi_err,
        "ms": timer(bi), "plain_ms": timer(bi_plain),
        "kernel_only_ms": device_ms([bi], GRU_KERNEL_NAMES["bi"]),
        # x, mask, both directions' W_x, b, W_h, W_hc, h0 in; hs and h_T of
        # both out.  The three products over the valid row-steps of both
        # directions, and the cell
        "bytes_flops": (f32 * (b * t * e + b * t
                               + 2 * (e * 3 * d + 3 * d + 3 * d * d + b * d)
                               + 2 * (b * t * d + b * d)),
                        2 * (2.0 * steps * e * 3 * d + rec + cell)),
        "library_ms": timer(lib_bi), "library_note": lib_note}]
    for kind, name, line, lib, bytes_flops in (
            # xw, mask, W_h, W_hc, h0 in; hs, h_T out
            ("fwd", "gru_seq_fwd", 311, lib_fwd,
             (f32 * (b * t * 3 * d + b * t * d + b * d) + io, rec + cell)),
            # xw, mask, W_h, W_hc, h0, hs, dhs, dh_T in; dxw, dh0, r*h
            # out; the recomputed products, dc W_hc^T and [du, dr] W_h^T
            ("remat", "gru_seq_bwd_remat", 279, lib_bwd,
             (gru_bwd_bytes, 2 * rec + 2 * cell)),
            # urc instead of xw, the same outputs; only the two transposed
            # products
            ("stored", "gru_seq_bwd_stored", 232, lib_bwd,
             (gru_bwd_bytes, rec + cell))):
        ms, by_dir, plain_ms, own = per_launch(kind)
        rows.append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/ops/kernels/csrc/gru_seq.cu",
            "replaces": f"paddle_tpu/ops/pallas/gru.py:{line}",
            "shape": [b, t, d], "max_abs_err": {
                "fwd": fwd_err, "remat": bwd_err, "stored": stored_err}[kind],
            # one launch: the mean of the two directions' times
            "ms": ms, "ms_by_direction": by_dir, "plain_ms": plain_ms,
            "kernel_only_ms": own, "bytes_flops": bytes_flops,
            "library_ms": timer(lib), "library_note": lib_note})
    for row in rows:
        row["bound_ms"], row["bound_by"] = bound(*row.pop("bytes_flops"))
    summary = {"phase": "nmt_kernels", "tol": TOL,
               "lengths": "half full (32), half ragged, one of length 1",
               "gru_directions": "forward (fw weights), reverse (bw weights)",
               "reruns_bit_identical": True,
               "gru_bwd_remat_equals_stored_bits": True,
               "gate_slab_leaves_hs_bits": True}
    del cudnn_bi, cudnn1, out1, g1, lib_params, x1
    torch.cuda.synchronize()
    return rows, summary


def nmt_batches(rng, k, bs, vocab, lo=32, hi=32):
    """``bench_nmt``'s synthetic batches: (source, target, next-target) id
    lists; lengths in [lo, hi] (the bench's 32), the target pair sharing
    one."""
    out = []
    for _ in range(k):
        batch = []
        for _ in range(bs):
            ls, lt = (int(rng.integers(lo, hi + 1)) for _ in range(2))
            trg = rng.integers(0, vocab, size=lt + 1)
            batch.append((rng.integers(0, vocab, size=ls).tolist(),
                          trg[:-1].tolist(), trg[1:].tolist()))
        out.append(batch)
    return out


def composed_bigru_check(dev, b=64, t=32, e=512, d=512):
    """``layer.bigru`` against the composed fw/bw ``networks.simple_gru2``
    pair (a mixed transform with bias + ``grumemory``) at the NMT's width on
    the card, on the same parameter values: the forward and every
    gradient within TOL * max(1, |ref|).  Then each ``grumemory`` of the
    pair again as its layer calls ``gru_seq``, on the pair's own gate
    inputs and weights, once with the remat backward the card runs and
    once with the stored-gates one: the same bits.  Returns (summary,
    launches by kernel)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.lod import SequenceBatch
    from paddle_tpu_torch.layers import networks
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import gru as GK

    gen = torch.Generator(device=dev).manual_seed(3)
    L, D = paddle.layer, paddle.data_type
    reset_name_counters()
    node = L.bigru(input=L.data(name="x", type=D.dense_vector_sequence(e)),
                   size=d, name="bi")
    topo = Topology(node)
    params = {s.name: 0.05 * torch.randn(*s.shape, generator=gen, device=dev)
              for s in topo.param_specs()}
    reset_name_counters()
    x2 = L.data(name="x", type=D.dense_vector_sequence(e))
    pair = [networks.simple_gru2(input=x2, size=d, name=f"bi_{k}",
                                 reverse=k == "bw", mixed_bias_attr=True)
            for k in ("fw", "bw")]
    topo2 = Topology(pair)
    if sorted(s.name for s in topo2.param_specs()) != sorted(params):
        raise AssertionError("bigru and the simple_gru2 pair name their "
                             "parameters differently")
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    feed = {"x": SequenceBatch(torch.randn(b, t, e, generator=gen,
                                           device=dev), lens)}
    ct = torch.randn(b, t, 2 * d, generator=gen, device=dev)

    def run(topology, outs):
        leaves = {n: v.clone().requires_grad_() for n, v in params.items()}
        vals, _ = topology.forward(leaves, {}, feed, True)
        out = torch.cat([vals[o].data for o in outs], dim=-1)
        grads = torch.autograd.grad((out * ct).sum(), list(leaves.values()))
        return [out.detach(), *grads], vals

    mask = feed["x"].mask(torch.float32)
    h0 = torch.zeros(b, d, device=dev)

    def grumemory_pair(vals, remat):
        """hs and the gradients of (xw, W_h, W_hc) of each direction."""
        out = []
        for k, reverse in (("fw", False), ("bw", True)):
            w = params[f"_bi_{k}.w0"]
            xw = (vals[f"bi_{k}_transform"].data.detach()
                  + params[f"_bi_{k}.wbias"])
            leaves = [xw, w[:, :2 * d].clone(), w[:, 2 * d:].clone()]
            leaves = [v.requires_grad_() for v in leaves]
            hs, _ = GK.gru_seq(leaves[0], mask, leaves[1], leaves[2], h0,
                               reverse=reverse, remat=remat)
            cot = ct[..., :d] if k == "fw" else ct[..., d:]
            out += [hs.detach(),
                    *torch.autograd.grad((hs * cot).sum(), leaves)]
        return out

    kernels = {"bigru_fwd": GK.KERNEL_BI, "gru_fwd": GK.KERNEL_FWD,
               "gru_bwd_remat": GK.KERNEL_BWD,
               "gru_bwd_stored": GK.KERNEL_BWD_STORED}
    for k in kernels.values():
        k.launches = 0
    got, _ = run(topo, ["bi"])
    want, vals = run(topo2, ["bi_fw", "bi_bw"])
    remat = grumemory_pair(vals, True)
    stored = grumemory_pair(vals, False)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
    if launches != {"bigru_fwd": 1, "gru_fwd": 6, "gru_bwd_remat": 6,
                    "gru_bwd_stored": 2}:
        raise AssertionError(f"composed check launches {launches}")
    if not all(torch.equal(p, q) for p, q in zip(remat, stored)):
        raise AssertionError("the grumemory pair: remat and stored-gates "
                             "backward differ in bits")
    if not torch.equal(torch.cat([remat[0], remat[4]], dim=-1), want[0]):
        raise AssertionError("gru_seq on the pair's inputs differs from "
                             "the pair's output")
    errs = {}
    for name, g, w in zip(["out"] + list(params), got, want):
        err = (g - w).abs().max().item()
        scale = max(1.0, w.abs().max().item())
        errs[name] = err / scale
        if not err <= TOL * scale:
            raise AssertionError(f"bigru vs the simple_gru2 pair: {name} "
                                 f"{err} (scale {scale})")
    return ({"phase": "nmt_composed_bigru_check", "batch": b, "T": t, "E": e,
             "D": d, "tol": TOL, "max_rel_err": max(errs.values()),
             "worst": max(errs, key=errs.get),
             "remat_equals_stored_bits": True,
             "gru_seq_on_the_pair_inputs_equals_the_pair_bits": True,
             "launches": launches},
            launches)


def train_nmt(dev, vocab=30000, width=512, bs=64, steps=10) -> tuple:
    """The attention NMT through the v2 flow (``bench_nmt``'s
    configuration, f32): the batch-2 step against a float64 witness, the
    first ``trainer.SGD`` step twice (bit for bit), 2 warm-up and
    ``steps`` timed steps at batch 64 with exact launch counts, a 3-step
    profile, ``test`` on 2 batches, and the composed BiGRU check."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.layers import networks
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.models import seqtoseq
    from paddle_tpu_torch.ops import rnn as rnn_ops
    from paddle_tpu_torch.ops.kernels import embedding as EK
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.reader.feeder import DataFeeder

    t0 = time.perf_counter()
    reset_name_counters()
    cost = seqtoseq.seqtoseq_net(vocab, vocab, word_vector_dim=width,
                                 encoder_size=width, decoder_size=width)
    order = ("source_language_word", "target_language_word",
             "target_language_next_word")
    feeding = {n: i for i, n in enumerate(order)}
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    # the biases start at 0; make them nonzero so the witness sees every
    # term of the cells and the softmax
    rng = np.random.default_rng(0)
    for n in carried:
        if n.endswith("bias"):
            carried[n] = (0.1 * rng.standard_normal(carried[n].shape)
                          ).astype(np.float32)
    n_params = int(sum(v.size for v in carried.values()))

    def trainer(where):
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Adam(
                learning_rate=5e-4, moment_dtype=torch.bfloat16),
            device=where)

    def run(tr, data, handler=None):
        out = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                out.append((e.cost, e.metrics[
                    "classification_error_evaluator"]))
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h,
                 feeding=feeding)
        return out

    # (a) one step at batch 2, ragged source and target lengths (T = 16
    # after bucketing), from the same parameters: the card's kernels in
    # f32 and the CPU's plain twins in f32, each against the CPU's plain
    # twins in float64, by the cost and every gradient leaf
    # (||g32 - g64|| / ||g64||).  The limit is 10x the float64 gradient's
    # own move when both embedding tables are nudged by 1e-6 relative (at
    # least NMT_GRAD_FLOOR).  TF32 allowed on the card, a CPU cell that
    # applies the reset gate after the candidate product (cuDNN's
    # convention) and an attention that does not mask the source padding
    # are planted faults that must exceed it; the card's step repeats bit
    # for bit.
    small = nmt_batches(rng, 1, 2, vocab, lo=5, hi=14)[0]
    topo = Topology(cost)
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}
    nudged = dict(carried)
    for n in ("_source_language_embedding", "_target_language_embedding"):
        nudged[n] = carried[n] * (1 + 1e-6 * rng.standard_normal(
            carried[n].shape)).astype(np.float32)

    def side(where, dtype=torch.float32, start=carried):
        feed = DataFeeder(types, feeding, device=where)(small)
        params = {n: torch.from_numpy(v).to(where, dtype)
                  for n, v in start.items()}
        return text_loss_and_grads(topo, cost.name, params, feed)

    loss64, g64 = side("cpu", torch.float64)
    sides = {"f64_nudged": side("cpu", torch.float64, nudged),
             "cpu": side("cpu"), "card": side(dev)}
    rerun = side(dev)
    plain_gates, plain_cell = GK._gates, rnn_ops.gru_cell
    plain_weights = networks._attention_weights

    def cudnn_gates(x_t, h, w_h, w_hc):
        d = h.shape[-1]
        ur = x_t[:, :2 * d] + torch.matmul(h, w_h)
        u, r = torch.sigmoid(ur[:, :d]), torch.sigmoid(ur[:, d:])
        c = torch.tanh(x_t[:, 2 * d:] + r * torch.matmul(h, w_hc))
        return u, r, c, r * h

    def cudnn_cell(xw, h, w_h, w_hc, gate_act=None, state_act=None):
        u, _, c, _ = cudnn_gates(xw, h, w_h, w_hc)
        return u * h + (1.0 - u) * c

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        sides["card_tf32_control"] = side(dev)
    finally:
        set_f32_policy()
    GK._gates, rnn_ops.gru_cell = cudnn_gates, cudnn_cell
    try:
        sides["cpu_cudnn_cell_control"] = side("cpu")
    finally:
        GK._gates, rnn_ops.gru_cell = plain_gates, plain_cell
    networks._attention_weights = (
        lambda scores, mask: plain_weights(scores, torch.ones_like(mask)))
    try:
        sides["card_unmasked_attention_control"] = side(dev)
    finally:
        networks._attention_weights = plain_weights
    if not (torch.equal(rerun[0], sides["card"][0]) and all(
            torch.equal(rerun[1][n], sides["card"][1][n]) for n in g64)):
        raise AssertionError("the card's NMT step is not bit-identical on a "
                             "rerun")
    witness = {"batch": 2, "lengths": [[len(s) for s in x[:2]]
                                       for x in small],
               "cost_f64": float(loss64), "cost_rtol": NMT_COST_RTOL}
    for label, (loss, grads) in sides.items():
        ratios = {n: rel_norm(grads[n], g64[n]) for n in g64}
        worst = max(ratios, key=ratios.get)
        witness[label] = {"cost": float(loss),
                          "cost_rel_err": abs(float(loss) - float(loss64))
                          / abs(float(loss64)),
                          "grad_worst": ratios[worst],
                          "grad_worst_leaf": worst}
    del sides, rerun, g64
    limit = max(NMT_GRAD_FLOOR, 10 * witness["f64_nudged"]["grad_worst"])
    witness["grad_limit"] = limit
    for label in ("cpu", "card"):
        w = witness[label]
        if not (w["cost_rel_err"] <= NMT_COST_RTOL
                and w["grad_worst"] <= limit):
            raise AssertionError(f"{label} NMT step vs the f64 witness: "
                                 f"{witness}")
    for label in ("card_tf32_control", "cpu_cudnn_cell_control",
                  "card_unmasked_attention_control"):
        if witness[label]["grad_worst"] <= limit:
            raise AssertionError(f"the NMT witness limit does not catch "
                                 f"{label}: {witness}")

    # (b) trainer.SGD at bench_nmt's configuration: Adam 5e-4 with bf16
    # moments, batch 64 of 32-token sequences; the first step twice from
    # the same parameters (bit for bit), then 2 warm-up steps (set-up) and
    # the timed steps with the launch counts zeroed just before and read
    # just after
    warm, data, test_data = (nmt_batches(rng, k, bs, vocab)
                             for k in (2, steps, 2))
    firsts = []
    for _ in range(2):
        tr = trainer(dev)
        firsts.append((run(tr, data[:1]),
                       {n: tr.parameters[n] for n in carried}))
        del tr
    if not (firsts[0][0] == firsts[1][0] and all(
            np.array_equal(firsts[0][1][n], firsts[1][1][n])
            for n in carried)):
        raise AssertionError("trainer.SGD's first NMT step is not "
                             "bit-identical on a rerun")
    del firsts
    tr = trainer(dev)
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = {"bigru_fwd": GK.KERNEL_BI, "gru_fwd": GK.KERNEL_FWD,
               "gru_bwd_remat": GK.KERNEL_BWD,
               "gru_bwd_stored": GK.KERNEL_BWD_STORED,
               "gather": EK.KERNEL_GATHER, "scatter_add": EK.KERNEL_SCATTER}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    zero()
    t1 = time.perf_counter()
    events = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"bigru_fwd": 1, "gru_fwd": 0, "gru_bwd_remat": 2,
            "gru_bwd_stored": 0, "gather": 2, "scatter_add": 2}
    if train_n != {n: c * steps for n, c in want.items()}:
        raise AssertionError(f"NMT train launches {train_n} != {want} x "
                             f"{steps}")
    costs = [c for c, _ in events]
    if not (len(costs) == steps and all(np.isfinite(costs))):
        raise AssertionError(f"NMT costs not finite: {costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    traced = nmt_batches(rng, 3, bs, vocab)
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    zero()
    result = tr.test(reader=lambda: iter(test_data), feeding=feeding)
    test_n = counts()
    want_test = dict(bigru_fwd=2, gru_fwd=0, gru_bwd_remat=0,
                     gru_bwd_stored=0, gather=4, scatter_add=0)
    if test_n != want_test or not np.isfinite(result.cost):
        raise AssertionError(f"NMT test launches {test_n} != {want_test} or "
                             f"cost {result.cost}")
    del tr
    torch.cuda.empty_cache()
    composed, composed_n = composed_bigru_check(dev, e=width, d=width)
    out = {"phase": "train_nmt",
           "model": "attention NMT (models/seqtoseq.seqtoseq_net, bench_nmt)",
           "params": n_params, "tensors": len(carried), "vocab": vocab,
           "width": width, "dtype": "float32", "adam_moments": "bfloat16",
           "lr": 5e-4,
           "step_vs_f64_witness": witness,
           "card_step_rerun_bit_identical": True,
           "first_step_rerun_bit_identical": True,
           "batch": bs, "tokens_per_sequence": 32, "steps": steps,
           "wall_s": wall, "sequences_per_s": bs * steps / wall,
           "step_ms_p50": p50, "step_ms": step_ms, "costs": costs,
           "classification_error": [m for _, m in events],
           "max_memory_allocated_bytes": peak, "train_launches": train_n,
           "test_launches": test_n, "test_batches": 2,
           "test_cost": result.cost, "test_metrics": result.metrics,
           "setup_s": setup_s, "profile": prof, "composed": composed}
    return out, (train_n["bigru_fwd"], composed_n["gru_fwd"],
                 train_n["gru_bwd_remat"], composed_n["gru_bwd_stored"])


VGG_COST_RTOL = 1e-5     # f32 small_vgg step vs the f64 witness: cost,
VGG_GRAD_FLOOR = 1e-4    # the gradient leaves' least limit, and
VGG_STATE_LIMIT = 1e-5   # the BN moving statistics (relative norm)
#: small_vgg's channel_stats views [R, C] at batch 128 of 32x32 images
VGG_STATS_SHAPES = ((131072, 64), (32768, 128), (8192, 256), (2048, 512),
                    (128, 512))


def check_vgg_kernels(dev, timer, shapes=VGG_STATS_SHAPES, conv_batch=64):
    """``channel_stats`` against its twin at small_vgg's five [R, C] views
    (max abs error <= 1e-4 x max(1, |ref|) for both sums, a rerun in the
    same bits), each timed beside its twin, ``torch.var_mean`` and its
    bound; then the direct conv kernel against its twin at AlexNet's conv1
    (11x11 stride 4, Cin 3, 227x227) and conv2 (5x5) at batch 64.
    Returns (the kernel row at the largest view, the phase's summary)."""
    import torch.nn.functional as F

    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import conv as CV

    gen = torch.Generator(device=dev).manual_seed(9)
    per_shape = []
    for r, c in shapes:
        x = torch.randn(r, c, generator=gen, device=dev) * 2 + 0.5
        got, again = CS.channel_stats(x), CS.channel_stats(x)
        want = CS.channel_stats_reference(x)
        err = 0.0
        for a, b, a2 in zip(got, want, again):
            rel = (a - b).abs().max().item() / max(1.0, b.abs().max().item())
            err = max(err, rel)
            if not torch.equal(a, a2):
                raise AssertionError(f"channel_stats [{r}, {c}] is not "
                                     "bit-identical on a rerun")
        if not err <= TOL:
            raise AssertionError(f"channel_stats [{r}, {c}]: kernel vs plain "
                                 f"err {err} x max(1, |ref|)")
        bound_ms, by = bound(4.0 * (r * c + 2 * c), 3.0 * r * c)
        launch = [lambda: CS.channel_stats(x)]
        per_shape.append({
            "shape": [r, c], "max_abs_err": err,
            "ms": timer(lambda: CS.channel_stats(x)),
            # the two passes' own device time from a trace (no L2 flush)
            "kernel_only_ms": (device_ms(launch, "::partial_kernel(")
                               + device_ms(launch, "::finish_kernel(")),
            "plain_ms": timer(lambda: CS.channel_stats_reference(x)),
            "bound_ms": bound_ms, "bound_by": by,
            "library_ms": timer(lambda: torch.var_mean(x, dim=0,
                                                       correction=0))})
        del x
    big = per_shape[0]
    row = {"name": "channel_stats", "route": "cuda",
           "source": "paddle_tpu_torch/ops/kernels/csrc/channel_stats.cu",
           "replaces": "paddle_tpu/ops/pallas/tpp/conv.py:87",
           "shape": big["shape"],
           "max_abs_err": max(s["max_abs_err"] for s in per_shape),
           **{k: big[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")}}
    convs = []
    for label, (n, h, w, cin), (k, cout, s, p) in (
            ("alexnet_conv1", (conv_batch, 227, 227, 3), (11, 96, 4, 1)),
            ("alexnet_conv2", (conv_batch, 27, 27, 96), (5, 256, 1, 2))):
        x = torch.randn(n, h, w, cin, generator=gen, device=dev)
        wt = torch.randn(k, k, cin, cout, generator=gen, device=dev) * (
            2.0 / (k * k * cin)) ** 0.5
        got = CV.fwd_raw(x, wt, (s, s), (p, p))
        want = CV.fwd_raw_reference(x, wt, (s, s), (p, p))
        err = (got - want).abs().max().item() / max(
            1.0, want.abs().max().item())
        if not (err <= TOL and torch.equal(got, CV.fwd_raw(x, wt, (s, s),
                                                           (p, p)))):
            raise AssertionError(f"direct conv at {label}: err {err} x "
                                 "max(1, |ref|) or not bit-identical on a "
                                 "rerun")
        oh = nn_ops.conv_out(h, k, s, p)
        macs = (n * in_range_taps(h, k, s, p) * in_range_taps(w, k, s, p)
                * cin * cout)
        xl = x.permute(0, 3, 1, 2)
        wl = wt.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        bound_ms, by = bound(4.0 * (x.numel() + wt.numel()
                                    + n * oh * oh * cout), 2.0 * macs)
        convs.append({"conv": label, "shape": [n, h, w, cin, k, cout, s, p],
                      "max_abs_err": err,
                      "ms": timer(lambda: CV.fwd_raw(x, wt, (s, s), (p, p))),
                      "plain_ms": timer(lambda: CV.fwd_raw_reference(
                          x, wt, (s, s), (p, p))),
                      "library_ms": timer(lambda: F.conv2d(xl, wl, None, s,
                                                           p)),
                      "bound_ms": bound_ms, "bound_by": by})
        del x, xl
    torch.cuda.synchronize()
    return row, {"phase": "vgg_kernels", "channel_stats": per_shape,
                 "direct_conv_new_shapes": convs,
                 "channel_stats_rerun_bit_identical": True}


def vgg_cost(paddle):
    """small_vgg over CIFAR-10 (32x32x3, 10 classes) with
    ``classification_cost``, as the book's ``train.py`` builds it."""
    from paddle_tpu_torch.layers import networks

    img = paddle.layer.data(name="image",
                            type=paddle.data_type.dense_vector(3072))
    label = paddle.layer.data(name="label",
                              type=paddle.data_type.integer_value(10))
    return paddle.layer.classification_cost(
        input=networks.small_vgg(img, 3, 10), label=label)


def vgg_witness(dev, cost, carried, small, seed=5):
    """A batch-4 small_vgg train-mode forward and backward (dropout on,
    seed ``seed``) on the card and on the CPU, each against the float64
    run on the same device (the masks are drawn in f32 from the same
    per-layer generators, so the witness drops what the step drops): the
    cost within VGG_COST_RTOL, every gradient leaf (||g32 - g64|| /
    ||g64||) within 10x the float64 gradient's own move under a 1e-6
    relative nudge of the images (at least VGG_GRAD_FLOOR), every BN
    moving statistic within VGG_STATE_LIMIT.  Batch 4, not 2: the head's
    batch norm normalizes over the rows, and two rows normalize to
    +-gamma whatever their values, with the single-pass f32 variance
    (E[x^2] - E[x]^2, the JAX package's convention) cancelling wherever
    the two are close (its output 3.5e-2 and the cost 4.9e-4 from the
    float64 run at batch 2, 2e-5 and 3e-7 at batch 4, on the CPU).  The
    conv biases that feed a batch norm (exact gradient zero) are left out
    of the gradient comparison.  TF32 on the card, dropout
    without its 1 / keep scaling and ``F.batch_norm``'s unbiased running
    variance are planted faults that must exceed those limits; the
    card's run repeats bit for bit."""
    import torch.nn.functional as F

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.config.topology import Topology
    from paddle_tpu_torch.core.dtype import set_f32_policy
    from paddle_tpu_torch.ops import nn as nn_ops
    from paddle_tpu_torch.reader.feeder import DataFeeder

    topo = Topology(cost)
    types = {n: paddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in topo.data_layers().items()}
    rng = np.random.default_rng(1)
    nudged = [(x * (1 + 1e-6 * rng.standard_normal(x.shape)).astype(
        np.float32), y) for x, y in small]

    def side(where, dtype=torch.float32, data=small):
        feed = DataFeeder(types, None, device=where)(data)
        feed = {k: v.to(dtype) if v.is_floating_point() else v
                for k, v in feed.items()}
        leaves = {n: torch.from_numpy(v).to(where, dtype).requires_grad_()
                  for n, v in carried.items()}
        states = {k: v.to(where, dtype) for k, v in
                  topo.init_states(where).items()}
        values, new_states = topo.forward(leaves, states, feed, True, seed)
        loss = values[cost.name]
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return (float(loss.detach()), dict(zip(leaves, grads)),
                {k: v.detach() for k, v in new_states.items()})

    plain_dropout, plain_bn = nn_ops.dropout, nn_ops.batch_norm

    def unscaled_dropout(x, rate, generator, is_train):
        kept = plain_dropout(x, rate, generator, is_train)
        return kept * (1.0 - rate) if is_train and rate > 0 else kept

    def unbiased_running_var(x, scale, bias, rm, rv, is_train, momentum=0.9,
                             eps=1e-5, use_fused_stats=None):
        y, nm, nv = plain_bn(x, scale, bias, rm, rv, is_train, momentum, eps,
                             use_fused_stats)
        if is_train:
            nm, nv = rm.clone(), rv.clone()
            F.batch_norm(x.detach().reshape(-1, x.shape[-1]), nm, nv,
                         training=True, momentum=1 - momentum, eps=eps)
        return y, nm, nv

    wit = {"cpu": side("cpu", torch.float64), "card": side(dev,
                                                           torch.float64)}
    nudge = {"cpu": side("cpu", torch.float64, nudged),
             "card": side(dev, torch.float64, nudged)}
    sides = {"cpu": ("cpu", side("cpu")), "card": ("card", side(dev))}
    rerun = side(dev)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        sides["card_tf32_control"] = ("card", side(dev))
    finally:
        set_f32_policy()
    nn_ops.dropout = unscaled_dropout
    try:
        sides["cpu_unscaled_dropout_control"] = ("cpu", side("cpu"))
    finally:
        nn_ops.dropout = plain_dropout
    nn_ops.batch_norm = unbiased_running_var
    try:
        sides["card_unbiased_running_var_control"] = ("card", side(dev))
    finally:
        nn_ops.batch_norm = plain_bn
    c_a, g_a, s_a = sides["card"][1]
    if not (rerun[0] == c_a and all(torch.equal(rerun[1][n], g_a[n])
                                    for n in g_a)
            and all(torch.equal(rerun[2][k], s_a[k]) for k in s_a)):
        raise AssertionError("the card's small_vgg step is not "
                             "bit-identical on a rerun")

    # a conv bias that feeds a batch norm directly has an exact gradient
    # of zero (the norm removes a per-channel constant): its f32 and f64
    # values are round-off alone, so it is left out of the comparison
    zero_grad = {s.name for n in topo.nodes if n.layer_type == "batch_norm"
                 for p in n.parents if p.layer_type == "exconv"
                 and not p.attrs.get("drop_rate")
                 for s in p.param_specs if s.name.endswith(".wbias")}

    def worst(got, want):
        """The worst ||got - want|| / ||want|| over the leaves, ||want||
        floored at STEP_FLOOR of the leaf's share of the whole."""
        want = {n: v.detach().cpu().double() for n, v in want.items()
                if n not in zero_grad}
        u = (sum(float(torch.sum(v * v)) for v in want.values())
             / sum(v.numel() for v in want.values())) ** 0.5
        ratios = {n: float(torch.linalg.norm(got[n].detach().cpu().double()
                                             - v))
                  / max(float(torch.linalg.norm(v)),
                        STEP_FLOOR * u * v.numel() ** 0.5)
                  for n, v in want.items()}
        n = max(ratios, key=ratios.get)
        return ratios[n], n

    out = {"batch": len(small), "seed": seed, "cost_rtol": VGG_COST_RTOL,
           "state_limit": VGG_STATE_LIMIT}
    limits = {}
    for where in ("cpu", "card"):
        c64, g64, s64 = wit[where]
        moved, leaf = worst(nudge[where][1], g64)
        limits[where] = max(VGG_GRAD_FLOOR, 10 * moved)
        out[f"f64_{where}"] = {"cost": c64, "nudge_grad_worst": moved,
                               "nudge_grad_worst_leaf": leaf,
                               "grad_limit": limits[where]}
    for label, (where, (c, g, s)) in sides.items():
        c64, g64, s64 = wit[where]
        gw, gn = worst(g, g64)
        sw, sn = worst(s, s64)
        out[label] = {"cost": c, "cost_rel_err": abs(c - c64) / abs(c64),
                      "grad_worst": gw, "grad_worst_leaf": gn,
                      "state_worst": sw, "state_worst_leaf": sn}
    for label in ("cpu", "card"):
        w = out[label]
        if not (w["cost_rel_err"] <= VGG_COST_RTOL
                and w["grad_worst"] <= limits[label]
                and w["state_worst"] <= VGG_STATE_LIMIT):
            raise AssertionError(f"{label} small_vgg step vs the f64 "
                                 f"witness: {out}")
    for label in ("card_tf32_control", "cpu_unscaled_dropout_control",
                  "card_unbiased_running_var_control"):
        w, where = out[label], sides[label][0]
        if (w["cost_rel_err"] <= VGG_COST_RTOL
                and w["grad_worst"] <= limits[where]
                and w["state_worst"] <= VGG_STATE_LIMIT):
            raise AssertionError(f"the small_vgg witness limits do not "
                                 f"catch {label}: {out}")
    out["card_rerun_bit_identical"] = True
    return out


def train_vgg(dev, bs=128, steps=10) -> tuple[dict, int]:
    """small_vgg through the v2 flow at the book's configuration (batch
    128 of CIFAR-10 from the port's seeded reader; Momentum 0.9 at lr
    0.1 / 128, L2 0.0002 x 128; f32): the batch-2 witness, the first
    ``trainer.SGD`` step twice (bit for bit), 2 warm-up and ``steps`` timed
    steps with exactly 11 channel_stats and 10 direct-conv launches a
    step, a 3-step profile, and ``test`` on 2 batches (no channel_stats:
    the running statistics)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import rng as prng
    from paddle_tpu_torch.core.parameters import Parameters
    from paddle_tpu_torch.dataset import cifar
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import conv as CV

    t0 = time.perf_counter()
    reset_name_counters()
    cost = vgg_cost(paddle)
    created = paddle.parameters.create(cost)     # generator seeded 0
    carried = {n: created[n] for n in created.names()}
    n_params = int(sum(v.size for v in carried.values()))
    samples = list(cifar.train10()())
    witness = vgg_witness(dev, cost, carried, samples[:4])

    def trainer():
        return paddle.trainer.SGD(
            cost=cost, parameters=Parameters.from_numpy(carried),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.1 / 128,
                regularization=paddle.optimizer.L2Regularization(
                    rate=0.0002 * 128)), device=dev)

    def run(tr, data, handler=None):
        costs = []

        def h(e):
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)
            if handler is not None:
                handler(e)

        tr.train(reader=lambda: iter(data), num_passes=1, event_handler=h)
        return costs

    batches = [samples[i:i + bs] for i in range(0, len(samples) - bs + 1,
                                                bs)]
    warm, data, traced = batches[:2], batches[2:2 + steps], \
        batches[2 + steps:5 + steps]
    firsts = []
    for _ in range(2):
        prng.seed(11)
        tr = trainer()
        firsts.append((run(tr, data[:1]),
                       {n: tr.parameters[n] for n in carried},
                       {k: v.cpu().numpy() for k, v in tr.states.items()}))
        del tr
    (c1, p1, s1), (c2, p2, s2) = firsts
    if not (c1 == c2 and all(np.array_equal(p1[n], p2[n]) for n in p1)
            and all(np.array_equal(s1[k], s2[k]) for k in s1)):
        raise AssertionError("trainer.SGD's first small_vgg step is not "
                             "bit-identical on a rerun")
    del firsts
    prng.seed(12)
    tr = trainer()
    run(tr, warm)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(dev)
    marks: dict[int, list] = {}

    def stamp(e):
        if isinstance(e, (paddle.event.BeginIteration,
                          paddle.event.EndIteration)):
            marks.setdefault(e.batch_id, []).append(time.perf_counter())

    kernels = {"channel_stats": CS.KERNEL, "conv2d_direct": CV.KERNEL,
               "brgemm": BR.KERNEL}

    def zero():
        for k in kernels.values():
            k.launches = 0

    def counts():
        return {n: k.launches for n, k in kernels.items()}

    zero()
    t1 = time.perf_counter()
    costs = run(tr, data, stamp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    train_n = counts()
    peak = torch.cuda.max_memory_allocated(dev)
    want = {"channel_stats": 11, "conv2d_direct": 10, "brgemm": 0}
    if train_n != {n: c * steps for n, c in want.items()}:
        raise AssertionError(f"small_vgg train launches {train_n} != {want} "
                             f"x {steps}")
    if not (len(costs) == steps and all(np.isfinite(costs))
            and np.mean(costs[-3:]) < np.mean(costs[:3])):
        raise AssertionError(f"small_vgg costs not finite and falling: "
                             f"{costs}")
    step_ms = [1e3 * (b - a) for a, b in marks.values()]
    p50 = float(np.percentile(step_ms, 50))
    prof = profile_window(lambda: run(tr, traced), 3)
    if "device_busy_ms_per_step" in prof:
        prof["idle_share_vs_step_p50"] = (
            1 - prof["device_busy_ms_per_step"] / p50)
    test_data = list(cifar.test10()())[:2 * bs]
    zero()
    result = tr.test(reader=lambda: iter([test_data[:bs], test_data[bs:]]))
    torch.cuda.synchronize()
    test_n = counts()
    want_test = {"channel_stats": 0, "conv2d_direct": 20, "brgemm": 0}
    if test_n != want_test or not np.isfinite(result.cost):
        raise AssertionError(f"small_vgg test launches {test_n} != "
                             f"{want_test} or cost {result.cost}")
    del tr
    out = {"phase": "train_vgg",
           "model": "small_vgg (layers/networks.small_vgg, the book's "
                    "vgg_bn_drop on CIFAR-10)",
           "params": n_params, "tensors": len(carried), "image": [32, 32, 3],
           "classes": 10, "dtype": "float32",
           "optimizer": "Momentum 0.9, lr 0.1/128, L2 0.0002*128",
           "step_vs_f64_witness": witness,
           "first_step_rerun_bit_identical": True,
           "batch": bs, "steps": steps, "wall_s": wall,
           "images_per_s": bs * steps / wall, "step_ms_p50": p50,
           "step_ms": step_ms, "costs": costs,
           "max_memory_allocated_bytes": peak, "train_launches": train_n,
           "test_launches": test_n, "test_batches": 2,
           "test_cost": result.cost, "test_metrics": result.metrics,
           "setup_s": setup_s, "profile": prof}
    return out, train_n["channel_stats"]


#: (builder, image side, classes, direct-conv and BRGEMM launches a step)
BENCH_NETS = {"smallnet": ("smallnet_cost", 32, 10, 3, 0),
              "alexnet": ("alexnet_cost", 227, 1000, 5, 0),
              "googlenet": ("googlenet_cost", 224, 1000, 20, 37),
              "vgg19": ("vgg_cost", 224, 1000, 16, 0)}


def bench_nets(dev, bs=64, warm=2, steps=5) -> dict:
    """``bench.py``'s image nets under its ``_image_step`` configuration
    (one fixed batch of N(0, 1) images, Momentum 0.9 at lr 0.01 / batch),
    through ``trainer.SGD``: smallnet, AlexNet and GoogLeNet 2 warm-up and
    5 timed steps each (ms a batch), VGG-19 one step; each with its exact
    conv launches a step."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.layers.base import reset_name_counters
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import conv as CV

    out = {"phase": "bench_nets", "batch": bs}
    for name, (builder, side, classes, n_direct, n_brgemm) in \
            BENCH_NETS.items():
        reset_name_counters()
        cost = getattr(paddle.models.image, builder)(
            class_num=classes, height=side, width=side)[0]
        r = np.random.default_rng(0)
        batch = [(x, int(y)) for x, y in zip(
            r.normal(size=(bs, 3 * side * side)).astype(np.float32),
            r.integers(0, classes, size=bs))]
        tr = paddle.trainer.SGD(
            cost=cost, parameters=paddle.parameters.create(cost),
            update_equation=paddle.optimizer.Momentum(
                momentum=0.9, learning_rate=0.01 / bs), device=dev)
        n_warm, n_timed = (warm, steps) if name != "vgg19" else (0, 1)
        costs = []

        def run(k, handler=None):
            tr.train(reader=lambda: iter([batch] * k), num_passes=1,
                     event_handler=handler)

        run(n_warm)
        torch.cuda.synchronize()
        for k in (CS.KERNEL, CV.KERNEL, BR.KERNEL):
            k.launches = 0
        marks: dict[int, list] = {}

        def stamp(e):
            if isinstance(e, (paddle.event.BeginIteration,
                              paddle.event.EndIteration)):
                marks.setdefault(e.batch_id, []).append(time.perf_counter())
            if isinstance(e, paddle.event.EndIteration):
                costs.append(e.cost)

        run(n_timed, stamp)
        torch.cuda.synchronize()
        got = {"conv2d_direct": CV.KERNEL.launches,
               "brgemm": BR.KERNEL.launches,
               "channel_stats": CS.KERNEL.launches}
        want = {"conv2d_direct": n_direct * n_timed,
                "brgemm": n_brgemm * n_timed, "channel_stats": 0}
        if got != want or not all(np.isfinite(costs)):
            raise AssertionError(f"{name}: launches {got} != {want} or "
                                 f"costs {costs}")
        step_ms = [1e3 * (b - a) for a, b in marks.values()]
        out[name] = {"image": [side, side, 3], "classes": classes,
                     "steps": n_timed, "ms_per_batch_p50":
                         float(np.percentile(step_ms, 50)),
                     "step_ms": step_ms, "costs": costs,
                     "launches_per_step": {k: v // n_timed
                                           for k, v in got.items()}}
        del tr
        torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        log("chip_smoke: torch sees no CUDA card; nothing to run")
        return 2
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build

    dev = resolve_device(None)    # cuda:0, TF32 off for matmul and cuDNN
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"card: {smi} | torch: {kind} x{count} | torch {torch.__version__}"
          f" cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    built = _build.build()
    print(json.dumps({"phase": "build", "sources": sorted(built),
                      "seconds": time.perf_counter() - t0}), flush=True)

    timer = Timer(dev)
    rows = [check_flash(dev, timer), check_paged(dev, timer)]
    bwd_rows, bwd_summary = check_flash_backward(dev, timer)
    conv_rows = check_brgemm(dev, timer) + check_conv(dev, timer)
    for row in rows + bwd_rows + conv_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(bwd_summary), flush=True)
    del timer
    print(json.dumps(check_conv_backward(dev)), flush=True)

    serve, flash_n, paged_n = serve_end_to_end(dev)
    print(json.dumps(serve), flush=True)
    train, br_n, cv_n = train_end_to_end(dev)
    print(json.dumps(train), flush=True)
    torch.cuda.empty_cache()
    lm, (fwd_n, dq_n, dkv_n) = train_lm(dev)
    print(json.dumps(lm), flush=True)
    torch.cuda.empty_cache()
    text_rows, text_summary = check_text_kernels(dev, Timer(dev))
    for row in text_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(text_summary), flush=True)
    text, text_n = train_text(dev)
    print(json.dumps(text), flush=True)
    torch.cuda.empty_cache()
    crnn_rows, crnn_summary = check_crnn_kernels(dev, Timer(dev))
    for row in crnn_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(crnn_summary), flush=True)
    crnn, crnn_n = train_crnn(dev)
    print(json.dumps(crnn), flush=True)
    torch.cuda.empty_cache()
    nmt_rows, nmt_summary = check_nmt_kernels(dev, Timer(dev))
    for row in nmt_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    print(json.dumps(nmt_summary), flush=True)
    nmt, nmt_n = train_nmt(dev)
    print(json.dumps(nmt), flush=True)
    torch.cuda.empty_cache()
    vgg_row, vgg_summary = check_vgg_kernels(dev, Timer(dev))
    print(json.dumps({"phase": "kernel", **vgg_row}), flush=True)
    print(json.dumps(vgg_summary), flush=True)
    vgg, stats_n = train_vgg(dev)
    print(json.dumps(vgg), flush=True)
    torch.cuda.empty_cache()
    print(json.dumps(bench_nets(dev)), flush=True)
    # the forward kernel runs on two paths, a row for each: serving's
    # prefill and LM training, each timed at its own shape
    rows[0]["launches"], rows[1]["launches"] = flash_n, paged_n
    for row, launches in zip(bwd_rows, (fwd_n, dq_n, dkv_n)):
        row["launches"] = launches
    rows += bwd_rows
    for name, launches in (("brgemm", br_n), ("conv2d_direct", cv_n)):
        mine = [r for r in conv_rows if r["name"] == name]
        rows.append({**mine[0], "launches": launches,
                     "max_abs_err": max(r["max_abs_err"] for r in mine)})
    for row, launches in zip(text_rows, text_n):
        rows.append({**row, "launches": launches})
    # the BiLSTM, LSTM-backward and CTC rows count the training run's
    # launches, the decode row the infer-and-decode run's
    for row, launches in zip(crnn_rows, crnn_n):
        rows.append({**row, "launches": launches})
    # the BiGRU and remat-backward rows count the training run's launches,
    # the GRU forward and stored-gates rows the composed BiGRU check's
    for row, launches in zip(nmt_rows, nmt_n):
        rows.append({**row, "launches": launches})
    rows.append({**vgg_row, "launches": stats_n})
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    print(smi, flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
