#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``paddle_tpu_torch``) on one NVIDIA
card — the quickest proof that the port builds, is right, serves and
trains.

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
   Times are CUDA-event means over many launches with the 50 MB L2
   flushed before each launch, beside the plain twin, one PyTorch library
   call used only here as a yardstick (``scaled_dot_product_attention``,
   ``torch.matmul``, channels_last ``F.conv2d``) and the bound: the larger
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
5. ``{"kernels": [...]}`` and then, as the last line, ``{"ok": true,
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
            row[mode] = max(float(torch.linalg.norm(g.cpu().double() - r)
                                  / torch.linalg.norm(r))
                            for g, r in zip(got, want))
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
    if "brgemma" in low:
        return "brgemm (ours)"
    if "conva" in low:
        return "conv2d_direct (ours)"
    if "stats_reduce" in low:
        return "stats_reduce (ours)"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if any(k in low for k in ("dgrad", "wgrad", "cudnn", "convolve")):
        return "cudnn conv backward"
    if "gemm" in low:
        return "other gemm (cuBLAS/cuDNN)"
    return "elementwise and reductions"


def profile_window(fn, steps: int) -> dict:
    """Device time by kernel class over ``fn()`` (``steps`` train steps)
    under ``torch.profiler``; busy = the sum of kernel times (one stream).
    The profiler's own host cost inflates the traced wall many times over,
    so the caller sets the idle share against an untraced step.  An empty
    trace reports "not measured"."""
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
        ms = e.self_device_time_total / 1e3
        cls = kernel_class(e.key)
        by_class[cls] = by_class.get(cls, 0.0) + ms / steps
        kernels.append((ms / steps, e.count // steps, e.key[:100], cls))
    if not kernels:
        return {"steps": steps, "device_time": "not measured"}
    busy = sum(by_class.values())
    kernels.sort(reverse=True)
    return {"steps": steps, "traced_wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy,
            "kernels_per_step": sum(k[1] for k in kernels),
            "by_class_ms_per_step": by_class,
            "top_kernels": [{"ms_per_step": k[0], "per_step": k[1],
                             "name": k[2], "class": k[3]}
                            for k in kernels[:12]]}


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
    conv_rows = check_brgemm(dev, timer) + check_conv(dev, timer)
    for row in rows + conv_rows:
        print(json.dumps({"phase": "kernel", **row}), flush=True)
    del timer
    print(json.dumps(check_conv_backward(dev)), flush=True)

    serve, flash_n, paged_n = serve_end_to_end(dev)
    print(json.dumps(serve), flush=True)
    train, br_n, cv_n = train_end_to_end(dev)
    print(json.dumps(train), flush=True)
    rows[0]["launches"], rows[1]["launches"] = flash_n, paged_n
    for name, launches in (("brgemm", br_n), ("conv2d_direct", cv_n)):
        mine = [r for r in conv_rows if r["name"] == name]
        rows.append({**mine[0], "launches": launches,
                     "max_abs_err": max(r["max_abs_err"] for r in mine)})
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
