#!/usr/bin/env python3
"""A/B of two checkouts of the PyTorch/CUDA port on one card, and a sweep
of the shared GEMM tile's plan.

The A/B times, in each tree, the wrapper calls ``CALLS`` names (rows 5
and 8, the forward without and with its gates slab, the remat and the
stored-gates backward: the LSTM at the text shape in f32 and in bf16 at
D 1280, 512 and 256, the GRU at the NMT's [64, 32, 512] in f32 and
bf16), then runs its own ``chip_smoke.train_text_bf16`` (the text
classifier in bf16 beside f32: 20 timed steps each at batch 64 with
their peak memory and launches by form, a 3-step bf16 profile), each
tree in a process of its own that builds that tree's kernels, in the
order given.
Host-bound phases vary up to 2x between machines, so two versions are
compared only within one run of this script, in turns:

    python3 chip_ab.py [--out DIR] [--calls] build/parent . . build/parent

(``build/parent`` holding ``git archive`` of the parent commit).  Prints
one JSON line a run (the tree, each call's event ms with the L2 flushed,
host ms and device ms alone with its kernels' names, the bf16 and f32
text steps' rate, p50, peak memory and launches, the bf16 idle share, the
LSTM kernels' and each class's device ms a step) and
writes each run's whole output to ``DIR/ab_<i>.json`` (default
``build/ab``).  ``--calls`` times the wrapper calls alone, without the
training steps.

    python3 chip_ab.py --sweep

times, at the ``SWEEP`` shapes of ``chip_smoke``'s row 14 and 15 cases
(stats epilogue), every tile of ``brgemm.F32.tiles`` whole and the smallest
split in 2 and 4, each checked against the twin first, beside the tile
the plan picks: one JSON line, {shape: {"<block_m>x<block_n>/<splits>":
ms}, "planned": ...}; then the same shapes in bf16 on the Hopper tile
(``brgemm.WGMMA``): every width in 1, 2 and 4 splits, and the planned
plan on copies of ``csrc/gemm_wgmma.cuh`` with other ring depths
(``STAGES``) and the other ``VARIANTS``, each checked by ``bf16_agrees``
first and timed alone (the device time of its kernels in a trace, no
flush): {"wgmma_sweep_ms": {shape: {"128x<block_n>/<splits>": ms,
"<variant>": ms}}}.

    python3 chip_ab.py --bilstm-plans

times every plan ``lstm.bi_plan`` weighs at the OCR CRNN's f32 BiLSTM
shape (cluster size, row tile, W_x resident or through L2), forced in
turn and checked against the twin first, beside the plan it picks; then
the planned plan alone on the ``BILSTM_VARIANTS`` copies of the source,
and the cycles a step of each part of the planned kernel's first CTAs
(``BILSTM_CLOCK``).

    python3 chip_ab.py --flash-order

times the Hopper flash forward with its blocks numbered heaviest q tile
first over all heads (the source) and by head (a copy), in turns.

    python3 chip_ab.py --tf32-variants

times the f32 flash backward's dQ and dK/dV kernels (3xTF32) at the LM
training shape [16, 1024, 12, 64] causal as the source builds them and
as each of ``TF32_VARIANTS`` (copies of the source with a line changed:
the TF32 rounding by ``cvt.rna.tf32.f32``, S and dP summed apart at head
dim 64, the long sums chained, the dK/dV blocks numbered by head) in
turns, each checked against the twin first, alone on [B, T, H, D] as it
lies and on the padded problem's views, with its distance from the
float64 twin.

    python3 chip_ab.py --tf32-fwd-variants [PARENT]

times the f32 flash forward (3xTF32, in place) at the LM training shape
[16, 1024, 12, 64] and serving's prefill shape [8, 512, 12, 64] causal
as the source builds it and as each of ``TF32_FWD_VARIANTS`` (S summed
apart at head_dim 64, a 3-stage ring, Q's fragments from shared memory),
and, where PARENT (a ``git
archive`` of an earlier tree) is given, its ``flash_attention_fwd_f32``
entry (the FMA form, on the padded problem), in turns, each checked
against the twin first, alone and with the L2 flushed, with o's distance
from float64.

    python3 chip_ab.py --paged-chunks

times the f32 paged decode at serving's shape with each of
``PAGED_CHUNK_TOKENS`` as ``paged_attention.CHUNK_TOKENS`` (pages a
chunk 1, 2, 4, 8, 16 at page 16), in turns, each checked against the
twin first, alone and with the L2 flushed; then the bf16 form with each
of ``PAGED_CHUNK_TOKENS_BF16`` as ``CHUNK_TOKENS_BF16`` (pages a chunk 4,
8, 16, 32), each checked by ``paged_bf16_agreement`` first.

    python3 chip_ab.py --lstm-fwd-split [TREE]

times the f32 LSTM forward built from TREE's source (default this one),
through this tree's wrappers, at the text shape over xw and at row 6's in
its fused-input form, as that source is and as each of
``LSTM_FWD_SPLIT`` whose lines it has (copies without a part of the
step: the h W_h product, the x_t W_x product, the grid barrier, the cell
with its stores), in turns, alone and with the L2 flushed: each part's
share of the step.

    python3 chip_ab.py --lstm-bwd-split [TREE]

times the f32 LSTM backward (remat) built from TREE's source (a checkout
whose C entry takes this tree's arguments: default this one), through
this tree's wrapper, at the text shape as that source is and as each of
``LSTM_BWD_SPLIT`` whose lines it has (copies without a part of the
step: the partial writes of dh_{t-1}'s shares, the sum over them, the
remat product, the dh product, the grid barrier), in turns, alone and
with the L2 flushed: each part's share of the step.

    python3 chip_ab.py --lstm-bwd-split [TREE] --bf16 [D ...] [--probes]
    python3 chip_ab.py --lstm-fwd-split [TREE] --bf16 [D ...] [--probes]

the same for the bf16 forms (``LSTM_BF16_BWD_SPLIT``,
``LSTM_BF16_FWD_SPLIT``: the parent's parts and the redesign's) at B 64,
T 128, lengths 100 and each hidden width D (default ``bench_lstm``'s
1280, 512 and 256), the backward remat and stored, the forward over xw
and, at 1280, row 6's fused-input form; ``--probes`` adds the products'
timing probes (``LSTM_BF16_PROBES``, ``LSTM_BF16_DH_PROBES``).

    python3 chip_ab.py --lstm-bf16-variants
    python3 chip_ab.py --lstm-bf16-bounds

times this tree's bf16 forward and backward as the source builds them and
as each of ``LSTM_BF16_VARIANTS`` (the ring's depth and stages, the
backward's part of W_h through L2, fragments ahead by U), each held to
the source's bits; ``--lstm-bf16-bounds`` prints the text forms' bounds
at those widths (arithmetic, no card).

    python3 chip_ab.py --paged-bf16-variants

times the bf16 paged decode at serving's shape as the source builds it
and as each of ``PAGED_BF16_VARIANTS`` (the row loads a thread issues
before reducing), in turns, each checked by ``paged_bf16_agreement``
first, alone and with the L2 flushed.

    python3 chip_ab.py --lstm-bwd-variants

times this tree's f32 LSTM backward (remat) at the text shape as the
source builds it and as each of ``LSTM_BWD_VARIANTS`` (the dh product's
k tiles a warp takes at once, the sum over the blocks in one range), in
turns, each checked against the twin first, alone and with the L2
flushed.

    python3 chip_ab.py --cluster-probe

builds ``CLUSTER_PROBE`` and launches it cooperative and in clusters of 1,
2, 4 and 8 at the f32 LSTM backward's text-shape grid: each launch's
error, the clusters the card holds at once, and a DSMEM read checked.

    python3 chip_ab.py --flash-bf16-processes [N]

runs ``test_flash_bf16_function_on_card_matches_the_cpu`` in N fresh
processes (default 20), keeping each one's card and CPU outputs' digests
(and the tensors of any process whose differ from the first's under
``build/flash_bf16``).

    python3 chip_ab.py --sass [TREE ...]

prints the opcode counts of the f32 flash kernels at head_dim 64 (total,
HMMA, NOP, local loads and stores; ``cuobjdump -sass``) as each tree's
sources build them (default: this one).

    python3 chip_ab.py --wgmma-bwd-variants

times the bf16 Hopper backward's dQ and dK/dV kernels at the same shape
as the source builds them and as each of ``WGMMA_BWD_VARIANTS`` (the dQ
kernel at two blocks an SM, a 2-stage ring), in turns, each checked
against the twins first, alone.

    python3 chip_ab.py --stats-plans

times ``channel_stats`` (row 13, f32 and bf16) at small_vgg's five views
under each of ``STATS_PLANS`` (the 16-byte forms' lanes and the least
blocks a call takes) and on the ``STATS_VARIANTS`` builds of its source,
each checked against the twin first, alone."""

from __future__ import annotations

import itertools
import json
import os
import subprocess
import sys
import time

RUN = r"""
import json, os, sys, time
tree = os.path.abspath(sys.argv[1])
os.chdir(tree)
sys.path.insert(0, tree)
import numpy as np
import torch
import chip_smoke as C
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.ops.kernels import _build
dev = resolve_device(None)
_build.build()
calls = CALLS(dev, C)
if sys.argv[2] == "calls":
    print(json.dumps({"calls": calls}))
    sys.exit(0)
torch.cuda.empty_cache()
text = C.train_text_bf16(dev, steps=20)[0]
print(json.dumps({"calls": calls, "train_text_bf16": text}))
"""

#: the wrapper calls whose form the route rule picks, at chip_smoke's
#: shapes, timed the same way in either tree (each tree's own wrappers):
#: the CUDA-event ms with the L2 flushed, the host's median ms a call
#: without a sync, and the device ms of the call's kernels alone (a trace,
#: summed over its kernels).  The LSTM (row 5) at the text shape (B 64,
#: T 128, lengths 100) in f32 at D 1280 (``check_text_kernels``' inputs)
#: and in bf16 at D 1280, 512 and 256 (``bench_lstm``'s widths;
#: ``bf16_lstm_inputs``): the forward without and with its gates slab, the
#: remat backward over xw and the stored-gates backward over the slab.
#: The GRU (row 8) at [64, 32, 512] (``check_nmt_kernels``' shape, half
#: the rows ragged) in f32 and bf16 (xw in the io dtype, as ``grumemory``
#: hands it over): the same four calls.
CALLS = r"""
def CALLS(dev, C):
    from paddle_tpu_torch.ops.kernels import gru as GK
    from paddle_tpu_torch.ops.kernels import lstm as LK

    timer = C.Timer(dev)

    def host(fn, iters=50):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
        return float(np.median(times)) * 1e3

    # the device ms of one call: the kernels' time in a trace of `rounds`
    # calls over `rounds`, summed (whatever either tree's kernels are
    # named), and each kernel's share by name
    def alone_all(fn, rounds=20):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(rounds):
                fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.count]
        each = {e.key[:60]: e.self_device_time_total / 1e3 / rounds
                for e in evs}
        return sum(each.values()), each

    def all3(fn, iters=5):
        ms, names = alone_all(fn)
        return {"ms": timer(fn), "host_ms": host(fn, iters),
                "alone_ms": ms, "kernels": names}

    def four(mod, xw, gates, fa, tail):
        # fa: the forward's arguments but its last (emit the slab); tail:
        # the backward's after (xw, gates) but its last (remat)
        return {"fwd": all3(lambda: mod._fwd_kernel(*fa, False)),
                "fwd_slab": all3(lambda: mod._fwd_kernel(*fa, True)),
                "bwd_remat": all3(lambda: mod._bwd_kernel(xw, None, *tail,
                                                          True)),
                "bwd_stored": all3(lambda: mod._bwd_kernel(None, gates, *tail,
                                                           False))}

    out = {}
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d = 64, 128, 1280
    mask = (torch.arange(t, device=dev)[None, :] < 100).float().expand(
        b, t).contiguous()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = c0 = zeros = torch.zeros(b, d, device=dev)
    dhs = torch.randn(b, t, d, generator=gen, device=dev)
    fa = (xw, mask, w_h, peep, h0, c0, False)
    hs, cs, gates = LK._fwd_kernel(*fa, True)[:3]
    out["lstm_f32_d1280"] = four(LK, xw, gates, fa, (
        mask, w_h, peep, h0, c0, hs, cs, dhs, zeros, zeros, False))
    del xw, w_h, peep, dhs, fa, hs, cs, gates
    for d in (1280, 512, 256):
        x = C.bf16_lstm_inputs(dev, gen, b, t, d, torch.full((b,), 100))
        h0, c0 = torch.zeros_like(x["h0"]), torch.zeros_like(x["c0"])
        fa = (x["xw"], x["mask"], x["w_h"], x["peep"], h0, c0, False)
        hs, cs, gates = LK._fwd_kernel(*fa, True)[:3]
        out[f"lstm_bf16_d{d}"] = four(LK, x["xw"], gates, fa, (
            x["mask"], x["w_h"], x["peep"], h0, c0, hs, cs, x["dhs"],
            x["dhT"], x["dcT"], False))
        del x, fa, hs, cs, gates
    b, t, d = 64, 32, 512
    lens = torch.randint(1, t + 1, (b,), generator=gen, device=dev)
    lens[: b // 2] = t
    lens[-1] = 1
    gmask = (torch.arange(t, device=dev)[None, :] < lens[:, None]).float()
    for dtype in (torch.float32, torch.bfloat16):
        gxw = torch.randn(b, t, 3 * d, generator=gen, device=dev).to(dtype)
        gw_h = (torch.randn(d, 2 * d, generator=gen, device=dev)
                / d ** 0.5).to(dtype)
        gw_hc = (torch.randn(d, d, generator=gen, device=dev)
                 / d ** 0.5).to(dtype)
        gh0 = torch.zeros(b, d, device=dev, dtype=dtype)
        fa = (gxw, gmask, gw_h, gw_hc, gh0, False)
        ghs, urc, _ = GK._fwd_kernel(*fa, True)
        gdhs = torch.randn(b, t, d, generator=gen, device=dev).to(dtype)
        name = "f32" if dtype == torch.float32 else "bf16"
        out[f"gru_{name}_d512"] = four(GK, gxw, urc, fa, (
            gmask, gw_h, gw_hc, gh0, ghs, gdhs,
            torch.zeros(b, d, device=dev), False))
        del gxw, gw_h, gw_hc, gh0, fa, ghs, urc, gdhs
    return out
"""


def summary(tree: str, out: dict, seconds: float) -> dict:
    if "train_text_bf16" not in out:
        return {"tree": tree, "seconds": seconds, "calls": out["calls"]}
    run = out["train_text_bf16"]
    prof = run.get("profile_bf16", {})
    lstm = {k["name"][:60]: k["ms_per_step"] for k in prof.get(
        "top_kernels", []) if "lstm" in k["name"]}
    steps = ("sequences_per_s", "step_ms_p50", "step_ms",
             "max_memory_allocated_bytes", "launches_per_block")
    return {"tree": tree, "seconds": seconds, "calls": out["calls"],
            "train_text_bf16": {k: run["bf16"].get(k) for k in steps},
            "train_text_f32": {k: run["f32"].get(k) for k in steps},
            "text_bf16_idle_share_vs_step_p50": prof.get(
                "idle_share_vs_step_p50"),
            "text_bf16_lstm_device_ms_per_step": lstm,
            "text_bf16_device_ms_per_step_by_class": prof.get(
                "by_class_ms_per_step")}


#: the shapes :func:`sweep` times every tile at
SWEEP = ("res2_3x3", "res3_3x3", "res4_3x3", "res5_3x3",
         "small_vgg_narrowest", "res2_2c", "res5_2a")


#: ring depths the bf16 sweep times beside the header's (4 stages at BN
#: 256, 6 at 64 and 128): {variant: the line of kStages it builds}
STAGES = {"3/4": "  static constexpr int kStages = BN == 256 ? 3 : 4;",
          "4/5": "  static constexpr int kStages = BN == 256 ? 4 : 5;",
          "3/8": "  static constexpr int kStages = BN == 256 ? 3 : BN == 128 "
                 "? 6 : 8;"}
#: other builds of the header the bf16 sweep times at the planned plan:
#: {variant: (its line, what it becomes)}; "no proxy fence": the
#: consumers read a stage cp.async filled without fence.proxy.async
VARIANTS = {"no proxy fence": ("        fence_proxy_async();", "")}
STAGES_LINE = "  static constexpr int kStages = BN == 256 ? 4 : 6;"


class forced_tile:
    """Within the block, every launch of the shared tile takes ``tile``
    (block_m, block_n) and ``splits`` in the copy form the plan would
    pick (and the Hopper tile where ``wgmma``)."""

    def __init__(self, tile, splits=1, wgmma=False):
        self.tile, self.splits, self.wgmma = tile, splits, wgmma

    def __enter__(self):
        from paddle_tpu_torch.ops.kernels import brgemm as BR

        self.real = real = BR.plan
        BR.plan = lambda *a: BR.Plan(*self.tile, real(*a).vec, self.splits,
                                     self.wgmma)

    def __exit__(self, *exc):
        from paddle_tpu_torch.ops.kernels import brgemm as BR

        BR.plan = self.real


def sweep() -> int:
    """Every tile whole and the smallest split in 2 and 4 at the SWEEP
    shapes, in this tree: checked against the twin, then timed (CUDA-event
    means, L2 flushed)."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import brgemm as BR

    dev = resolve_device(None)
    _build.build()
    timer = C.Timer(dev)
    out = {}
    for case in itertools.chain(C.brgemm_cases(dev), C.conv_cases(dev)):
        if case["label"] not in SWEEP or case["mode"] != "stats":
            continue
        fn, want = case["fn"], case["plain_fn"]()
        p = case["plan"]
        row = {"planned": f"{p.block_m}x{p.block_n}/{p.splits}"}
        cases = [(t, 1) for t in BR.F32.tiles]
        cases += [(BR.F32.tiles[-1], k) for k in (2, 4)
                  if k <= -(-case["kred"] // BR.F32.block_k)]
        for tile, splits in cases:
            with forced_tile(tile, splits):
                err = C.moments_err(fn(), want, case["count"])
                if not err <= C.TOL:
                    raise AssertionError(f"{case['label']} tile {tile} / "
                                         f"{splits}: err {err}")
                row[f"{tile[0]}x{tile[1]}/{splits}"] = timer(fn)
        out[case["label"]] = row
        del fn, want, case
        torch.cuda.synchronize()
    print(C.nvidia_smi())
    print(json.dumps({"tile_sweep_ms": out}), flush=True)
    print(json.dumps({"wgmma_sweep_ms": sweep_wgmma(dev)}), flush=True)
    return 0


def sweep_wgmma(dev) -> dict:
    """The SWEEP shapes in bf16 on the Hopper tile: every width whole and
    split in 2 and 4 (where the reduction has the stages), then the
    planned plan on each STAGES and VARIANTS build (in place of the
    source's entry); each checked by ``bf16_agrees``, then timed alone:
    the device ms of the tile, ``split_reduce`` and ``stats_reduce`` in
    one call (``chip_smoke.device_passes_ms``)."""
    import ctypes

    import torch

    import chip_smoke as C
    from paddle_tpu_torch.ops.kernels import brgemm as BR
    from paddle_tpu_torch.ops.kernels import conv as CV

    edits = {f"stages {name}": (STAGES_LINE, line)
             for name, line in STAGES.items()}
    edits.update(VARIANTS)
    builds = {}
    for source in ("brgemm", "conv2d_direct"):
        for name, edit in edits.items():
            tag = name.replace("/", "_").replace(" ", "_")
            builds[(source, name)] = C.source_fault_builds(
                source, {tag: edit})[tag]
    libs = C.built(builds)
    out = {}
    cases = itertools.chain(C.brgemm_cases(dev, torch.bfloat16),
                            C.conv_cases(dev, torch.bfloat16))
    for case in cases:
        if case["label"] not in SWEEP or case["mode"] != "stats":
            continue
        fn, p = case["fn"], case["plan"]
        want = case["wide_fn"]()[0]
        mag, kred = case["mag_fn"](), case["kred"]

        def checked(label, splits):
            y = fn()[0]
            y = y.reshape(-1, y.shape[-1])
            w = want.reshape(y.shape).to(torch.bfloat16)
            m = mag.reshape(y.shape)
            if not C.bf16_agrees(y, w, m, kred):
                raise AssertionError(f"{case['label']} {label}: "
                                     f"{C.bf16_agreement(y, w, m, kred)}")
            keys = ("wgmma_kernel<", "stats_reduce") + (
                ("split_reduce",) if splits > 1 else ())
            return C.device_passes_ms([fn], keys)["total"]

        row = {"planned": f"{p.block_m}x{p.block_n}/{p.splits}"}
        slices = -(-kred // BR.WGMMA.block_k)
        for tile in BR.WGMMA.tiles:
            for splits in (1, 2, 4):
                if splits <= slices:
                    with forced_tile(tile, splits, True):
                        row[f"{tile[0]}x{tile[1]}/{splits}"] = checked(
                            (tile, splits), splits)
        mod = BR if case["label"] in [r[0] for r in C.RESNET_1X1] else CV
        kernel = mod.KERNEL_WGMMA
        real = kernel._fn or kernel._resolve()
        for name in edits:
            fn_v = getattr(ctypes.CDLL(str(libs[(kernel.source, name)])),
                           kernel.symbol)
            fn_v.argtypes, fn_v.restype = kernel.argtypes, ctypes.c_int
            kernel._fn = fn_v
            try:
                row[name] = checked(name, p.splits)
            finally:
                kernel._fn = real
        out[case["label"]] = row
        del fn, want, mag, case
        torch.cuda.synchronize()
    return out


#: copies of csrc/bilstm_seq.cu that each change one part of the f32
#: kernel, {variant: [(line, what it becomes)]}, timed alone at the
#: planned plan: "no ..." drops a part of the step, to show what it costs
#: (their results are wrong and not checked); the others are designs
#: weighed against the source's
BILSTM_VARIANTS = {
    "512 threads": [("constexpr int kClThreads = 256;",
                     "constexpr int kClThreads = 512;")],
    "copies after the arrive": [
        ("    if (s + 1 < T) stage(s + 1);     // x_s is read; the copies "
         "overlap the cell\n", ""),
        ("    if (s + 1 < T) cluster_arrive();   // this CTA's h_t slice is "
         "out", "    if (s + 1 < T) cluster_arrive();\n    if (s + 1 < T) "
         "stage(s + 1);")],
    "fast exp": [(
        "float sigm(float x) { return 1.f / (1.f + expf(-x)); }",
        "float sigm(float x) { return 1.f / (1.f + __expf(-x)); }")],
    "no x product": [(
        "    partial_sums<kRows, kResident>(red_x, x_s, wx_s, E, U, KS, xt, "
        "p.wx, D,\n                                   col0);\n", "")],
    "no h product": [(
        "    partial_sums<kRows, true>(red_h, h_cur, wh_s, D, U, KS, nullptr,"
        "\n                              nullptr, D, col0);\n", "")],
    "no cluster barrier": [   # but the last, so no CTA exits early
        ("    if (s > 0) cluster_wait();",
         "    if (s == T - 1) cluster_wait();"),
        ("    if (s + 1 < T) cluster_arrive();",
         "    if (s + 2 == T) cluster_arrive();")],
    "no peer stores": [(
        "          cluster.map_shared_rank(h_nxt, q)[unit * kRows + r] = hn;",
        "          ;")]}


#: a copy of csrc/bilstm_seq.cu whose thread 0 of each CTA sums clock64()
#: over six parts of every step and writes the sums (cycles) over its
#: h_T entries: the top barrier and copies' wait, x_t W_x, the cluster
#: barrier's wait, h W_h with its barrier, the cell with the peer stores
#: and the arrive, the stores of the step's outputs
BILSTM_CLOCK = [
    ("constexpr int kMaxCluster = 8;",
     "constexpr int kMaxCluster = 8;\n#define TICK(k) { const long long "
     "n_ = clock64(); ph[k] += n_ - t_0; t_0 = n_; }"),
    ("  for (int s = 0; s < T; ++s) {\n    const int t = reverse ? T - 1 - s "
     ": s;\n    if (s > 0) {",
     "  long long ph[6] = {0, 0, 0, 0, 0, 0}, t_0 = clock64();\n  for (int s "
     "= 0; s < T; ++s) {\n    const int t = reverse ? T - 1 - s : s;\n    "
     "if (s > 0) {"),
    ("    const float* xt[kRows];",
     "    TICK(0);\n    const float* xt[kRows];"),
    ("    if (s > 0) cluster_wait();",
     "    TICK(1);\n    if (s > 0) cluster_wait();\n    TICK(2);"),
    ("    if (s + 1 < T) stage(s + 1);", "    TICK(3);\n    if (s + 1 < T) "
     "stage(s + 1);"),
    ("    if (s + 1 < T) cluster_arrive();   // this CTA's h_t slice is out",
     "    if (s + 1 < T) cluster_arrive();\n    TICK(4);"),
    ("        p.cT[(size_t)b * D + unit] = cn;\n      }\n    }\n  }\n}\n",
     "        p.cT[(size_t)b * D + unit] = cn;\n      }\n    }\n    TICK(5);"
     "\n  }\n  __syncthreads();\n  if (threadIdx.x == 0)\n    for (int k = "
     "0; k < 6; ++k) p.hT[(size_t)b0 * D + col0 + k] = (float)ph[k];\n}\n")]
#: the parts BILSTM_CLOCK times, in its order
CLOCK_PARTS = ("top barrier and copies", "x product", "cluster wait",
               "h product", "cell, peer stores, arrive", "outputs")


def bilstm_plans() -> int:
    """Every plan ``lstm.bi_plan`` weighs at the OCR CRNN's BiLSTM shape
    (B 64, T 24, E 256, D 64; x and weights as ``check_crnn_kernels``),
    in this tree: each forced in turn, checked against the twin, then
    timed alone (the kernel's device ms in a trace, no flush) and by
    CUDA events (L2 flushed), beside how many of its clusters the card
    holds at once: one JSON line, {"<cluster>x<rows> <resident|l2>":
    {"ctas", "clusters_held", "alone_ms", "ms"}, "planned": ...}."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import lstm as LK

    dev = resolve_device(None)
    builds = C.source_fault_builds("bilstm_seq", {
        "phase_clock": BILSTM_CLOCK, **{
            name.replace(" ", "_"): edits
            for name, edits in BILSTM_VARIANTS.items()}})
    _build.build(["bilstm_seq"])
    timer = C.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(8)
    b, t, e, d = 64, 24, 256, 64
    rnd = lambda *s, k=1.0: k * torch.randn(*s, generator=gen, device=dev)
    x, mask = rnd(b, t, e), torch.ones(b, t, device=dev)
    zeros = torch.zeros(b, d, device=dev)
    fw, bw = ((rnd(e, 4 * d, k=e ** -0.5), rnd(4 * d, k=0.1),
               rnd(d, 4 * d, k=d ** -0.5), rnd(3, d, k=0.3), zeros, zeros)
              for _ in range(2))
    fn = lambda: LK._bi_fwd_kernel(x, mask, fw, bw)
    want = LK._bi_fwd_plain(x, mask, fw, bw)
    key = lambda p: (f"{p.cluster}x{p.rows} "
                     f"{'resident' if p.resident else 'l2'}")
    sms, optin = LK._card(dev)
    held = LK._max_clusters(dev, e, d)
    out = {"planned": key(LK._bi_launch(dev, b, t, e, d)[0])}
    real = LK._bi_launch
    for p in LK._bi_candidates(b, e, d, optin):
        LK._bi_launch = lambda *a, p=p: (p, (b, t, e, d, p.cluster, p.rows,
                                             int(p.resident)))
        try:
            for g_dir, w_dir in zip(fn(), want):
                for g, w in zip(g_dir, w_dir):
                    err = (g - w).abs().max().item()
                    if not err <= C.TOL * max(1.0, w.abs().max().item()):
                        raise AssertionError(f"plan {p}: err {err}")
            out[key(p)] = {"ctas": p.ctas, "clusters_held": held(
                p.cluster, p.rows, p.resident), "alone_ms": C.device_ms(
                [fn], "bilstm_cluster_kernel"), "ms": timer(fn)}
        finally:
            LK._bi_launch = real
    kernel = LK.KERNEL_BI
    whole = kernel._fn or kernel._resolve()
    variants = {}
    for name in BILSTM_VARIANTS:
        kernel._fn = C.planted(*builds[name.replace(" ", "_")], kernel)
        try:
            variants[name] = C.device_ms([fn], "bilstm_cluster_kernel")
        finally:
            kernel._fn = whole
    # the planned plan's first CTA of each direction, cycles a step by part
    kernel._fn = C.planted(*builds["phase_clock"], kernel)
    try:
        fn()
        outs = fn()
        torch.cuda.synchronize()
    finally:
        kernel._fn = whole
    clock = {direction: dict(zip(CLOCK_PARTS, (outs[i][2][0, :6] / t)
                                 .tolist()))
             for i, direction in enumerate(("forward", "reverse"))}
    print(C.nvidia_smi())
    print(json.dumps({"bilstm_plans": out, "variants_alone_ms": variants,
                      "cycles_a_step": clock}), flush=True)
    return 0


#: the plan constants ``--stats-plans`` times at small_vgg's views:
#: (VEC_LANES, TARGET_BLOCKS); a target of 1 gives one row block
STATS_PLANS = tuple(itertools.product((1, 2, 4, 8, 16, 32), (1, 64, 128,
                                                              256)))
#: other builds of csrc/channel_stats.cu ``--stats-plans`` times at the
#: planned plans: {variant: [(its line, what it becomes)]}; "fenced
#: ticket": a relaxed atomicAdd between two __threadfence()s after every
#: writer's own fence, in place of the acquire-release atomic
STATS_VARIANTS = {"fenced ticket": [
    ("    last = ticket.fetch_add(1u, cuda::memory_order_acq_rel) ==",
     "    __threadfence();\n    last = atomicAdd(tickets + blockIdx.x, 1u) "
     "=="),
    ("           (unsigned)(P - 1);", "           (unsigned)(P - 1);\n"
     "    __threadfence();\n    (void)ticket;"),
    ("  // after it).\n  __syncthreads();",
     "  // after it).\n  __threadfence();\n  __syncthreads();")]}


def stats_plans() -> int:
    """``channel_stats`` at small_vgg's five views in f32 and bf16 under
    each of ``STATS_PLANS`` in this tree (``channel_stats.VEC_LANES``
    and ``TARGET_BLOCKS`` set, the prepared calls dropped), then at the
    planned plan on each ``STATS_VARIANTS`` build: each checked against
    the twin, then timed alone (the kernel's device ms in a trace, no
    flush): one JSON line, {"<dtype> <R>x<C>": {"<lanes>/<target>":
    [ms, blocks], "<variant>": ms}, "planned": ...}."""
    import ctypes

    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import channel_stats as CS
    from paddle_tpu_torch.ops.kernels import _kept

    dev = resolve_device(None)
    builds = C.source_fault_builds("channel_stats", {
        name.replace(" ", "_").replace("'", ""): edits
        for name, edits in STATS_VARIANTS.items()})
    _build.build(["channel_stats"])
    gen = torch.Generator(device=dev).manual_seed(20)
    real = CS.VEC_LANES, CS.TARGET_BLOCKS
    out = {"planned": f"{real[0]}/{real[1]}"}
    views = []

    def checked(x, want, what):
        for a, b in zip(CS.channel_stats(x), want):
            err = (a.double() - b).abs().max().item()
            if not err <= C.TOL * max(1.0, b.abs().max().item()):
                raise AssertionError(f"{what}: err {err}")
        return C.device_ms([lambda: CS.channel_stats(x)],
                           C.STATS_KERNEL[x.dtype])

    try:
        for dtype in (torch.float32, torch.bfloat16):
            for r, c in C.VGG_STATS_SHAPES:
                x = (torch.randn(r, c, generator=gen, device=dev) * 2
                     + 0.5).to(dtype)
                want = CS.channel_stats_reference(x.double())
                label = f"{str(dtype)[6:]} {r}x{c}"
                row = out[label] = {}
                views.append((label, x, want))
                for lanes, target in STATS_PLANS:
                    CS.VEC_LANES, CS.TARGET_BLOCKS = lanes, target
                    CS._PREPARED.clear()
                    row[f"{lanes}/{target}"] = [
                        checked(x, want, f"{label} {lanes}/{target}"),
                        CS.plan(r, c, CS.VEC[dtype]).blocks]
    finally:
        CS.VEC_LANES, CS.TARGET_BLOCKS = real
        CS._PREPARED.clear()
    for name in STATS_VARIANTS:
        proc, lib = builds[name.replace(" ", "_").replace("'", "")]
        C.planted(proc, lib, CS.KERNEL)     # waits for the build
        for dtype, kernel in CS.KERNELS.items():
            whole = kernel._fn or kernel._resolve()
            kernel._fn = getattr(ctypes.CDLL(str(lib)), kernel.symbol)
            kernel._fn.argtypes = kernel.argtypes
            kernel._fn.restype = ctypes.c_int
            try:
                for label, x, want in views:
                    if x.dtype == dtype:
                        out[label][name] = checked(x, want,
                                                   f"{label} {name}")
            finally:
                kernel._fn = whole
                _kept.forget()
    print(C.nvidia_smi())
    print(json.dumps({"stats_plans_alone_ms": out}), flush=True)
    return 0


#: the Hopper flash forward's block numbering: the source's (every head's
#: heaviest q tile first) and, in a copy of the source, by head (a head's
#: q tiles together, so they share its K and V in L2)
ORDER_LINES = (
    "  const int bh = blockIdx.x, b = bh / H, h = bh % H;\n"
    "  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;  "
    "// heaviest first",
    "  const int lin = blockIdx.x + blockIdx.y * gridDim.x;\n"
    "  const int bh = lin / gridDim.y, b = bh / H, h = bh % H;\n"
    "  const int q0 = (gridDim.y - 1 - lin % gridDim.y) * kRows;")


def flash_order() -> int:
    """The Hopper flash forward alone (a trace, no flush) with its blocks
    numbered as the source numbers them and by head (a copy of the
    source), in turns (source, copy, copy, source), at serving's prefill
    [8, 512, 12, 64] and LM training [16, 1024, 12, 64] causal shapes,
    each output checked against the twin first: one JSON line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    dev = resolve_device(None)
    builds = C.source_fault_builds("flash_attention",
                                   {"by_head": [ORDER_LINES]})
    _build.build(["flash_attention"])
    kern = FA.KERNEL_WGMMA
    real = kern._fn or kern._resolve()
    by_head = C.planted(*builds["by_head"], kern)
    gen = torch.Generator(device=dev).manual_seed(3)
    out = {}
    for b, t in ((8, 512), (16, 1024)):
        q, k, v = (torch.randn(b, t, 12, 64, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        call = lambda: FA._fwd_bthd(q, k, v, True, 0.125)  # noqa: E731
        for turn, (name, fn) in enumerate((
                ("heaviest_first", real), ("by_head", by_head),
                ("by_head", by_head), ("heaviest_first", real))):
            kern._fn = fn
            o, lse = call()
            a = C.flash_forward_agreement(q, k, v, o, lse, True, 0.125)
            if not a["agrees"]:
                raise AssertionError(f"{name} at [{b}, {t}]: {a}")
            out[f"{b}x{t} turn {turn} {name}"] = C.device_ms(
                [call], "flash_fwd_wgmma_kernel")
        kern._fn = real
    print(json.dumps({"flash_order_alone_ms": out}), flush=True)
    return 0


#: source variants of the f32 backward (csrc/flash_attention_bwd.cu) that
#: ``--tf32-variants`` times beside the source: {variant: [(its line, what
#: it becomes)]}.  "cvt_rna": the TF32 rounding by the conversion
#: instruction; "s_apart": S and dP's slices summed apart at every head
#: dim (the source: at 128 only); "long_chained": dV, dK and dQ's slices
#: chained into their accumulators; "dkv_by_head": the dK/dV blocks numbered
#: by head (a head's key tiles together, for its Q and dO tiles' reuse in
#: L2) where the source numbers them key tile by key tile over all heads;
#: "free_registers": both kernels' registers left to ptxas (the source asks
#: for two blocks an SM);
#: "copy_per_row": each 16-byte copy's row and address computed apart
#: (tf32x3.cuh); "dkv_rows_in_fetch": Q's and dO's row bases computed at
#: each fetch instead of held through the loop
TF32_VARIANTS = {
    "cvt_rna": [("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
                 "  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(r) : "
                 "\"f\"(x));\n"
                 "  return r;")],
    "s_apart": [("constexpr bool kSliceApart = D > 64;",
                 "constexpr bool kSliceApart = true;")],
    "long_chained": [
        (f"        mma3_add({x}, {a}, {m}[bi], {m}[bi + LD]);",
         f"        mma3({x}, {a}, {m}[bi], {m}[bi + LD]);")
        for x, a, m in (("acc_v[dn]", "pa", "sdo"), ("acc_k[dn]", "da", "sq"),
                        ("acc[dn]", "sa", "sk"))],
    "dkv_by_head": [
        ("  const int j = blockIdx.y, bh = blockIdx.x;  // j = 0 (most work) "
         "first",
         "  const int j = blockIdx.x, bh = blockIdx.y;"),
        ("  const dim3 grid(B * H, (t_k + kB - 1) / kB);",
         "  const dim3 grid((t_k + kB - 1) / kB, B * H);")],
    "free_registers": [
        ("__global__ void __launch_bounds__(kThreads, 2)\n"
         f"flash_bwd_{k}_tf32x3_kernel(",
         "__global__ void __launch_bounds__(kThreads)\n"
         f"flash_bwd_{k}_tf32x3_kernel(") for k in ("dkv", "dq")],
    "copy_per_row": [(
        "  const int r0 = tid / kPerRow, e = 4 * (tid % kPerRow);\n"
        "  const float* p = src.base + (row0 + r0) * src.stride + e;\n"
        "  const long long jump = kStep * src.stride;\n"
        "  float* d = dst + r0 * ld<D>() + e;\n"
        "#pragma unroll\n"
        "  for (int i = 0; i < kB / kStep; ++i) {\n"
        "    const bool ok = row0 + r0 + i * kStep < rows;\n"
        "    bf16_tc::cp_async16(d + i * kStep * ld<D>(), ok ? p + i * jump\n"
        "                                                     : src.base, ok);\n"
        "  }\n",
        "#pragma unroll\n"
        "  for (int i = 0; i < kB * kPerRow / kThreads; ++i) {\n"
        "    const int c = tid + i * kThreads;\n"
        "    const int r = c / kPerRow, e = 4 * (c % kPerRow);\n"
        "    const bool ok = row0 + r < rows;\n"
        "    bf16_tc::cp_async16(dst + r * ld<D>() + e,\n"
        "                        ok ? src.base + (row0 + r) * src.stride + e\n"
        "                           : src.base, ok);\n"
        "  }\n")],
    "dkv_rows_in_fetch": [
        ("  const Rows qr = ops.rows(0, b, h), dor = ops.rows(3, b, h);\n",
         ""),
        ("    copy_rows<D, kThreads>(stage_q(s), qr, i * kB, t_q, tid);\n"
         "    copy_rows<D, kThreads>(stage_do(s), dor, i * kB, t_q, tid);\n",
         "    copy_rows<D, kThreads>(stage_q(s), ops.rows(0, b, h), i * kB, "
         "t_q, tid);\n"
         "    copy_rows<D, kThreads>(stage_do(s), ops.rows(3, b, h), i * kB, "
         "t_q, tid);\n")],
}


def tf32_variants() -> int:
    """The f32 backward kernels (3xTF32) at the LM training shape [16,
    1024, 12, 64] causal, the source and each of TF32_VARIANTS in turns
    (source, variants, variants reversed, source): each checked against
    the twin (1e-4 x max(1, |ref|)) first on the in-place route, then
    timed alone (a trace, no flush) on the in-place route (q, k, v, dO
    [B, T, H, D] as they lie: each 256-byte row 3 KB from the next) and
    on the padded problem's [BH, Tp, 1, D] views (a tile 16 KB in one
    piece), with dq, dk, dv's relative norm against the float64 twin on
    the same inputs: one JSON line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    dev = resolve_device(None)
    builds = C.source_fault_builds("flash_attention_bwd", TF32_VARIANTS)
    _build.build(["flash_attention", "flash_attention_bwd"])
    kerns = (FA.KERNEL_BWD_DQ, FA.KERNEL_BWD_DKV)
    fns = {"source": [k._fn or k._resolve() for k in kerns]}
    for name, (proc, lib) in builds.items():
        fns[name] = C.planted_all(proc, lib, kerns)
    gen = torch.Generator(device=dev).manual_seed(3)
    b, t, h, d = 16, 1024, 12, 64
    scale = d ** -0.5
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                  for _ in range(4))
    o, lse = FA._fwd_bthd(q, k, v, True, scale)
    delta = FA._delta_bthd(g, o, lse.shape[1])
    bthd = (q, k, v, lse, g, delta, True, scale)
    qp, kp, vp = FA._prep(q, k, v)
    dop = FA._to_bh(g)
    padded = (qp, kp, vp, lse, dop, delta.view(b * h, -1, 1), t, True,
              scale)
    # the same problem as [BH, T, 1, D] views of the padded copies (T is
    # a multiple of 64 here): each head's rows one piece
    views = (qp[:, :, None], kp[:, :, None], vp[:, :, None], lse,
             dop[:, :, None], delta, True, scale)
    want = [FA._from_bh(x, b, h, t, d) for x in (
        FA._bwd_dq_plain(*padded), *FA._bwd_dkv_plain(*padded))]
    wide = [x.double() for x in (qp, kp, vp, dop)]
    o64, lse64 = FA._fwd_plain(*wide[:3], t, True, scale)
    args64 = (*wide[:3], lse64, wide[3], FA._delta(wide[3], o64), t, True,
              scale)
    want64 = [FA._from_bh(x, b, h, t, d) for x in (
        FA._bwd_dq_plain(*args64), *FA._bwd_dkv_plain(*args64))]
    del wide, o64, args64
    names = [n for n in fns if n != "source"]
    out = {}
    for turn, name in enumerate(["source", *names, *names[::-1], "source"]):
        for kern, fn in zip(kerns, fns[name]):
            kern._fn = fn
        got = (FA._bwd_dq_bthd(*bthd), *FA._bwd_dkv_bthd(*bthd))
        for x, y in zip(got, want):
            e = (x - y).abs().max().item()
            if not e <= C.TOL * max(1.0, y.abs().max().item()):
                raise AssertionError(f"{name}: kernel vs plain {e}")
        out[f"turn {turn} {name}"] = {
            "dq": C.device_ms([lambda: FA._bwd_dq_bthd(*bthd)],
                              "flash_bwd_dq_tf32x3"),
            "dkv": C.device_ms([lambda: FA._bwd_dkv_bthd(*bthd)],
                               "flash_bwd_dkv_tf32x3"),
            "dq_padded_views": C.device_ms(
                [lambda: FA._bwd_dq_bthd(*views)], "flash_bwd_dq_tf32x3"),
            "dkv_padded_views": C.device_ms(
                [lambda: FA._bwd_dkv_bthd(*views)], "flash_bwd_dkv_tf32x3"),
            "vs_f64": [C.rel_norm(x, y) for x, y in zip(got, want64)]}
    for kern, fn in zip(kerns, fns["source"]):
        kern._fn = fn
    print(json.dumps({"tf32_variants_alone_ms": out}), flush=True)
    return 0


def sass_counts(trees: list[str]) -> int:
    """The opcode counts of the f32 flash kernels at head_dim 64 (the
    forward, dQ, dK/dV), as ``cuobjdump -sass`` lists their instructions,
    in ``flash_attention.cu`` and ``flash_attention_bwd.cu`` of each tree
    (built into ``build/faults/``): the total, the HMMAs, the NOPs a
    register-starved schedule puts between dependent HMMAs, and the local
    memory's loads and stores: one JSON line."""
    import collections
    import re

    from paddle_tpu_torch.ops.kernels import _build

    tool = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    out = {}
    for tree in trees:
        csrc = os.path.join(os.path.abspath(tree), "paddle_tpu_torch", "ops",
                            "kernels", "csrc")
        for source in ("flash_attention", "flash_attention_bwd"):
            lib = _build.BUILD_DIR.parent / "faults" / f"sass_{source}.so"
            lib.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I",
                            csrc, "-o", str(lib),
                            os.path.join(csrc, f"{source}.cu")], check=True)
            sass = subprocess.run([tool, "-sass", str(lib)], check=True,
                                  capture_output=True, text=True).stdout
            for part in re.split(r"\n\s+Function : ", sass)[1:]:
                name = part.split("\n", 1)[0]
                kind = re.search(
                    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_tf32x3_kernel)ILi64E", name)
                if not kind:
                    continue
                ops = collections.Counter(m.group(1).split(".")[0] for m in
                                          re.finditer(
                    r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                    part))
                out[f"{tree} {kind.group(1)}"] = {
                    "total": sum(ops.values()), "HMMA": ops["HMMA"],
                    "NOP": ops["NOP"], "LDL": ops["LDL"], "STL": ops["STL"]}
    print(json.dumps({"sass_counts": out}), flush=True)
    return 0


#: source variants of the f32 forward (csrc/flash_attention.cu and
#: tf32x3.cuh) that ``--tf32-fwd-variants`` times beside the source:
#: "s_apart": S's slices summed apart at head_dim 64 (the source: chained
#: at <= 64); "three_stages": a 3-deep ring of K/V tiles (the source: 2);
#: "q_from_smem": Q's fragments split from shared memory every tile at
#: head_dim 64 too (the source keeps them in registers at <= 64);
#: "lo_unrounded": the low parts passed unrounded (the tensor cores drop
#: their low bits), two ALU operations a split fewer: what the split costs;
#: "two_blocks": registers for two blocks an SM (the source asks ptxas for
#: three at head_dim <= 64)
TF32_FWD_VARIANTS = {
    "q_from_smem": [("constexpr bool kQInRegisters = D <= 64;",
                     "constexpr bool kQInRegisters = false;")],
    "lo_unrounded": [("  lo = to_tf32(x - __uint_as_float(hi));",
                      "  lo = __float_as_uint(x - __uint_as_float(hi));")],
    "two_blocks": [("constexpr int kMinBlocks = D <= 64 ? 3 : 1;",
                    "constexpr int kMinBlocks = D <= 64 ? 2 : 1;")],
    "s_apart": [("constexpr bool kSliceApart = D > 64;",
                 "constexpr bool kSliceApart = true;")],
    "three_stages": [("constexpr int kStages = 2;     // K/V tiles of the "
                      "ring",
                      "constexpr int kStages = 3;     // K/V tiles of the "
                      "ring")],
}


def fma_forward(parent: str):
    """The FMA form of the f32 forward from an earlier tree's
    ``flash_attention.cu`` (its entry ``flash_attention_fwd_f32`` on the
    padded [BH, Tp, D] problem), built into ``build/faults/``: a function
    of (qp, kp, vp, t_k, causal, scale) -> (o, lse) like ``_fwd_kernel``."""
    import ctypes

    import torch

    from paddle_tpu_torch.ops.kernels import _build

    csrc = os.path.join(os.path.abspath(parent), "paddle_tpu_torch", "ops",
                        "kernels", "csrc")
    lib = _build.BUILD_DIR.parent / "faults" / "flash_attention_fma.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", csrc, "-o",
                    str(lib), os.path.join(csrc, "flash_attention.cu")],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).flash_attention_fwd_f32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * 5 + [I] * 6 + [ctypes.c_float, P]
    fn.restype = I

    def run(qp, kp, vp, t_k, causal, scale):
        bh, tqp, d = qp.shape
        o = torch.empty_like(qp)
        lse = torch.empty((bh, tqp, 1), device=qp.device)
        code = fn(qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), o.data_ptr(),
                  lse.data_ptr(), bh, tqp, kp.shape[1], t_k, d, int(causal),
                  scale, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"flash_attention_fwd_f32: CUDA error {code}")
        return o, lse
    return run


def tf32_fwd_variants(parent: str | None) -> int:
    """The f32 forward at the LM training shape [16, 1024, 12, 64] and at
    serving's prefill shape [8, 512, 12, 64] causal: the source, each of
    TF32_FWD_VARIANTS and (with ``parent``) the parent's FMA form, in
    turns (source, variants, variants reversed, source): o and lse checked
    against the twin (TOL) first, then timed alone (a trace, no flush) and
    with the L2 flushed, with o's relative norm against float64 exact
    attention: one JSON line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    dev = resolve_device(None)
    builds = C.source_fault_builds("flash_attention", TF32_FWD_VARIANTS)
    _build.build(["flash_attention"])
    real = FA.KERNEL._fn or FA.KERNEL._resolve()
    fns = {"source": real}
    for name, (proc, lib) in builds.items():
        fns[name] = C.planted(proc, lib, FA.KERNEL)
    fma = fma_forward(parent) if parent else None
    timer = C.Timer(dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    out = {}
    for b, t in ((16, 1024), (8, 512)):
        h, d = 12, 64
        scale = d ** -0.5
        q, k, v = (torch.randn(b, t, h, d, generator=gen, device=dev)
                   for _ in range(3))
        qp, kp, vp = FA._prep(q, k, v)
        o_ref, lse_ref = FA._fwd_plain(qp, kp, vp, t, True, scale)
        o64 = FA.flash_attention_reference(q.double(), k.double(),
                                           v.double(), causal=True)
        names = [n for n in fns if n != "source"] + (["fma"] if fma else [])
        shape = {}
        for turn, name in enumerate(["source", *names, *names[::-1],
                                     "source"]):
            if name == "fma":
                call = lambda: fma(qp, kp, vp, t, True, scale)  # noqa: E731
                key = "flash_fwd_kernel"
                o, lse = call()
                o = FA._from_bh(o, b, h, t, d)
            else:
                FA.KERNEL._fn = fns[name]
                call = lambda: FA._fwd_bthd(q, k, v, True,  # noqa: E731
                                            scale)
                key = "flash_fwd_tf32x3_kernel"
                o, lse = call()
            e = max((o - FA._from_bh(o_ref, b, h, t, d)).abs().max().item(),
                    (lse - lse_ref).abs().max().item())
            if not e <= C.TOL:
                raise AssertionError(f"{name} [{b}, {t}]: vs plain {e}")
            shape[f"turn {turn} {name}"] = {
                "alone_ms": C.device_ms([call], key), "ms": timer(call),
                "vs_f64": C.rel_norm(o, o64)}
        FA.KERNEL._fn = real
        out[f"[{b}, {t}, {h}, {d}]"] = shape
        del q, k, v, qp, kp, vp, o_ref, lse_ref, o64
    print(json.dumps({"tf32_fwd_variants": out}), flush=True)
    return 0


#: tokens a chunk ``--paged-chunks`` times the f32 paged decode with (pages
#: a chunk 1, 2, 4, 8, 16 at serving's page of 16), and the bf16 form
#: (pages a chunk 4, 8, 16, 32)
PAGED_CHUNK_TOKENS = (16, 32, 64, 128, 256)
PAGED_CHUNK_TOKENS_BF16 = (64, 128, 256, 512)


def paged_chunks() -> int:
    """The f32 paged decode at serving's shape (``chip_smoke.paged_inputs``)
    with each of PAGED_CHUNK_TOKENS as ``CHUNK_TOKENS`` in turns (the list,
    then reversed): checked against the twin (TOL) first, then timed alone
    (a trace, no flush) and with the L2 flushed; then the bf16 form in bf16
    with each of PAGED_CHUNK_TOKENS_BF16 as ``CHUNK_TOKENS_BF16``, checked
    by ``paged_bf16_agreement``, alone (both kernels) and flushed: one JSON
    line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    dev = resolve_device(None)
    _build.build(["paged_attention"])
    q, kp, vp, pt, sl, _ = C.paged_inputs(dev)
    ref = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    timer = C.Timer(dev)
    call = lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl)  # noqa: E731
    kept, out = PA.CHUNK_TOKENS, {}
    order = [*PAGED_CHUNK_TOKENS, *PAGED_CHUNK_TOKENS[::-1]]
    for turn, tokens in enumerate(order):
        PA.CHUNK_TOKENS = tokens
        e = (call() - ref).abs().max().item()
        if not e <= C.TOL:
            raise AssertionError(f"{tokens} tokens a chunk: vs plain {e}")
        out[f"turn {turn} pages_a_chunk "
            f"{PA.pages_per_chunk(kp.shape[2])}"] = {
            "alone_ms": C.device_ms([call], "paged_split_kernel"),
            "ms": timer(call)}
    PA.CHUNK_TOKENS = kept
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    kept, bf16 = PA.CHUNK_TOKENS_BF16, {}
    order = [*PAGED_CHUNK_TOKENS_BF16, *PAGED_CHUNK_TOKENS_BF16[::-1]]
    for turn, tokens in enumerate(order):
        PA.CHUNK_TOKENS_BF16 = tokens
        a = C.paged_bf16_agreement(q, kp, vp, pt, sl)
        if not a["agrees"]:
            raise AssertionError(f"bf16, {tokens} tokens a chunk: {a}")
        bf16[f"turn {turn} pages_a_chunk "
             f"{PA.pages_per_chunk(kp.shape[2], torch.bfloat16)}"] = {
            "alone_ms": C.device_passes_ms(
                [call], C.PAGED_BF16_KERNELS)["total"],
            "ms": timer(call)}
    PA.CHUNK_TOKENS_BF16 = kept
    print(json.dumps({"paged_chunks": out, "paged_chunks_bf16": bf16}),
          flush=True)
    return 0


#: source variants of the bf16 Hopper backward (csrc/flash_attention_bwd.cu)
#: that ``--wgmma-bwd-variants`` times beside the source: "dq_two_blocks":
#: the dQ kernel held to two blocks an SM (112 registers a thread);
#: "two_stages": a 2-stage ring at head_dim 64 (the source: 4)
WGMMA_BWD_VARIANTS = {
    "dq_two_blocks": [("__global__ void __launch_bounds__(kThreads, 1)\n"
                       "flash_bwd_dq_wgmma_kernel(",
                       "__global__ void __launch_bounds__(kThreads, 2)\n"
                       "flash_bwd_dq_wgmma_kernel(")],
    "two_stages": [("  static constexpr int kStages = D == 64 ? 4 : 3;",
                    "  static constexpr int kStages = D == 64 ? 2 : 3;")],
}


def wgmma_bwd_variants() -> int:
    """The bf16 Hopper backward's dQ and dK/dV kernels at the LM training
    shape [16, 1024, 12, 64] causal, the source and each of
    WGMMA_BWD_VARIANTS in turns (source, variants, variants reversed,
    source): dq, dk, dv checked against the twins by ``bf16_agrees``
    first, then each kernel timed alone (a trace, no flush): one JSON
    line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import flash_attention as FA

    dev = resolve_device(None)
    builds = C.source_fault_builds("flash_attention_bwd", WGMMA_BWD_VARIANTS)
    _build.build(["flash_attention", "flash_attention_bwd"])
    kerns = (FA.KERNEL_BWD_DQ_WGMMA, FA.KERNEL_BWD_DKV_WGMMA)
    fns = {"source": [k._fn or k._resolve() for k in kerns]}
    for name, (proc, lib) in builds.items():
        fns[name] = C.planted_all(proc, lib, kerns)
    gen = torch.Generator(device=dev).manual_seed(4)
    b, t, h, d = 16, 1024, 12, 64
    scale = d ** -0.5
    q, k, v, g = (torch.randn(b, t, h, d, generator=gen, device=dev)
                  .to(torch.bfloat16) for _ in range(4))
    o, lse = FA._fwd_bthd(q, k, v, True, scale)
    want, mags = C.flash_wgmma_bwd_want(q, k, v, o, lse, g, True, scale)
    args = (lse, g, FA._delta_bthd(g, o, lse.shape[1]), True, scale)
    names = [n for n in fns if n != "source"]
    out = {}
    for turn, name in enumerate(["source", *names, *names[::-1], "source"]):
        for kern, fn in zip(kerns, fns[name]):
            kern._fn = fn
        got = FA._bwd_bthd(q, k, v, o, lse, g, True, scale)
        for n, x in zip(("dq", "dk", "dv"), got):
            if not C.bf16_agrees(x, want[n], mags[n],
                                 coef=C.FLASH_BF16_FLIP):
                raise AssertionError(f"{name}: {n} against the twin")
        out[f"turn {turn} {name}"] = {
            "dq": C.device_ms([lambda: FA._bwd_dq_bthd(q, k, v, *args)],
                              "flash_bwd_dq_wgmma"),
            "dkv": C.device_ms([lambda: FA._bwd_dkv_bthd(q, k, v, *args)],
                               "flash_bwd_dkv_wgmma")}
    for kern, fn in zip(kerns, fns["source"]):
        kern._fn = fn
    print(json.dumps({"wgmma_bwd_variants_alone_ms": out}), flush=True)
    return 0


def time_turns(fns: dict, run) -> dict:
    """``run(name, fn)`` for the source and each variant of ``fns``
    ({name: C entry}, "source" among them) in turns: source, variants,
    variants reversed, source; each turn's row printed as it comes;
    returns {"turn i name": row}."""
    names = [n for n in fns if n != "source"]
    out = {}
    for turn, name in enumerate(["source", *names, *names[::-1], "source"]):
        key = f"turn {turn} {name}"
        out[key] = run(name, fns[name])
        print(json.dumps({key: out[key]}), flush=True)
    return out


def variant_fns(kern, source: str, edits: dict, tree: str = ".") -> dict:
    """{"source": ``kern``'s C entry built from ``tree``'s
    ``csrc/<source>.cu`` as it is, name: built with that variant's edits}
    for each of ``edits`` whose lines that source (or a header beside it)
    has; the builds start together."""
    import chip_smoke as C

    csrc = os.path.join(tree, "paddle_tpu_torch", "ops", "kernels", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in sorted(os.listdir(csrc))
                   if f == f"{source}.cu" or f.endswith(".cuh"))
    edits = {"source": [], **{n: e for n, e in edits.items()
                              if all(line in text for line, _ in e)}}
    builds = C.source_fault_builds(source, edits, csrc=csrc,
                                   prefix=f"variant_{abs(hash(tree))}_")
    return {name: C.planted(*build, kern) for name, build in builds.items()}


#: builds of a tree's ``csrc/lstm_seq.cu`` that ``--lstm-bwd-split`` times
#: beside that tree's source, each dropping one part of the f32 backward's
#: step, to give each part its share (their results are wrong and not
#: checked): the partial writes of dh_{t-1}'s shares (the product kept by a
#: test no value passes), the (B) sum over the blocks' partials, the remat
#: product, the dh product with its writes, the grid barrier.  A tree takes
#: the variants whose lines its source has: the FMA form's (the tree before
#: the dh product moved to the tensor cores, ``git show 914dacf``) or the
#: 3xTF32 form's
LSTM_BWD_SPLIT = {
    "no_partial_writes": [(
        "            if (r < rows) Pb[(size_t)k * B + r] = pacc[i][n];",
        "            if (r < rows && pacc[i][n] == -1.2345e-38f)\n"
        "              Pb[(size_t)k * B + r] = pacc[i][n];")],
    "no_sum": [(
        "    const int n_out = B * nu;\n"
        "    for (int e0 = threadIdx.x; e0 < n_out; e0 += 4 * blockDim.x) {",
        "    const int n_out = B * nu;\n"
        "    for (int e0 = threadIdx.x; e0 < 0 * n_out; e0 += 4 * blockDim.x)"
        " {")],
    "no_remat_product": [(
        "        gemm_gates<S>(a, first ? D : TD, rows, D, w_s, U, uu, rg, "
        "half, a_s,\n                      fin);",
        "        for (int i = 0; i < 2; ++i)\n"
        "          for (int g = 0; g < 4; ++g) fin[i][g] = 0.f * a[0];")],
    "no_dh_product": [(
        "      for (int j0 = 0; uu + U * j0 < D; j0 += 4) {",
        "      for (int j0 = 0; uu + U * j0 < 0; j0 += 4) {")],
    "no_grid_barrier": [(
        "    grid.sync();\n    // (B) dh_{t-1} of the own units: the partials "
        "summed in block order,\n    // four outputs a thread interleaved "
        "(32",
        "    // (B) dh_{t-1} of the own units: the partials summed in block "
        "order,\n    // four outputs a thread interleaved (32")],
    "no_dh_share": [("      dh_share(dg_s, ldg, w_s, U, D, B4, rows,\n"
                     "               P + (size_t)blockIdx.x * D * B4 + b0);",
                     "")],
    "no_range_sum": [("      if (grp < groups && q < nq) {",
                      "      if (false) {"),
                     ("      if (grp == 0 && q < nq) {", "      if (false) {")],
    "no_grid_barrier_tf32": [(
        "    grid.sync();\n    // (B) dh_{t-1} of the own units: the blocks' "
        "partials summed, four\n", "    // (B) dh_{t-1} of the own units: "
        "the blocks' partials summed, four\n")]}

#: builds of a tree's ``csrc/lstm_seq.cu`` that ``--lstm-fwd-split`` times
#: beside that tree's source, each dropping one part of the f32 forward's
#: step, to give each part its share (their results are wrong and not
#: checked): the h_{t-1} W_h product, the fused-input form's x_t W_x
#: product, the grid barrier, the cell with its stores (the product kept
#: by a test no value passes).  A tree takes the variants whose lines its
#: source has: the products' calls of the FMA form (the tree before the
#: product moved to the tensor cores, ``git show 8ba8484``) or of the
#: 3xTF32 form (``_tf32``, ``_3xtf32``); the cell is the same in both
LSTM_FWD_SPLIT = {
    "no_h_product": [(
        "      gemm_gates<S>(a, s == 0 ? D : TD, rows, D, w_s, U, uu, rg, "
        "half, a_s,\n                    fin);",
        "      for (int i = 0; i < 2; ++i)\n"
        "        for (int g = 0; g < 4; ++g) fin[i][g] = 0.f * a[0];")],
    "no_x_product": [(
        "        gemm_gates<S>(in + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, "
        "U,\n                      uu, rg, half, a_s, px);",
        "        for (int i = 0; i < 2; ++i)\n"
        "          for (int g = 0; g < 4; ++g) px[i][g] = 0.f * in[0];")],
    "no_h_product_tf32": [(
        "      gemm_gates<S, true>(a, s == 0 ? D : TD, rows, D, w_s, U, uu, rg, "
        "half,\n                          a_s, fin);",
        "      for (int i = 0; i < 2; ++i)\n"
        "        for (int g = 0; g < 4; ++g) fin[i][g] = 0.f * a[0];")],
    "no_x_product_tf32": [(
        "        gemm_gates<S, true>(in + b0 * TE + (size_t)t * E, TE, rows, E, "
        "wx_s,\n                            U, uu, rg, half, a_s, px);",
        "        for (int i = 0; i < 2; ++i)\n"
        "          for (int g = 0; g < 4; ++g) px[i][g] = 0.f * in[0];")],
    "no_grid_barrier": [(
        "    grid.sync();\n  }\n}\n\ntemplate <bool kRemat, int S>",
        "  }\n}\n\ntemplate <bool kRemat, int S>")],
    "no_grid_barrier_3xtf32": [(
        "    grid.sync();\n  }\n}\n\n// kThreads: the block's bound",
        "  }\n}\n\n// kThreads: the block's bound")],
    "no_cell": [(
        "        if (!live || r >= rows) continue;\n        const int b = b0 + r;"
        "\n        const Gates q = cell(x[i][0], x[i][1], x[i][2], x[i][3], "
        "fin[i][0],",
        "        if (!live || r >= rows || fin[i][0] != -1.2345e-38f) continue;"
        "\n        const int b = b0 + r;\n        const Gates q = cell(x[i][0], "
        "x[i][1], x[i][2], x[i][3], fin[i][0],")]}


#: the product's ring step (the GRU's header has its first lines too)
_RING = ("    cp_async_wait<S - 2>();\n    __syncthreads();\n"
         "    const int cn = c + S - 1;\n")
_RING_TAIL = ("    if (cn < nc) load_chunk(a_s + (cn % S) * kStage, a, lda, rows, "
              "K, cn);\n    cp_async_commit();\n    stage(c, a_s + (c % S) * "
              "kStage);")

#: builds of ``csrc/lstm_seq.cu`` that ``--lstm-fwd-variants`` times beside
#: the source's f32 forward (timing probes, results unchecked): the column
#: walk at every U (the source: from U 7), the ring's wait made
#: one chunk short (compute on the stage as it is), the wait and the chunk
#: barrier both dropped, two stages in place of three
LSTM_FWD_VARIANTS = {
    "columns_from_1": [("constexpr int kColumnsFrom = 7;",
                        "constexpr int kColumnsFrom = 1;")],
    "no_load_wait": [(_RING + _RING_TAIL, _RING.replace(
        "<S - 2>", "<S - 1>") + _RING_TAIL)],
    "no_wait_no_sync": [(_RING + _RING_TAIL,
                         _RING.split("\n", 2)[2] + _RING_TAIL)],
    "two_stages": [("  for (int s = 3; s >= 2; --s)\n    if (sizeof(float) * "
                    "(size_t)Plan(K, U, s)", "  for (int s = 2; s >= 2; --s)\n"
                    "    if (sizeof(float) * (size_t)Plan(K, U, s)")]}


def lstm_fwd_times(edits: dict, tree: str = ".") -> dict:
    """The f32 LSTM forward built from ``tree``'s source (a checkout whose
    C entries take this tree's arguments: default this one), through this
    tree's wrappers, as that source is and as each of ``edits`` whose
    lines it has, in turns (:func:`time_turns`), each timed alone (a
    trace, no flush) and with the L2 flushed: over xw at the text shape
    (B 64, T 128, D 1280, lengths 100; ``check_text_kernels``' inputs;
    a variant named ``no_x_product...`` has no part there) and in its
    fused-input form at row 6's (``RAW_RNN``'s LSTM: B 64, T 100, E 128,
    D 512, the forward direction).  The source is checked against the
    twin (TOL x max(1, |ref|)) first.  Returns {shape: {"turns": the
    rows, "mean": each build's mean, "shares_ms": the source's mean less
    each variant's}}."""
    import numpy as np
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import lstm as LK

    dev = resolve_device(None)
    csrc = os.path.join(tree, "paddle_tpu_torch", "ops", "kernels", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in sorted(os.listdir(csrc))
                   if f == "lstm_seq.cu" or f.endswith(".cuh"))
    edits = {"source": [], **{n: e for n, e in edits.items()
                              if all(line in text for line, _ in e)}}
    builds = C.source_fault_builds("lstm_seq", edits, csrc=csrc,
                                   prefix=f"fwd_{abs(hash(tree))}_")
    entries = {n: C.planted_all(*b, [LK.KERNEL_FWD, LK.KERNEL_FI])
               for n, b in builds.items()}
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d = 64, 128, 1280
    mask = (torch.arange(t, device=dev)[None, :] < 100).float().expand(
        b, t).contiguous()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = c0 = torch.zeros(b, d, device=dev)
    text_args = (xw, mask, w_h, peep, h0, c0, False, False)
    _, rb, rt, re, rd = C.RAW_RNN[0]
    x, lens, w, init, _ = C.raw_rnn_inputs(dev, "lstm", rb, rt, re, rd)
    fi_mask = (torch.arange(rt, device=dev)[None, :]
               < lens[:, None]).float()
    fi_args = (x, fi_mask, w["w_x"], w["b"], w["w_h"],
               torch.zeros(3, rd, device=dev), *init, False, False)
    timer = C.Timer(dev)
    shapes = {"text": (LK.KERNEL_FWD, 0, lambda: LK._fwd_kernel(*text_args),
                       LK._fwd_plain(*text_args), "lstm_fwd_kernel<false"),
              "row6": (LK.KERNEL_FI, 1, lambda: LK._fi_fwd_kernel(*fi_args),
                       LK._fi_fwd_plain(*fi_args), "lstm_fwd_kernel<true")}
    print(C.nvidia_smi(), flush=True)
    out = {}
    for shape, (kern, which, call, want, key) in shapes.items():
        def run(name, fn, kern=kern, call=call, want=want, key=key):
            kern._fn = fn
            got = call()
            if name == "source":
                for g, ref in zip(got, want):
                    if g is None:
                        continue
                    err = (g - ref).abs().max().item()
                    if not err <= C.TOL * max(1.0, ref.abs().max().item()):
                        raise AssertionError(f"{tree} {shape}: vs plain "
                                             f"{err}")
            return {"alone_ms": C.device_ms([call], key), "ms": timer(call)}

        fns = {n: e[which] for n, e in entries.items()
               if not (shape == "text" and n.startswith("no_x_product"))}
        saved = kern._fn
        try:
            turns = time_turns(fns, run)
        finally:
            kern._fn = saved
        by = {}
        for k, row in turns.items():
            by.setdefault(k.split(" ", 2)[2], []).append(row)
        mean = {n: {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
                for n, rows in by.items()}
        out[shape] = {"turns": turns, "mean": mean, "shares_ms": {
            n: {k: mean["source"][k] - mean[n][k] for k in mean[n]}
            for n in mean if n != "source"}}
    return out


def lstm_fwd_split(tree: str) -> int:
    """:func:`lstm_fwd_times` of ``tree``'s source and LSTM_FWD_SPLIT (the
    variants unchecked); one JSON line with each part's share."""
    print(json.dumps({"lstm_fwd_split": lstm_fwd_times(LSTM_FWD_SPLIT, tree),
                      "steps": {"text": 128, "row6": 100}}),
          flush=True)
    return 0


def lstm_fwd_variants() -> int:
    """:func:`lstm_fwd_times` of this tree's source and LSTM_FWD_VARIANTS
    (timing probes, unchecked); one JSON line."""
    print(json.dumps({"lstm_fwd_variants": lstm_fwd_times(
        LSTM_FWD_VARIANTS)}), flush=True)
    return 0


#: builds of ``csrc/lstm_seq.cu`` that ``--lstm-bwd-variants`` times beside
#: the source's f32 backward: the dh product's k tiles a warp takes at once
#: (the source: 8), the (B) sum in one range of blocks (the source: two at
#: the text shape), twice the partials' loads a thread issues before it
#: adds them (the source: 8), and the remat form at 128 registers a
#: thread (the source: 204 where U <= 10)
LSTM_BWD_VARIANTS = {
    **{f"k_tiles_{n}": [("constexpr int kTilesK = 8;",
                         f"constexpr int kTilesK = {n};")] for n in (2, 4)},
    "one_range": [("    const int groups = 2 * nq <= (int)blockDim.x\n",
                   "    const int groups = false\n")],
    "remat_512_bound": [("  if (remat && n <= kNarrow)",
                         "  if (remat && n <= 0)")],
    "unroll_16": [(
        "#pragma unroll 8\n        for (int k = grp * span; k < k1; ++k) {",
        "#pragma unroll 16\n        for (int k = grp * span; k < k1; ++k) {"
    )]}


def lstm_bwd_times(edits: dict, tree: str = ".",
                   check_all: bool = True) -> dict:
    """The f32 LSTM backward (remat) through its wrapper at the text shape
    (B 64, T 128, D 1280, lengths 100; ``check_text_kernels``' sizes),
    its C entry built from ``tree``'s source as it is and with each of
    ``edits`` (:func:`variant_fns`), in turns (:func:`time_turns`): the
    source, and every variant where ``check_all``, checked against the
    twin (TOL x max(1, |ref|)) first, each timed alone (a trace, no
    flush) and with the L2 flushed."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import lstm as LK

    dev = resolve_device(None)
    kern = LK.KERNEL_BWD
    fns = variant_fns(kern, "lstm_seq", edits, tree)
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d = 64, 128, 1280
    mask = (torch.arange(t, device=dev)[None, :] < 100).float().expand(
        b, t).contiguous()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = c0 = dh_t = dc_t = torch.zeros(b, d, device=dev)
    dhs = torch.randn(b, t, d, generator=gen, device=dev)
    hs, cs = LK._fwd_plain(xw, mask, w_h, peep, h0, c0, False, False)[:2]
    args = (xw, None, mask, w_h, peep, h0, c0, hs, cs, dhs, dh_t, dc_t,
            False, True)
    call = lambda: LK._bwd_kernel(*args)  # noqa: E731
    want = LK._bwd_plain(*args)
    timer = C.Timer(dev)

    def run(name, fn):
        kern._fn = fn
        got = call()
        for x, ref in zip(got, want):
            err = (x - ref).abs().max().item()
            if (check_all or name == "source") and not (
                    err <= C.TOL * max(1.0, ref.abs().max().item())):
                raise AssertionError(f"{tree} {name}: vs plain {err}")
        return {"alone_ms": C.device_ms([call], "lstm_bwd_kernel"),
                "ms": timer(call)}

    print(C.nvidia_smi(), flush=True)
    saved = kern._fn
    try:
        return time_turns(fns, run)
    finally:
        kern._fn = saved


def lstm_bwd_split(tree: str) -> int:
    """:func:`lstm_bwd_times` of ``tree``'s source and LSTM_BWD_SPLIT (the
    variants unchecked); one JSON line with each part's share (the
    source's mean time less the variant's)."""
    import numpy as np

    out = lstm_bwd_times(LSTM_BWD_SPLIT, tree, check_all=False)
    by = {}
    for key, row in out.items():
        by.setdefault(key.split(" ", 2)[2], []).append(row)
    mean = {n: {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
            for n, rows in by.items()}
    shares = {n: {k: mean["source"][k] - mean[n][k] for k in mean[n]}
              for n in mean if n != "source"}
    print(json.dumps({"lstm_bwd_split": out, "mean": mean,
                      "shares_ms": shares, "steps": 128}), flush=True)
    return 0


def lstm_bwd_variants() -> int:
    """:func:`lstm_bwd_times` of this tree's source and LSTM_BWD_VARIANTS,
    each checked; one JSON line."""
    print(json.dumps({"lstm_bwd_variants": lstm_bwd_times(
        LSTM_BWD_VARIANTS)}), flush=True)
    return 0


#: builds of a tree's ``csrc/lstm_seq.cu`` that ``--lstm-bwd-split --bf16``
#: times beside that tree's source, each dropping one part of the bf16
#: backward's step (their results are wrong and not checked).  The tree
#: before the redesign (``git show 9093cce``): the partial writes of
#: dh_{t-1}'s f32 shares (the product kept by a test no value passes), the
#: (B) sum over them, the remat product, ``partial_product`` with its
#: writes, the grid barrier.  The redesign: the rounded dgates' writes to
#: the exchange X, the dh product's first pass (``dh_part``) and second
#: (``dh_sum``), the remat product, the two grid barriers around the first
#: pass
LSTM_BF16_BWD_SPLIT = {
    "no_partial_writes": [
        ("      if (r < rows) {\n        Pb[(size_t)k * B + r] = acc[0];",
         "      if (r < rows && acc[0] == -1.2345e-38f) {\n"
         "        Pb[(size_t)k * B + r] = acc[0];"),
        ("      if (r + 8 < rows) {\n        Pb[(size_t)k * B + r + 8] = acc[2];",
         "      if (r + 8 < rows && acc[2] == -1.2345e-38f) {\n"
         "        Pb[(size_t)k * B + r + 8] = acc[2];")],
    "no_sum": [(
        "    for (int e0 = threadIdx.x; e0 < n_out; e0 += 4 * kThreadsB) {",
        "    for (int e0 = threadIdx.x; e0 < 0 * n_out; e0 += 4 * kThreadsB) {"
    )],
    "no_remat_product": [(
        "        product_bf16<S>(a, first ? D : TD, rows, D, w_s, LDK, NT, a_s, "
        "pre);",
        "        for (int j = 0; j < kMaxNT; ++j)\n"
        "          for (int e = 0; e < 4; ++e) pre[j][e] = 0.f * b2f(a[0]);")],
    "no_partial_product": [(
        "      partial_product(dg_s, LDG, KP / 16, w_s, LDK, D,\n"
        "                      P + (size_t)blockIdx.x * D * B + b0, B, rows);",
        "")],
    "no_grid_barrier": [(
        "    grid.sync();\n    // (B) dh_{t-1} of the own units: the partials "
        "summed in block order,\n",
        "    // (B) dh_{t-1} of the own units: the partials summed in block "
        "order,\n")],
    "no_remat_product_kc": [(
        "        product_bf16<S, kKCB, false>(a, first ? D : TD, rows, D, w_s, "
        "LDK,\n                                     NT, a_s, pre);",
        "        for (int j = 0; j < kMaxNT; ++j)\n"
        "          for (int e = 0; e < 4; ++e) pre[j][e] = 0.f * b2f(a[0]);")],
    "no_dgates_writes": [(
        "            *reinterpret_cast<uint2*>(X + (size_t)b * 4 * D + 4 * u) =",
        "            if (d_i == -1.2345e-38f)\n"
        "            *reinterpret_cast<uint2*>(X + (size_t)b * 4 * D + 4 * u) =")],
    "no_dh_part": [(
        "      dh_part(X, wp, sp, D, B, BP, b0, nmu, ppb);", "      ;")],
    "no_dh_sum": [("    dh_sum(part, sp, D, B, BP, U, nu, u0, dh);", "")],
    "no_grid_barriers_dh": [(
        "    grid.sync();\n    for (int b0 = 0; b0 < B; b0 += kRows)\n"
        "      dh_part(", "    for (int b0 = 0; b0 < B; b0 += kRows)\n"
        "      dh_part("), (
        "    grid.sync();\n    dh_sum(", "    dh_sum(")]}

#: timing probes of the bf16 product (``product_bf16``, the forward's and
#: the remat backward's) and of the backward's dh product's first pass
#: (``dh_part``), results unchecked: the ring's copies dropped (the MMAs
#: read what the slots hold), the MMAs and their B fragments dropped (the
#: A fragments kept live; the schedule without fragments ahead), the
#: barrier of each slice dropped; the first pass's loads of X, its loads
#: of W_h's part
LSTM_BF16_PROBES = {
    "no_ring_loads": [
        ("    if (c < nc) load_slice_a<KC>(a_s + c * kStage, a, lda, rows, K, c);",
         "    if (c < 0) load_slice_a<KC>(a_s + c * kStage, a, lda, rows, K, c);"),
        ("    if (cn < nc) load_slice_a<KC>(a_s + (cn % S) * kStage, a, lda, "
         "rows, K, cn);", "    if (cn < 0) load_slice_a<KC>(a_s + (cn % S) * "
         "kStage, a, lda, rows, K, cn);")],
    "no_mma": [("        const int k0 = c * KC + 16 * ks;",
                "        const int k0 = c * KC + 16 * ks;\n"
                "        if (k0 >= 0) {\n"
                "          acc[0][0] += __uint_as_float(af[0] & 1u);\n"
                "          continue;\n        }")],
    "no_slice_sync": [(
        "    __syncthreads();   // slice c landed; slice c - 1 read by every "
        "warp", "")]}
LSTM_BF16_DH_PROBES = {
    "dh_no_x_loads": [("      x[i] = c + i < c1 && b < B",
                       "      x[i] = c + i < c1 && b < 0")],
    "dh_no_w_loads": [
        ("        const uint4 w0 = m < nmu ? ld16(",
         "        const uint4 w0 = m < 0 ? ld16("),
        ("        const uint4 w1 = m + 8 < nmu ? ld16(",
         "        const uint4 w1 = m + 8 < 0 ? ld16(")]}

#: builds of a tree's ``csrc/lstm_seq.cu`` that ``--lstm-fwd-split --bf16``
#: times beside that tree's source, each dropping one part of the bf16
#: forward's step (results unchecked): the h_{t-1} W_h product, the
#: fused-input form's x_t W_x product, the grid barrier, the cell with its
#: stores (the product kept by a test no value passes)
LSTM_BF16_FWD_SPLIT = {
    "no_h_product": [(
        "      product_bf16<S>(a, s == 0 ? D : TD, rows, D, w_s, LDK, NT, a_s, "
        "pre);",
        "      for (int j = 0; j < kMaxNT; ++j)\n"
        "        for (int e = 0; e < 4; ++e) pre[j][e] = 0.f * b2f(a[0]);")],
    "no_x_product": [(
        "        product_bf16<S>(in + b0 * TE + (size_t)t * E, TE, rows, E, wx_s, "
        "LDE,\n                        NT, a_s, x);",
        "        for (int j = 0; j < kMaxNT; ++j)\n"
        "          for (int e = 0; e < 4; ++e) x[j][e] = 0.f * b2f(in[0]);")],
    "no_h_product_kc": [(
        "      product_bf16<S, kKCF, kAhead>(a, s == 0 ? D : TD, rows, D, w_s, "
        "LDK,\n                                    NT, a_s, pre);",
        "      for (int j = 0; j < kMaxNT; ++j)\n"
        "        for (int e = 0; e < 4; ++e) pre[j][e] = 0.f * b2f(a[0]);")],
    "no_x_product_kc": [(
        "        product_bf16<S, kKCF, false>(in + b0 * TE + (size_t)t * E, TE, "
        "rows,\n                                     E, wx_s, LDE, NT, a_s, x);",
        "        for (int j = 0; j < kMaxNT; ++j)\n"
        "          for (int e = 0; e < 4; ++e) x[j][e] = 0.f * b2f(in[0]);")],
    "no_grid_barrier": [(
        "      __syncthreads();   // the sums and the ring are free for the next "
        "chunk\n    }\n    grid.sync();\n",
        "      __syncthreads();   // the sums and the ring are free for the next "
        "chunk\n    }\n")],
    "no_cell": [(
        "          if (!rok || j >= NT || u >= D) continue;\n"
        "          const Gates q = cell(",
        "          if (!rok || j >= NT || u >= D || pre[j][0] != -1.2345e-38f)\n"
        "            continue;\n          const Gates q = cell(")]}

#: builds of ``csrc/lstm_seq.cu`` that ``--lstm-bf16-variants`` times
#: beside the source's bf16 forward and backward, each held to the
#: source's bits (no sum changes its order): the forward's ring 64 deep
#: (the source: 128) and at most 2 stages (the source: 3); the backward's
#: part of W_h read through L2 where it fits in shared memory; the
#: forward's fragments loaded ahead from U 2, or never (the source: from
#: U 8)
LSTM_BF16_VARIANTS = {
    "kc_64": [("constexpr int kKCF = 128;", "constexpr int kKCF = 64;")],
    "fwd_stages_2": [("  for (int s = 3; s >= 2; --s)\n    if (PlanFwdBf16(",
                      "  for (int s = 2; s >= 2; --s)\n    if (PlanFwdBf16(")],
    "bwd_part_in_l2": [("  for (int p = 1; p >= 0; --p)\n    for (int s = remat",
                        "  for (int p = 0; p >= 0; --p)\n    for (int s = remat")],
    **{f"fwd_ahead_from_u{n}": [("constexpr int kAheadFromU = 8;",
                                  f"constexpr int kAheadFromU = {n};")]
       for n in (2, 99)}}

#: the bf16 shapes the splits run: the text classifier's (B 64, T 128,
#: lengths 100; ``check_rnn_bf16_kernels``) at each hidden width
#: ``bench_lstm`` trains (``bench.py:209``), the backward in both forms
LSTM_BF16_WIDTHS = (1280, 512, 256)


def lstm_bf16_times(kind: str, edits: dict, tree: str = ".",
                    widths=LSTM_BF16_WIDTHS, exact: bool = False) -> dict:
    """The bf16 LSTM ``kind`` ("fwd" or "bwd") through this tree's
    wrappers, its C entries built from ``tree``'s source as it is and with
    each of ``edits`` whose lines it has (:func:`variant_fns`), in turns
    (:func:`time_turns`), each timed alone (a trace, no flush) and with
    the L2 flushed, at B 64, T 128, lengths 100 and each of ``widths``:
    the forward over xw, and at D 1280 also row 6's fused-input form
    (``RAW_RNN``'s LSTM in bf16: B 64, T 100, E 128, D 512); the backward
    with remat and over the stored gates.  The source's outputs are held
    to the bf16 twin's within 1e-2 relative norm first; the variants are
    unchecked, or with ``exact`` held to the source's bits.  Returns {shape: {"turns", "mean" (each build's), and
    "shares_ms" (the source's mean less each variant's)}}."""
    import numpy as np
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import lstm as LK

    dev = resolve_device(None)
    bf = torch.bfloat16
    kerns = ([LK.KERNEL_FWD_BF16, LK.KERNEL_FI_BF16] if kind == "fwd"
             else [LK.KERNEL_BWD_BF16, LK.KERNEL_BWD_STORED_BF16])
    csrc = os.path.join(tree, "paddle_tpu_torch", "ops", "kernels", "csrc")
    text = "".join(open(os.path.join(csrc, f)).read()
                   for f in sorted(os.listdir(csrc))
                   if f == "lstm_seq.cu" or f.endswith(".cuh"))
    edits = {"source": [], **{n: e for n, e in edits.items()
                              if all(line in text for line, _ in e)}}
    builds = C.source_fault_builds("lstm_seq", edits, csrc=csrc,
                                   prefix=f"bf16_{kind}_{abs(hash(tree))}_")
    entries = {n: C.planted_all(*b, kerns) for n, b in builds.items()}
    timer = C.Timer(dev)
    shapes = {}
    for d in widths:
        gen = torch.Generator(device=dev).manual_seed(7)
        x = C.bf16_lstm_inputs(dev, gen, 64, 128, d, torch.full((64,), 100))
        h0 = torch.zeros_like(x["h0"])
        c0 = torch.zeros_like(x["c0"])
        fa = (x["xw"], x["mask"], x["w_h"], x["peep"], h0, c0, False)
        if kind == "fwd":
            shapes[f"text_d{d}"] = (0, lambda fa=fa: LK._fwd_kernel(
                *fa, False), LK._fwd_plain(*fa, False), "lstm_fwd_bf16_kernel"
                "<false")
            continue
        hs, cs, gates = LK._fwd_plain(*fa, True)[:3]
        tail = (x["mask"], x["w_h"], x["peep"], h0, c0, hs, cs, x["dhs"],
                x["dhT"], x["dcT"], False)
        for which, form, args in (
                (0, "remat", (x["xw"], None, *tail, True)),
                (1, "stored", (None, gates, *tail, False))):
            shapes[f"{form}_d{d}"] = (
                which, lambda args=args: LK._bwd_kernel(*args),
                LK._bwd_plain(*args), "lstm_bwd_bf16_kernel")
    if kind == "fwd" and 1280 in widths:
        _, rb, rt, re, rd = C.RAW_RNN[0]
        xr, lens, w, init, _ = C.raw_rnn_inputs(dev, "lstm", rb, rt, re, rd)
        fi = (xr.to(bf), (torch.arange(rt, device=dev)[None, :]
                          < lens[:, None]).float(), w["w_x"].to(bf), w["b"],
              w["w_h"].to(bf), torch.zeros(3, rd, device=dev, dtype=bf),
              init[0].to(bf), init[1], False, False)
        shapes["row6"] = (1, lambda: LK._fi_fwd_kernel(*fi),
                          LK._fi_fwd_plain(*fi), "lstm_fwd_bf16_kernel<true")
    print(C.nvidia_smi(), flush=True)
    out = {}
    for shape, (which, call, want, key) in shapes.items():
        kern = kerns[which]
        first = []

        def run(name, fn, kern=kern, call=call, want=want, key=key,
                first=first):
            kern._fn = fn
            got = [g for g in call() if g is not None]
            if name == "source":
                for g, ref in zip(got, [w for w in want if w is not None]):
                    if not C.rel_norm(g, ref) <= 1e-2:
                        raise AssertionError(f"{tree} {shape}: vs the twin "
                                             f"{C.rel_norm(g, ref)}")
                first[:] = first or got
            elif exact and not all(torch.equal(g, f)
                                   for g, f in zip(got, first)):
                raise AssertionError(f"{tree} {shape} {name}: not the "
                                     "source's bits")
            return {"alone_ms": C.device_ms([call], key), "ms": timer(call)}

        fns = {n: e[which] for n, e in entries.items()
               if not (n.startswith("no_x_product") and shape != "row6")
               and not (n.startswith("no_remat_product")
                        and "stored" in shape)}
        saved = kern._fn
        try:
            turns = time_turns(fns, run)
        finally:
            kern._fn = saved
        by = {}
        for k, row in turns.items():
            by.setdefault(k.split(" ", 2)[2], []).append(row)
        mean = {n: {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
                for n, rows in by.items()}
        out[shape] = {"turns": turns, "mean": mean, "shares_ms": {
            n: {k: mean["source"][k] - mean[n][k] for k in mean[n]}
            for n in mean if n != "source"}}
        print(json.dumps({shape: {"mean": mean,
                                  "shares_ms": out[shape]["shares_ms"]}}),
              flush=True)
    return out


def lstm_bf16_bounds() -> int:
    """The bf16 text forms' bounds (``chip_smoke.lstm_bf16_bytes_flops``:
    the forward without and with its gates slab, the remat and the
    stored-gates backward;
    2 B an element, 989 TFLOP/s, 3.35 TB/s) at B 64, T 128, lengths 100
    and each of LSTM_BF16_WIDTHS; one JSON line (arithmetic, no card)."""
    import chip_smoke as C

    print(json.dumps({f"{kind}_d{d}": C.bound(
        *C.lstm_bf16_bytes_flops(kind, 64, 128, d, 64 * 100),
        C.BF16_FLOPS_PER_S) for d in LSTM_BF16_WIDTHS
        for kind in ("fwd", "fwd_slab", "bwd", "stored")}), flush=True)
    return 0


def lstm_bf16_variants() -> int:
    """:func:`lstm_bf16_times` of this tree's source and LSTM_BF16_VARIANTS,
    the forward and the backward, each variant held to the source's bits;
    one JSON line."""
    print(json.dumps({f"lstm_{k}_bf16_variants": lstm_bf16_times(
        k, LSTM_BF16_VARIANTS, exact=True) for k in ("fwd", "bwd")}),
        flush=True)
    return 0


def lstm_bf16_split(kind: str, tree: str, widths=LSTM_BF16_WIDTHS,
                    probes: bool = False) -> int:
    """:func:`lstm_bf16_times` of ``tree``'s source and the bf16 split of
    ``kind`` (with ``probes``, the probes of its products too) at
    ``widths``; one JSON line with each part's share."""
    edits = LSTM_BF16_FWD_SPLIT if kind == "fwd" else LSTM_BF16_BWD_SPLIT
    if probes:
        edits = {**edits, **LSTM_BF16_PROBES,
                 **(LSTM_BF16_DH_PROBES if kind == "bwd" else {})}
    print(json.dumps({f"lstm_{kind}_split_bf16": lstm_bf16_times(
        kind, edits, tree, widths), "steps": {"text": 128, "row6": 100}}),
        flush=True)
    return 0


#: builds of ``csrc/paged_attention.cu`` that ``--paged-bf16-variants``
#: times beside the source's bf16 form: the row loads a thread issues
#: before it reduces any (the source: 8), 4 and 16
PAGED_BF16_VARIANTS = {
    f"in_flight_{n}": [(
        "constexpr int kInFlight = 8;   // 16-byte row loads a thread issues "
        "first", f"constexpr int kInFlight = {n};")] for n in (4, 16)}


def paged_bf16_variants() -> int:
    """The bf16 paged decode at serving's shape (``paged_inputs`` in bf16)
    as the source builds it and as each of PAGED_BF16_VARIANTS
    (:func:`variant_fns`), in turns (:func:`time_turns`): each checked by
    ``paged_bf16_agreement`` first, then timed alone (its two kernels in a
    trace, no flush) and with the L2 flushed; one JSON line."""
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import paged_attention as PA

    dev = resolve_device(None)
    kern = PA.KERNEL_BF16
    fns = variant_fns(kern, "paged_attention", PAGED_BF16_VARIANTS)
    q, kp, vp, pt, sl, _ = C.paged_inputs(dev)
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    call = lambda: PA.ragged_paged_attention(q, kp, vp, pt, sl)  # noqa: E731
    timer = C.Timer(dev)

    def run(name, fn):
        kern._fn = fn
        a = C.paged_bf16_agreement(q, kp, vp, pt, sl)
        if not a["agrees"]:
            raise AssertionError(f"{name}: {a}")
        return {"alone_ms": C.device_passes_ms(
            [call], C.PAGED_BF16_KERNELS)["total"], "ms": timer(call)}

    saved = kern._fn
    try:
        out = time_turns(fns, run)
    finally:
        kern._fn = saved
    print(json.dumps({"paged_bf16_variants": out}), flush=True)
    return 0


#: one fresh process of ``--flash-bf16-processes``: the card test
#: ``test_flash_bf16_function_on_card_matches_the_cpu`` as the first work
#: of the process, its card and CPU outputs (o, dq, dk, dv) kept as they
#: come out of ``torch.autograd.grad``; prints their digests, whether the
#: test passed, and saves the tensors to argv[1]
FLASH_BF16_PROCESS = r"""
import hashlib, json, os, sys
sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "tests")]
import torch
from paddle_tpu_torch.core.dtype import set_policy
import test_torch_cuda as TC

set_policy()
seen, real_grad = [], torch.autograd.grad


def grad(o, leaves, g, **kw):
    out = real_grad(o, leaves, g, **kw)
    seen.append([o.detach().cpu(), *(x.cpu() for x in out)])
    return out


torch.autograd.grad = grad
passed, why = True, ""
try:
    TC.test_flash_bf16_function_on_card_matches_the_cpu(
        torch.device("cuda", 0))
except AssertionError as e:
    passed, why = False, repr(e)[:400]
torch.autograd.grad = real_grad
names = ("o", "dq", "dk", "dv")
digest = lambda x: hashlib.sha256(
    x.contiguous().view(torch.int16).numpy().tobytes()).hexdigest()[:16]
card, cpu = seen[0], seen[1]
torch.save({"card": dict(zip(names, card)), "cpu": dict(zip(names, cpu))},
           sys.argv[1])
print(json.dumps({"passed": passed, "why": why,
                  "card": {n: digest(x) for n, x in zip(names, card)},
                  "cpu": {n: digest(x) for n, x in zip(names, cpu)},
                  "unequal_card_cpu": {
                      n: float((x != y).float().mean())
                      for n, x, y in zip(names, card, cpu)}}))
"""


def flash_bf16_processes(n: int, out_dir: str = "build/flash_bf16") -> int:
    """``test_flash_bf16_function_on_card_matches_the_cpu`` alone in ``n``
    fresh processes in turn (FLASH_BF16_PROCESS; the kernels built once
    before): each one's pass or failure, the digests of the card's and
    the CPU's o, dq, dk, dv, and how many distinct digests each output
    took over the processes; the tensors of every process whose digests
    differ from the first one's are kept under ``out_dir``."""
    from paddle_tpu_torch.ops.kernels import _build

    _build.build(["flash_attention", "flash_attention_bwd"])
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i in range(n):
        path = os.path.join(out_dir, f"process_{i}.pt")
        proc = subprocess.run([sys.executable, "-c", FLASH_BF16_PROCESS,
                               path], capture_output=True, text=True)
        if proc.returncode != 0:
            runs.append({"rc": proc.returncode,
                         "stderr": proc.stderr[-1500:]})
            continue
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        if runs and all(run[s] == runs[0].get(s) for s in ("card", "cpu")):
            os.remove(path)
        runs.append(run)
        print(json.dumps({"process": i, **run}), flush=True)
    done = [r for r in runs if "card" in r]
    distinct = {side: {k: len({r[side][k] for r in done})
                       for k in ("o", "dq", "dk", "dv")}
                for side in ("card", "cpu")}
    print(json.dumps({"flash_bf16_processes": n,
                      "passed": sum(r.get("passed", False) for r in runs),
                      "failed_processes": [i for i, r in enumerate(runs)
                                           if not r.get("passed")],
                      "distinct_digests": distinct}), flush=True)
    return 0


#: a probe of the launch the cluster exchange needs: a kernel that syncs
#: its cluster, reads a peer's shared memory (DSMEM), syncs the grid and
#: the cluster again, launched by ``cudaLaunchKernelEx`` with the
#: cooperative attribute and a cluster dimension, at the f32 LSTM
#: backward's text-shape grid (128 CTAs of 320 threads, 227 KB of shared
#: memory each: one an SM)
CLUSTER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void probe_kernel(int* out) {
  extern __shared__ int s[];
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cl = cg::this_cluster();
  if (threadIdx.x == 0) s[0] = blockIdx.x;
  cl.sync();
  const int peer = (cl.block_rank() + 1) % cl.num_blocks();
  const int v = *cl.map_shared_rank(s, peer);
  grid.sync();
  cl.sync();
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

extern "C" int probe_launch(int grid, int threads, int smem, int cluster,
                            int* out, int* max_clusters) {
  cudaError_t e = cudaFuncSetAttribute(
      probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaOccupancyMaxActiveClusters(max_clusters, (const void*)probe_kernel,
                                     &cfg);
  if (e != cudaSuccess) return (int)e;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, probe_kernel, out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSynchronize();
}

extern "C" const char* probe_error(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
"""


def cluster_probe() -> int:
    """CLUSTER_PROBE built and launched with clusters of 1, 2, 4 and 8:
    for each, the launch's CUDA error (0: accepted), how many clusters
    the card holds at once (``cudaOccupancyMaxActiveClusters``), and
    whether every CTA read its peer's block index over DSMEM; one JSON
    line."""
    import ctypes

    import torch

    from paddle_tpu_torch.ops.kernels import _build

    work = os.path.join("build", "probe")
    os.makedirs(work, exist_ok=True)
    src, lib = (os.path.join(work, f) for f in ("probe.cu", "probe.so"))
    with open(src, "w") as f:
        f.write(CLUSTER_PROBE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
                   check=True)
    so = ctypes.CDLL(os.path.abspath(lib))
    so.probe_launch.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    so.probe_error.argtypes, so.probe_error.restype = [ctypes.c_int], \
        ctypes.c_char_p
    torch.cuda.init()
    grid, threads = 128, 320
    smem = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    out = {"grid": grid, "threads": threads, "smem": smem}
    for cluster in (1, 2, 4, 8):
        got = torch.full((grid,), -1, dtype=torch.int32, device="cuda")
        held = ctypes.c_int(-1)
        code = so.probe_launch(grid, threads, smem, cluster, got.data_ptr(),
                               ctypes.byref(held))
        want = [(i // cluster) * cluster + (i % cluster + 1) % cluster
                for i in range(grid)]
        out[f"cluster {cluster}"] = {
            "error": code, "error_name": so.probe_error(code).decode(),
            "max_active_clusters": held.value,
            "dsmem_read_right": code == 0 and got.tolist() == want}
    print(json.dumps({"cluster_probe": out}), flush=True)
    return 0


def slab_cost(turns: int = 2) -> int:
    """What writing the gates slab costs the text forward, in the smoke's
    own measures: this tree's f32 and bf16 LSTM forward at B 64, T 128,
    D 1280, lengths 100 (``check_text_kernels``' and
    ``bf16_lstm_inputs``' inputs) without and with its slab, in turns
    (without, with, with, without) ``turns`` times, each timed alone
    (``device_ms``: the kernel's own time, no flush) and with the L2
    flushed; then the same turns each right after the plain twin, as
    ``check_text_kernels`` times the forward.  One JSON line."""
    import numpy as np
    import torch

    import chip_smoke as C
    from paddle_tpu_torch.core.place import resolve_device
    from paddle_tpu_torch.ops.kernels import lstm as LK

    dev = resolve_device(None)
    gen = torch.Generator(device=dev).manual_seed(7)
    b, t, d = 64, 128, 1280
    mask = (torch.arange(t, device=dev)[None, :] < 100).float()
    xw = 0.5 * torch.randn(b, t, 4 * d, generator=gen, device=dev)
    w_h = torch.randn(d, 4 * d, generator=gen, device=dev) / d ** 0.5
    peep = 0.1 * torch.randn(3, d, generator=gen, device=dev)
    h0 = c0 = torch.zeros(b, d, device=dev)
    x = C.bf16_lstm_inputs(dev, gen, b, t, d, torch.full((b,), 100))
    forms = {"f32": ((xw, mask, w_h, peep, h0, c0, False), "lstm_fwd_kernel"),
             "bf16": ((x["xw"], x["mask"], x["w_h"], x["peep"],
                       torch.zeros_like(x["h0"]), torch.zeros_like(x["c0"]),
                       False), "lstm_fwd_bf16")}
    timer = C.Timer(dev)
    print(C.nvidia_smi(), flush=True)
    out = {}
    for name, (fa, key) in forms.items():
        plain = lambda fa=fa: LK._fwd_plain(*fa, True)     # noqa: E731
        for after_plain in (False, True):
            rows = {False: [], True: []}
            for slab in [False, True, True, False] * turns:
                call = (lambda fa=fa, slab=slab:        # noqa: E731
                        LK._fwd_kernel(*fa, slab))
                if after_plain:
                    plain()
                rows[slab].append({"alone_ms": C.device_ms([call], key),
                                   "ms": timer(call)})
            mean = {s: {k: float(np.mean([r[k] for r in rows[s]]))
                        for k in ("alone_ms", "ms")} for s in rows}
            label = name + ("_after_plain" if after_plain else "")
            out[label] = {"without": rows[False], "with": rows[True],
                          "slab_cost_ms": {k: mean[True][k] - mean[False][k]
                                           for k in ("alone_ms", "ms")}}
            print(json.dumps({label: out[label]["slab_cost_ms"]}),
                  flush=True)
    print(json.dumps({"slab_cost": out}), flush=True)
    return 0


def main(trees: list[str], out_dir: str, calls_only: bool = False) -> int:
    os.makedirs(out_dir, exist_ok=True)
    rc = 0
    for i, tree in enumerate(trees):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", CALLS + RUN, tree,
                               "calls" if calls_only else "all"],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        with open(os.path.join(out_dir, f"ab_{i}.json"), "w") as f:
            f.write(proc.stdout + "\n--- stderr\n" + proc.stderr)
        if proc.returncode != 0:
            print(json.dumps({"tree": tree, "rc": proc.returncode,
                              "stderr": proc.stderr[-2000:]}), flush=True)
            rc = 1
            continue
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(summary(tree, out, seconds)), flush=True)
    return rc


if __name__ == "__main__":
    args = sys.argv[1:]
    if args == ["--sweep"]:
        sys.exit(sweep())
    if args == ["--bilstm-plans"]:
        sys.exit(bilstm_plans())
    if args == ["--stats-plans"]:
        sys.exit(stats_plans())
    if args == ["--flash-order"]:
        sys.exit(flash_order())
    if args == ["--tf32-variants"]:
        sys.exit(tf32_variants())
    if args == ["--wgmma-bwd-variants"]:
        sys.exit(wgmma_bwd_variants())
    if args[:1] == ["--tf32-fwd-variants"] and len(args) <= 2:
        sys.exit(tf32_fwd_variants(args[1] if len(args) > 1 else None))
    if args == ["--paged-chunks"]:
        sys.exit(paged_chunks())
    if args[:1] in (["--lstm-fwd-split"], ["--lstm-bwd-split"]) \
            and "--bf16" in args:
        i = args.index("--bf16")
        probes = "--probes" in args
        widths = [int(a) for a in args[i + 1:] if a != "--probes"]
        sys.exit(lstm_bf16_split(args[0][7:10],
                                 args[1] if i == 2 else ".",
                                 widths or LSTM_BF16_WIDTHS, probes))
    if args[:1] == ["--lstm-fwd-split"] and len(args) <= 2:
        sys.exit(lstm_fwd_split(args[1] if len(args) > 1 else "."))
    if args[:1] == ["--lstm-bwd-split"] and len(args) <= 2:
        sys.exit(lstm_bwd_split(args[1] if len(args) > 1 else "."))
    if args[:1] == ["--flash-bf16-processes"] and len(args) <= 2:
        sys.exit(flash_bf16_processes(int(args[1]) if len(args) > 1
                                      else 20))
    if args == ["--cluster-probe"]:
        sys.exit(cluster_probe())
    if args == ["--lstm-fwd-variants"]:
        sys.exit(lstm_fwd_variants())
    if args == ["--slab-cost"]:
        sys.exit(slab_cost())
    if args == ["--lstm-bf16-bounds"]:
        sys.exit(lstm_bf16_bounds())
    if args == ["--lstm-bf16-variants"]:
        sys.exit(lstm_bf16_variants())
    if args == ["--lstm-bwd-variants"]:
        sys.exit(lstm_bwd_variants())
    if args == ["--paged-bf16-variants"]:
        sys.exit(paged_bf16_variants())
    if args[:1] == ["--sass"]:
        sys.exit(sass_counts(args[1:] or ["."]))
    out = "build/ab"
    if args[:1] == ["--out"] and len(args) > 1:
        out, args = args[1], args[2:]
    calls_only = args[:1] == ["--calls"]
    args = args[calls_only:]
    if not args:
        sys.exit(__doc__)
    sys.exit(main(args, out, calls_only))
