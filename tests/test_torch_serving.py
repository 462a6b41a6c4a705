"""``paddle_tpu_torch.serving`` against ``paddle_tpu.serving`` on the same
weights and request traces: greedy tokens EQUAL to the JAX engine's
(continuous batching, mixed lengths, more requests than slots),
temperature traces deterministic and placement-invariant, servables
exported by the JAX package load and serve, the page allocator agrees
with JAX's, the telemetry stream, the threaded loop, and the
``python -m paddle_tpu_torch.serving`` CLI (``serving`` marker)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.export import _flatten, export_servable
from paddle_tpu.serving.kv_cache import PageAllocator as JPageAllocator
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.serving import (
    PageAllocator,
    ServingConfig,
    ServingEngine,
    load_servable,
    sample_tokens,
)
from paddle_tpu_torch.telemetry import MemorySink, MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
             mlp_dim=64, max_seq_len=64, remat=False)


@pytest.fixture(scope="module")
def model():
    cfg_j = JT.TransformerConfig(**SMALL)
    pj = JT.init_params(cfg_j, jax.random.key(1))
    cfg_t = T.TransformerConfig(**SMALL)
    return cfg_j, pj, cfg_t, T.params_from_numpy(_flatten(pj), "cpu")


def engine(model, registry=None, **kw):
    _, _, cfg, params = model
    base = dict(max_slots=2, page_size=4, num_pages=32, max_prompt_len=16,
                max_new_tokens=8, prefill_batch=2, seed=0)
    base.update(kw)
    return ServingEngine(cfg, params, ServingConfig(**base),
                         registry=registry or MetricsRegistry("t"),
                         device="cpu")


TRACES = [
    # (prompt lengths, engine knobs): more requests than slots each time
    ((3, 7, 12, 5, 16, 1), dict(max_slots=2, prefill_batch=2)),
    ((9, 2, 14, 6), dict(max_slots=3, prefill_batch=1, page_size=8,
                         num_pages=16)),
    ((4, 4, 11, 8, 3), dict(max_slots=2, prefill_batch=2,
                            static_batching=True)),
]


@pytest.mark.parametrize("lens,knobs", TRACES)
def test_greedy_tokens_equal_the_jax_engine(model, lens, knobs, rng_np):
    cfg_j, pj, _, _ = model
    prompts = [list(rng_np.integers(1, 64, size=n)) for n in lens]
    base = dict(max_slots=2, page_size=4, num_pages=32, max_prompt_len=16,
                max_new_tokens=8, prefill_batch=2, seed=0)
    base.update(knobs)
    want = JServingEngine(cfg_j, pj, JServingConfig(**base)).generate(
        prompts, max_new_tokens=6)
    got = engine(model, **knobs).generate(prompts, max_new_tokens=6)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    assert [r.finish_reason for r in got] == ["length"] * len(prompts)


def test_eos_stops_and_frees_pages(model, rng_np):
    prompt = list(rng_np.integers(1, 64, size=4))
    tokens = engine(model, max_slots=1, prefill_batch=1).generate(
        [prompt])[0].tokens
    eos = tokens[2]
    eng = engine(model, max_slots=1, prefill_batch=1, eos_id=eos)
    res = eng.generate([prompt])[0]
    assert res.finish_reason == "eos"
    assert res.tokens == tokens[:tokens.index(eos) + 1]
    eng.step()  # retire
    assert eng.cache.allocator.free_pages == 31


def test_admission_blocks_on_pages_then_drains(model, rng_np):
    prompts = [list(rng_np.integers(1, 64, size=6)) for _ in range(6)]
    # 7 usable pages; each request reserves (6+8)/4 -> 4 pages
    eng = engine(model, max_slots=4, num_pages=8, max_prompt_len=8,
                 prefill_batch=4)
    results = eng.generate(prompts, max_new_tokens=4)
    assert all(len(r.tokens) == 4 for r in results)
    assert eng.scheduler.rejected_admissions > 0
    assert eng.cache.allocator.free_pages == 7


def test_temperature_is_deterministic_and_placement_invariant(model,
                                                              rng_np):
    prompts = [list(rng_np.integers(1, 64, size=n)) for n in (5, 9, 3, 7)]

    def run(seed=123, **kw):
        return [r.tokens for r in engine(model, seed=seed, **kw).generate(
            prompts, max_new_tokens=6, temperature=0.8)]

    first = run()
    assert run() == first                       # same seed + arrival order
    assert run(max_slots=4, prefill_batch=4) == first  # other slots/steps
    assert run(max_slots=1, prefill_batch=1) == first
    assert run(seed=124) != first
    greedy = [r.tokens for r in engine(model).generate(prompts,
                                                       max_new_tokens=6)]
    assert first != greedy                      # it really samples


def test_sample_tokens_greedy_rows_are_argmax(rng_np):
    logits = torch.from_numpy(rng_np.normal(size=(6, 64)).astype(np.float32))
    temps = np.array([0, 5, 0, 5, 5, 0], np.float32)
    rids = np.arange(6, dtype=np.int32)
    gens = np.zeros(6, np.int32)
    a = sample_tokens(logits, temps, 7, rids, gens)
    assert a.dtype == np.int32 and a.shape == (6,)
    argmax = logits.argmax(-1).numpy()
    assert np.array_equal(a[temps == 0], argmax[temps == 0])
    assert np.array_equal(a, sample_tokens(logits, temps, 7, rids, gens))
    hot = sample_tokens(logits, np.full(6, 5.0, np.float32), 7, rids, gens)
    assert (hot != argmax).any()


def test_page_allocator_agrees_with_jax(rng_np):
    mine, ref = PageAllocator(12), JPageAllocator(12)
    held = []
    for _ in range(200):
        r = rng_np.random()
        if held and r < 0.1:  # share: one more reference, freed later
            pages = held[int(rng_np.integers(len(held)))]
            mine.retain(pages)
            ref.retain(pages)
            held.append(list(pages))
        elif held and r < 0.55:
            pages = held.pop(int(rng_np.integers(len(held))))
            mine.free(pages)
            ref.free(pages)
            assert all(mine.refcount(p) == ref.refcount(p) for p in pages)
        else:
            n = int(rng_np.integers(1, 4))
            assert mine.can_alloc(n) == ref.can_alloc(n)
            if mine.can_alloc(n):
                got = mine.alloc(n)
                assert got == ref.alloc(n)
                held.append(got)
        assert mine.free_pages == ref.free_pages
        assert mine.live_pages == ref.live_pages
    with pytest.raises(EnforceError, match="null"):
        mine.free([0])


def test_load_servable_from_a_jax_export(model, tmp_path, rng_np):
    cfg_j, pj, _, _ = model
    out = export_servable(str(tmp_path / "servable"), cfg_j, pj)
    cfg, params = load_servable(out, device="cpu")
    assert cfg == T.TransformerConfig(**SMALL)
    for k, v in _flatten(pj).items():
        node = params
        for part in k.split("/"):
            node = node[part]
        assert np.array_equal(node.numpy(), v), k
    prompts = [list(rng_np.integers(1, 64, size=n)) for n in (4, 9)]
    scfg = dict(max_slots=1, page_size=4, num_pages=16, max_prompt_len=16,
                max_new_tokens=4, prefill_batch=1)
    want = JServingEngine(cfg_j, pj, JServingConfig(**scfg)).generate(
        prompts)
    got = ServingEngine(cfg, params, ServingConfig(**scfg),
                        device="cpu").generate(prompts)
    assert [r.tokens for r in got] == [r.tokens for r in want]
    # a flipped byte is refused
    payload = tmp_path / "servable" / "params.npz"
    raw = bytearray(payload.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    payload.write_bytes(bytes(raw))
    with pytest.raises(EnforceError, match="hash mismatch"):
        load_servable(out, device="cpu")


def test_load_servable_refuses_partial_artifacts(model, tmp_path):
    import json

    cfg_j, pj, _, _ = model
    out = export_servable(str(tmp_path / "a"), cfg_j, pj)
    mpath = tmp_path / "a" / "servable.json"
    m = json.loads(mpath.read_text())
    m["params"]["blocks/extra_w"] = "float32"
    mpath.write_text(json.dumps(m))
    with pytest.raises(EnforceError, match="do not match"):
        load_servable(out, device="cpu")
    out = export_servable(str(tmp_path / "b"), cfg_j, pj)
    (tmp_path / "b" / "params.npz").unlink()
    with pytest.raises(EnforceError, match="missing from disk"):
        load_servable(out, device="cpu")


def test_per_request_records_and_summary(model, rng_np):
    reg = MetricsRegistry("serve_test")
    sink = MemorySink()
    reg.add_sink(sink)
    eng = engine(model, registry=reg)
    prompts = [list(rng_np.integers(1, 64, size=4)) for _ in range(3)]
    eng.generate(prompts, max_new_tokens=4)
    eng.emit_summary()
    serves = sink.by_kind("serve")
    assert len(serves) == 3
    for r in serves:
        assert r["schema"] == "paddle_tpu.metrics/15"
        for f in ("queue_wait_ms", "ttft_ms", "tpot_ms", "total_ms"):
            assert r[f] >= 0.0
        assert r["new_tokens"] == 4
    for name in ("serve_ttft_ms", "serve_tpot_ms", "serve_decode_step_ms"):
        h = reg.get(name)
        assert h.percentile(50) <= h.percentile(99) <= h.summary()["max"]
    summary = sink.by_kind("serve_summary")[-1]["summary"]
    assert "serve_ttft_ms" in summary
    assert reg.counter("serve_tokens").value() == 12.0


def test_threaded_loop_and_crash_propagation(model, rng_np):
    eng = engine(model)
    eng.start()
    try:
        ids = [eng.submit(list(rng_np.integers(1, 64, size=4)),
                          max_new_tokens=3) for _ in range(3)]
        got = eng.results(n=3, timeout=60.0)
    finally:
        eng.stop()
    assert sorted(r.id for r in got) == sorted(ids)
    with pytest.raises(RuntimeError, match="stopped"):
        eng.submit([1, 2, 3])

    reg = MetricsRegistry("crash")
    eng = engine(model, registry=reg)
    boom = RuntimeError("injected decode fault")

    def bad_step():
        raise boom

    eng.submit([1, 2, 3], max_new_tokens=3)
    eng.step = bad_step
    eng.start()
    try:
        with pytest.raises(RuntimeError, match="serving loop crashed") as ei:
            eng.results(n=1, timeout=30.0)
        assert ei.value.__cause__ is boom
        with pytest.raises(RuntimeError, match="submit refused"):
            eng.submit([1, 2, 3])
    finally:
        eng.stop()
    assert reg.counter("serve_loop_crashes").value() == 1.0


def test_engine_refuses_what_is_not_ported(model):
    with pytest.raises(EnforceError, match="not ported"):
        engine(model, prefix_cache=True)
    with pytest.raises(EnforceError, match="not ported"):
        engine(model, prefill_chunk_tokens=4)
    eng = engine(model)
    with pytest.raises(EnforceError, match="outside"):
        eng.submit([1, 64])


@pytest.mark.serving
def test_cli_loop_subprocess():
    lines = "5 17 3\n9 9 9 9\n"
    argv = [sys.executable, "-m", "paddle_tpu_torch.serving", "--random",
            "--vocab", "64", "--embed", "32", "--max_new_tokens", "4",
            "--seed", "7"]

    def run(*extra):
        return subprocess.run(argv + list(extra), input=lines, cwd=REPO,
                              capture_output=True, text=True, timeout=300)

    out = run("--device", "cpu")
    assert out.returncode == 0, out.stderr[-800:]
    got = [l for l in out.stdout.splitlines() if l.strip()]
    assert len(got) == 2
    assert got[0].startswith("0:") and got[1].startswith("1:")
    toks = [int(t) for t in got[0].split(":")[1].split()]
    assert len(toks) == 4 and all(0 <= t < 64 for t in toks)
    assert run("--device", "cpu").stdout == out.stdout  # deterministic
    if not torch.cuda.is_available():
        # the default device is the card: without one the CLI refuses
        refused = run()
        assert refused.returncode != 0
        assert "no CUDA card" in refused.stderr
