"""bf16 serving in ``paddle_tpu_torch`` against the JAX package, on the CPU.

- The paged-attention twin against JAX's Pallas kernel (interpret mode)
  on bf16 q and pools: it runs the kernel's page loop, so p is rounded to
  bf16 against the running max of whole pages.  Tolerance: equal on at
  least 99% of the elements, every element within one bf16 ulp (an f32
  sum in another order may round p or the output to a neighbour).
- The f32 twin against both JAX functions at 2e-5 (f32 einsum order).
- ``params_from_numpy`` carries JAX's bf16 params bit for bit.
- ``forward_prefill`` and 6 ``forward_decode`` steps in bf16: the port's
  logits within 2x the JAX package's own bf16 error, both against a
  float64 run of the port on the same weights upcast.
- The bf16 ``ServingEngine`` against JAX's bf16 engine: equal greedy
  tokens, or a first difference where the float64 top-2 margin lies
  within 2x the bf16 logits' own error against float64.
- A servable with f32 params under a bf16 config loads as bf16 and serves
  through the CLI; one with a bf16 payload is refused."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.serving import ServingConfig as JServingConfig
from paddle_tpu.serving import ServingEngine as JServingEngine
from paddle_tpu.serving.export import _flatten, export_servable
from paddle_tpu_torch.core.enforce import EnforceError
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops.kernels import paged_attention as PA
from paddle_tpu_torch.serving import (ServingConfig, ServingEngine,
                                      load_servable)
from paddle_tpu_torch.telemetry import MetricsRegistry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16 = ml_dtypes.bfloat16
SHARE_EQUAL = 0.99    # the bf16 twin vs JAX's kernel: equal on >= 99%
TOL = dict(rtol=2e-5, atol=2e-5)
SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
             mlp_dim=64, max_seq_len=64, remat=False)


def to_torch(a) -> torch.Tensor:
    """numpy (ml_dtypes bf16 included) -> torch, bit for bit."""
    a = np.asarray(a)
    if a.dtype == BF16:
        return torch.from_numpy(np.array(a.view(np.int16))).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def bf16_ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many bf16 steps apart two bf16 arrays lie, element by element
    (+0 and -0 equal)."""
    def key(x):
        i = np.asarray(x, BF16).view(np.int16).astype(np.int64)
        return np.where(i < 0, -(i + 32768), i)
    return np.abs(key(a) - key(b))


def make_paged(rng, lens, h, d, ps, maxp, k_scale=1.0):
    """Random pools + a page table with scattered page ids for ``lens``."""
    b = len(lens)
    need = [-(-int(n) // ps) for n in lens]
    pool = 1 + sum(need) + 2
    ids = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, maxp), np.int32)
    nxt = 0
    for i, n in enumerate(need):
        table[i, :n] = ids[nxt:nxt + n]
        nxt += n
    kp = (rng.normal(size=(h, pool, ps, d)) * k_scale).astype(np.float32)
    vp = rng.normal(size=(h, pool, ps, d)).astype(np.float32)
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    return q, kp, vp, table, np.asarray(lens, np.int32)


PAGED_CASES = [
    # lens, heads, head_dim, page_size, max_pages, K scale
    ([0, 1, 7, 20], 2, 32, 4, 5, 2.0),     # the probe that showed C4
    ([1, 0, 16, 9, 33], 2, 16, 4, 9, 3.0),
    ([3, 12, 1, 0], 3, 64, 4, 4, 2.0),
    ([24, 5], 1, 64, 8, 3, 4.0),
]


@pytest.mark.parametrize("lens,h,d,ps,maxp,k_scale", PAGED_CASES)
def test_bf16_twin_rounds_where_the_pallas_kernel_rounds(lens, h, d, ps,
                                                         maxp, k_scale):
    rng = np.random.default_rng(0)
    q, kp, vp, pt, sl = make_paged(rng, lens, h, d, ps, maxp, k_scale)
    q, kp, vp = (x.astype(BF16) for x in (q, kp, vp))
    want = np.asarray(JPA.ragged_paged_attention(
        q, kp, vp, pt, sl, impl="kernel", interpret=True))
    got = PA.ragged_paged_attention_reference(
        *(to_torch(x) for x in (q, kp, vp, pt, sl)))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy().astype(BF16)
    ulps = bf16_ulps(got, want)
    assert (ulps == 0).mean() >= SHARE_EQUAL, (ulps > 0).mean()
    assert ulps.max() <= 1
    idle = sl == 0
    assert not got[idle].astype(np.float32).any()   # exact zeros


@pytest.mark.parametrize("lens,h,d,ps,maxp,k_scale", PAGED_CASES)
def test_f32_twin_still_matches_both_jax_functions(lens, h, d, ps, maxp,
                                                   k_scale):
    rng = np.random.default_rng(0)
    q, kp, vp, pt, sl = make_paged(rng, lens, h, d, ps, maxp, k_scale)
    got = PA.ragged_paged_attention_reference(
        *(to_torch(x) for x in (q, kp, vp, pt, sl))).numpy()
    for impl in ("kernel", "reference"):
        want = np.asarray(JPA.ragged_paged_attention(
            q, kp, vp, pt, sl, impl=impl, interpret=True))
        np.testing.assert_allclose(got, want, **TOL)


def test_wrapper_takes_the_bf16_twin_for_cpu_tensors():
    rng = np.random.default_rng(1)
    q, kp, vp, pt, sl = (to_torch(x) for x in
                         make_paged(rng, [3, 0, 9], 2, 16, 4, 3))
    q, kp, vp = (x.to(torch.bfloat16) for x in (q, kp, vp))
    before = (PA.KERNEL.launches, PA.KERNEL_BF16.launches)
    out = PA.ragged_paged_attention(q, kp, vp, pt, sl)
    want = PA.ragged_paged_attention_reference(q, kp, vp, pt, sl)
    assert torch.equal(out.view(torch.int16), want.view(torch.int16))
    assert (PA.KERNEL.launches, PA.KERNEL_BF16.launches) == before


def test_params_from_numpy_carries_jax_bf16_params_bit_for_bit():
    cfg = JT.TransformerConfig(**SMALL, dtype=jnp.bfloat16)
    flat = _flatten(JT.init_params(cfg, jax.random.key(3)))
    assert all(v.dtype == BF16 for v in flat.values())
    params = T.params_from_numpy(flat, device="cpu")
    for key, value in flat.items():
        node = params
        for part in key.split("/"):
            node = node[part]
        assert node.dtype == torch.bfloat16
        assert np.array_equal(node.view(torch.int16).numpy(),
                              value.view(np.int16)), key


# -- the model's serving pair -------------------------------------------------


def _bf16_model(seed=5):
    """(JAX bf16 config and params, the port's bf16 config and params,
    the port's float64 config and the same weights upcast)."""
    cfg_j = JT.TransformerConfig(**SMALL, dtype=jnp.bfloat16,
                                 attn_impl="flash")
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    flat = _flatten(pj)
    cfg_t = T.TransformerConfig(**SMALL, dtype=torch.bfloat16,
                                attn_impl="flash")
    cfg_64 = T.TransformerConfig(**SMALL, dtype=torch.float64,
                                 attn_impl="exact")
    return (cfg_j, pj, cfg_t, T.params_from_numpy(flat, device="cpu"),
            cfg_64, T.params_from_numpy(flat, device="cpu",
                                        dtype=torch.float64))


def _steps_torch(cfg, params, ids, lens, table, dec_ids, ps, pages):
    """Logits of forward_prefill, then of one forward_decode per column of
    ``dec_ids``, through the port's paged cache in cfg.dtype."""
    kc, vc = PA.init_kv_pages(cfg.num_layers, cfg.num_heads, pages, ps,
                              cfg.head_dim, dtype=cfg.dtype, device="cpu")
    tb, lb = torch.from_numpy(table), torch.from_numpy(lens)
    logits, ks, vs = T.forward_prefill(cfg, params, torch.from_numpy(ids),
                                       lb)
    PA.write_prefill_kv(kc, vc, ks, vs, tb, lb)
    out = [logits.double()]
    pos = lb.clone()
    for j in range(dec_ids.shape[1]):
        logits, _, _ = T.forward_decode(
            cfg, params, torch.from_numpy(dec_ids[:, j]), pos, pos + 1, tb,
            kc, vc)
        out.append(logits.double())
        pos = pos + 1
    return [o.numpy() for o in out]


def _steps_jax(cfg, params, ids, lens, table, dec_ids, ps, pages):
    """The same on the JAX package: prefill through its flash kernel, each
    decode step through its Pallas paged kernel, both interpreted."""
    kc, vc = JPA.init_kv_pages(cfg.num_layers, cfg.num_heads, pages, ps,
                               cfg.head_dim, dtype=cfg.dtype)
    logits, ks, vs = JT.forward_prefill(cfg, params, ids, lens)
    kc, vc = JPA.write_prefill_kv(kc, vc, ks, vs, table, lens)
    out = [np.asarray(logits).astype(np.float64)]
    pos = lens.copy()
    for j in range(dec_ids.shape[1]):
        logits, kc, vc = JT.forward_decode(
            cfg, params, dec_ids[:, j], pos, pos + 1, table, kc, vc,
            attn_impl="kernel")
        out.append(np.asarray(logits).astype(np.float64))
        pos = pos + 1
    return out


def _step_errors():
    """Per step (prefill, then 6 decode steps), the largest distance of
    the port's bf16 logits and of JAX's from the port's float64 run on
    the same weights upcast: (port's, JAX's)."""
    cfg_j, pj, cfg_t, pt, cfg_64, p64 = _bf16_model()
    rng = np.random.default_rng(7)
    ps, maxp, steps = 4, 5, 6
    lens = np.array([5, 11, 3], np.int32)
    ids = np.zeros((3, 12), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, SMALL["vocab_size"], size=n)
    table = np.arange(1, 1 + 3 * maxp, dtype=np.int32).reshape(3, maxp)
    dec = rng.integers(1, SMALL["vocab_size"], size=(3, steps)).astype(
        np.int32)
    args = (ids, lens, table, dec, ps, 1 + 3 * maxp)
    want64 = _steps_torch(cfg_64, p64, *args)
    return ([np.abs(g - w).max()
             for g, w in zip(_steps_torch(cfg_t, pt, *args), want64)],
            [np.abs(j - w).max()
             for j, w in zip(_steps_jax(cfg_j, pj, *args), want64)])


def test_prefill_and_decode_in_bf16_within_2x_jax_bf16_error():
    port, jax_ = _step_errors()
    port_err, jax_err = max(port), max(jax_)
    assert 0 < port_err <= 2 * jax_err, (port_err, jax_err)
    # each step on its own too: the decode steps do not drift apart
    for p, j in zip(port, jax_):
        assert p <= 2 * max(j, port_err / 2), (p, j)


def _margin_ok(cfg_t, pt, cfg_64, p64, prompt, got, want):
    """Greedy ``got`` and ``want`` agree, or first differ where the float64
    logits of the two candidates lie within 2x the bf16 logits' error
    against float64 on that prefix (each bf16 logit may lie that error
    from its float64 witness)."""
    j = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), None)
    if j is None:
        return True
    seq = torch.tensor([prompt + got[:j]])
    l64 = T.forward(cfg_64, p64, seq)[0].numpy()
    lbf = T.forward(cfg_t, pt, seq)[0].double().numpy()
    err = np.abs(lbf - l64).max()
    last = l64[-1]
    return abs(last[got[j]] - last[want[j]]) <= 2 * err


def test_bf16_engine_gives_the_jax_bf16_engine_greedy_tokens():
    cfg_j, pj, cfg_t, pt, cfg_64, p64 = _bf16_model(seed=1)
    rng = np.random.default_rng(3)
    prompts = [list(rng.integers(1, 64, size=n)) for n in (3, 7, 12, 5, 16)]
    knobs = dict(max_slots=2, page_size=4, num_pages=32, max_prompt_len=16,
                 max_new_tokens=8, prefill_batch=2, seed=0)
    want = JServingEngine(cfg_j, pj, JServingConfig(**knobs)).generate(
        prompts, max_new_tokens=8)
    eng = ServingEngine(cfg_t, pt, ServingConfig(**knobs),
                        registry=MetricsRegistry("t"), device="cpu")
    assert eng.cache.k.dtype == torch.bfloat16
    got = eng.generate(prompts, max_new_tokens=8)
    for p, g, w in zip(prompts, got, want):
        assert len(g.tokens) == 8
        assert _margin_ok(cfg_t, pt, cfg_64, p64, [int(t) for t in p],
                          g.tokens, w.tokens), (g.tokens, w.tokens)


# -- servables ----------------------------------------------------------------


def test_f32_servable_under_a_bf16_config_serves_in_bf16(tmp_path):
    cfg_f = JT.TransformerConfig(**SMALL)
    pj = JT.init_params(cfg_f, jax.random.key(2))
    cfg_b = JT.TransformerConfig(**SMALL, dtype=jnp.bfloat16)
    out = export_servable(str(tmp_path / "sv"), cfg_b, pj)
    cfg, params = load_servable(out, device="cpu")
    assert cfg.dtype == torch.bfloat16
    flat = _flatten(pj)
    assert params["blocks"]["wq"].dtype == torch.bfloat16
    assert np.array_equal(
        params["blocks"]["wq"].view(torch.int16).numpy(),
        flat["blocks/wq"].astype(BF16).view(np.int16))

    lines = "5 17 3\n9 9 9 9\n"
    argv = [sys.executable, "-m", "paddle_tpu_torch.serving", "--servable",
            out, "--device", "cpu", "--max_new_tokens", "4"]
    ran = subprocess.run(argv, input=lines, cwd=REPO, capture_output=True,
                         text=True, timeout=300)
    assert ran.returncode == 0, ran.stderr[-800:]
    printed = [l for l in ran.stdout.splitlines() if l.strip()]
    # the CLI's defaults: 4 slots, page 16, 64 pages, prompts <= 32, seed 0
    eng = ServingEngine(cfg, params, ServingConfig(
        max_slots=4, page_size=16, num_pages=64, max_prompt_len=32,
        max_new_tokens=4, seed=0), registry=MetricsRegistry("t"),
        device="cpu")
    want = [f"{i}: {' '.join(str(t) for t in r.tokens)}" for i, r in
            enumerate(eng.generate([[5, 17, 3], [9, 9, 9, 9]]))]
    assert printed == want


def test_bf16_payload_servable_is_refused_naming_the_quirk(tmp_path):
    cfg_b = JT.TransformerConfig(**SMALL, dtype=jnp.bfloat16)
    pj = JT.init_params(cfg_b, jax.random.key(2))
    out = export_servable(str(tmp_path / "sv"), cfg_b, pj)
    with pytest.raises(EnforceError, match=r"raw voids \(\|V2\).*"
                       r"load_servable cannot read them either"):
        load_servable(out, device="cpu")


if __name__ == "__main__":
    # the measured figures behind the tolerances above:
    # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_serving_bf16.py
    for case in PAGED_CASES:
        q, kp, vp, pt, sl = make_paged(np.random.default_rng(0), *case)
        q, kp, vp = (x.astype(BF16) for x in (q, kp, vp))
        want = np.asarray(JPA.ragged_paged_attention(
            q, kp, vp, pt, sl, impl="kernel", interpret=True))
        got = PA.ragged_paged_attention_reference(
            *(to_torch(x) for x in (q, kp, vp, pt, sl)))
        ulps = bf16_ulps(got.float().numpy().astype(BF16), want)
        print("paged", case, "unequal", float((ulps > 0).mean()),
              "max ulps", int(ulps.max()))
    port, jax_ = _step_errors()
    print("bf16 logits vs float64 by step: port",
          [round(float(e), 5) for e in port], "jax",
          [round(float(e), 5) for e in jax_])
