"""``paddle_tpu_torch.models.transformer`` against the JAX model on the same
weights (moved across by ``params_from_numpy`` from the JAX export
names): full-context ``forward``, ``forward_prefill`` (logits and K/V
stacks) and ``forward_decode`` (logits and pools) at atol 1e-4 — f32
round-off through two layers of products, LN and GELU — plus the block
ops (single-pass LN with its clamp, tanh GELU) at 2e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu.ops.nn import layer_norm as j_layer_norm
from paddle_tpu.ops.pallas import paged_attention as JPA
from paddle_tpu.serving.export import _flatten
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops import nn as tnn

ATOL = 1e-4

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
             mlp_dim=64, max_seq_len=64, remat=False)


def pair(attn_impl="exact", seed=1, **kw):
    cfg_j = JT.TransformerConfig(**SMALL, **kw)
    cfg_t = T.TransformerConfig(**SMALL, attn_impl=attn_impl, **kw)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    return cfg_j, pj, cfg_t, T.params_from_numpy(_flatten(pj), "cpu")


def test_init_params_names_and_shapes_match_jax():
    cfg_j, pj, cfg_t, _ = pair()
    mine = T.init_params(cfg_t, torch.Generator().manual_seed(0), "cpu")
    flat_j = _flatten(pj)
    flat_t = {}
    for k, v in mine.items():
        if isinstance(v, dict):
            flat_t.update({f"{k}/{n}": x for n, x in v.items()})
        else:
            flat_t[k] = v
    assert sorted(flat_t) == sorted(flat_j)
    for k in flat_j:
        assert tuple(flat_t[k].shape) == flat_j[k].shape, k
        assert flat_t[k].dtype == torch.float32
    assert T.count_params(mine) == sum(v.size for v in flat_j.values())


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_forward_matches_jax(attn_impl, rng_np):
    cfg_j, pj, cfg_t, pt = pair(attn_impl)
    ids = rng_np.integers(0, 64, size=(2, 11))
    want = np.asarray(JT.forward(cfg_j, pj, jnp.asarray(ids)))
    got = T.forward(cfg_t, pt, torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("attn_impl", ["exact", "flash"])
def test_forward_prefill_matches_jax(attn_impl, rng_np):
    cfg_j, pj, cfg_t, pt = pair(attn_impl)
    ids = rng_np.integers(0, 64, size=(3, 12)).astype(np.int32)
    lens = np.array([12, 5, 0], np.int32)
    jl, jks, jvs = JT.forward_prefill(cfg_j, pj, jnp.asarray(ids),
                                      jnp.asarray(lens))
    tl, tks, tvs = T.forward_prefill(cfg_t, pt, torch.from_numpy(ids),
                                     torch.from_numpy(lens))
    assert tuple(tks.shape) == jks.shape == (2, 3, 12, 2, 16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL)
    np.testing.assert_allclose(tks.numpy(), np.asarray(jks), atol=ATOL)
    np.testing.assert_allclose(tvs.numpy(), np.asarray(jvs), atol=ATOL)


def test_forward_decode_matches_jax(rng_np):
    cfg_j, pj, cfg_t, pt = pair()
    ps, maxp, pool = 4, 4, 16
    prompts = rng_np.integers(0, 64, size=(3, 9)).astype(np.int32)
    lens = np.array([9, 4, 6], np.int32)
    table = np.array([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 0]], np.int32)
    # prefill in JAX, then hand the same pools to both decoders
    _, jks, jvs = JT.forward_prefill(cfg_j, pj, jnp.asarray(prompts),
                                     jnp.asarray(lens))
    kc, vc = JPA.init_kv_pages(2, 2, pool, ps, 16)
    kc, vc = JPA.write_prefill_kv(kc, vc, jks, jvs, table, lens)
    ids = rng_np.integers(0, 64, size=3).astype(np.int32)
    positions = lens.copy()
    seq_lens = np.array([10, 5, 0], np.int32)  # row 2 idle this step
    dec_table = table.copy()
    dec_table[2] = 0
    jl, jkc, jvc = JT.forward_decode(cfg_j, pj, ids, positions, seq_lens,
                                     dec_table, kc, vc,
                                     attn_impl="reference")
    tkc = torch.from_numpy(np.array(kc))
    tvc = torch.from_numpy(np.array(vc))
    tl, _, _ = T.forward_decode(
        cfg_t, pt, *map(torch.from_numpy, (ids, positions, seq_lens,
                                           dec_table)), tkc, tvc)
    live = seq_lens > 0
    np.testing.assert_allclose(tl.numpy()[live], np.asarray(jl)[live],
                               atol=ATOL)
    # the pools after the step agree outside the null page
    np.testing.assert_allclose(tkc.numpy()[:, :, 1:],
                               np.asarray(jkc)[:, :, 1:], atol=ATOL)
    np.testing.assert_allclose(tvc.numpy()[:, :, 1:],
                               np.asarray(jvc)[:, :, 1:], atol=ATOL)


def test_incremental_decode_equals_full_context_argmax(rng_np):
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine

    _, _, cfg_t, pt = pair("flash")
    prompts = [list(rng_np.integers(1, 64, size=n)) for n in (3, 7, 12)]
    eng = ServingEngine(cfg_t, pt, ServingConfig(
        max_slots=2, page_size=4, num_pages=32, max_prompt_len=16,
        max_new_tokens=8, prefill_batch=2, seed=0), device="cpu")
    for prompt, res in zip(prompts, eng.generate(prompts,
                                                 max_new_tokens=5)):
        assert res.finish_reason == "length"
        full = torch.tensor([prompt + res.tokens])
        logits = T.forward(cfg_t, pt, full)
        assert res.tokens == logits[0, len(prompt) - 1:-1].argmax(-1).tolist()


def test_layer_norm_and_gelu_match_jax(rng_np):
    x = rng_np.normal(size=(4, 32)).astype(np.float32) * 3.0
    x[1] = 1000.0  # constant row with a large mean: the clamp at 0
    g = rng_np.normal(size=(32,)).astype(np.float32)
    b = rng_np.normal(size=(32,)).astype(np.float32)
    want = np.asarray(j_layer_norm(jnp.asarray(x), g, b))
    got = tnn.layer_norm(*map(torch.from_numpy, (x, g, b))).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(tnn.gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.gelu(x)), atol=2e-6)


def test_unported_options_raise():
    _, _, cfg_t, pt = pair("ring")
    with pytest.raises(NotImplementedError, match="ring"):
        T.forward(cfg_t, pt, torch.zeros(1, 4, dtype=torch.long))
    moe = T.TransformerConfig(**SMALL, moe_experts=2)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.init_params(moe, torch.Generator(), "cpu")
