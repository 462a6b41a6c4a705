"""LM training in ``paddle_tpu_torch.models.transformer`` against the JAX
package on the same weights (moved across by ``params_from_numpy``) and
the same token ids: ``loss_fn`` and its gradient in every leaf against
``jax.value_and_grad(loss_fn)`` (flash and exact attention, remat on and
off), and a 5-step ``build_train_step`` trajectory with Adam against the
JAX step, from the JAX ``init_tree`` state carried across by
``opt_state_from_numpy``.  The JAX flash path runs its Pallas kernels in
interpret mode; the port's runs the plain twins inside the same autograd
Function the card runs.  Tolerances are stated at each test."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import transformer as JT
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.serving.export import _flatten
from paddle_tpu.trainer.step import _cast_floats
from paddle_tpu_torch.core import tree
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.optimizer import Adam, opt_state_from_numpy

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
             mlp_dim=64, max_seq_len=32)


def pair(attn_impl="flash", remat=False, seed=1, **widths):
    shape = {**SMALL, **widths}
    cfg_j = JT.TransformerConfig(**shape, attn_impl=attn_impl, remat=remat)
    cfg_t = T.TransformerConfig(**shape, attn_impl=attn_impl, remat=remat)
    pj = JT.init_params(cfg_j, jax.random.key(seed))
    return cfg_j, pj, cfg_t, T.params_from_numpy(_flatten(pj), "cpu")


def _flat(params) -> dict:
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in _flatten(params).items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("attn_impl", ["flash", "exact"])
def test_loss_and_grads_match_jax(attn_impl, remat, rng_np):
    """Loss to rtol 2e-6 [measured 2.1e-7] and every gradient leaf to atol
    2e-6 times the leaf's largest entry, floor 1 [1.6e-7]: f32 round-off
    through two layers, the tied head and the log-sum-exp, in another
    summation order."""
    cfg_j, pj, cfg_t, pt = pair(attn_impl, remat)
    ids = rng_np.integers(0, 64, size=(2, 17))
    want_loss, want_g = jax.value_and_grad(
        lambda p: JT.loss_fn(cfg_j, p, jnp.asarray(ids)))(pj)
    loss, grads = T.loss_and_grads(cfg_t, pt, torch.from_numpy(ids))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=2e-6)
    want, got = _flat(want_g), _flat(grads)
    assert sorted(got) == sorted(want)
    for k in want:
        scale = max(1.0, float(np.abs(want[k]).max()))
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2e-6 * scale,
                                   err_msg=k)
    # loss_fn itself is the same function, with autograd
    direct = T.loss_fn(cfg_t, pt, torch.from_numpy(ids))
    assert float(direct) == float(loss)


def test_remat_recomputes_the_same_gradients(rng_np):
    """``remat=True`` (a checkpoint per block) re-runs each block's forward
    in the backward and gives the gradients of ``remat=False`` bit for
    bit on the CPU."""
    _, _, cfg_t, pt = pair("flash", False)
    ids = torch.from_numpy(rng_np.integers(0, 64, size=(2, 17)))
    plain = T.loss_and_grads(cfg_t, pt, ids)
    remat = T.loss_and_grads(dataclasses.replace(cfg_t, remat=True), pt, ids)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(tree.leaves(plain[1]), tree.leaves(remat[1])):
        assert torch.equal(a, b)


def test_flash_gradient_goes_through_the_function(rng_np, monkeypatch):
    """The LM's attention gradient is the Function's backward: with the
    backward's delta dropped (on both delta routes: the f32 route takes
    it from [B, T, H, D], ``_delta_bthd``), the gradients move (a wrong
    backward shows)."""
    _, _, cfg_t, pt = pair("flash", False)
    ids = torch.from_numpy(rng_np.integers(0, 64, size=(2, 17)))
    loss, good = T.loss_and_grads(cfg_t, pt, ids)
    monkeypatch.setattr(FA, "_delta", lambda do, o: torch.zeros_like(
        do[..., :1]))
    plain_bthd = FA._delta_bthd
    monkeypatch.setattr(FA, "_delta_bthd", lambda do, o, tqp: torch.zeros_like(
        plain_bthd(do, o, tqp)))
    loss_bad, bad = T.loss_and_grads(cfg_t, pt, ids)
    assert torch.equal(loss, loss_bad)      # the forward is untouched
    assert not torch.allclose(good["blocks"]["wq"], bad["blocks"]["wq"],
                              atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "exact"])
def test_train_step_trajectory_matches_jax(attn_impl, rng_np):
    """5 Adam steps (lr 1e-2) from the same weights and the JAX optimizer
    state: losses within 2e-6 relative [measured 1.1e-7], params within
    5e-5 absolute [7.9e-6].  Adam divides each gradient by its own RMS,
    so an element whose gradient is near round-off moves by up to lr
    either way and amplifies f32 noise; the first step is about
    lr * sign(g) (a sign flipped by round-off would show as 2 * lr =
    2e-2).  The measured distance shows no flipped element at this size."""
    cfg_j, pj, cfg_t, pt = pair(attn_impl, False)
    jopt, topt = JAdam(learning_rate=1e-2), Adam(learning_rate=1e-2)
    js = jopt.init_tree(pj)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    jstep = JT.build_train_step(cfg_j, jopt)
    tstep = T.build_train_step(cfg_t, topt)
    batches = [rng_np.integers(0, 64, size=(4, 17)) for _ in range(5)]
    j_losses, t_losses = [], []
    jp = jax.tree.map(jnp.copy, pj)
    for ids in batches:
        jp, js, jl = jstep(jp, js, jnp.asarray(ids))
        before = pt
        pt, ts, tl = tstep(pt, ts, torch.from_numpy(ids))
        assert pt is before            # updated in place (donated buffers)
        j_losses.append(float(jl))
        t_losses.append(float(tl))
    np.testing.assert_allclose(t_losses, j_losses, rtol=2e-6)
    assert t_losses[-1] < t_losses[0]
    assert ts["step"] == int(js["step"]) == 5
    want, got = _flat(jp), _flat(pt)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=5e-5,
                                   err_msg=k)


def test_unported_training_options_raise():
    cfg = T.TransformerConfig(**SMALL, attn_impl="flash")
    opt = Adam(learning_rate=1e-3)
    with pytest.raises(NotImplementedError, match="mesh"):
        T.build_train_step(cfg, opt, mesh=object())
    with pytest.raises(NotImplementedError, match="ZeRO"):
        T.build_train_step(cfg, opt, zero=1)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        T.build_train_step(cfg, opt, compute_dtype=torch.float16)
    with pytest.raises(NotImplementedError, match="dots"):
        T.build_train_step(dataclasses.replace(cfg, remat="dots"), opt)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.build_train_step(dataclasses.replace(cfg, moe_experts=2), opt)


# -- bf16 compute_dtype -------------------------------------------------------
#
# The port's bf16 step against the JAX package's ``build_train_step(...,
# compute_dtype=jnp.bfloat16)`` from the same weights.  bf16 cannot match
# bit for bit (XLA and PyTorch round the elementwise chain at other
# points), so both are held against the float64 step: per gradient leaf
# ||g - g64|| / ||g64||, the port's within 2x JAX's own plus a margin.


def _f64(params):
    return tree.unflatten(params, [p.double() for p in tree.leaves(params)])


def _leaf_errors(grads, g64) -> dict:
    want = _flat(g64)
    return {k: float(np.linalg.norm(np.asarray(v, np.float64) - want[k])
                     / np.linalg.norm(want[k]))
            for k, v in _flat(grads).items()}


def test_bf16_train_step_builds_and_keeps_f32_masters(rng_np):
    """``compute_dtype=torch.bfloat16`` builds (float32 too, as None); one
    step leaves the params and the Adam state in their own dtypes and the
    gradients reach the f32 leaves in f32."""
    cfg_j, pj, cfg_t, pt = pair("flash", False)
    ids = torch.from_numpy(rng_np.integers(0, 64, size=(2, 17)))
    _, grads = T.loss_and_grads(cfg_t, pt, ids, torch.bfloat16)
    assert all(g.dtype == torch.float32 for g in tree.leaves(grads))
    T.build_train_step(cfg_t, Adam(learning_rate=1e-3),
                       compute_dtype=torch.float32)
    opt = Adam(learning_rate=1e-3, moment_dtype=torch.bfloat16)
    state = opt.init_tree(pt)
    step = T.build_train_step(cfg_t, opt, compute_dtype=torch.bfloat16)
    pt, state, loss = step(pt, state, ids)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in tree.leaves(pt))
    assert all(s["m"].dtype == torch.bfloat16 for s in state["slots"])


def test_bf16_first_step_against_jax_and_float64(rng_np):
    """The first bf16 step's loss and gradient leaves (flash, 2 layers,
    T = 96: two 64-key tiles) of both packages against the float64 step
    of the same weights.  Each port leaf within 2x JAX's own distance
    plus 2^-8 (one bf16 unit) [measured: at most 0.997x JAX's, 4.3e-3 to
    1.3e-2 against JAX's 7.7e-3 to 1.5e-2]; the loss within 2x JAX's
    relative error plus 1e-5 [2.0e-5 against JAX's 5.3e-5].  Control: the
    port's f32 step lies within 1e-5 of float64 on every leaf [8.6e-7], so
    the bf16 distance is bf16's."""
    cfg_j, pj, cfg_t, pt = pair("flash", False, embed_dim=128, mlp_dim=256,
                                  max_seq_len=128)
    ids = rng_np.integers(0, 64, size=(2, 97))
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(
        cfg_j, _cast_floats(p, jnp.bfloat16), jnp.asarray(ids)))(pj)
    tid = torch.from_numpy(ids)
    l64, g64 = T.loss_and_grads(cfg_t, _f64(pt), tid)
    tl, tg = T.loss_and_grads(cfg_t, pt, tid, torch.bfloat16)
    _, gf = T.loss_and_grads(cfg_t, pt, tid)
    ej, et, ef = (_leaf_errors(g, g64) for g in (jg, tg, gf))
    for k in ej:
        assert et[k] <= 2 * ej[k] + 2.0 ** -8, (k, et[k], ej[k])
        assert ef[k] <= 1e-5, (k, ef[k])
    jerr = abs(float(jl) - float(l64)) / float(l64)
    assert abs(float(tl) - float(l64)) / float(l64) <= 2 * jerr + 1e-5


def test_bf16_five_adam_steps_against_the_float64_trajectory(rng_np):
    """5 Adam steps (lr 1e-2) from the same weights, in bf16 with bf16
    moments in both packages (the repo's LM benchmark: ``bench.py:914``,
    ``:919``): the port's bf16 losses and JAX's against the float64
    trajectory of the port (the plain twins in float64, f64 moments).  Each port bf16 loss within 2x the
    largest distance of JAX's bf16 loss over the run plus 1e-4
    [measured: 3.17e-3 at most against JAX's 2.59e-3]; control: the
    port's f32 trajectory lands measurably closer, below a tenth of the
    port's bf16 distance [1.25e-6]."""
    cfg_j, pj, cfg_t, pt = pair("flash", False, embed_dim=128, mlp_dim=256,
                                  max_seq_len=128)
    batches = [rng_np.integers(0, 64, size=(4, 97)) for _ in range(5)]
    jopt = JAdam(learning_rate=1e-2, moment_dtype=jnp.bfloat16)
    js = jopt.init_tree(pj)
    jstep = JT.build_train_step(cfg_j, jopt, compute_dtype=jnp.bfloat16)
    jp, j_losses = jax.tree.map(jnp.copy, pj), []
    for ids in batches:
        jp, js, jl = jstep(jp, js, jnp.asarray(ids))
        j_losses.append(float(jl))
    losses = {}
    for name, params, dtype in (("bf16", pt, torch.bfloat16),
                                ("f32", pt, None), ("f64", _f64(pt), None)):
        params = tree.unflatten(params, [p.clone()
                                         for p in tree.leaves(params)])
        opt = Adam(learning_rate=1e-2, moment_dtype=dtype)
        state, step = opt.init_tree(params), T.build_train_step(
            cfg_t, opt, compute_dtype=dtype)
        losses[name] = []
        for ids in batches:
            params, state, loss = step(params, state, torch.from_numpy(ids))
            losses[name].append(float(loss))
    f64 = np.array(losses["f64"])
    jdist = np.abs(np.array(j_losses) - f64).max()
    bdist = np.abs(np.array(losses["bf16"]) - f64)
    fdist = np.abs(np.array(losses["f32"]) - f64).max()
    assert bdist.max() <= 2 * jdist + 1e-4, (bdist, jdist)
    assert fdist < 0.1 * bdist.max(), (fdist, bdist)
    assert losses["bf16"][-1] < losses["bf16"][0]


def test_bf16_building_blocks_against_jax(rng_np):
    """The LM's elementwise blocks on bf16 tensors against the JAX
    package's on the same values: ``ops.nn.layer_norm`` (one f32 upcast,
    as JAX's) unequal on at most 1% of the elements, each within one ulp
    [measured: equal]; the token gather (``F.embedding``) equal to
    ``embed[ids]``; ``ops.nn.gelu`` (PyTorch computes the tanh form in f32
    and rounds once, XLA's CPU rounds op by op in bf16) closer than JAX's
    to the float64 tanh form of the same inputs, a mean distance within 2
    ulps of the result [measured: 1.35 against JAX's 14.2]."""
    import chip_smoke as S
    from paddle_tpu.ops.nn import layer_norm as j_ln
    from paddle_tpu_torch.ops.nn import gelu, layer_norm

    def bf16_pair(*shape, scale=1.0, shift=0.0):
        x = jnp.asarray(rng_np.normal(size=shape).astype(np.float32) * scale
                        + shift, jnp.bfloat16)
        return x, to_torch(x)

    def to_torch(x):
        return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))
                                ).to(torch.bfloat16)

    (jx, tx), (jg, tg), (jb, tb) = (
        bf16_pair(4, 33, 256, scale=3.0, shift=1.0),
        bf16_pair(256, scale=0.1, shift=1.0), bf16_pair(256, scale=0.1))
    ulps = S.bf16_ulps(layer_norm(tx, tg, tb), to_torch(j_ln(jx, jg, jb)))
    assert float((ulps > 0).float().mean()) <= 0.01 and int(ulps.max()) <= 1
    (jt, tt), ids = bf16_pair(50, 16), rng_np.integers(0, 50, size=(3, 7))
    assert torch.equal(torch.nn.functional.embedding(torch.from_numpy(ids),
                                                     tt),
                       to_torch(jt[jnp.asarray(ids)]))
    jx, tx = bf16_pair(4, 33, 1024, scale=2.0)
    x64 = tx.double()
    exact = 0.5 * x64 * (1 + torch.tanh((2 / np.pi) ** 0.5 * (
        x64 + 0.044715 * x64 ** 3)))

    def mean_ulps(y):
        top = torch.maximum(y.double().abs(), exact.abs())
        ulp = torch.ldexp(torch.ones_like(top), torch.frexp(top)[1] - 8)
        return float(((y.double() - exact).abs() / ulp).mean())

    port, ref = mean_ulps(gelu(tx)), mean_ulps(to_torch(jax.nn.gelu(jx)))
    assert port <= min(2.0, ref), (port, ref)


def lm_bf16_witness_errors() -> dict:
    """At ``chip_smoke.py``'s LM bf16 witness step (``LM_BF16_NET``, batch
    2 x 128, ``lm_bf16_setup``): the relative error per gradient leaf and
    of the loss, against the port's float64 step, of the JAX package's
    bf16 step (flash at its default block), of the port's bf16 step on the
    CPU and of the same with the flash backward's delta dropped."""
    import chip_smoke as S

    cfg_t, params, ids = S.lm_bf16_setup()
    cfg_j = JT.TransformerConfig(**S.LM_BF16_NET, attn_impl="flash",
                                 remat=False)
    pj = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    l64, g64 = T.loss_and_grads(cfg_t, _f64(params), ids)
    g64 = S.named_leaves(g64)
    jl, jg = jax.value_and_grad(lambda p: JT.loss_fn(
        cfg_j, _cast_floats(p, jnp.bfloat16), jnp.asarray(ids.numpy())))(pj)
    out = {"jax": S.lm_bf16_errors(
        float(jl), jax.tree.map(lambda x: torch.from_numpy(np.array(x)),
                                jg), l64, g64)}
    out["port"] = S.lm_bf16_errors(*T.loss_and_grads(
        cfg_t, params, ids, torch.bfloat16), l64, g64)
    plain_delta = FA._delta
    FA._delta = lambda do, o: torch.zeros_like(plain_delta(do, o))
    try:
        out["delta_dropped"] = S.lm_bf16_errors(*T.loss_and_grads(
            cfg_t, params, ids, torch.bfloat16), l64, g64)
    finally:
        FA._delta = plain_delta
    return out


def test_chip_smoke_lm_bf16_witness_limits_are_jaxs_own_error():
    """``chip_smoke.LM_BF16_WITNESS_JAX`` holds the JAX package's own bf16
    error at the card's LM witness step, for each of the 16 gradient
    leaves and the loss: recomputed, each within 25% [the margin is for
    another CPU's f32 rounding, which bf16 amplifies].  The port's bf16
    step on the CPU lies within the card's limit, 2x that error plus
    ``LM_BF16_FLOOR``, on every leaf [at most 0.4 of it]; the backward
    without delta exceeds it [by 10x or more on the attention leaves]."""
    import chip_smoke as S

    got = lm_bf16_witness_errors()
    assert sorted(got["jax"]) == sorted(S.LM_BF16_WITNESS_JAX)
    assert len(S.LM_BF16_WITNESS_JAX) == 16 + 1
    for n, r in got["jax"].items():
        assert r == pytest.approx(S.LM_BF16_WITNESS_JAX[n], rel=0.25), n

    def over(errs):
        return [n for n, r in errs.items()
                if r > 2 * S.LM_BF16_WITNESS_JAX[n] + S.LM_BF16_FLOOR]

    assert not over(got["port"]), over(got["port"])
    assert over(got["delta_dropped"])


if __name__ == "__main__":
    # chip_smoke.py's LM_BF16_WITNESS_JAX, from the root of a checkout:
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_lm_train.py
    errs = lm_bf16_witness_errors()
    print("LM_BF16_WITNESS_JAX = {")
    for n, r in sorted(errs["jax"].items()):
        print(f"    {n!r}: {r:.4g},")
    print("}")
    print("# the port's bf16 step on the CPU, worst (error, 2 x JAX's):",
          max((r, 2 * errs["jax"][n]) for n, r in errs["port"].items()))
