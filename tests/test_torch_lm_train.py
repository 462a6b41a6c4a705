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
from paddle_tpu_torch.core import tree
from paddle_tpu_torch.models import transformer as T
from paddle_tpu_torch.ops.kernels import flash_attention as FA
from paddle_tpu_torch.optimizer import Adam, opt_state_from_numpy

SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, embed_dim=32,
             mlp_dim=64, max_seq_len=32)


def pair(attn_impl="flash", remat=False, seed=1):
    cfg_j = JT.TransformerConfig(**SMALL, attn_impl=attn_impl, remat=remat)
    cfg_t = T.TransformerConfig(**SMALL, attn_impl=attn_impl, remat=remat)
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
    backward's delta dropped, the gradients move (a wrong backward shows)."""
    _, _, cfg_t, pt = pair("flash", False)
    ids = torch.from_numpy(rng_np.integers(0, 64, size=(2, 17)))
    loss, good = T.loss_and_grads(cfg_t, pt, ids)
    monkeypatch.setattr(FA, "_delta", lambda do, o: torch.zeros_like(
        do[..., :1]))
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
        T.build_train_step(cfg, opt, compute_dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="dots"):
        T.build_train_step(dataclasses.replace(cfg, remat="dots"), opt)
    with pytest.raises(NotImplementedError, match="MoE"):
        T.build_train_step(dataclasses.replace(cfg, moe_experts=2), opt)
