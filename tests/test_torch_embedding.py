"""The port's embedding gather / scatter-add / fused lookup
(``paddle_tpu_torch/ops/kernels/embedding.py``, plain twins on the CPU)
against the JAX package's ``paddle_tpu/ops/pallas/tpp/embedding.py``:
each Pallas kernel forced (``impl="kernel"``, interpret mode) and its
``*_reference`` twin, on the same numpy inputs, with duplicate,
out-of-range and negative ids and a ``padding_idx``.

Tolerance: the gather copies rows, so it is bit-identical; the sums
(scatter-add, the table gradient) are held to 1e-6 (f32 round-off of
another summation order over at most a few duplicates)."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import embedding as temb
from paddle_tpu_torch.ops.kernels import embedding as EK

JE = importlib.import_module("paddle_tpu.ops.pallas.tpp.embedding")

SUM_TOL = 1e-6


def ids_of(rng, n, v):
    """Flat ids with duplicates, ids past V, -1 and another negative."""
    ids = rng.integers(0, v, size=n)
    ids[:4] = [v + 3, -1, -7, v - 1]
    ids[4:10] = ids[10:16]
    return ids.astype(np.int32)


@pytest.mark.parametrize("n,v,d", [(37, 50, 8), (64, 20, 33)])
def test_gather_is_bit_identical_to_jax(n, v, d):
    rng = np.random.default_rng(n + v)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = ids_of(rng, n, v)
    got = EK.embedding_gather(torch.from_numpy(table),
                              torch.from_numpy(ids).long()).numpy()
    for impl in ("kernel", "reference"):
        want = np.asarray(JE.embedding_gather(jnp.asarray(table),
                                              jnp.asarray(ids), impl=impl))
        assert np.array_equal(got, want), impl


@pytest.mark.parametrize("n,v,d", [(37, 50, 8), (64, 20, 33)])
def test_scatter_add_matches_jax(n, v, d):
    rng = np.random.default_rng(n * v)
    table = rng.normal(size=(v, d)).astype(np.float32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    ids = ids_of(rng, n, v)
    got = EK.embedding_scatter_add(torch.from_numpy(table),
                                   torch.from_numpy(ids).long(),
                                   torch.from_numpy(rows)).numpy()
    for impl in ("kernel", "reference"):
        want = np.asarray(JE.embedding_scatter_add(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
            impl=impl))
        np.testing.assert_allclose(got, want, atol=SUM_TOL, rtol=0,
                                   err_msg=impl)


def test_dedup_ids_matches_jax():
    rng = np.random.default_rng(1)
    ids = ids_of(rng, 40, 30)
    uids, inv = EK.dedup_ids(torch.from_numpy(ids).long())
    juids, jinv = JE.dedup_ids(jnp.asarray(ids))
    k = uids.shape[0]
    assert np.array_equal(uids.numpy(), np.asarray(juids)[:k])
    assert np.all(np.asarray(juids)[k:] == -1)
    assert np.array_equal(inv.numpy(), np.asarray(jinv))


@pytest.mark.parametrize("padding_idx", [None, 5])
@pytest.mark.parametrize("shape", [(48,), (6, 8)])
def test_fused_lookup_forward_and_table_grad_match_jax(padding_idx, shape):
    rng = np.random.default_rng(7)
    v, d = 50, 16
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = ids_of(rng, int(np.prod(shape)), v)
    ids[20:23] = 5                      # the padding id, repeated
    ids = ids.reshape(shape)
    ct = rng.normal(size=shape + (d,)).astype(np.float32)

    t = torch.from_numpy(table).requires_grad_()
    out = temb.lookup(t, torch.from_numpy(ids).long(), padding_idx)
    (g,) = torch.autograd.grad(out, (t,), torch.from_numpy(ct))
    for impl in ("kernel", "reference"):
        jout, vjp = jax.vjp(
            lambda tb: JE.fused_embedding_lookup(tb, jnp.asarray(ids),
                                                 padding_idx, impl),
            jnp.asarray(table))
        (jg,) = vjp(jnp.asarray(ct))
        assert np.array_equal(out.detach().numpy(), np.asarray(jout)), impl
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=SUM_TOL,
                                   rtol=0, err_msg=impl)
    if padding_idx is not None:
        assert np.all(g.numpy()[padding_idx] == 0)
        assert np.all(out.detach().numpy()[ids == padding_idx] == 0)


def test_fused_lookup_float64_gradcheck():
    """In-range ids only: an id outside [0, V) reads the clamped row but
    gives it no gradient (the JAX contract), which no finite difference
    reproduces."""
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(9, 3))).requires_grad_()
    ids = torch.tensor([[0, 3, 3, 8], [7, 2, 2, 3]])
    assert torch.autograd.gradcheck(
        lambda tb: EK.fused_embedding_lookup(tb, ids, 2), (table,),
        fast_mode=True)
