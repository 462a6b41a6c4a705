"""The bf16 forms of the port's large-vocabulary cross-entropy
(``paddle_tpu_torch/ops/kernels/softmax_xent.py``) and embedding
scatter-add (``ops/kernels/embedding.py``), their plain twins on the
CPU, against the JAX package's Pallas kernels in interpret mode on the
same numpy inputs.

- ``softmax_xent`` on bf16 logits (``paddle_tpu/ops/pallas/
  softmax_xent.py``): the row lse and the NLL in f32 (:106-108), the
  gradient ``(exp(x - lse) - onehot) g`` in f32 rounded to bf16 once
  (:126).  N 1 / 37, V 3 / 1,003, targets at both ends of the vocabulary.
- ``embedding_scatter_add`` on a bf16 table with f32 and with bf16 rows
  (``tpp/embedding.py:176-189``): an f32 accumulator started from the
  table, the rows added in f32, the result rounded once; duplicate ids
  and ``-1`` ids (dropped).

Tolerances: the NLL at rtol 1e-5 (f32 log-sum-exp in another summation
order); a bf16 result unequal on at most 1% of its elements, each within
one bf16 ulp at the larger magnitude.  The measured values stand at each
test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import embedding as EK
from paddle_tpu_torch.ops.kernels import softmax_xent as SX

JX = importlib.import_module("paddle_tpu.ops.pallas.softmax_xent")
JE = importlib.import_module("paddle_tpu.ops.pallas.tpp.embedding")

BF = jnp.bfloat16
NLL_RTOL = 1e-5
ULP_SHARE = 0.01


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _torch(x):
    x = jnp.asarray(x)
    out = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return out.to(torch.bfloat16) if x.dtype == BF else out


def unequal(got, want) -> tuple[float, float]:
    """(share of unequal elements, largest gap in ulps at the larger
    magnitude) of two bf16 results."""
    a, b = _np(got).astype(np.float64), _np(want).astype(np.float64)
    top = np.maximum(np.abs(a), np.abs(b))
    ulp = np.ldexp(1.0, np.frexp(top)[1] - 8)
    gap = np.abs(a - b)
    return float((gap > 0).mean()), float((gap / ulp).max())


def assert_bf16_matches(got, want, name):
    assert got.dtype == torch.bfloat16, (name, got.dtype)
    assert jnp.asarray(want).dtype == BF, (name, jnp.asarray(want).dtype)
    share, ulps = unequal(got, want)
    assert share <= ULP_SHARE and ulps <= 1, (name, share, ulps)


# -- softmax_xent -------------------------------------------------------------


def xent_inputs(n, v, seed):
    rng = np.random.default_rng(seed)
    logits = jnp.asarray((3.0 * rng.normal(size=(n, v))).astype(np.float32),
                         BF)
    targets = rng.integers(0, v, size=n)
    targets[0] = v - 1
    if n > 1:
        targets[1] = 0
    g = rng.normal(size=n).astype(np.float32)
    return logits, targets, g


def jax_xent(logits, targets, g):
    def f(x):
        return JX.softmax_xent(x, jnp.asarray(targets.astype(np.int32)),
                               interpret=True)

    nll, vjp = jax.vjp(f, logits)
    return nll, vjp(jnp.asarray(g))[0]


def torch_xent(logits, targets, g):
    x = _torch(logits).requires_grad_()
    nll = SX.softmax_xent(x, torch.from_numpy(targets))
    (dx,) = torch.autograd.grad(nll, x, torch.from_numpy(g))
    return nll, dx


@pytest.mark.parametrize("n", [1, 37])
@pytest.mark.parametrize("v", [3, 1003])
def test_bf16_softmax_xent_matches_jax_kernel(n, v):
    """The NLL (f32) and the logits' gradient (bf16) on bf16 logits
    against JAX's kernels in interpret mode [measured: the NLL within
    1.3e-7 relative; the gradient equal in bits]."""
    logits, targets, g = xent_inputs(n, v, seed=n * 7 + v)
    nll, dx = torch_xent(logits, targets, g)
    jnll, jdx = jax_xent(logits, targets, g)
    assert nll.dtype == torch.float32 and jnll.dtype == jnp.float32
    np.testing.assert_allclose(nll.detach().numpy(), np.asarray(jnll),
                               rtol=NLL_RTOL, atol=0)
    assert_bf16_matches(dx, jdx, "dlogits")


def test_bf16_softmax_xent_rounds_where_jax_rounds():
    """The fault this slice repaired (ROADMAP C6): the twin ran the
    log-sum-exp, the exp and the product in bf16 and returned the NLL in
    bf16.  Now the NLL is f32 and equals JAX's kernel's at rtol 1e-5, and
    dlogits is computed in f32 and rounded once."""
    logits, targets, g = xent_inputs(37, 1003, seed=5)
    nll, lse = SX._fwd_plain(_torch(logits), torch.from_numpy(targets))
    assert nll.dtype == lse.dtype == torch.float32
    jnll, jdx = jax_xent(logits, targets, g)
    np.testing.assert_allclose(nll.numpy(), np.asarray(jnll), rtol=NLL_RTOL,
                               atol=0)
    dx = SX._bwd_plain(_torch(logits), torch.from_numpy(targets), lse,
                       torch.from_numpy(g))
    assert unequal(dx, jdx) == (0.0, 0.0)


# -- embedding_scatter_add ----------------------------------------------------


def scatter_inputs(v, d, n, seed, rows_dtype, pad=True):
    """A bf16 table [v, d], n ids (duplicates; ``-1`` pads when ``pad``)
    and rows [n, d] of ``rows_dtype`` (numpy, jax)."""
    rng = np.random.default_rng(seed)
    table = jnp.asarray(rng.standard_normal((v, d)).astype(np.float32), BF)
    ids = rng.integers(0, v, size=n)
    if pad:
        ids[::7] = -1
        ids[1::5] = ids[2]          # one id many times
    rows = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32),
                       rows_dtype)
    return table, ids, rows


def jax_scatter(table, ids, rows):
    return JE.embedding_scatter_add(table, jnp.asarray(ids.astype(np.int32)),
                                    rows, impl="kernel", interpret=True)


@pytest.mark.parametrize("rows_dtype", [jnp.float32, BF],
                         ids=["f32_rows", "bf16_rows"])
@pytest.mark.parametrize("v,d,n", [(37, 16, 400), (300, 40, 96)])
def test_bf16_scatter_add_matches_jax_kernel(rows_dtype, v, d, n):
    """A bf16 table with f32 or bf16 rows, duplicate and ``-1`` ids,
    against JAX's kernel in interpret mode [measured: equal in bits]."""
    table, ids, rows = scatter_inputs(v, d, n, v + d, rows_dtype)
    got = EK.embedding_scatter_add(_torch(table), torch.from_numpy(ids),
                                   _torch(rows))
    assert_bf16_matches(got, jax_scatter(table, ids, rows), "table")


def test_bf16_scatter_add_sums_in_f32():
    """The fault this slice found and repaired (ROADMAP C7): the twin cast
    the rows to the table's dtype before adding, where the JAX kernel
    sums f32 rows into an f32 accumulator started from the table and
    rounds once (``tpp/embedding.py:176-189``).  On the probe's input (V
    37, D 16, 400 ids from ``default_rng(0)``, a bf16 table, f32
    standard-normal rows) the twin was unequal to JAX's kernel on 37.3% of
    the elements, by up to 0.0625; now they are equal in bits."""
    rng = np.random.default_rng(0)
    v, d, n = 37, 16, 400
    table = jnp.asarray(rng.standard_normal((v, d)).astype(np.float32), BF)
    ids = rng.integers(0, v, size=n)
    rows = jnp.asarray(rng.standard_normal((n, d)).astype(np.float32))
    got = EK.embedding_scatter_add(_torch(table), torch.from_numpy(ids),
                                   _torch(rows))
    assert got.dtype == torch.bfloat16
    assert unequal(got, jax_scatter(table, ids, rows)) == (0.0, 0.0)


@pytest.mark.parametrize("rows_dtype", [jnp.float32, BF],
                         ids=["f32_rows", "bf16_rows"])
@pytest.mark.parametrize("v,d,n", [(37, 16, 400), (300, 40, 96)])
def test_bf16_scatter_by_groups_matches_jax_kernel(rows_dtype, v, d, n):
    """The kernels' order of sums through the grouping twin
    (``scatter_add_by_groups``) on a bf16 table with f32 or bf16 rows,
    against JAX's kernel in interpret mode and the twin: within one bf16
    ulp, on at most 1% of the elements."""
    table, ids, rows = scatter_inputs(v, d, n, 2 * v + d, rows_dtype)
    got = EK.scatter_add_by_groups(_torch(table), torch.from_numpy(ids),
                                   _torch(rows))
    assert_bf16_matches(got, jax_scatter(table, ids, rows), "table")
    twin = EK.embedding_scatter_add_reference(
        _torch(table), torch.from_numpy(ids), _torch(rows))
    share, ulps = unequal(got, twin)
    assert share <= ULP_SHARE and ulps <= 1, (share, ulps)
