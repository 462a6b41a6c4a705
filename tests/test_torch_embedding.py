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


# -- the scatter-add's grouping passes (their twin) and its order of sums --------


def _stable_groups(ids, v):
    """counts, offsets and order by their definition: a stable sort of the
    in-range positions by id (numpy's mergesort)."""
    ids = np.asarray(ids, np.int64)
    pos = np.nonzero((ids >= 0) & (ids < v))[0]
    order = pos[np.argsort(ids[pos], kind="stable")]
    counts = np.bincount(ids[pos], minlength=v)
    return counts, np.concatenate([[0], np.cumsum(counts)]), order


GROUP_CASES = {
    "empty": (np.zeros(0, np.int64), 7),
    "all_equal": (np.full(300, 4, np.int64), 9),
    "out_of_range": (np.array([-1, 5, 3, 12, 5, -7, 3, 11, 5, 0]), 12),
    "v_one": (np.array([0, 0, -1, 1, 0, 2, 0]), 1),
    "mixed": (np.random.default_rng(3).integers(-2, 40, size=2500), 37),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_ids_twin_is_the_stable_sort(case):
    """``group_ids_reference`` (and ``group_ids`` on CPU ids) against the
    stable sort's construction, in integers: no ids, one id 300 times, -1
    and >= V ids, V = 1."""
    ids, v = GROUP_CASES[case]
    want = _stable_groups(ids, v)
    for fn in (EK.group_ids_reference, EK.group_ids):
        got = fn(torch.from_numpy(ids), v)
        assert [t.dtype for t in got] == [torch.int32] * 3
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), w), (fn.__name__, case)
    counts, offsets, order = (t.numpy() for t in got)
    assert offsets[-1] == order.size == counts.sum()
    # each run is one id, its positions increasing
    for r in range(v):
        run = order[offsets[r]:offsets[r + 1]]
        assert np.all(ids[run] == r) and np.all(np.diff(run) > 0)


def test_scratch_layout_holds_each_section_apart():
    """The scatter-add's scratch block (mirrored in csrc/embedding.cu):
    16-byte aligned sections in order, the counters first, none
    overlapping, the keys 8-byte entries for at least one chunk."""
    for n, v, d in ((0, 1, 0), (1, 37, 5), (8192, 30000, 128),
                    (70000, 10 ** 6, 0)):
        lay = EK.scratch_layout(n, v, d)
        sizes = {"counts": 4, "done": 4, "arrive": 4, "offsets": 4,
                 "order": 4, "keys": 8, "partial": 4}
        names = list(sizes)
        assert [lay[k][0] for k in names] == sorted(lay[k][0] for k in names)
        for a, b in zip(names, names[1:] + ["total"]):
            off, count = lay[a]
            end = lay[b] if b == "total" else lay[b][0]
            assert off % 16 == 0 and off + sizes[a] * count <= end, (a, n)
        assert lay["keys"][1] >= EK.GROUP_CHUNK
        assert lay["arrive"][1] == -(-n // EK.SEGMENT)
        assert lay["partial"][1] == 2 * d * (-(-n // EK.SEGMENT))


@pytest.mark.parametrize("n,v,d", [(37, 50, 8), (64, 20, 33), (300, 7, 5)])
def test_scatter_by_groups_matches_the_twin_and_jax(n, v, d):
    """The kernels' order of sums (``scatter_add_by_groups``: each run
    summed in position order through the grouping twin, then added to its
    table row once) against ``embedding_scatter_add_reference`` and JAX's
    kernel in interpret mode, and a table gradient (no table) against the
    twin on zeros: within 1e-6, or where a row takes a long run (300 ids
    into 7 rows: ~43 a row) within the two orders' f32 error bound,
    k 2^-23 (|table| + sum |rows|) for a run of k."""
    rng = np.random.default_rng(n + 3 * v)
    table = rng.normal(size=(v, d)).astype(np.float32)
    rows = rng.normal(size=(n, d)).astype(np.float32)
    ids = ids_of(rng, n, v)
    t, i, r = (torch.from_numpy(table), torch.from_numpy(ids).long(),
               torch.from_numpy(rows))

    def near(got, want, base):
        keep = (ids >= 0) & (ids < v)
        k = np.bincount(ids[keep], minlength=v)[:, None]
        mag = np.abs(base).astype(np.float64)
        np.add.at(mag, ids[keep], np.abs(rows[keep]))
        tol = np.maximum(SUM_TOL, k * 2.0 ** -23 * mag)
        assert np.all(np.abs(got - np.asarray(want)) <= tol)

    got = EK.scatter_add_by_groups(t, i, r).numpy()
    near(got, EK.embedding_scatter_add_reference(t, i, r).numpy(), table)
    near(got, JE.embedding_scatter_add(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows),
        impl="kernel", interpret=True), table)
    grad = EK.scatter_add_by_groups(None, i, r, num_rows=v)
    near(grad.numpy(), EK.table_grad(i, r, v).numpy(), np.zeros_like(table))


# -- the lookup forward as one gather (no dedup) ------------------------------


def _jax_bf16(x):
    """A numpy f32 array as JAX bf16 and as the same bits in torch."""
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j.astype(jnp.float32))).to(
        torch.bfloat16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("padding_idx", [None, 5])
def test_lookup_forward_is_jaxs_copy_bit_for_bit(dtype, padding_idx):
    """The forward gathers by the flat ids with the padding rows zeroed in
    the same gather, where JAX dedups, gathers each unique row once and
    re-expands: the same copy, bit for bit, in f32 and bf16, with
    duplicate ids and the padding id repeated (ids in range: past V JAX's
    CPU ``jnp.take`` gives NaN rows)."""
    rng = np.random.default_rng(11)
    v, d = 40, 24
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, size=(6, 9))
    ids[0, :4] = 5
    ids[1] = ids[2]                       # whole rows of duplicates
    if dtype == "bfloat16":
        jt, tt = _jax_bf16(table)
    else:
        jt, tt = jnp.asarray(table), torch.from_numpy(table)
    for impl in ("kernel", "reference"):
        want = JE.fused_embedding_lookup(jt, jnp.asarray(ids), padding_idx,
                                         impl)
        got = EK.fused_embedding_lookup(tt, torch.from_numpy(ids),
                                        padding_idx)
        assert got.dtype == tt.dtype
        assert np.array_equal(got.float().numpy(),
                              np.asarray(want.astype(jnp.float32))), impl
    if padding_idx is not None:
        assert not got[torch.from_numpy(ids) == padding_idx].any()


def test_lookup_forward_calls_no_dedup(monkeypatch):
    """The forward is one gather: ``dedup_ids`` (a sort whose size
    depends on the data, a host sync on the card) is never called; the
    gradient is built from the flat ids as before."""
    def no_dedup(*a, **k):
        raise AssertionError("the lookup forward called dedup_ids")

    monkeypatch.setattr(EK, "dedup_ids", no_dedup)
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(30, 8)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 30, size=(4, 5)))
    leaf = table.clone().requires_grad_()
    out = EK.fused_embedding_lookup(leaf, ids, padding_idx=3)
    ct = torch.from_numpy(rng.normal(size=(4, 5, 8)).astype(np.float32))
    (g,) = torch.autograd.grad(out, leaf, ct)
    flat = ids.reshape(-1)
    want = EK.embedding_gather_reference(table, flat, 3).reshape(4, 5, 8)
    assert torch.equal(out.detach(), want)
    ctf = ct.reshape(-1, 8).clone()
    ctf[flat == 3] = 0
    assert torch.equal(g, EK.table_grad(flat, ctf, 30))


@pytest.mark.parametrize("padding_idx", [None, 0, 7, -1])
def test_gather_twin_zeroes_the_padding_rows(padding_idx):
    """``embedding_gather_reference(..., padding_idx)``: the clamped copy,
    with the rows whose raw id is the padding id zero (a -1 padding id
    matches the raw -1, not the row it clamps to)."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.normal(size=(10, 4)).astype(np.float32))
    ids = torch.tensor([0, 7, -1, 12, 7, 3, 0])
    got = EK.embedding_gather(table, ids, padding_idx)
    want = table[ids.clamp(0, 9)].clone()
    if padding_idx is not None:
        want[ids == padding_idx] = 0
    assert torch.equal(got, want)
