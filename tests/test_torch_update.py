"""The fused SGD / Momentum update and the row-lazy table update (the
port's ``ops/kernels/update.py`` and ``embedding.sparse_row_update``)
against the JAX package's kernels in interpret mode and their references,
and the routed ``Optimizer.apply`` against the per-tensor loop.

Tolerances: the twins run the eager rule op for op, as the JAX references
do, so they are held bit-identical to those; against the JAX kernels in
interpret mode, whose XLA CPU fusion contracts a multiply-add in places,
to 2e-7 x max(1, |x|) (measured: one ulp); the routed
``apply`` is held bit-identical to the loop it replaces
(``Optimizer._apply_each``); the table of the card's launch is checked by
walking it as the kernel does."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.core.initializer as JI
import paddle_tpu.core.parameters as JParams
import paddle_tpu.optimizer as JO
import paddle_tpu_torch.core.initializer as TI
import paddle_tpu_torch.core.parameters as TParams
import paddle_tpu_torch.optimizer as TO
from paddle_tpu.layers.attr import ParamAttr as JAttr
from paddle_tpu.ops.pallas import tpp
from paddle_tpu_torch.layers.attr import ParamAttr as TAttr
from paddle_tpu_torch.ops.kernels import embedding as EK
from paddle_tpu_torch.ops.kernels import update as U

JU = importlib.import_module("paddle_tpu.ops.pallas.tpp.update")
SHAPES = [(1,), (127,), (37, 53)]
KERNEL_ATOL = 2e-7


def _draw(rng, shape, n):
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _near_kernel(got, want, what=""):
    """Against a JAX kernel run in interpret mode, whose XLA CPU fusion
    contracts a product and a sum into one rounding in places: within
    KERNEL_ATOL x max(1, |x|) elementwise, x the kernel's value (measured:
    one ulp, 1.19e-7 x max(1, |x|), on about a quarter of the elements)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.all(np.abs(got.astype(np.float64) - want)
                  <= KERNEL_ATOL * np.maximum(1.0, np.abs(want))), what


def _same(got, want, what=""):
    """Bit-identical, NaNs in the same places."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), what


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.02])
@pytest.mark.parametrize("nesterov", [False, True])
def test_momentum_twin_matches_the_jax_kernel_and_reference(shape, wd,
                                                            nesterov):
    rng = np.random.default_rng(len(shape) * 7 + int(wd * 100) + nesterov)
    p, g, v = _draw(rng, shape, 3)
    lr, mu = 0.1, 0.9
    got = U.fused_momentum_update_reference(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(v), lr,
        mu, nesterov=nesterov, weight_decay=wd)
    ref = tpp.fused_momentum_update_reference(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(v), lr, mu,
        nesterov=nesterov, weight_decay=wd)
    ker = tpp.fused_momentum_update(
        jnp.asarray(p), jnp.asarray(g), jnp.asarray(v), jnp.float32(lr),
        jnp.float32(mu), nesterov=nesterov, weight_decay=wd, impl="kernel",
        interpret=True)
    for t, r, k, what in zip(got, ref, ker, ("p", "v")):
        _same(t.numpy(), r, f"{what} vs reference")
        _near_kernel(t.numpy(), k, f"{what} vs interpret kernel")
    # the wrapper on CPU tensors is the twin
    wrapped = U.fused_update([U.TensorUpdate(
        torch.from_numpy(p), torch.from_numpy(g), torch.from_numpy(v), lr,
        mu, nesterov, wd)])[0]
    for t, w in zip(got, wrapped):
        _same(w.numpy(), t.numpy())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wd", [0.0, 0.02])
def test_sgd_twin_matches_the_jax_kernel_and_reference(shape, wd):
    rng = np.random.default_rng(len(shape) + int(wd * 100))
    p, g = _draw(rng, shape, 2)
    got = U.fused_sgd_update_reference(torch.from_numpy(p),
                                       torch.from_numpy(g), 0.05,
                                       weight_decay=wd)
    ref = tpp.fused_sgd_update_reference(jnp.asarray(p), jnp.asarray(g),
                                         0.05, weight_decay=wd)
    ker = tpp.fused_sgd_update(jnp.asarray(p), jnp.asarray(g),
                               jnp.float32(0.05), weight_decay=wd,
                               impl="kernel", interpret=True)
    _same(got.numpy(), ref)
    _near_kernel(got.numpy(), ker)
    wrapped, none = U.fused_update([U.TensorUpdate(
        torch.from_numpy(p), torch.from_numpy(g), lr=0.05,
        weight_decay=wd)])[0]
    _same(wrapped.numpy(), got.numpy())
    assert none is None


def _sparse_grad(rng, rows, d):
    """Rows 0-2 all zero, row 3 all -0.0 (untouched), row 4 touched by a
    single nonzero, the rest dense."""
    g = rng.normal(size=(rows, d)).astype(np.float32)
    g[:3] = 0.0
    g[3] = -0.0
    g[4] = 0.0
    g[4, d // 2] = 0.75
    return g


@pytest.mark.parametrize("kind", ["sgd", "momentum", "nesterov"])
@pytest.mark.parametrize("wd", [0.0, 0.02])
def test_sparse_row_twin_matches_the_jax_kernel_and_reference(kind, wd):
    rng = np.random.default_rng(len(kind) + int(wd * 100))
    p = rng.normal(size=(12, 5)).astype(np.float32)
    g = _sparse_grad(rng, 12, 5)
    v = None if kind == "sgd" else rng.normal(size=(12, 5)).astype(np.float32)
    kw = dict(lr=0.1, mu=0.9, nesterov=kind == "nesterov", weight_decay=wd)
    got = EK.sparse_row_update_reference(
        torch.from_numpy(p), torch.from_numpy(g),
        None if v is None else torch.from_numpy(v), **kw)
    jv = None if v is None else jnp.asarray(v)
    ref = tpp.sparse_row_update_reference(jnp.asarray(p), jnp.asarray(g),
                                          jv, **kw)
    ker = tpp.sparse_row_update(jnp.asarray(p), jnp.asarray(g), jv,
                                impl="kernel", interpret=True, **kw)
    _same(got[0].numpy(), ref[0])
    _near_kernel(got[0].numpy(), ker[0])
    _same(got[0].numpy()[:4], np.asarray(ker[0])[:4])
    if v is None:
        assert got[1] is None and ref[1] is None and ker[1] is None
    else:
        _same(got[1].numpy(), ref[1])
        _near_kernel(got[1].numpy(), ker[1])
        _same(got[1].numpy()[:4], v[:4])
        assert not np.array_equal(got[1].numpy()[4], v[4])
    # untouched rows (the zero rows and the -0.0 row) bit for bit; the
    # single-nonzero row moves everywhere it decays or has momentum
    _same(got[0].numpy()[:4], p[:4])
    assert not np.array_equal(got[0].numpy()[4], p[4])
    wrapped = EK.sparse_row_update([U.TensorUpdate(
        torch.from_numpy(p), torch.from_numpy(g),
        None if v is None else torch.from_numpy(v), 0.1, 0.9,
        kind == "nesterov", wd)])[0]
    _same(wrapped[0].numpy(), got[0].numpy())


def test_sparse_row_twin_counts_a_nan_row_as_touched():
    p = np.ones((3, 4), np.float32)
    g = np.zeros((3, 4), np.float32)
    g[1, 2] = np.nan
    got, _ = EK.sparse_row_update_reference(torch.from_numpy(p),
                                            torch.from_numpy(g), lr=0.5)
    ref, _ = tpp.sparse_row_update_reference(jnp.asarray(p), jnp.asarray(g),
                                             lr=0.5)
    _same(got.numpy(), ref)
    assert np.isnan(got.numpy()[1, 2]) and got.numpy()[1, 0] == 1.0


# -- the card's table, walked as the kernel walks it ---------------------------


def _walk(table, blocks, rows):
    """For each entry, the work units (elements or rows) the blocks cover,
    found as the kernel finds them: the last entry whose first block is
    at most the block's index."""
    firsts = table["first"]
    per = U.ROWS_PER_BLOCK if rows else U.CHUNK
    covered = [np.zeros(int(n), np.int64) for n in table["n"]]
    for b in range(blocks):
        i = int(np.searchsorted(firsts, b, side="right")) - 1
        lo = (b - int(firsts[i])) * per
        hi = min(int(table["n"][i]), lo + per)
        assert lo < hi, f"block {b} has no work"
        covered[i][lo:hi] += 1
    return covered


@pytest.mark.parametrize("rows", [False, True])
def test_table_covers_every_unit_once(rows):
    rng = np.random.default_rng(3)
    shapes = ([(10, 1), (0, 4), (9, 64), (1000, 64), (17, 3)] if rows else
              [(1,), (10,), (0,), (2048,), (2049,), (64, 3, 3, 3), (5000,)])
    updates = []
    for i, s in enumerate(shapes):
        p = torch.from_numpy(rng.normal(size=s).astype(np.float32))
        v = torch.zeros_like(p) if i % 2 else None
        updates.append(U.TensorUpdate(p, torch.ones_like(p), v,
                                      lr=0.1 * (i + 1), mu=0.9,
                                      nesterov=i == 3, weight_decay=i * 1e-3))
    table, blocks, out, inputs = U.build_table(updates, rows)
    nonempty = [u for u in updates if u.p.numel()]
    assert len(table) == len(nonempty) == len(shapes) - 1
    assert table.dtype.itemsize == 80
    for cover in _walk(table, blocks, rows):
        assert np.all(cover == 1)
    for e, u in zip(table, nonempty):
        assert e["p"] == u.p.data_ptr() and e["g"] == u.g.data_ptr()
        assert e["n"] == (u.p.shape[0] if rows else u.p.numel())
        assert e["width"] == (u.p.shape[1] if rows else 0)
        assert e["lr"] == np.float32(u.lr) and e["wd"] == np.float32(
            u.weight_decay)
        has_v = u.v is not None
        assert e["flags"] == (has_v * U.HAS_V
                              + (has_v and u.nesterov) * U.NESTEROV
                              + bool(u.weight_decay) * U.HAS_WD)
        assert (e["v"] != 0) == has_v and (e["v_out"] != 0) == has_v
    assert [tuple(po.shape) for po, _ in out] == [tuple(s) for s in shapes]
    assert len(inputs) == 3 * len(shapes)


def test_table_refuses_what_the_kernels_do_not_take():
    f32 = torch.zeros(4, 3)
    with pytest.raises(Exception, match="float32"):
        U.build_table([U.TensorUpdate(f32.double(), f32.double())], False)
    with pytest.raises(Exception, match="one shape"):
        U.build_table([U.TensorUpdate(f32, torch.zeros(3, 4))], False)
    with pytest.raises(Exception, match=r"\[V, D\]"):
        U.build_table([U.TensorUpdate(torch.zeros(4), torch.zeros(4))], True)


# -- Optimizer.apply routed through the kernels vs the per-tensor loop ---------

SPEC_FIELDS = {
    "plain": {},
    "decay": {"decay_rate": 5e-3},
    "lr_scale": {"learning_rate": 0.25},
    "own_momentum": {"momentum": 0.5},
    "frozen": {"is_static": True},
    "all": {"decay_rate": 1e-2, "learning_rate": 2.0, "momentum": 0.7},
    "table": {"sparse": True, "decay_rate": 0.25},
    "table_plain": {"sparse": True},
}
P_SHAPES = {"plain": (3, 4), "decay": (5,), "lr_scale": (2, 2, 3),
            "own_momentum": (4,), "frozen": (3,), "all": (3, 3, 2, 4),
            "table": (9, 4), "table_plain": (6, 3)}


def _specs(mod_params, mod_init, attr):
    out = {}
    for n, f in SPEC_FIELDS.items():
        extra = ({"attr": attr(name=n, sparse_update=True)}
                 if f.get("sparse") else {})
        out[n] = mod_params.ParamSpec(name=n, shape=P_SHAPES[n],
                                      initializer=mod_init.constant(0.0),
                                      **f, **extra)
    return out


def _grads(rng):
    g = {n: rng.normal(size=s).astype(np.float32) for n, s in
         P_SHAPES.items()}
    for n in ("table", "table_plain"):
        keep = rng.random(P_SHAPES[n][0]) < 0.5
        g[n][~keep] = 0.0
        g[n][0] = 0.0
    return g


OPTIMIZERS = {
    "sgd": lambda mod, **kw: mod.SGD(**kw),
    "momentum": lambda mod, **kw: mod.Momentum(momentum=0.9, **kw),
    "nesterov": lambda mod, **kw: mod.Momentum(momentum=0.9,
                                               use_nesterov=True, **kw),
}


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
@pytest.mark.parametrize("l2", [0.0, 1e-3])
def test_routed_apply_is_bit_identical_to_the_loop(kind, l2, monkeypatch):
    """Slot-free SGD, SGD with a spec momentum, Momentum with and without
    nesterov; a global L2 and a spec decay_rate; a spec learning_rate and
    momentum; a static parameter; two row-lazy tables — three steps."""
    rng = np.random.default_rng(len(kind) + int(l2 * 1e4))
    reg = TO.L2Regularization(rate=l2) if l2 else None
    opt = OPTIMIZERS[kind](TO, learning_rate=0.1, regularization=reg)
    specs = _specs(TParams, TI, TAttr)
    p0 = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for n, s in P_SHAPES.items()}
    routed = []
    real = U.fused_apply
    monkeypatch.setattr(U, "fused_apply",
                        lambda *a: routed.append(1) or real(*a))
    pa, sa = p0, opt.init(p0, specs)
    pb, sb = p0, opt.init(p0, specs)
    for _ in range(3):
        g = {n: torch.from_numpy(v) for n, v in _grads(rng).items()}
        pa, sa = opt.apply(g, pa, sa, specs)
        pb, sb = opt._apply_each(g, pb, sb, specs)
    assert len(routed) == 3 and sa["step"] == sb["step"] == 3
    for n in P_SHAPES:
        _same(pa[n].numpy(), pb[n].numpy(), n)
        if isinstance(sb["slots"][n], dict):
            assert sa["slots"][n].keys() == sb["slots"][n].keys()
            _same(sa["slots"][n]["velocity"].numpy(),
                  sb["slots"][n]["velocity"].numpy(), n)
        else:
            assert sa["slots"][n] == sb["slots"][n] == ()
    assert pa["frozen"] is p0["frozen"]
    assert not torch.equal(pa["table"], p0["table"])
    # row 0 of each table is never touched: parameter and slot stay
    for n in ("table", "table_plain"):
        _same(pa[n][0].numpy(), p0[n][0].numpy(), n)
        if isinstance(sa["slots"][n], dict):
            assert not sa["slots"][n]["velocity"][0].any()


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_routed_apply_matches_the_jax_apply(kind):
    """The same three steps through the JAX package's ``Optimizer.apply``
    (its row-lazy rule included): rtol 1e-6, atol 1e-7 (the bound of
    ``test_torch_optimizer.py``: XLA may fuse a multiply-add)."""
    rng = np.random.default_rng(11 + len(kind))
    jopt = OPTIMIZERS[kind](JO, learning_rate=0.1,
                            regularization=JO.L2Regularization(rate=1e-3))
    topt = OPTIMIZERS[kind](TO, learning_rate=0.1,
                            regularization=TO.L2Regularization(rate=1e-3))
    jspecs, tspecs = _specs(JParams, JI, JAttr), _specs(TParams, TI, TAttr)
    p0 = {n: rng.normal(size=s).astype(np.float32)
          for n, s in P_SHAPES.items()}
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    tp = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    js, ts = jopt.init(jp, jspecs), topt.init(tp, tspecs)
    for _ in range(3):
        g = _grads(rng)
        jp, js = jopt.apply({n: jnp.asarray(v) for n, v in g.items()}, jp,
                            js, jspecs)
        tp, ts = topt.apply({n: torch.from_numpy(v) for n, v in g.items()},
                            tp, ts, tspecs)
    for n in P_SHAPES:
        np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7, err_msg=n)
    for n in ("table", "table_plain"):
        _same(tp[n][0].numpy(), np.asarray(jp[n])[0], n)


ELIGIBILITY = {
    "sgd": (lambda m: m.SGD(learning_rate=0.1), {}),
    "momentum": (lambda m: m.Momentum(learning_rate=0.1), {}),
    "nesterov_l2": (lambda m: m.Momentum(
        learning_rate=0.1, use_nesterov=True,
        regularization=m.L2Regularization(rate=1e-3)), {}),
    "l1": (lambda m: m.SGD(learning_rate=0.1,
                           regularization=m.L1Regularization(rate=1e-3)), {}),
    "global_clip": (lambda m: m.Momentum(learning_rate=0.1,
                                         gradient_clipping_threshold=1.0),
                    {}),
    "spec_clip": (lambda m: m.Momentum(learning_rate=0.1),
                  {"gradient_clipping_threshold": 0.5}),
    "spec_sparsity": (lambda m: m.SGD(learning_rate=0.1),
                      {"sparsity_ratio": 0.5}),
    "adam": (lambda m: m.Adam(learning_rate=0.1), {}),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY))
@pytest.mark.parametrize("avg", [False, True])
def test_eligibility_agrees_with_the_jax_rule(case, avg):
    make, fields = ELIGIBILITY[case]
    got = []
    for mod, params_mod, init_mod in ((JO, JParams, JI), (TO, TParams, TI)):
        spec = params_mod.ParamSpec(name="w", shape=(2,),
                                    initializer=init_mod.constant(0.0),
                                    **fields)
        state = {"step": 0, "slots": {"w": ()}}
        if avg:
            state["avg"] = {}
        if mod is JO:
            got.append(JU.fused_apply_eligible(make(mod), state,
                                               {"w": spec}, ["w"]))
        else:
            got.append(U.fused_apply_eligible(make(mod), state, {"w": spec},
                                              ["w"]))
    want = case in ("sgd", "momentum", "nesterov_l2") and not avg
    assert got == [want, want]


def test_ineligible_apply_takes_the_loop(monkeypatch):
    monkeypatch.setattr(U, "fused_apply",
                        lambda *a: pytest.fail("routed an L1 optimizer"))
    opt = TO.SGD(learning_rate=0.1,
                 regularization=TO.L1Regularization(rate=1e-3))
    p = {"w": torch.ones(3)}
    got, state = opt.apply({"w": torch.ones(3)}, p, opt.init(p))
    assert state["step"] == 1
    np.testing.assert_allclose(got["w"].numpy(), 1 - 0.1 * (1 + 1e-3),
                               rtol=1e-6)
