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

import ctypes
import dataclasses
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
from paddle_tpu_torch.core.enforce import EnforceError
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
    built = U.build_table(*U.columns(updates), rows)
    table, blocks = built.entries, int(built.first[-1])
    nonempty = [u for u in updates if u.p.numel()]
    assert len(table) == built.count == len(nonempty) == len(shapes) - 1
    assert table.dtype.itemsize == 56
    assert built.index == [i for i, u in enumerate(updates) if u.p.numel()]
    assert list(built.first[:-1]) == list(table["first"])
    for cover in _walk(table, blocks, rows):
        assert np.all(cover == 1)
    for e, u in zip(table, nonempty):
        # in place: the table holds p and v only, the gradients come with
        # each launch
        assert e["p"] == u.p.data_ptr()
        assert e["n"] == (u.p.shape[0] if rows else u.p.numel())
        assert e["width"] == (u.p.shape[1] if rows else 0)
        assert e["lr"] == np.float32(u.lr) and e["wd"] == np.float32(
            u.weight_decay)
        has_v = u.v is not None
        assert e["flags"] == (has_v * U.HAS_V
                              + (has_v and u.nesterov) * U.NESTEROV
                              + bool(u.weight_decay) * U.HAS_WD)
        assert (e["v"] != 0) == has_v
        assert not has_v or e["v"] == u.v.data_ptr()


def test_table_refuses_what_the_kernels_do_not_take():
    f32 = torch.zeros(4, 3)

    def build(*ups, rows=False):
        return U.build_table(*U.columns(list(ups)), rows)

    with pytest.raises(Exception, match="float32"):
        build(U.TensorUpdate(f32.double(), f32.double()))
    with pytest.raises(Exception, match="one shape"):
        build(U.TensorUpdate(f32, torch.zeros(3, 4)))
    with pytest.raises(Exception, match=r"\[V, D\]"):
        build(U.TensorUpdate(torch.zeros(4), torch.zeros(4)), rows=True)
    # written in place: p and v must be contiguous
    with pytest.raises(Exception, match="contiguous"):
        build(U.TensorUpdate(torch.zeros(3, 4).t(), torch.zeros(4, 3)))
    with pytest.raises(Exception, match="contiguous"):
        build(U.TensorUpdate(f32, f32, torch.zeros(3, 4).t()))


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
    # the routed apply updates its parameters in place: it gets copies
    given = {n: t.clone() for n, t in p0.items()}
    pa, sa = given, opt.init(given, specs)
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
    assert all(pa[n] is given[n] for n in P_SHAPES)
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


# -- in place, and the table kept on the card ------------------------------------


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_routed_apply_is_in_place_with_the_loops_bits_over_ten_steps(kind):
    """The twins' route (CPU): ``apply`` returns the parameters and slots
    it was given, updated, and they equal the per-tensor loop's in bits
    after each of 10 steps."""
    rng = np.random.default_rng(40 + len(kind))
    opt = OPTIMIZERS[kind](TO, learning_rate=0.1,
                           regularization=TO.L2Regularization(rate=1e-3))
    specs = _specs(TParams, TI, TAttr)
    p0 = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for n, s in P_SHAPES.items()}
    given = {n: t.clone() for n, t in p0.items()}
    sa = opt.init(given, specs)
    vel = {n: s["velocity"] for n, s in sa["slots"].items()
           if isinstance(s, dict)}
    pa, pb, sb = given, p0, opt.init(p0, specs)
    for _ in range(10):
        g = {n: torch.from_numpy(v) for n, v in _grads(rng).items()}
        pa, sa = opt.apply(g, pa, sa, specs)
        pb, sb = opt._apply_each(g, pb, sb, specs)
        assert all(pa[n] is given[n] for n in P_SHAPES)
        for n in P_SHAPES:
            _same(pa[n].numpy(), pb[n].numpy(), n)
        for n, v in vel.items():
            assert sa["slots"][n]["velocity"] is v
            _same(v.numpy(), sb["slots"][n]["velocity"].numpy(), n)
    assert sa["step"] == 10


def test_wrappers_write_their_twins_results_in_place():
    """``fused_update`` and ``sparse_row_update`` on CPU tensors: the
    tensors given come back, holding the pure twins' results, their
    version counters moved."""
    rng = np.random.default_rng(8)
    p, g, v = (torch.from_numpy(a) for a in _draw(rng, (6, 5), 3))
    g[1] = 0.0
    for run, twin in ((U.fused_update, U.reference_update),
                      (EK.sparse_row_update, EK.reference_row_update)):
        u = U.TensorUpdate(p.clone(), g, v.clone(), 0.1, 0.9, True, 1e-2)
        want = twin(u)
        versions = (u.p._version, u.v._version)
        (p2, v2), = run([u])
        assert p2 is u.p and v2 is u.v
        assert p2._version > versions[0] and v2._version > versions[1]
        _same(p2.numpy(), want[0].numpy())
        _same(v2.numpy(), want[1].numpy())


class _Card:
    """The card's two update kernels emulated on the CPU from what the
    wrappers hand them: the kept table (read back from its copy "on the
    card") and the launch's gradient pointers, each pointer resolved to
    a tensor the test registered, the rule applied by the twins with the
    table's f32 scalars.  So the host side of the route (keys, kept
    tables, gradient checks, the pointers by value) runs as it does on
    the card."""

    def __init__(self, monkeypatch):
        import functools

        from paddle_tpu_torch.ops import nn as nn_ops

        self.tensors = {}
        monkeypatch.setattr(nn_ops, "_takes_kernel",
                            lambda x: x.dtype != torch.float64)
        for kernel, rows in ((U.KERNEL, False), (EK.KERNEL_ROWS, True)):
            monkeypatch.setattr(kernel, "tables", [])
            monkeypatch.setattr(kernel, "table_builds", 0)
            monkeypatch.setattr(kernel, "launch_on",
                                functools.partial(self.launch_on, kernel,
                                                  rows))

    def launch_on(self, kernel, rows, index, *args):
        """``Kernel.launch_on``: the card's stream appended (0 here)."""
        self.launch(kernel, rows, *args, 0)

    def know(self, *trees):
        for t in trees:
            for x in (t.values() if isinstance(t, dict) else t):
                if isinstance(x, dict):
                    self.know(x)
                elif isinstance(x, torch.Tensor):
                    self.tensors[x.data_ptr()] = x

    def launch(self, kernel, rows, table_ptr, count, first_ptr, grads_ptr,
               stream):
        table = kernel.tables[0]
        assert (table_ptr, first_ptr) == (table.on_card.data_ptr(),
                                          table.first.ctypes.data)
        entries = np.frombuffer(table.on_card.numpy().tobytes(), U.ENTRY)
        assert count == len(entries) == table.count
        grads = np.ctypeslib.as_array(
            (ctypes.c_uint64 * count).from_address(grads_ptr))
        for e, gp in zip(entries, grads):
            p, g = self.tensors[int(e["p"])], self.tensors[int(gp)]
            v = self.tensors[int(e["v"])] if e["flags"] & U.HAS_V else None
            assert e["n"] == (p.shape[0] if rows else p.numel())
            u = U.TensorUpdate(
                p, g, v, float(e["lr"]), float(e["mu"]),
                bool(e["flags"] & U.NESTEROV),
                float(e["wd"]) if e["flags"] & U.HAS_WD else 0.0)
            U.twin_in_place(EK.reference_row_update if rows
                            else U.reference_update, u)
        kernel.launches += 1


def _card_step(card, opt, g, params, state, specs):
    card.know(g)
    return opt.apply(g, params, state, specs)


@pytest.mark.parametrize("kind", sorted(OPTIMIZERS))
def test_kept_table_hits_and_is_rebuilt_when_its_key_changes(kind,
                                                             monkeypatch):
    """Through the card's route (emulated): 10 steps build each kernel's
    table once and give the loop's bits; a replaced parameter tensor and a
    new learning rate each build it once more, and the loop's bits
    hold."""
    card = _Card(monkeypatch)
    rng = np.random.default_rng(60 + len(kind))
    opt = OPTIMIZERS[kind](TO, learning_rate=0.1,
                           regularization=TO.L2Regularization(rate=1e-3))
    loop = OPTIMIZERS[kind](TO, learning_rate=0.1,
                            regularization=TO.L2Regularization(rate=1e-3))
    specs = _specs(TParams, TI, TAttr)
    p0 = {n: torch.from_numpy(rng.normal(size=s).astype(np.float32))
          for n, s in P_SHAPES.items()}
    pa = {n: t.clone() for n, t in p0.items()}
    sa = opt.init(pa, specs)
    card.know(pa, sa["slots"])
    pb, sb = p0, loop.init(p0, specs)
    launches = (U.KERNEL.launches, EK.KERNEL_ROWS.launches)

    def step():
        nonlocal pa, sa, pb, sb
        g = {n: torch.from_numpy(v) for n, v in _grads(rng).items()}
        pa, sa = _card_step(card, opt, g, pa, sa, specs)
        pb, sb = loop._apply_each(g, pb, sb, specs)
        for n in P_SHAPES:
            _same(pa[n].numpy(), pb[n].numpy(), n)

    for _ in range(10):
        step()
    assert (U.KERNEL.launches - launches[0],
            EK.KERNEL_ROWS.launches - launches[1]) == (10, 10)
    assert (U.KERNEL.table_builds, EK.KERNEL_ROWS.table_builds) == (1, 1)
    # a replaced parameter tensor: its table is built anew, the other kept
    pa = dict(pa, plain=pa["plain"].clone())
    card.know(pa)
    step()
    assert (U.KERNEL.table_builds, EK.KERNEL_ROWS.table_builds) == (2, 1)
    step()
    assert U.KERNEL.table_builds == 2
    # a new learning rate: both built anew
    opt.learning_rate = loop.learning_rate = 0.05
    step()
    step()
    assert (U.KERNEL.table_builds, EK.KERNEL_ROWS.table_builds) == (3, 2)


@pytest.mark.parametrize("fault", ["shape", "dtype", "device"])
def test_kept_table_still_checks_every_gradient(fault, monkeypatch):
    """A gradient of the wrong shape, dtype or device raises on a kept
    table as on a new one, before any launch."""
    card = _Card(monkeypatch)
    rng = np.random.default_rng(5)
    ups = [U.TensorUpdate(*(torch.from_numpy(a) for a in _draw(rng, s, 3)),
                          lr=0.1, mu=0.9) for s in ((4, 3), (7,))]
    card.know([t for u in ups for t in (u.p, u.g, u.v)])
    U.launch_table(U.KERNEL, ups, rows=False)
    U.launch_table(U.KERNEL, ups, rows=False)
    assert U.KERNEL.table_builds == 1
    before = U.KERNEL.launches
    bad = {"shape": torch.zeros(3, 4), "dtype": torch.zeros(4, 3).double(),
           "device": torch.zeros(4, 3, device="meta")}[fault]
    ups[0] = dataclasses.replace(ups[0], g=bad)
    with pytest.raises(EnforceError, match="float32 parameters, gradients"):
        U.launch_table(U.KERNEL, ups, rows=False)
    assert U.KERNEL.launches == before and U.KERNEL.table_builds == 1


def test_launch_bumps_the_version_of_every_tensor_written(monkeypatch):
    """A graph that saved a parameter raises after the step instead of
    reading its new bits."""
    card = _Card(monkeypatch)
    w = torch.ones(5, requires_grad=True)
    p = w.detach()
    u = U.TensorUpdate(p, torch.ones(5), torch.zeros(5), 0.1, 0.9)
    card.know([p, u.g, u.v])
    y = (w * w).sum()              # saves w for its backward
    versions = (p._version, u.v._version)
    U.launch_table(U.KERNEL, [u], rows=False)
    assert p._version > versions[0] and u.v._version > versions[1]
    with pytest.raises(RuntimeError, match="modified by an inplace"):
        y.backward()


def test_plan_is_kept_until_the_optimizer_names_or_specs_change():
    """``fused_apply``'s plan: the same object while the optimizer's
    configuration, the names and the specs hold; a new one after each
    change, with the new scalars."""
    opt = TO.Momentum(momentum=0.9, learning_rate=0.1)
    specs = _specs(TParams, TI, TAttr)
    params = {n: torch.zeros(P_SHAPES[n]) for n in P_SHAPES}
    state = opt.init(params, specs)
    first = U.plan(opt, params, state, specs)
    assert U.plan(opt, dict(params), state, dict(specs)) is first
    dense = dict(zip(*[g[1:4:2] for g in first.groups if not g[0]][0]))
    assert dense["lr_scale"] == (0.1 * 0.25, 0.9, False, 0.0)
    assert dense["own_momentum"][1] == 0.5 and "frozen" not in dense
    lazy = [g for g in first.groups if g[0]][0]
    assert lazy[1] == ("table", "table_plain")
    opt.learning_rate = 0.2
    second = U.plan(opt, params, state, specs)
    assert second is not first
    dense = dict(zip(*[g[1:4:2] for g in second.groups if not g[0]][0]))
    assert dense["plain"][0] == 0.2
    assert U.plan(opt, params, state, specs) is second
    fewer = {n: t for n, t in params.items() if n != "decay"}
    assert U.plan(opt, fewer, state, specs) is not second
    specs2 = dict(specs, plain=dataclasses.replace(specs["plain"],
                                                   decay_rate=0.5))
    third = U.plan(opt, params, state, specs2)
    dense = dict(zip(*[g[1:4:2] for g in third.groups if not g[0]][0]))
    assert dense["plain"][3] == 0.5
