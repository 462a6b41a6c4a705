"""Dropout in the port: ``ops/nn.dropout``, ``layer.dropout``,
``ExtraAttr(drop_rate=)`` and the seeded stream behind them
(``core/rng``, ``Context.generator_for``, the trainer's step seed).

The JAX package draws its masks from threefry and the port from PyTorch's
generators, so the masks themselves are not compared with JAX: what is
held is the law (the kept share within 4 sigma of 1 - rate over 10^6
draws, kept values x / keep), the identity in test mode and at rate 0,
the determinism (the same step seed and layer name give the same mask,
another name or another step another one), and the configuration
(``drop_rate`` stays on the node under its own name, byte-equal
serialization with JAX)."""

import numpy as np
import pytest
import torch

import paddle_tpu.config.topology as JTopo
import paddle_tpu.layers.activation as JA
import paddle_tpu.layers.api as JL
import paddle_tpu.layers.data_type as JD
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.config.topology as TTopo
import paddle_tpu_torch.layers.activation as TA
import paddle_tpu_torch.layers.api as TL
import paddle_tpu_torch.layers.data_type as TD
from paddle_tpu.layers.attr import ExtraAttr as JExtra
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.layers.attr import ExtraAttr as TExtra
from paddle_tpu_torch.layers.base import Context
from paddle_tpu_torch.ops import nn as tnn

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _fresh_names():
    from paddle_tpu.layers.base import reset_name_counters as jreset
    from paddle_tpu_torch.layers.base import reset_name_counters as treset

    jreset()
    treset()
    yield


def test_rate_zero_and_test_mode_are_the_identity():
    x = torch.randn(50, 7, generator=torch.Generator().manual_seed(0))
    gen = Context(True, seed=3).generator_for("d", CPU)
    assert tnn.dropout(x, 0.0, gen, True) is x
    assert tnn.dropout(x, 0.5, gen, False) is x
    node = TL.dropout(input=TL.data(name="x", type=TD.dense_vector(7)),
                      dropout_rate=0.5)
    # test mode: no seed, nothing drawn
    vals, _ = TTopo.Topology(node).forward({}, {}, {"x": x}, False)
    assert vals[node.name] is x
    zero = TL.dropout(input=TL.data(name="y", type=TD.dense_vector(7)),
                      dropout_rate=0.0)
    vals, _ = TTopo.Topology(zero).forward({}, {}, {"y": x}, True, seed=1)
    assert vals[zero.name] is x


@pytest.mark.parametrize("rate", [0.3, 0.5])
def test_kept_share_and_scaling(rate):
    """Over 10^6 draws the kept share lies within 4 sigma of 1 - rate, and
    each kept value is x / keep (dropped ones are 0)."""
    keep = 1.0 - rate
    x = torch.rand(1000, 1000, generator=torch.Generator().manual_seed(1)) + 1
    y = tnn.dropout(x, rate, Context(True, seed=9).generator_for("d", CPU),
                    True)
    kept = y != 0
    share = kept.double().mean().item()
    assert abs(share - keep) <= 4 * np.sqrt(keep * rate / x.numel())
    assert torch.equal(y[kept], (x / keep)[kept])


def test_float64_input_draws_the_f32_mask():
    """The mask is drawn in float32 whatever the dtype, so a float64
    witness of a step drops exactly what the f32 step drops."""
    x = torch.rand(64, 33, generator=torch.Generator().manual_seed(2)) + 1
    ctx = Context(True, seed=5)
    y32 = tnn.dropout(x, 0.4, ctx.generator_for("d", CPU), True)
    y64 = tnn.dropout(x.double(), 0.4, ctx.generator_for("d", CPU), True)
    assert y64.dtype == torch.float64
    assert torch.equal(y32 != 0, y64 != 0)
    torch.testing.assert_close(y64.float(), y32)


def test_masks_follow_the_seed_and_the_name():
    x = torch.ones(200, 50)

    def mask(seed, name):
        gen = Context(True, seed=seed).generator_for(name, CPU)
        return tnn.dropout(x, 0.5, gen, True) != 0

    assert torch.equal(mask(11, "a"), mask(11, "a"))
    assert not torch.equal(mask(11, "a"), mask(11, "b"))
    assert not torch.equal(mask(11, "a"), mask(12, "a"))
    with pytest.raises(Exception, match="step seed"):
        Context(True).generator_for("a", CPU)


def test_the_stream_gives_one_seed_a_step():
    rng.seed(7)
    first = rng.peek_seed()
    assert rng.peek_seed() == first
    seeds = [rng.next_seed() for _ in range(4)]
    assert seeds[0] == first and len(set(seeds)) == 4
    assert all(0 <= s < 2 ** 63 for s in seeds)
    assert rng.get_state() == (7, 4)
    after = rng.next_seed()
    rng.seed(7)
    assert [rng.next_seed() for _ in range(5)] == seeds + [after]


def drop_graph(L, A, D, E):
    x = L.data(name="x", type=D.dense_vector(16))
    h = L.fc(input=x, size=32, act=A.ReluActivation(), name="hidden",
             layer_attr=E(drop_rate=0.5))
    h = L.dropout(input=h, dropout_rate=0.25, name="drop")
    return L.fc(input=h, size=4, act=A.SoftmaxActivation(), name="out",
                layer_attr=E(drop_rate=0.1))


def test_extra_attr_drop_rate_keeps_the_node_and_serializes_as_jax():
    jt = JTopo.Topology(drop_graph(JL, JA, JD, JExtra))
    tt = TTopo.Topology(drop_graph(TL, TA, TD, TExtra))
    assert tt.serialize() == jt.serialize()
    assert tt.digest() == jt.digest()
    nodes = {n.name: n for n in tt.nodes}
    assert [n.layer_type for n in tt.nodes] == ["data", "fc", "dropout",
                                                "fc"]
    assert nodes["hidden"].attrs["drop_rate"] == 0.5
    assert nodes["drop"].attrs["dropout_rate"] == 0.25
    # a dropping softmax fc exposes no logits companion (as in JAX)
    assert "__fc_logits__" not in nodes["out"].attrs


def test_drop_rate_applies_in_training_only():
    t = TTopo.Topology(drop_graph(TL, TA, TD, TExtra))
    params = tpaddle.parameters.create(t).as_dict()
    x = torch.randn(64, 16, generator=torch.Generator().manual_seed(0))
    a, _ = t.forward(params, {}, {"x": x}, True, seed=3)
    b, _ = t.forward(params, {}, {"x": x}, True, seed=3)
    c, _ = t.forward(params, {}, {"x": x}, True, seed=4)
    e, _ = t.forward(params, {}, {"x": x}, False)
    assert torch.equal(a["out"], b["out"])
    assert not torch.equal(a["out"], c["out"])
    plain = torch.relu(x @ params["_hidden.w0"] + params["_hidden.wbias"])
    assert torch.equal(e["hidden"], plain)
    # half of the nonzero relu outputs survive (within 4 sigma)
    n = int((plain != 0).sum())
    kept = int((a["hidden"] != 0).sum()) / n
    assert abs(kept - 0.5) <= 4 * np.sqrt(0.25 / n)
    assert torch.equal(a["hidden"][a["hidden"] != 0],
                       (plain / 0.5)[a["hidden"] != 0])


def test_error_clipping_is_still_refused():
    x = TL.data(name="x", type=TD.dense_vector(4))
    with pytest.raises(NotImplementedError, match="error_clipping"):
        TL.fc(input=x, size=3, layer_attr=TExtra(error_clipping_threshold=1))


def net(rate):
    x = TL.data(name="x", type=TD.dense_vector(12))
    h = TL.fc(input=x, size=24, act=TA.ReluActivation(), name="h",
              layer_attr=TExtra(drop_rate=rate))
    y = TL.fc(input=h, size=3, act=TA.SoftmaxActivation(), name="y")
    lbl = TL.data(name="label", type=TD.integer_value(3))
    return TL.classification_cost(input=y, label=lbl)


def samples(n, seed=0):
    r = np.random.default_rng(seed)
    return [(r.normal(size=12).astype(np.float32), int(r.integers(0, 3)))
            for _ in range(n)]


def train_costs(cost, data, seed):
    rng.seed(seed)
    params = tpaddle.parameters.create(cost)
    tr = tpaddle.trainer.SGD(cost=cost, parameters=params, device="cpu",
                             update_equation=tpaddle.optimizer.Momentum(
                                 momentum=0.9, learning_rate=0.1))
    out = []
    tr.train(reader=lambda: iter([data[i:i + 8] for i in range(0, 32, 8)]),
             num_passes=1, event_handler=lambda e: out.append(e.cost)
             if isinstance(e, tpaddle.event.EndIteration) else None)
    return out, tr


def test_trainer_draws_a_seed_a_step_and_reruns_bit_for_bit():
    data = samples(32)
    cost = net(0.5)
    a, tr = train_costs(cost, data, 5)
    b, _ = train_costs(cost, data, 5)
    c, _ = train_costs(cost, data, 6)
    assert a == b and a != c
    assert rng.get_state() == (6, 4)
    # test draws nothing: the stream does not move and the cost repeats
    before = rng.get_state()
    t1 = tr.test(reader=lambda: iter([data[:8]]))
    t2 = tr.test(reader=lambda: iter([data[:8]]))
    assert rng.get_state() == before and t1.cost == t2.cost


def test_float64_witness_sees_the_masks_of_the_f32_step():
    """``SGD.step_f64`` takes the seed the next step will take, so with
    dropout on, the f32 step lies within f32 round-off of it; a witness
    with another seed does not."""
    data = samples(8, seed=1)
    cost = net(0.5)
    rng.seed(21)
    params = tpaddle.parameters.create(cost)
    p0 = {n: params[n].copy() for n in params.names()}
    tr = tpaddle.trainer.SGD(cost=cost, parameters=params, device="cpu",
                             update_equation=tpaddle.optimizer.SGD(
                                 learning_rate=1.0))
    p64, _, c64 = tr.step_f64(data)
    rng.next_seed()
    other, _, c_other = tr.step_f64(data)
    rng.seed(21)
    costs = []
    tr.train(reader=lambda: iter([data]), num_passes=1,
             event_handler=lambda e: costs.append(e.cost)
             if isinstance(e, tpaddle.event.EndIteration) else None)
    np.testing.assert_allclose(costs[0], c64, rtol=1e-6)
    assert abs(c_other - c64) > 1e-3
    for n in p0:
        moved = np.linalg.norm(p64[n] - p0[n])
        assert np.linalg.norm(tr.parameters[n] - p64[n]) <= 1e-5 * max(
            moved, 1e-3), n
