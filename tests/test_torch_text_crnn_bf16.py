"""The LSTM text classifier and the OCR CRNN in bf16 ``compute_dtype``:
the port's steps against the JAX package's bf16 steps and the float64
trajectory of the same weights, and the bf16 repairs of the embedding
lookup and the CTC they run through.

The nets are ``chip_smoke.py``'s bf16 witness cuts (``text_bf16_setup``:
hidden 64, vocabulary 1,000, embedding 32, 8 ragged sequences of 3-16
tokens; ``crnn_bf16_setup``: 16 x 48 images, 6 classes, ``rnn_size`` 8,
batch 8), with their seeded parameters and batches.  A first bf16 step
from a random init is mostly its own round-off, so both packages are
held against float64 rather than against each other: per gradient leaf
||g - g64|| / ||g64||, the port's within 2x JAX's own plus 2^-8 (one
bf16 unit), the loss within 2x JAX's relative error plus 1e-5; the
port's f32 step within 1e-4 on every leaf (control: the bf16 distance is
bf16's).  Over 5 Adam steps with bf16 moments (the benches' optimizers),
each port bf16 loss within 2x the largest distance of JAX's bf16 loss
from the float64 trajectory plus 1e-4, the f32 losses closer still.
The measured values stand at each test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as S
import paddle_tpu as jpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu.models import ocr_crnn as jcrnn
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer import step as JStep
from paddle_tpu_torch.core.dtype import cast_floats
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.ops.kernels import ctc as KC
from paddle_tpu_torch.ops.kernels import embedding as EK
from paddle_tpu_torch.ops.kernels import lstm as LK
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.trainer.step import build_train_step

JE = importlib.import_module("paddle_tpu.ops.pallas.tpp.embedding")
JD = importlib.import_module("paddle_tpu.layers.data_type")
BF = torch.bfloat16
FLOOR = 2.0 ** -8
STEPS = 5


def _to_torch(x):
    x = jnp.asarray(x)
    out = torch.from_numpy(np.array(x.astype(jnp.float32)))
    return out.to(BF) if x.dtype == jnp.bfloat16 else out


# -- the embedding lookup and the CTC in bf16 --------------------------------


def test_bf16_gather_twin_equals_jax_kernel():
    """The bf16 gather copies rows in the table's dtype (JAX
    ``tpp/embedding.py:146``): the twin equals JAX's kernel in interpret
    mode bit for bit, ids outside [0, V) clamped."""
    rng = np.random.default_rng(0)
    table = jnp.asarray(rng.normal(size=(50, 24)).astype(np.float32),
                        jnp.bfloat16)
    ids = rng.integers(-3, 53, size=97)
    want = JE.embedding_gather(table, jnp.asarray(ids), impl="kernel",
                               interpret=True)
    got = EK.embedding_gather(_to_torch(table), torch.from_numpy(ids))
    assert got.dtype == BF and torch.equal(got, _to_torch(want))


def test_bf16_lookup_gradient_sums_in_f32_and_casts_once():
    """The fused lookup's backward on a bf16 table (JAX
    ``tpp/embedding.py:380-394``): the cotangent upcast, each row summed
    in f32, the [V, D] result cast to bf16 once.  Against JAX's gradient
    (its kernels in interpret mode) with 2,000 ids over 40 rows, a third
    of them one id: at most one bf16 ulp apart on at most 1% of the
    entries [measured: equal].  On the card this sum is the f32
    scatter-add kernel's (``tests/test_torch_cuda.py``)."""
    rng = np.random.default_rng(1)
    v, d, n = 40, 16, 2000
    table = jnp.asarray(rng.normal(size=(v, d)).astype(np.float32),
                        jnp.bfloat16)
    ids = rng.integers(0, v, size=n)
    ids[: n // 3] = 7
    ct = jnp.asarray(rng.normal(size=(n, d)).astype(np.float32),
                     jnp.bfloat16)
    _, vjp = jax.vjp(lambda t: JE.fused_embedding_lookup(
        t, jnp.asarray(ids), None, "kernel", True), table)
    (want,) = vjp(ct)
    leaf = _to_torch(table).requires_grad_()
    out = EK.fused_embedding_lookup(leaf, torch.from_numpy(ids))
    (got,) = torch.autograd.grad(out, leaf, _to_torch(ct))
    assert got.dtype == BF
    ulps = S.bf16_ulps(got, _to_torch(want))
    assert int(ulps.max()) <= 1 and float((ulps > 0).float().mean()) <= 0.01


def test_bf16_ctc_equals_the_f32_route():
    """The CTC on bf16 log-probs (``layer.ctc`` takes log(clip(probs)) in
    the compute dtype): the fused CTC casts them to f32 first, as JAX
    ``ctc.py:269-270`` does, so the loss equals the f32 route's on the
    same values bit for bit and the gradient is that route's rounded to
    bf16 once."""
    rng = np.random.default_rng(2)
    b, t, v = 4, 9, 6
    logits = torch.from_numpy(rng.normal(size=(b, t, v)).astype(np.float32))
    logp = torch.log(torch.clamp(torch.softmax(logits, -1).to(BF),
                                 min=1e-12))
    labels = torch.from_numpy(rng.integers(0, v - 1, size=(b, 3)))
    ilen, llen = torch.tensor([9, 7, 9, 5]), torch.tensor([3, 2, 1, 3])

    def loss_and_grad(x):
        leaf = x.detach().requires_grad_()
        loss = KC.ctc_loss_fused(leaf, ilen, labels, llen, blank=v - 1)
        return loss, torch.autograd.grad(loss.mean(), leaf)[0]

    loss, grad = loss_and_grad(logp)
    loss32, grad32 = loss_and_grad(logp.float())
    assert logp.dtype == grad.dtype == BF and loss.dtype == torch.float32
    assert torch.equal(loss, loss32)
    assert torch.equal(grad, grad32.to(BF))


# -- the first step and 5 Adam steps against JAX and float64 ------------------


def jax_net(name):
    """The JAX package's net of the witness cut ``name`` and its feeder."""
    jax_reset()
    if name == "text":
        L, A = jpaddle.layer, jpaddle.activation
        net_cfg = S.TEXT_BF16_NET
        data = L.data(name="data",
                      type=JD.integer_value_sequence(net_cfg["vocab"]))
        net = L.embedding(input=data, size=net_cfg["embed"])
        net = L.fc(input=net, size=net_cfg["hidden"] * 4,
                   act=A.LinearActivation())
        net = L.last_seq(input=L.lstmemory(input=net))
        net = L.fc(input=net, size=2, act=A.SoftmaxActivation())
        label = L.data(name="label", type=JD.integer_value(2))
        cost = L.classification_cost(input=net, label=label)
    else:
        cost, _, _ = jcrnn.crnn_ctc_cost(**S.CRNN_BF16_NET)
    topo = JTopology(cost)
    types = {n: JD.InputType(dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
                             kind=l.attrs["data_type"])
             for n, l in topo.data_layers().items()}
    return topo, cost.name, JFeeder(types)


SETUPS = {"text": S.text_bf16_setup, "crnn": S.crnn_bf16_setup}
#: each bench's optimizer: Adam with bf16 moments at its rate
LR = {"text": 2e-3, "crnn": 1e-3}


def jax_errors(name) -> dict:
    """At the witness step ``name``: the relative error of each gradient
    leaf and of the loss, against the port's float64 step, of the JAX
    package's bf16 step, of the port's bf16 and f32 steps on the CPU, and
    of the port's bf16 step with dW_h over unshifted stacks (the card
    witness's planted fault)."""
    topo, cost_name, params, types, batch = SETUPS[name]()
    reset_name_counters()
    jtopo, jcost, jfeeder = jax_net(name)
    assert jtopo.digest() == topo.digest()
    feed = DataFeeder(types, device="cpu")(batch)

    def port(wide=torch.float32, dtype=None):
        p = {n: torch.from_numpy(v).to(wide) for n, v in params.items()}
        return S.topology_grads(topo, cost_name, p, feed, dtype)

    loss64, g64 = port(torch.float64)
    jfeed = jfeeder(batch)
    states = jtopo.init_states()

    def jloss(p):
        values, _ = jtopo.forward(JStep._cast_floats(p, jnp.bfloat16),
                                  states,
                                  JStep._cast_floats(jfeed, jnp.bfloat16),
                                  True, jax.random.key(0))
        return jnp.sum(values[jcost].astype(jnp.float32))

    jl, jg = jax.value_and_grad(jloss)(
        {n: jnp.asarray(v) for n, v in params.items()})
    out = {"jax": S.rnn_bf16_errors(
        float(jl), {n: torch.from_numpy(np.array(v)) for n, v in jg.items()},
        loss64, g64)}
    out["port"] = S.rnn_bf16_errors(*port(dtype=BF), loss64, g64)
    out["f32"] = S.rnn_bf16_errors(*port(), loss64, g64)
    plain = LK._shift_prev
    LK._shift_prev = lambda stack, boot, reverse: stack
    try:
        out["unshifted"] = S.rnn_bf16_errors(*port(dtype=BF), loss64, g64)
    finally:
        LK._shift_prev = plain
    return out


@pytest.fixture(scope="module")
def errors():
    return {name: jax_errors(name) for name in SETUPS}


@pytest.mark.parametrize("name", list(SETUPS))
def test_bf16_first_step_against_jax_and_float64(errors, name):
    """The first bf16 step's gradient leaves and loss of both packages
    against the float64 step [measured: the port at most 1.31x JAX's on
    a text leaf, 1.14x on a CRNN leaf; the losses 6.3e-6 against JAX's
    6.3e-6, 5.5e-5 against 4.9e-5]; the f32 step within 1e-4 on every
    leaf [at most 1.2e-6]."""
    e = errors[name]
    for n, jerr in e["jax"].items():
        floor = 1e-5 if n == "loss" else FLOOR
        assert e["port"][n] <= 2 * jerr + floor, (n, e["port"][n], jerr)
        assert e["f32"][n] <= 1e-4, (n, e["f32"][n])


@pytest.mark.parametrize("name", list(SETUPS))
def test_chip_smoke_rnn_bf16_witness_limits_are_jaxs_own_error(errors, name):
    """``chip_smoke``'s ``TEXT_BF16_WITNESS_JAX`` / ``CRNN_BF16_WITNESS_JAX``
    hold the JAX package's own bf16 error at the card's witness step,
    every gradient leaf and the loss: recomputed, each within 25% [the
    margin is for another CPU's f32 rounding, which bf16 amplifies].  The
    port's bf16 step on the CPU lies within the card's limit (2x that plus
    ``RNN_BF16_FLOOR``) on every leaf; dW_h over unshifted stacks exceeds
    it."""
    want = {"text": S.TEXT_BF16_WITNESS_JAX,
            "crnn": S.CRNN_BF16_WITNESS_JAX}[name]
    e = errors[name]
    assert sorted(e["jax"]) == sorted(want)
    for n, r in e["jax"].items():
        assert r == pytest.approx(want[n], rel=0.25), n

    def over(errs):
        return [n for n, r in errs.items()
                if r > 2 * want[n] + S.RNN_BF16_FLOOR]

    assert not over(e["port"]), over(e["port"])
    assert over(e["unshifted"])


def trajectories(name) -> dict:
    """STEPS Adam steps (bf16 moments, the bench's rate) from the witness
    weights on seeded batches: the JAX package's bf16
    ``build_train_step``, the port's in bf16 and f32, and the port's in
    float64 (f64 moments).  Returns the losses of each."""
    topo, cost_name, params, types, batch = SETUPS[name]()
    reset_name_counters()
    jtopo, _, jfeeder = jax_net(name)
    rng = np.random.default_rng(5)
    if name == "text":
        batches = [[(rng.integers(0, S.TEXT_BF16_NET["vocab"], size=int(
            rng.integers(3, 17))).tolist(), int(rng.integers(0, 2)))
            for _ in range(8)] for _ in range(STEPS)]
    else:
        from paddle_tpu_torch.models import ocr_crnn

        cfg = S.CRNN_BF16_NET
        samples = list(ocr_crnn.synthetic_ocr_reader(
            n_samples=8 * STEPS, image_height=cfg["image_height"],
            image_width=cfg["image_width"],
            num_classes=cfg["num_classes"], max_label_len=3, seed=9)())
        batches = [samples[8 * k:8 * k + 8] for k in range(STEPS)]
    out = {}
    jopt = JAdam(learning_rate=LR[name], moment_dtype=jnp.bfloat16)
    jstep = JStep.build_train_step(jtopo, jopt, compute_dtype=jnp.bfloat16)
    specs = {s.name: s for s in jtopo.param_specs()}
    p = {n: jnp.asarray(v) for n, v in params.items()}
    o, s = jopt.init(p, specs), jtopo.init_states()
    out["jax"] = []
    for b in batches:
        p, o, s, c, _ = jstep(p, o, s, jfeeder(b), jax.random.key(0))
        out["jax"].append(float(c))
    feeder = DataFeeder(types, device="cpu")
    for label, wide, dtype, moments in (
            ("bf16", torch.float32, BF, BF), ("f32", torch.float32, None, BF),
            ("f64", torch.float64, None, None)):
        opt = Adam(learning_rate=LR[name], moment_dtype=moments)
        step = build_train_step(topo, opt, compute_dtype=dtype)
        tspecs = {s.name: s for s in topo.param_specs()}
        tp = {n: torch.from_numpy(v).to(wide) for n, v in params.items()}
        to, ts = opt.init(tp, tspecs), {
            k: v.to(wide) for k, v in topo.init_states().items()}
        out[label] = []
        for b in batches:
            feed = feeder(b)
            if wide == torch.float64:
                feed = cast_floats(feed, torch.float64)
            tp, to, ts, c, _ = step(tp, to, ts, feed, 0)
            out[label].append(float(c))
    return out


@pytest.mark.parametrize("name", list(SETUPS))
def test_bf16_five_adam_steps_against_the_float64_trajectory(name):
    """5 Adam steps with bf16 moments: each port bf16 loss within 2x the
    largest distance of JAX's bf16 loss from the float64 trajectory plus
    1e-4 [measured: 2.9e-4 against JAX's 3.7e-4 (text), 7.9e-3 against
    2.3e-2 (CRNN)]; the f32 trajectory closer than a tenth of the port's
    bf16 distance plus 1e-6 [2.1e-6 and 2.8e-5]; the losses finite."""
    tr = trajectories(name)
    f64 = np.array(tr["f64"])
    jdist = np.abs(np.array(tr["jax"]) - f64).max()
    bdist = np.abs(np.array(tr["bf16"]) - f64)
    fdist = np.abs(np.array(tr["f32"]) - f64).max()
    assert np.isfinite(tr["bf16"]).all()
    assert bdist.max() <= 2 * jdist + 1e-4, (bdist, jdist)
    assert fdist <= 0.1 * bdist.max() + 1e-6, (fdist, bdist)


if __name__ == "__main__":
    # chip_smoke.py's TEXT_BF16_WITNESS_JAX and CRNN_BF16_WITNESS_JAX, from
    # the root of a checkout:
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_text_crnn_bf16.py
    for net in SETUPS:
        errs = jax_errors(net)
        print(f"{net.upper()}_BF16_WITNESS_JAX = {{")
        for n, r in sorted(errs["jax"].items()):
            print(f"    {n!r}: {r:.4g},")
        print("}")
        print("# the port's bf16 step on the CPU, worst (error, 2 x JAX's):",
              max((r, 2 * errs["jax"][n]) for n, r in errs["port"].items()))
