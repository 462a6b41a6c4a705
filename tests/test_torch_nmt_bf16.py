"""The attention NMT in bf16 ``compute_dtype``: the port's steps against
the JAX package's bf16 steps and the float64 trajectory of the same
weights.

The net is ``chip_smoke.py``'s bf16 witness cut (``nmt_bf16_setup``:
source vocabulary 20, target 17, word, encoder and decoder width 16 so
the card's D % 8 holds, 8 ragged rows of 1-12 tokens), with its seeded
parameters and batch.  The port's BiGRU runs the ``bigru_seq`` twin (the
f32 projection, the bf16 recurrence); JAX's, on the CPU, its unfused
composition with ``gru_seq`` in interpret mode; both decoders run the
``gru_step`` cell in bf16.  A first bf16 step from a random init is
mostly its own round-off, so both packages are held against float64
rather than against each other: per gradient leaf ||g - g64|| / ||g64||,
the port's within 2x JAX's own plus 2^-8 (one bf16 unit), the loss within
2x JAX's relative error plus 1e-5; the port's f32 step within 1e-4 on
every leaf.  Over 5 Adam steps with bf16 moments (``bench_nmt``'s
optimizer), each port bf16 loss within 2x the largest distance of JAX's
bf16 loss from the float64 trajectory plus 1e-4, the f32 losses within a
tenth of that.  The measured values stand at each test."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as S
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu.models import seqtoseq as jnmt
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu.trainer import step as JStep
from paddle_tpu_torch.core.dtype import cast_floats
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.ops.kernels import gru as GK
from paddle_tpu_torch.optimizer import Adam
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.trainer.step import build_train_step

JD = importlib.import_module("paddle_tpu.layers.data_type")
BF = torch.bfloat16
FLOOR = 2.0 ** -8
STEPS = 5
LR = 5e-3


def jax_net():
    """The JAX package's NMT at the witness cut and its feeder."""
    jax_reset()
    net = S.NMT_BF16_NET
    cost = jnmt.seqtoseq_net(net["source_dict_dim"], net["target_dict_dim"],
                             word_vector_dim=net["word_vector_dim"],
                             encoder_size=net["encoder_size"],
                             decoder_size=net["decoder_size"])
    topo = JTopology(cost)
    types = {n: JD.InputType(dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
                             kind=l.attrs["data_type"])
             for n, l in topo.data_layers().items()}
    return topo, cost.name, JFeeder(types, S.NMT_ORDER)


def jax_errors() -> dict:
    """At the witness step: the relative error of each gradient leaf and of
    the loss, against the port's float64 step, of the JAX package's bf16
    step, of the port's bf16 and f32 steps on the CPU, and of the port's
    bf16 step with the GRUs' dW_h over unshifted stacks (the card
    witness's planted fault)."""
    topo, cost_name, params, types, batch, feeding = S.nmt_bf16_setup()
    reset_name_counters()
    jtopo, jcost, jfeeder = jax_net()
    assert jtopo.digest() == topo.digest()
    feed = DataFeeder(types, feeding, device="cpu")(batch)

    def port(wide=torch.float32, dtype=None):
        p = {n: torch.from_numpy(v).to(wide) for n, v in params.items()}
        return S.topology_grads(topo, cost_name, p, feed, dtype)

    loss64, g64 = port(torch.float64)
    jfeed = jfeeder(batch)

    def jloss(p):
        values, _ = jtopo.forward(JStep._cast_floats(p, jnp.bfloat16), {},
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
    out["unshifted"] = S.rnn_bf16_errors(
        *S.gru_dwh_unshifted(lambda: port(dtype=BF)), loss64, g64)
    return out


@pytest.fixture(scope="module")
def errors():
    return jax_errors()


def test_bf16_first_step_against_jax_and_float64(errors):
    """The first bf16 step's gradient leaves and loss of both packages
    against the float64 step [measured: the port at most 1.49x JAX's on a
    leaf (_gru_decoder.w, 7.8e-3 against 5.2e-3); the loss 2.3e-5
    against 7.6e-5]; the f32 step within 1e-4 on every leaf [at most
    1.4e-6]."""
    for n, jerr in errors["jax"].items():
        floor = 1e-5 if n == "loss" else FLOOR
        assert errors["port"][n] <= 2 * jerr + floor, (
            n, errors["port"][n], jerr)
        assert errors["f32"][n] <= 1e-4, (n, errors["f32"][n])


def test_chip_smoke_nmt_bf16_witness_limits_are_jaxs_own_error(errors):
    """``chip_smoke``'s ``NMT_BF16_WITNESS_JAX`` holds the JAX package's own
    bf16 error at the card's witness step, every gradient leaf and the
    loss: recomputed, each within 25% [the margin is for another CPU's f32
    rounding, which bf16 amplifies].  The port's bf16 step on the CPU lies
    within the card's limit (2x that plus ``RNN_BF16_FLOOR``) on every
    leaf; the GRUs' dW_h over unshifted stacks exceeds it."""
    want = S.NMT_BF16_WITNESS_JAX
    assert sorted(errors["jax"]) == sorted(want)
    for n, r in errors["jax"].items():
        assert r == pytest.approx(want[n], rel=0.25), n

    def over(errs):
        return [n for n, r in errs.items()
                if r > 2 * want[n] + S.RNN_BF16_FLOOR]

    assert not over(errors["port"]), over(errors["port"])
    assert over(errors["unshifted"])


def trajectories() -> dict:
    """STEPS Adam steps (bf16 moments) from the witness weights on seeded
    batches: the JAX package's bf16 ``build_train_step``, the port's in
    bf16 and f32, and the port's in float64 (f64 moments).  Returns the
    losses of each."""
    topo, cost_name, params, types, _, feeding = S.nmt_bf16_setup()
    reset_name_counters()
    jtopo, _, jfeeder = jax_net()
    rng = np.random.default_rng(5)
    net = S.NMT_BF16_NET
    batches = []
    for _ in range(STEPS):
        batch = []
        for _ in range(8):
            ls, lt = (int(rng.integers(1, 13)) for _ in range(2))
            trg = rng.integers(0, net["target_dict_dim"], size=lt + 1)
            batch.append((rng.integers(0, net["source_dict_dim"],
                                       size=ls).tolist(),
                          trg[:-1].tolist(), trg[1:].tolist()))
        batches.append(batch)
    out = {}
    jopt = JAdam(learning_rate=LR, moment_dtype=jnp.bfloat16)
    jstep = JStep.build_train_step(jtopo, jopt, compute_dtype=jnp.bfloat16)
    specs = {s.name: s for s in jtopo.param_specs()}
    p = {n: jnp.asarray(v) for n, v in params.items()}
    o, s = jopt.init(p, specs), jtopo.init_states()
    out["jax"] = []
    for b in batches:
        p, o, s, c, _ = jstep(p, o, s, jfeeder(b), jax.random.key(0))
        out["jax"].append(float(c))
    feeder = DataFeeder(types, feeding, device="cpu")
    for label, wide, dtype, moments in (
            ("bf16", torch.float32, BF, BF), ("f32", torch.float32, None, BF),
            ("f64", torch.float64, None, None)):
        opt = Adam(learning_rate=LR, moment_dtype=moments)
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
            tp, to, ts, c, metrics = step(tp, to, ts, feed, 0)
            out[label].append(float(c))
            out.setdefault(label + "_metric_dtype", set()).add(
                type(metrics["classification_error_evaluator"]))
    return out


def test_bf16_five_adam_steps_against_the_float64_trajectory():
    """5 Adam steps with bf16 moments: each port bf16 loss within 2x the
    largest distance of JAX's bf16 loss from the float64 trajectory plus
    1e-4 [measured: 3.6e-4 against JAX's 1.5e-4]; the f32 trajectory
    within a tenth of the port's bf16 distance plus 1e-6 [8.4e-6]; the
    losses finite, the metric a Python float (divided in f32 and read
    back) in every dtype."""
    tr = trajectories()
    f64 = np.array(tr["f64"])
    jdist = np.abs(np.array(tr["jax"]) - f64).max()
    bdist = np.abs(np.array(tr["bf16"]) - f64)
    fdist = np.abs(np.array(tr["f32"]) - f64).max()
    assert np.isfinite(tr["bf16"]).all()
    assert bdist.max() <= 2 * jdist + 1e-4, (bdist, jdist)
    assert fdist <= 0.1 * bdist.max() + 1e-6, (fdist, bdist)
    assert tr["bf16_metric_dtype"] == tr["f32_metric_dtype"] == {float}


def test_bf16_nmt_labels_stay_integer_and_the_bigru_gets_f32_biases():
    """Under ``compute_dtype=torch.bfloat16`` the feed's id slots stay
    integer (``cast_floats`` leaves them), and the BiGRU reaches
    ``bigru_seq`` with bf16 x and weights and f32 biases, as JAX's
    ``bigru_fused`` hands them to its kernel."""
    topo, cost_name, params, types, batch, feeding = S.nmt_bf16_setup()
    feed = cast_floats(DataFeeder(types, feeding, device="cpu")(batch), BF)
    assert all(not v.data.is_floating_point() for v in feed.values())
    seen = []
    plain = GK.bigru_seq

    def spy(x, mask, *args):
        seen.append([x.dtype] + [a.dtype for a in args])
        return plain(x, mask, *args)

    GK.bigru_seq = spy
    try:
        p = {n: torch.from_numpy(v) for n, v in params.items()}
        S.topology_grads(topo, cost_name, p, feed, BF)
    finally:
        GK.bigru_seq = plain
    f32 = torch.float32
    assert seen == [[BF, BF, f32, BF, BF, BF, f32, BF, BF, BF, BF]]


if __name__ == "__main__":
    # chip_smoke.py's NMT_BF16_WITNESS_JAX, from the root of a checkout:
    #   JAX_PLATFORMS=cpu PYTHONPATH=.:tests python tests/test_torch_nmt_bf16.py
    errs = jax_errors()
    print("NMT_BF16_WITNESS_JAX = {")
    for n, r in sorted(errs["jax"].items()):
        print(f"    {n!r}: {r:.4g},")
    print("}")
    print("# the port's bf16 step on the CPU, worst (error, 2 x JAX's):",
          max((r, 2 * errs["jax"][n]) for n, r in errs["port"].items()))
