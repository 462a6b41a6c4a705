"""The OCR CRNN slice as a whole: the port's v2 flow (``models.ocr_crnn``:
``img_conv_bn`` x2 -> ``cols_to_seq`` -> ``layer.bilstm`` -> softmax ``fc``
-> ``extras.ctc``; ``trainer.SGD`` with Adam; ``paddle.infer`` and
``ocr_crnn.ctc_decode``) against the JAX package's, at a small width
(16 x 48 images -> T = 12 columns of E = 128, ``rnn_size`` 8, 6 classes)
from the same carried parameters and the same synthetic samples.  The JAX
trainer runs as the repo's tests run it (8 virtual CPU devices); its
BiLSTM is the unfused composition with ``lstm_seq`` in interpret mode,
its CTC the ``ops/ctc.py`` scan.  The port's CTC is the fused Function's
twin (the hand-derived gradient), so the gradients agree to round-off.

Tolerances (f32 round-off of another summation order and of the hand
CTC gradient against autodiff of the scan; measured on the CPU in
brackets): the first step's cost rtol 2e-6 [0] and every gradient leaf
atol 2e-5 relative to the leaf's largest entry [4.3e-6]; BN moving
statistics atol 1e-5 [9.8e-7]; over 5 Adam steps with bf16 moments,
per-step costs rtol 2e-6 [2.1e-7], parameters atol 5e-5 [6.5e-6];
``infer`` probabilities atol 2e-6 [3.9e-7]; decoded ids equal."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.config.topology import Topology as JTopology
from paddle_tpu.layers.base import reset_name_counters as jax_reset
from paddle_tpu.models import ocr_crnn as jcrnn
from paddle_tpu.reader.feeder import DataFeeder as JFeeder
from paddle_tpu_torch.config.topology import Topology as TTopology
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.layers.base import reset_name_counters
from paddle_tpu_torch.models import ocr_crnn as tcrnn
from paddle_tpu_torch.reader.feeder import DataFeeder as TFeeder

H, W, CLASSES, RNN, BATCH = 16, 48, 6, 8, 8
JD = importlib.import_module("paddle_tpu.layers.data_type")


@pytest.fixture(autouse=True)
def _fresh_names():
    reset_name_counters()
    jax_reset()
    yield


def crnn(mod, **kw):
    cfg = dict(image_height=H, image_width=W, num_classes=CLASSES,
               rnn_size=RNN)
    cfg.update(kw)
    return mod.crnn_ctc_cost(**cfg)


def samples(n, seed):
    return list(tcrnn.synthetic_ocr_reader(
        n_samples=n, image_height=H, image_width=W, num_classes=CLASSES,
        max_label_len=3, seed=seed)())


def carried_params(jtopo, seed=0):
    """The JAX package's initial parameters as numpy, the biases (the
    BiLSTM's gate biases and peepholes among them) made nonzero so every
    term is exercised."""
    params = jpaddle.parameters.create(jtopo)
    out = {n: np.asarray(params[n]) for n in params.names()}
    rng = np.random.default_rng(seed)
    for n in out:
        if n.endswith(".wbias"):
            out[n] = (0.1 * rng.normal(size=out[n].shape)).astype(np.float32)
    return out


def feeders(jtopo, ttopo):
    jtypes = {n: JD.InputType(dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
                              kind=l.attrs["data_type"])
              for n, l in jtopo.data_layers().items()}
    ttypes = {n: tpaddle.data_type.InputType(
        dim=l.attrs["dim"], seq_type=l.attrs["seq_type"],
        kind=l.attrs["data_type"]) for n, l in ttopo.data_layers().items()}
    return JFeeder(jtypes), TFeeder(ttypes, device="cpu")


def test_topology_equals_the_jax_one():
    jcost, jprobs, jorder = crnn(jcrnn)
    tcost, tprobs, torder = crnn(tcrnn)
    jtopo, ttopo = JTopology([jcost, jprobs]), TTopology([tcost, tprobs])
    assert torder == jorder
    assert ttopo.serialize() == jtopo.serialize()
    assert ttopo.digest() == jtopo.digest()
    assert [n.name for n in ttopo.nodes] == [n.name for n in jtopo.nodes]
    assert ([(s.name, s.shape) for s in ttopo.param_specs()]
            == [(s.name, s.shape) for s in jtopo.param_specs()])
    assert ([(s.name, s.shape, s.init_value) for s in ttopo.state_specs()]
            == [(s.name, s.shape, s.init_value)
                for s in jtopo.state_specs()])


def test_full_width_census_equals_the_jax_one():
    """``bench_crnn``'s configuration (32 x 96, 26 classes, rnn_size 64),
    built in both packages without computing anything."""
    jcost, jprobs, _ = jcrnn.crnn_ctc_cost(num_classes=26)
    reset_name_counters()
    tcost, tprobs, _ = tcrnn.crnn_ctc_cost(num_classes=26)
    jtopo, ttopo = JTopology([jcost, jprobs]), TTopology([tcost, tprobs])
    census = [(s.name, s.shape) for s in ttopo.param_specs()]
    assert census == [(s.name, s.shape) for s in jtopo.param_specs()]
    sizes = dict((n, int(np.prod(shape))) for n, shape in census)
    # conv 3x3 1->16 and 16->32 with their BN scale and shift; per BiLSTM
    # direction the [256, 256] projection and bias, the [64, 256]
    # recurrent weight and the 7 x 64 bias bundle; the [128, 27] head
    assert sorted(sizes.values()) == sorted(
        [144, 16, 16, 4608, 32, 32] + [65536, 256, 16384, 448] * 2
        + [3456, 27])
    assert sum(sizes.values()) == 173_579
    assert ttopo.digest() == jtopo.digest()


@pytest.mark.parametrize("seed", [0, 123])
def test_synthetic_reader_samples_equal(seed):
    kw = dict(n_samples=20, num_classes=8, seed=seed)
    got = list(tcrnn.synthetic_ocr_reader(**kw)())
    want = list(jcrnn.synthetic_ocr_reader(**kw)())
    assert len(got) == len(want) == 20
    for (gi, gl), (wi, wl) in zip(got, want):
        assert np.array_equal(gi, wi) and gl == wl


def test_first_step_cost_and_gradients_match_jax():
    jcost, jprobs, _ = crnn(jcrnn)
    tcost, tprobs, _ = crnn(tcrnn)
    jtopo, ttopo = JTopology(jcost), TTopology(tcost)
    carried = carried_params(jtopo)
    batch = samples(4, 5)
    jfeeder, tfeeder = feeders(jtopo, ttopo)
    jfeed, tfeed = jfeeder(batch), tfeeder(batch)
    assert tfeed["label"].max_len == 16 and tfeed["image"].shape == (4, H * W)
    jstates = {k: jnp.asarray(v) for k, v in jtopo.init_states().items()}

    def jloss(p):
        values, states = jtopo.forward(p, jstates, jfeed, True,
                                       jax.random.key(0))
        return values[jcost.name], states

    jparams = {n: jnp.asarray(v) for n, v in carried.items()}
    (jc, jst), jg = jax.value_and_grad(jloss, has_aux=True)(jparams)
    params = {n: torch.tensor(v).requires_grad_() for n, v in carried.items()}
    states = ttopo.init_states("cpu")
    values, tst = ttopo.forward(params, states, tfeed, True)
    tc = values[tcost.name]
    tg = torch.autograd.grad(tc, list(params.values()))
    np.testing.assert_allclose(tc.item(), float(jc), rtol=2e-6)
    for (name, _), g in zip(params.items(), tg):
        want = np.asarray(jg[name])
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(g.numpy(), want, atol=2e-5 * scale,
                                   rtol=0, err_msg=name)
    for k, v in tst.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(jst[k]),
                                   atol=1e-5, rtol=0, err_msg=k)


def test_adam_trajectory_infer_and_decode_match_the_jax_package():
    jcost, jprobs, jorder = crnn(jcrnn)
    tcost, tprobs, torder = crnn(tcrnn)
    jtopo = JTopology(jcost)
    carried = carried_params(jtopo)
    jparams = jpaddle.parameters.create(jtopo)
    for n, v in carried.items():
        jparams[n] = v
    jtrainer = jpaddle.trainer.SGD(
        cost=jcost, parameters=jparams,
        update_equation=jpaddle.optimizer.Adam(learning_rate=1e-3,
                                               moment_dtype=jnp.bfloat16))
    ttrainer = tpaddle.trainer.SGD(
        cost=tcost, parameters=Parameters.from_numpy(carried),
        update_equation=tpaddle.optimizer.Adam(learning_rate=1e-3,
                                               moment_dtype=torch.bfloat16),
        device="cpu")
    train = samples(5 * BATCH, 2)
    got = {"jax": [], "torch": []}

    def handler(key):
        def h(e):
            if type(e).__name__ == "EndIteration":
                got[key].append(e.cost)
        return h

    feeding = {n: i for i, n in enumerate(jorder)}
    jtrainer.train(reader=jpaddle.reader.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("jax"),
                   feeding=feeding)
    ttrainer.train(reader=tpaddle.batch(lambda: iter(train), BATCH),
                   num_passes=1, event_handler=handler("torch"),
                   feeding=feeding)
    assert len(got["torch"]) == len(got["jax"]) == 5
    np.testing.assert_allclose(got["torch"], got["jax"], rtol=2e-6)
    for name in carried:
        np.testing.assert_allclose(ttrainer.parameters[name],
                                   jtrainer.parameters[name], atol=5e-5,
                                   rtol=0, err_msg=name)
        assert not np.array_equal(ttrainer.parameters[name], carried[name])
    for name, v in ttrainer.states.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jtrainer.states[name]),
                                   atol=1e-5, rtol=0, err_msg=name)

    # paddle.infer on the trained parameters (BN at its initial moving
    # statistics in both, as the parameters hold none), then the decode
    fresh = samples(6, 123)
    inputs = [(img, lab) for img, lab in fresh]
    jout = jpaddle.infer(output_layer=jprobs, parameters=jtrainer.parameters,
                         input=inputs, feeding=feeding)
    tout = tpaddle.infer(output_layer=tprobs, parameters=ttrainer.parameters,
                         input=inputs, feeding=feeding, device="cpu")
    assert len(tout) == len(jout) == 6
    for g, w in zip(tout, jout):
        assert g.shape == (W // 4, CLASSES + 1)
        np.testing.assert_allclose(g, np.asarray(w), atol=2e-6, rtol=0)
    lp = np.log(np.stack([np.asarray(w) for w in jout]) + 1e-9)
    lens = np.full(6, W // 4, np.int32)
    jids, jlen = jcrnn.ctc_decode(jnp.asarray(lp), jnp.asarray(lens),
                                  blank=CLASSES)
    tids, tlen = tcrnn.ctc_decode(torch.tensor(lp), torch.tensor(lens),
                                  blank=CLASSES)
    assert np.array_equal(tids.numpy(), np.asarray(jids))
    assert np.array_equal(tlen.numpy(), np.asarray(jlen))


def test_inference_strict_refuses_missing_parameters():
    tcost, tprobs, _ = crnn(tcrnn)
    full = tpaddle.parameters.create(TTopology(tprobs))
    partial = Parameters.from_numpy(
        {n: full[n] for n in full.names() if "bilstm_bw" not in n})
    with pytest.raises(ValueError, match="crnn_bilstm_bw"):
        tpaddle.inference.Inference(tprobs, partial, strict=True,
                                    device="cpu")
    inf = tpaddle.inference.Inference(tprobs, full, strict=True, device="cpu")
    out = inf.infer([(np.zeros(H * W, np.float32), [1])],
                    feeding={"image": 0, "label": 1})
    assert len(out) == 1 and out[0].shape == (W // 4, CLASSES + 1)
    np.testing.assert_allclose(out[0].sum(-1), 1.0, atol=1e-5)
