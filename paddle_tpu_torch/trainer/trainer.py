"""The v2 SGD trainer — the port of ``paddle_tpu/trainer/trainer.py``'s
``SGD.__init__`` / ``train`` / ``test`` (≅ ``python/paddle/v2/trainer.py``:
reader -> DataFeeder -> forward/backward -> update -> events).

It runs on ``cuda:0`` unless the caller passes ``device="cpu"``.  The
metrics that cost layers attach (``classification_cost``'s
``classification_error_evaluator``) ride on ``EndIteration`` (the batch's),
``EndPass`` and ``TestResult`` (the mean over batches).  The options of
the JAX trainer that this port does not take yet (mesh, ZeRO,
checkpoints, elastic, prefetch, declared evaluators, telemetry) are not
accepted: passing one raises ``TypeError``."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from paddle_tpu_torch.config.topology import Topology
from paddle_tpu_torch.core import logger as log
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.lod import SequenceBatch
from paddle_tpu_torch.core.parameters import Parameters
from paddle_tpu_torch.core.place import resolve_device
from paddle_tpu_torch.layers.base import LayerOutput
from paddle_tpu_torch.layers.data_type import InputType
from paddle_tpu_torch.reader.feeder import DataFeeder
from paddle_tpu_torch.trainer import event as v2_event
from paddle_tpu_torch.trainer.step import build_eval_step, build_train_step


class SGD:
    """v2 ``paddle.trainer.SGD``.

    :param cost: the cost LayerOutput (or list) to minimize.
    :param parameters: ``paddle.parameters.create(...)`` or
        ``Parameters.from_numpy(...)``; BN running statistics found in it
        by name are loaded as the initial states.
    :param update_equation: an optimizer of ``paddle_tpu_torch.optimizer``.
    :param extra_layers: additional layers to keep in the topology.
    :param compute_dtype: None or torch.float32, or torch.bfloat16:
        forward and backward in bf16 on f32 master parameters, optimizer
        state and BN statistics (``trainer/step.py``); ``test`` and
        ``step_f64`` stay in their own dtypes, as the JAX trainer's eval
        step does.
    :param device: where to train; default ``cuda:0`` (raises without a
        card), ``"cpu"`` only when asked for.
    """

    def __init__(self, cost, parameters: Parameters, update_equation,
                 extra_layers=None, compute_dtype=None, device=None):
        self.device = resolve_device(device)
        self.topology = Topology(
            [cost] if isinstance(cost, LayerOutput) else list(cost),
            extra_layers=extra_layers)
        self.parameters = parameters
        for spec in self.topology.param_specs():
            self.parameters.add(spec)
        self.parameters.init_missing()
        self.optimizer = update_equation
        self.states = self.topology.init_states(self.device)
        for sname in self.states:
            if sname in self.parameters:
                self.states[sname] = torch.as_tensor(
                    self.parameters[sname], device=self.device)
        self._specs = {s.name: s for s in self.topology.param_specs()}
        self._trainable = [n for n, s in self._specs.items()
                           if not s.is_static]
        self._opt_state = None
        self._train_step = build_train_step(self.topology, self.optimizer,
                                            compute_dtype)
        self._eval_step = build_eval_step(self.topology)

    def _params_dict(self, copy: bool = False) -> dict[str, torch.Tensor]:
        """The parameters on the trainer's device; ``copy``: always fresh
        tensors, which a train step may update in place (it donates its
        inputs, as the JAX package's does)."""
        return {n: t.to(self.device, copy=copy)
                for n, t in self.parameters.as_dict().items()}

    def _feeder(self, feeding, device=None) -> DataFeeder:
        types = {name: InputType(dim=node.attrs["dim"],
                                 seq_type=node.attrs["seq_type"],
                                 kind=node.attrs["data_type"])
                 for name, node in self.topology.data_layers().items()}
        return DataFeeder(types, feeding, device=device or self.device)

    def step_f64(self, data_batch, feeding=None):
        """One first train step (fresh optimizer state) in float64 on the
        CPU from the current parameters and states, which stay as they
        are: the double-precision witness an f32 step, on the CPU's plain
        twins or the card's kernels, is held against.  It takes the seed
        the next train step will take (``core/rng.peek_seed()``) without
        consuming it, so dropout draws the masks a CPU step draws (masks
        are drawn in f32 whatever the dtype).  Returns (params, states,
        cost): float64 numpy arrays by name and a float."""
        cpu = torch.device("cpu")

        def wide(t):
            if isinstance(t, SequenceBatch):
                return SequenceBatch(wide(t.data), t.length)
            t = torch.as_tensor(t, device=cpu)
            return (t.to(torch.float64, copy=True) if t.is_floating_point()
                    else t)

        params = {n: wide(t) for n, t in self.parameters.as_dict().items()}
        states = {k: wide(v) for k, v in self.states.items()}
        feed = {k: wide(v) for k, v in
                self._feeder(feeding, cpu)(data_batch).items()}
        opt_state = self.optimizer.init(
            {k: params[k] for k in self._trainable}, self._specs)
        params, _, states, cost, _ = build_train_step(
            self.topology, self.optimizer)(params, opt_state, states, feed,
                                           rng.peek_seed())
        return ({n: t.numpy() for n, t in params.items()},
                {k: v.numpy() for k, v in states.items()}, float(cost))

    def train(self, reader, num_passes: int = 1,
              event_handler: Callable | None = None, feeding=None):
        """``reader`` yields BATCHES (lists of sample tuples), the output of
        ``paddle.batch(...)`` as in v2.  Events per pass: BeginPass, then
        per batch BeginIteration and EndIteration (with the batch cost as
        a float and the batch's metrics), then EndPass (the metrics'
        mean over the pass)."""
        handler = event_handler or _default_event_handler
        feeder = self._feeder(feeding)
        # the step updates these in place: the Parameters keep their own
        params = self._params_dict(copy=True)
        states = self.states
        opt_state = self._opt_state
        if opt_state is None:
            opt_state = self.optimizer.init(
                {k: params[k] for k in self._trainable}, self._specs)
        for pass_id in range(num_passes):
            handler(v2_event.BeginPass(pass_id))
            batch_metrics = []
            for batch_id, data_batch in enumerate(reader()):
                handler(v2_event.BeginIteration(pass_id, batch_id))
                feed = feeder(data_batch)
                params, opt_state, states, cost, metrics = self._train_step(
                    params, opt_state, states, feed, rng.next_seed())
                batch_metrics.append(metrics)
                handler(v2_event.EndIteration(pass_id, batch_id,
                                              float(cost), metrics))
            # written back every pass, so a handler or test() sees them;
            # copies, which the next pass's steps leave as they are
            self.parameters.update_from(
                {n: t.clone() for n, t in params.items()})
            self.states = states
            self._opt_state = opt_state
            handler(v2_event.EndPass(pass_id, _mean_dicts(batch_metrics)))

    def test(self, reader, feeding=None) -> v2_event.TestResult:
        """Forward-only over a reader of batches (test mode: nothing is
        drawn); the mean batch cost and the mean of each metric."""
        feeder = self._feeder(feeding)
        params = self._params_dict()
        costs, metrics = [], []
        for batch in reader():
            _, cost, m = self._eval_step(params, self.states, feeder(batch))
            costs.append(float(cost))
            metrics.append(m)
        enforce(len(costs) > 0, "test reader yielded no batches")
        return v2_event.TestResult(_mean_dicts(metrics),
                                   float(np.mean(costs)))


def _mean_dicts(dicts: list[dict]) -> dict:
    if not dicts:
        return {}
    return {k: float(np.mean([d[k] for d in dicts if k in d]))
            for k in dicts[0]}


def _default_event_handler(e) -> None:
    if isinstance(e, v2_event.EndIteration) and e.batch_id % 100 == 0:
        log.info("Pass %d, Batch %d, Cost %f", e.pass_id, e.batch_id, e.cost)
    elif isinstance(e, v2_event.EndPass):
        log.info("Pass %d done", e.pass_id)
