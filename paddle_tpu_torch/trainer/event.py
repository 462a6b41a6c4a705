"""Training events — the port of ``paddle_tpu/trainer/event.py`` (v2
``paddle.event``): objects handed to the user's event_handler during
``SGD.train`` and returned by ``SGD.test``."""

from __future__ import annotations

import dataclasses


class WithMetric:
    def __init__(self, evaluator):
        self.evaluator = evaluator  # dict metric_name -> value

    @property
    def metrics(self) -> dict:
        return dict(self.evaluator or {})


@dataclasses.dataclass
class BeginPass:
    pass_id: int


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None):
        self.pass_id = pass_id
        WithMetric.__init__(self, evaluator)


@dataclasses.dataclass
class BeginIteration:
    pass_id: int
    batch_id: int


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        WithMetric.__init__(self, evaluator)


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost: float = 0.0):
        self.cost = cost
        WithMetric.__init__(self, evaluator)
