"""Every kernel launch of the port runs on the card its tensors lie on.

Each wrapper under ``paddle_tpu_torch/ops/kernels/`` launches through
``Kernel.launch_on`` (``_build.py``): the tensors' card's current stream,
and that card current during the launch.  The scan below holds every
module to it; the fake-card test holds the helper to what it does on one
card (no guard, the same arguments) and on another (a guard)."""

import re
from pathlib import Path

import pytest
import torch

from paddle_tpu_torch.ops.kernels import _build

KERNELS = Path(_build.__file__).resolve().parent


def _modules():
    return sorted(p for p in KERNELS.glob("*.py") if p.name != "_build.py")


@pytest.mark.parametrize("path", _modules(), ids=lambda p: p.name)
def test_no_wrapper_launches_outside_the_guarded_helper(path):
    """No module takes a stream without naming its card
    (``current_stream()``) or calls ``Kernel.launch`` itself."""
    text = path.read_text()
    assert not re.search(r"current_stream\(\s*\)", text), path.name
    assert not re.search(r"\.launch\(", text), path.name


def test_the_scan_sees_every_kernel_module():
    names = {p.stem for p in _modules()}
    assert {"brgemm", "channel_stats", "conv", "ctc", "embedding",
            "flash_attention", "gru", "lstm", "paged_attention",
            "softmax_xent", "update"} <= names


class _Cards:
    """Fake cards: a current index, a raw stream a card, and the guard."""

    def __init__(self, monkeypatch, current):
        self.current, self.entered = current, []
        # (a CPU build of torch has neither entry: raising=False)
        monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                            lambda index: 1000 + index, raising=False)
        monkeypatch.setattr(torch._C, "_cuda_getDevice",
                            lambda: self.current, raising=False)
        monkeypatch.setattr(torch.cuda, "device", self.device)

    def device(self, index):
        cards = self

        class Guard:
            def __enter__(self):
                cards.entered.append(index)
                cards.previous, cards.current = cards.current, index

            def __exit__(self, *exc):
                cards.current = cards.previous

        return Guard()


def _kernel(calls, cards):
    k = _build.Kernel("none", "none", [])

    def fn(*args):
        calls.append((args, cards.current))
        return 0

    k._fn = fn
    return k


@pytest.mark.parametrize("current,index", [(0, 0), (1, 1), (0, 1), (2, 0)])
def test_launch_on_runs_on_the_tensors_card(monkeypatch, current, index):
    cards = _Cards(monkeypatch, current)
    calls = []
    k = _kernel(calls, cards)
    k.launch_on(index, 11, 22)
    # the card's own stream last, the launch with that card current, and
    # a guard only where another card was current
    assert calls == [((11, 22, 1000 + index), index)]
    assert cards.entered == ([] if current == index else [index])
    assert cards.current == current and k.launches == 1


def test_a_refused_launch_raises_and_counts_nothing(monkeypatch):
    cards = _Cards(monkeypatch, 0)
    k = _build.Kernel("none", "none", [])
    k._fn = lambda *args: 9
    k._err = lambda code: b"refused"
    with pytest.raises(RuntimeError, match="CUDA error 9"):
        k.launch_on(1, 5)
    assert k.launches == 0 and cards.current == 0
