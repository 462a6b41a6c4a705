"""Scratch kept on the card between launches for the kernels that finish
in a launch's last block (``channel_stats``, the f32 paged decode): an f32
buffer of partials and a row of tickets (int32 counters, zeroed when
allocated; each launch leaves the ones it drew at 0 again).  One set per
(device, stream), so two streams never share one, grown when a larger
call comes; the kernels of one stream run in turn, so they share it."""

from __future__ import annotations

import torch


class Kept:
    """The partials (f32) and the tickets of one device and stream."""

    __slots__ = ("part", "tickets", "part_ptr", "tickets_ptr", "_tensors")

    def __init__(self, device, part, tickets):
        buf = torch.empty(part, dtype=torch.float32, device=device)
        tick = torch.zeros(tickets, dtype=torch.int32, device=device)
        self.part, self.tickets = part, tickets
        self.part_ptr, self.tickets_ptr = buf.data_ptr(), tick.data_ptr()
        self._tensors = (buf, tick)


#: {(device index, raw stream): Kept}
KEPT: dict = {}


def keep(device, stream, part: int, tickets: int) -> Kept:
    """The kept scratch of (device, stream) with at least ``part`` floats
    and ``tickets`` tickets; a larger one is allocated on that stream (the
    current one), the old one going back to the allocator behind the
    launches queued on it."""
    old = KEPT.get((device.index, stream))
    if old is not None and old.part >= part and old.tickets >= tickets:
        return old
    if old is not None:
        part, tickets = max(part, old.part), max(tickets, old.tickets)
    kept = KEPT[(device.index, stream)] = Kept(device, part, tickets)
    return kept


def forget() -> None:
    """Drop every kept set: the next call on each stream allocates anew,
    the tickets zeroed (after a launch that did not leave its tickets at
    0, or to give the memory back)."""
    KEPT.clear()
