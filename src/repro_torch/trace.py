"""The port's in-process recorder of spans and events.

``span(name, **attrs)`` times a block of host code; ``event(name,
**attrs)`` marks an instant. Each record holds its name, its start and
end (``time.perf_counter_ns()``, the clock of ``time.perf_counter``),
its attributes, its own id and the id of the span open around it (its
parent), and goes into a ring of fixed length: ``records()`` returns
the ring, oldest first, ``dropped()`` counts the records that fell off
its far end, ``clear()`` empties it. A span is appended when it closes,
so a parent follows its children in the ring.

While a ``torch.profiler`` session records, a span also enters
``torch.profiler.record_function(name)``, which puts it in the
profiler's trace on the trace's own clock. Without one, a span costs a
``perf_counter_ns`` pair and one append. The recorder never
synchronises the card, records nothing inside ``paused()`` (the trainer
pauses it while it captures a CUDA graph) and works alike on the CPU.

``readback(site, x)`` is the one way the trainer's federation rounds
read a device value on the host: ``x`` copied to the CPU, counted as a
``huscf.readback`` event that names its ``site``.

The trainer's records (``core.huscf``): ``huscf.init.cut_search``,
``huscf.init.state``, ``huscf.graphs.capture`` (``steps``,
``layout_copies``: ``models.nn.layout_copies`` made by one captured
step), ``huscf.train_steps`` (``steps``) over ``.adopt``, ``.launch``
(on the CPU, where the steps run eagerly, with ``layout_copies`` of one
step) and ``.readback``, the step's device phases
``huscf.step.grad_d``, ``.adam_d``, ``.grad_g`` and ``.adam_g`` (events
carrying ``ms``), ``huscf.federate`` (``mode``) over ``.cluster``,
``.kld`` and ``.aggregate`` (``net``, ``plan_built``), and
``huscf.readback`` (``site``).
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Any, Dict, List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _profiler

RING = 1 << 16
READBACK = "huscf.readback"


class Record(NamedTuple):
    name: str
    t0: int                  # perf_counter_ns at the start
    t1: int                  # and at the end (t0 for an event)
    id: int
    parent: Optional[int]    # id of the span open around it
    attrs: Dict[str, Any]

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def _profiling() -> bool:
    # torch's own flag for a profiler that records, set by
    # torch.profiler.profile on start and stop
    return getattr(_profiler, "_is_profiler_enabled", False)


class Recorder:
    """A ring of ``size`` records and the stack of open spans."""

    def __init__(self, size: int = RING):
        self._ring: collections.deque = collections.deque(maxlen=size)
        self._open: List[int] = []
        self._next = 0
        self._dropped = 0
        self._paused = 0

    def _append(self, rec: Record) -> None:
        if len(self._ring) == self._ring.maxlen:
            self._dropped += 1
        self._ring.append(rec)

    def _id(self) -> int:
        self._next += 1
        return self._next

    def span(self, name: str, **attrs) -> "Span":
        return Span(self, name, attrs)

    def event(self, name: str, **attrs) -> None:
        if self._paused:
            return
        now = time.perf_counter_ns()
        self._append(Record(name, now, now, self._id(),
                            self._open[-1] if self._open else None, attrs))

    def records(self) -> List[Record]:
        return list(self._ring)

    def dropped(self) -> int:
        return self._dropped

    def clear(self) -> None:
        self._ring.clear()
        self._dropped = 0

    @contextlib.contextmanager
    def paused(self):
        """Record nothing inside (a CUDA graph's capture)."""
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1


class Span:
    """One timed block: ``seconds`` holds its duration once it closed
    (also while the recorder is paused, when nothing is recorded)."""
    __slots__ = ("_rec", "name", "attrs", "t0", "t1", "id", "_fn")

    def __init__(self, rec: Recorder, name: str, attrs: Dict[str, Any]):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.id, self._fn = None, None

    def __enter__(self) -> "Span":
        rec = self._rec
        if not rec._paused:
            self.id = rec._id()
            rec._open.append(self.id)
            if _profiling():
                self._fn = torch.profiler.record_function(self.name)
                self._fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter_ns()
        if self.id is None:
            return
        rec = self._rec
        if self._fn is not None:
            self._fn.__exit__(*exc)
        rec._open.pop()
        rec._append(Record(self.name, self.t0, self.t1, self.id,
                           rec._open[-1] if rec._open else None, self.attrs))

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


RECORDER = Recorder()


def span(name: str, **attrs) -> Span:
    return RECORDER.span(name, **attrs)


def event(name: str, **attrs) -> None:
    RECORDER.event(name, **attrs)


def records() -> List[Record]:
    return RECORDER.records()


def dropped() -> int:
    return RECORDER.dropped()


def clear() -> None:
    RECORDER.clear()


def paused():
    return RECORDER.paused()


def readback(site: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` on the host, one ``huscf.readback`` event at ``site``."""
    RECORDER.event(READBACK, site=site)
    return x.cpu()
