"""Spans and counters inside the program, recorded while torch's profiler
runs.

* ``span(name, device=None, **attrs)``: a context manager around one
  layer's work;
* ``count(name, k=1)``: bumps a counter by a host int, or by a 0-d
  integer tensor that is kept unread until the snapshot;
* ``snapshot(clear=True)``: the spans and counters of the last profiled
  stretch (a :class:`Snapshot`), cleared unless ``clear=False``;
* ``summary(snap)``: per span name, its count, host ms, device ms and
  self device ms.

Recording follows ``torch.profiler``: an operator who takes a trace gets
the spans with it, and there is no other switch. While no profiler runs,
``span`` returns one shared no-op and ``count`` returns at once, after one
check of whether the profiler is enabled: no span is made, no range
opened and no event recorded.

While it runs, a span keeps its name, its parent (the span open on the
same thread when it began, the one that caused it), its attributes and
its host start and end in epoch nanoseconds (``time.time_ns()``, the
clock of the profiler's events). It also opens a ``record_function``
range named ``repro_torch.<name>``, so the profiler's own trace shows it
on the device trace's clock. On a CUDA ``device`` it records a timing
event on the current stream at each end; the device interval between the
two, idle time inside the span included, is read by ``snapshot()``,
which synchronizes once. On the CPU the device interval is None.

Attributes are host ints or floats, or short names, that the caller holds
already: the recorder reads no device value and adds no sync. A count by a
device scalar (a length a kernel wrote, say) is kept as the tensor;
``snapshot()`` reads all of them in one copy a device, after its
synchronize. One recorder serves the process, as the profiler does, and
it holds one profiled stretch: a span or count that finds the profiler
off marks the stretch closed, and the next one made while it runs drops
what the last stretch left. So a
reader of a finished profile reads that profile's spans alone, and the
spans of a long-running process that is profiled now and then do not pile
up. (Two profiles with no span or count between them, as a repeating
``torch.profiler.schedule`` with neither wait nor warm-up steps makes,
count as one stretch.)
"""
from __future__ import annotations

import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional, Union

import torch
from torch._C._autograd import _profiler_enabled
from torch.autograd.profiler import record_function

PREFIX = "repro_torch."  # the ranges' names in the profiler's trace


@dataclasses.dataclass
class Span:
    """One recorded span. ``parent`` is the ``id`` of the span open on the
    same thread when this one began (None at the top)."""

    id: int
    parent: Optional[int]
    name: str
    attrs: Dict[str, Union[int, float, str]]
    start_ns: int  # host, epoch nanoseconds
    end_ns: int
    device_ms: Optional[float] = None  # None on the CPU
    # (device, start event, end event) until ``snapshot`` reads them
    _events: Optional[tuple] = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-6


@dataclasses.dataclass
class Snapshot:
    spans: List[Span]  # closed spans, in the order they began
    counters: Dict[str, int]

    def named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name]


class _NoSpan:
    """The span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _NoSpan()


class _OpenSpan:
    __slots__ = ("_rec", "_span", "_range", "_stream")

    def __init__(self, rec: "Recorder", name: str, device, attrs):
        self._rec = rec
        self._span = Span(next(rec._ids), None, name, attrs, 0, 0)
        self._range = record_function(PREFIX + name)
        cuda = device is not None and torch.device(device).type == "cuda"
        self._stream = torch.cuda.current_stream(device) if cuda else None

    def __enter__(self) -> Span:
        stack = self._rec._stack()
        self._span.parent = stack[-1].id if stack else None
        stack.append(self._span)
        self._range.__enter__()
        if self._stream is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(self._stream)
            self._span._events = (self._stream.device, start)
        self._span.start_ns = time.time_ns()
        return self._span

    def __exit__(self, *exc):
        span = self._span
        span.end_ns = time.time_ns()
        if self._stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self._stream)
            span._events += (end,)
        self._range.__exit__(*exc)
        self._rec._stack().pop()
        with self._rec._lock:
            self._rec._done.append(span)
        return False


class Recorder:
    """Closed spans and counters, kept in memory until ``snapshot``."""

    def __init__(self):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self._done: List[Span] = []
        self._counters: Dict[str, int] = {}
        # counts by tensors, not read yet: (name, 0-d tensor)
        self._pending: List[tuple] = []
        self._closed = False  # the profiler was seen off since last span

    def _open(self) -> None:
        """Under the lock: drop the last stretch if it was closed."""
        if self._closed:
            self._done, self._counters, self._pending = [], {}, []
            self._closed = False

    def _stack(self) -> List[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str, device=None, **attrs):
        """A span of ``name`` over the ``with`` block; ``device`` is where
        its work runs (CUDA adds the device interval)."""
        if not _profiler_enabled():
            self._closed = True
            return _NOOP
        if self._closed:
            with self._lock:
                self._open()
        return _OpenSpan(self, name, device, attrs)

    def count(self, name: str, k: Union[int, torch.Tensor] = 1) -> None:
        """Add ``k`` to the counter ``name``: a host int, or a 0-d integer
        tensor, kept as it is and read by ``snapshot``."""
        if not _profiler_enabled():
            self._closed = True
            return
        with self._lock:
            self._open()
            if isinstance(k, torch.Tensor):
                self._counters.setdefault(name, 0)
                self._pending.append((name, k))
            else:
                self._counters[name] = self._counters.get(name, 0) + k

    def _read_pending(self) -> None:
        """Under the lock, the devices synchronized: add the tensors'
        values to their counters, one copy a device."""
        by_dev: Dict[torch.device, List[tuple]] = {}
        for name, t in self._pending:
            by_dev.setdefault(t.device, []).append((name, t))
        for items in by_dev.values():
            vals = torch.stack([t.reshape(()).to(torch.int64)
                                for _, t in items]).tolist()
            for (name, _), v in zip(items, vals):
                self._counters[name] += v
        self._pending = []

    def snapshot(self, clear: bool = True) -> Snapshot:
        """What was recorded, device intervals and counts by tensors read
        (one synchronize of each CUDA device that they are on)."""
        with self._lock:
            timed = [s for s in self._done if s._events is not None]
            for dev in ({s._events[0] for s in timed}
                        | {t.device for _, t in self._pending
                           if t.device.type == "cuda"}):
                torch.cuda.synchronize(dev)
            self._read_pending()
            done, counters = self._done, dict(self._counters)
            if clear:
                self._done, self._counters = [], {}
            for s in timed:
                s.device_ms = s._events[1].elapsed_time(s._events[2])
                s._events = None
        return Snapshot(sorted(done, key=lambda s: s.id), counters)


_RECORDER = Recorder()
span = _RECORDER.span
count = _RECORDER.count
snapshot = _RECORDER.snapshot


def summary(snap: Snapshot) -> Dict[str, Dict[str, Optional[float]]]:
    """Per span name: ``count``, ``host_ms``, ``device_ms`` and
    ``self_device_ms`` (device ms less that of its child spans), the
    device fields None on the CPU."""
    child_ms: Dict[int, float] = {}
    for s in snap.spans:
        if s.parent is not None and s.device_ms is not None:
            child_ms[s.parent] = child_ms.get(s.parent, 0.0) + s.device_ms
    out: Dict[str, Dict[str, Optional[float]]] = {}
    for s in snap.spans:
        row = out.setdefault(s.name, {"count": 0, "host_ms": 0.0,
                                      "device_ms": None,
                                      "self_device_ms": None})
        row["count"] += 1
        row["host_ms"] += s.host_ms
        if s.device_ms is not None:
            row["device_ms"] = (row["device_ms"] or 0.0) + s.device_ms
            row["self_device_ms"] = ((row["self_device_ms"] or 0.0)
                                     + s.device_ms - child_ms.get(s.id, 0.0))
    return out
