"""The traced run: spans from the benchmark's own files, and the reduction
of ``torch.profiler``'s trace to what the per-layer readers and the
result's ``breakdown`` need.

Spans are ``record_function`` ranges named ``portbench.<what>``: one
around the whole window and one around each call into the program.
From the trace come the device's operations (kernels, copies, sets)
inside the window span, their busy time (the union of their intervals),
the time by operation name, and the device's idle gaps, each named by
what the host was doing in its middle: the innermost host operation open
then, under the innermost ``portbench`` span (``python`` where the host
was between operations).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

SPAN = "portbench."
WINDOW_SPAN = SPAN + "window"
TOP = 10  # entries of each breakdown list
NAME_CHARS = 160  # a device operation's name is cut to this length


@dataclasses.dataclass
class DeviceTrace:
    """The device side of the traced window (seconds)."""

    window_s: float
    busy_s: float
    # (name, start, end) of each device operation, seconds from the
    # window span's start
    ops: List[Tuple[str, float, float]]
    idle_by_host: Dict[str, float]

    def seconds(self, pred) -> float:
        """Device seconds in operations whose name satisfies ``pred``."""
        return float(sum(e - s for name, s, e in self.ops if pred(name)))

    def top_ops(self) -> List[list]:
        by: Dict[str, float] = {}
        for name, s, e in self.ops:
            key = name[:NAME_CHARS]
            by[key] = by.get(key, 0.0) + (e - s)
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:TOP]]

    def top_idle(self) -> List[list]:
        return [[k, v] for k, v in sorted(self.idle_by_host.items(),
                                          key=lambda kv: -kv[1])[:TOP]]


def span(name: str):
    """A ``portbench.<name>`` range in the trace (a no-op untraced: the
    profiler records ranges only while it runs)."""
    from torch.profiler import record_function

    return record_function(SPAN + name)


@contextlib.contextmanager
def profiler(enabled: bool, device_type: str):
    """``torch.profiler`` over the block when ``enabled``; yields the
    profile or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _union(intervals: np.ndarray) -> Tuple[float, List[Tuple[float, float]]]:
    """Total length of the union of sorted (start, end) rows and the gaps
    between its pieces."""
    busy, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def _name_points(host, name_of, points) -> List[str]:
    """For each sorted time point, the innermost host event open there,
    prefixed by the innermost ``portbench`` span: one sweep over the
    host events ``(start, end, key)`` sorted by start (outer ranges
    first), with a stack of the open ones; ``name_of(key)`` names one."""
    names = []
    stack: List[Tuple[float, str]] = []  # (end, name)
    i = 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, e, key = host[i]
            while stack and stack[-1][0] <= s:
                stack.pop()
            stack.append((e, key))
            i += 1
        while stack and stack[-1][0] <= p:
            stack.pop()
        open_names = [name_of(key) for _, key in stack]
        spans = [nm for nm in open_names if nm.startswith(SPAN)]
        inner = open_names[-1] if open_names else ""
        where = spans[-1][len(SPAN):] if spans else "outside"
        what = "python" if not inner or inner.startswith(SPAN) else inner
        names.append(f"{where}:{what}")
    return names


def _annotation(ev) -> bool:
    """A range on the device's timeline that is no operation: a span's."""
    flag = getattr(ev, "is_user_annotation", None)
    if flag is not None and flag():
        return True
    return ev.name().startswith(SPAN)


def reduce(prof, device_type: str) -> Optional[DeviceTrace]:
    """The window's device trace from a finished profile, or None when the
    trace has no window span."""
    from torch.autograd import DeviceType

    cpu_kind = DeviceType.CPU
    dev_kind = getattr(DeviceType, device_type.upper())
    events = prof.profiler.kineto_results.events()
    cpu_at: List[int] = []  # indices of host events
    dev: List[Tuple[float, float, str]] = []
    window = None
    for i, ev in enumerate(events):
        kind = ev.device_type()
        if kind == cpu_kind:
            cpu_at.append(i)
            if window is None and ev.name() == WINDOW_SPAN:
                window = ev
        elif kind == dev_kind and not _annotation(ev):
            s = ev.start_ns() * 1e-9
            dev.append((s, s + ev.duration_ns() * 1e-9, ev.name()))
    if window is None:
        return None
    w0 = window.start_ns() * 1e-9
    w1 = w0 + window.duration_ns() * 1e-9
    thread = window.start_thread_id()
    dev = sorted((max(s, w0), min(e, w1), name) for s, e, name in dev
                 if e > w0 and s < w1)
    host = []
    for i in cpu_at:
        ev = events[i]
        if ev.start_thread_id() == thread:
            s = ev.start_ns() * 1e-9
            e = s + ev.duration_ns() * 1e-9
            if e > w0 and s < w1:
                host.append((s, e, i))
    host.sort(key=lambda h: (h[0], -h[1]))  # outer ranges first
    busy, gaps = _union(np.array([(s, e) for s, e, _ in dev]
                                 ).reshape(-1, 2))
    if dev:  # the idle stretches before the first and after the last op
        gaps = [(w0, dev[0][0])] + gaps + [(max(e for _, e, _ in dev), w1)]
    else:
        gaps = [(w0, w1)]
    mids = sorted(((s + e) / 2, e - s) for s, e in gaps if e > s)
    idle: Dict[str, float] = {}
    names = _name_points(host, lambda i: events[i].name(),
                         [m for m, _ in mids])
    for name, (_, length) in zip(names, mids):
        idle[name] = idle.get(name, 0.0) + length
    return DeviceTrace(window_s=w1 - w0, busy_s=busy,
                       ops=[(name, s - w0, e - w0) for s, e, name in dev],
                       idle_by_host=idle)
