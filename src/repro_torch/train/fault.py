"""Fault tolerance: supervised restart loop + straggler mitigation.

A copy of ``repro/train/fault.py`` over the port's checkpoints.

``Supervisor.run`` drives a step function under a retry policy: on worker
failure (``WorkerFailure`` — raised by the harness when a host/device dies,
or injected by tests/chaos config) it restores the latest checkpoint and
resumes. A step function keyed by step (a BC sweep's batch b runs sources
[b·n_b, (b+1)·n_b)) consumes exactly the inputs it would have, so
restarts are bit-exact (tested).

Straggler mitigation (``BackupTaskPolicy``): at 1000+ node scale the
slowest host dominates step time. The policy tracks a running latency
EWMA per data shard producer; when a producer exceeds ``threshold`` x the
median, its next input shard is *duplicated* onto the spare producer and
the first result wins (speculative execution at the input layer — the
device-side collectives stay bulk-synchronous, which is the only part we
can emulate honestly on one host).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

from repro_torch.train import checkpoint as ckpt_lib


class WorkerFailure(RuntimeError):
    """A (simulated) lost worker/host."""


@dataclasses.dataclass
class ChaosConfig:
    """Deterministic failure injection for tests."""

    fail_at_steps: tuple = ()
    already_failed: set = dataclasses.field(default_factory=set)

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at_steps and step not in self.already_failed:
            self.already_failed.add(step)
            raise WorkerFailure(f"injected failure at step {step}")


@dataclasses.dataclass
class Supervisor:
    ckpt_dir: str
    save_every: int = 10
    max_restarts: int = 10
    keep: int = 3

    def run(self, *, init_state, step_fn: Callable[[Any, int], Any],
            n_steps: int, chaos: Optional[ChaosConfig] = None,
            state_like=None, log: Optional[List[str]] = None):
        """Run ``step_fn(state, step) -> state`` with checkpoint/restart.

        Returns the final state. ``init_state`` is the first state, or a
        function of no arguments that makes it: a step that updates its
        state in place (``train_lib``'s) needs the function, since a
        failure before the first save restarts from a fresh initial state,
        and the one it was handed has been stepped. ``state_like`` (a tree
        whose leaves are placed where the restored state should live)
        restores onto another device or dtype than the one that wrote the
        checkpoint; by default the state is restored like the initial
        state.
        """
        fresh = init_state if callable(init_state) else lambda: init_state
        restarts = 0
        init_state = state = fresh()
        start = ckpt_lib.latest_step(self.ckpt_dir)
        if start is not None:
            state, start = ckpt_lib.restore(
                self.ckpt_dir, like=state_like if state_like is not None
                else init_state)
            start += 1
            if log is not None:
                log.append(f"resumed@{start}")
        else:
            start = 0

        step = start
        while step < n_steps:
            try:
                if chaos is not None:
                    chaos.maybe_fail(step)
                state = step_fn(state, step)
                if (step + 1) % self.save_every == 0 or step + 1 == n_steps:
                    ckpt_lib.save(self.ckpt_dir, step, state, keep=self.keep)
                step += 1
            except WorkerFailure as e:
                restarts += 1
                if log is not None:
                    log.append(f"failure@{step}:{e}")
                if restarts > self.max_restarts:
                    raise
                latest = ckpt_lib.latest_step(self.ckpt_dir)
                if latest is None:
                    state, step = fresh(), 0
                else:
                    state, saved = ckpt_lib.restore(
                        self.ckpt_dir,
                        like=state_like if state_like is not None
                        else init_state)
                    step = saved + 1
                if log is not None:
                    log.append(f"restart@{step}")
        return state


@dataclasses.dataclass
class BackupTaskPolicy:
    """Speculative re-execution of slow input-shard producers."""

    n_producers: int
    threshold: float = 2.0
    ewma: float = 0.7
    _lat: Dict[int, float] = dataclasses.field(default_factory=dict)

    def observe(self, producer: int, seconds: float) -> None:
        prev = self._lat.get(producer, seconds)
        self._lat[producer] = self.ewma * prev + (1 - self.ewma) * seconds

    def stragglers(self) -> List[int]:
        if len(self._lat) < max(2, self.n_producers // 2):
            return []
        med = sorted(self._lat.values())[len(self._lat) // 2]
        return [p for p, l in self._lat.items() if l > self.threshold * med]

    def fetch(self, producers: Dict[int, Callable[[], Any]],
              timer=time.monotonic) -> Dict[int, Any]:
        """Fetch every shard; duplicate flagged stragglers onto the least
        loaded producer and take the first completion (here: the faster of
        the two measured calls — single-process emulation)."""
        flagged = set(self.stragglers())
        out = {}
        for pid, fn in producers.items():
            t0 = timer()
            val = fn()
            dt = timer() - t0
            if pid in flagged:
                # speculative duplicate on the backup producer
                t1 = timer()
                val2 = fn()
                dt2 = timer() - t1
                if dt2 < dt:
                    val, dt = val2, dt2
            self.observe(pid, dt)
            out[pid] = val
        return out
