"""Content-addressed result cache for approximate-BC serving.

A copy of ``repro.serve.cache`` over the port's ``ApproxCheckpoint``.

Millions of users mostly ask the same things: the same graphs, the same
top-k sizes, a handful of accuracy tiers. This cache keys finished
``BCResponse`` payloads on *content identity* — the canonical graph
digest (``repro_torch.graphs.graph_digest``, the same string ``repro``
computes for the same graph) plus the query parameters ``(δ, k, rule,
tier)`` — so a repeat query is served in O(1) without touching the
solver, and re-registering the same graph under a different name still
hits.

ε is deliberately *not* part of the key. Accuracy targets are ordered:
a cached answer at ε' ≤ ε satisfies an ε request outright (``HIT``),
and a cached answer at ε' > ε is still the right λ estimate — just a
looser one — so it is returned immediately as a stale answer
(``REFINE``) while the estimator resumes from its checkpointed
(S1, S2, τ) sums toward the tighter target
(``repro_torch.bc.resume_approx``).
Each key therefore stores exactly one entry: the *tightest* result seen,
with the checkpoint that makes it resumable.

The cache is a bounded LRU (``max_entries``): lookups refresh recency,
insertions past the cap evict the least-recently-used key. Everything
here is plain stdlib — no torch, no service state — so the gateway can
consult it under its request lock without touching the tick loop.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, Optional, Tuple

from repro_torch.bc import ApproxCheckpoint

__all__ = ["CacheEntry", "ResultCache", "HIT", "REFINE", "MISS"]

# Lookup outcomes (returned next to the entry, never None-punned):
HIT = "hit"        # cached ε ≤ requested ε — serve as-is, O(1)
REFINE = "refine"  # cached ε > requested ε — serve stale + resume tighter
MISS = "miss"      # no usable entry — full solve

# (graph_digest, delta, k, rule, tier, metric): everything that changes
# the answer except ε, which the lookup orders instead of matching.
# metric is part of the key — a closeness answer and a betweenness
# answer at the same (digest, δ, k, rule, tier) are different analytics
# and must never collide. Hop-bounded metrics fold the bound into the
# metric component ("khop:3"), so distinct bounds are distinct keys too.
Key = Tuple[str, float, int, str, str, str]


@dataclasses.dataclass
class CacheEntry:
    """One cached answer: the wire payload plus what makes it resumable.

    ``payload`` is the exact ``BCResponse.to_json()`` dict of the run
    that produced it — a HIT returns it verbatim, so repeat queries see
    byte-identical results. ``eps`` is the target the payload satisfies;
    ``checkpoint`` the (S1, S2, τ) + stream snapshot a REFINE resumes
    from (None for entries whose service ran without checkpoints — those
    can only HIT, never refine).
    """

    key: Key
    eps: float
    payload: Dict
    checkpoint: Optional[ApproxCheckpoint] = None
    hits: int = 0
    refines: int = 0


class ResultCache:
    """Bounded LRU of the tightest-ε answer per content-addressed key."""

    def __init__(self, max_entries: int = 256):
        if max_entries <= 0:
            raise ValueError(f"max_entries must be positive, "
                             f"got {max_entries}")
        self.max_entries = max_entries
        self._entries: "OrderedDict[Key, CacheEntry]" = OrderedDict()
        self._lock = threading.Lock()
        self.evictions = 0
        # lifetime totals — per-entry counters die with their entry
        # (a refined put replaces the entry that served the lookups)
        self.hits = 0
        self.refines = 0
        self.misses = 0

    @staticmethod
    def key(digest: str, *, delta: float, k: int, rule: str,
            tier: str, metric: str = "betweenness") -> Key:
        return (digest, float(delta), int(k), str(rule), str(tier),
                str(metric))

    def __len__(self) -> int:
        return len(self._entries)

    # ------------------------------------------------------------------
    def lookup(self, digest: Optional[str], *, eps: float, delta: float,
               k: int, rule: str, tier: str, metric: str = "betweenness"
               ) -> Tuple[Optional[CacheEntry], str]:
        """Resolve one query against the cache: (entry, HIT|REFINE|MISS).

        A ``None`` digest (stats-only graph with no content identity)
        can never hit — identity is the whole point of the key. An entry
        at a looser ε than requested only refines when it carries a
        checkpoint; without one it is reported as a MISS (serving a
        looser answer with no path to the tighter target would silently
        break the ε contract).
        """
        if digest is None:
            with self._lock:
                self.misses += 1
            return None, MISS
        key = self.key(digest, delta=delta, k=k, rule=rule, tier=tier,
                       metric=metric)
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self.misses += 1
                return None, MISS
            self._entries.move_to_end(key)
            if entry.eps <= eps:
                entry.hits += 1
                self.hits += 1
                return entry, HIT
            if entry.checkpoint is not None:
                entry.refines += 1
                self.refines += 1
                return entry, REFINE
            self.misses += 1
            return None, MISS

    def put(self, digest: Optional[str], *, eps: float, delta: float,
            k: int, rule: str, tier: str, metric: str = "betweenness",
            payload: Dict, checkpoint: Optional[ApproxCheckpoint] = None
            ) -> Optional[CacheEntry]:
        """Insert one finished answer; keeps the tightest ε per key.

        A looser result never overwrites a tighter cached one (the
        tighter entry already serves both), so concurrent misses racing
        to fill the same key converge on the best answer. Returns the
        entry now cached under the key (None for digest-less graphs).
        """
        if digest is None:
            return None
        key = self.key(digest, delta=delta, k=k, rule=rule, tier=tier,
                       metric=metric)
        with self._lock:
            existing = self._entries.get(key)
            if existing is not None and existing.eps <= eps:
                self._entries.move_to_end(key)
                return existing
            entry = CacheEntry(key=key, eps=float(eps), payload=payload,
                               checkpoint=checkpoint)
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
                self.evictions += 1
            return entry

    # ------------------------------------------------------------------
    def stats(self) -> Dict:
        """Counters for the metrics snapshot (O(entries), lock-held)."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "max_entries": self.max_entries,
                "evictions": self.evictions,
                "hits": self.hits,
                "refines": self.refines,
                "misses": self.misses,
            }
