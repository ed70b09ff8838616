"""Cross-request batch fusion — many queries, one padded batch.

A copy of ``repro/bc/fusion.py``. The serving-side half of the paper's
batching story: the batched MFBC step amortizes its fixed cost (kernel
launches and the host loop of each sweep) over every source row in the
batch, but a
slot-scheduled service advancing each request independently runs each
request's epoch as its own under-filled batch and pays that fixed cost
per *request*. ``BatchAssembler`` closes the gap: it drains the source
demand of many live requests on the same graph (the demand side of
``approx.sampling.AdaptiveSampler``) and packs it into slot-tagged
``FusedBatch``es for the executor's ``step_segmented`` — one device call
returns per-slot ``(S1, S2, n_reach)`` rows that ``scatter`` hands back
to each request's ``LambdaEstimator``.

Packing policy: ``order_demand`` decides *which slot drains first* —
``pack="fifo"`` keeps the caller's order, ``"deadline"`` sorts by
deadline slack (tightest first, the QoS scheduler's drain order), and
``"fair"`` greedily balances cumulative rows across tenants. Whatever
the policy, slots are laid out contiguously in the chosen order (never
interleaved), so each fused batch touches as few distinct slots as
possible and every slot's rows keep their draw order — which is what
makes a slot's fused statistics bitwise-identical to an unfused run of
the same rows (the segmented sum folds each slot's rows in batch order,
and on the card every bucket runs the kernels with one split count)
under *every* packing policy. Batches are chopped at the executor's
capacity ``n_b`` and padded to its power-of-two bucket, so ragged
multi-request demand never pays always-pad-to-``n_b`` waste.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.bc.executor import BatchExecutor

PACKS = ("fifo", "deadline", "fair")


def order_demand(demand: Sequence[Tuple[int, np.ndarray]],
                 pack: str = "fifo", *,
                 slack: Optional[Dict[int, float]] = None,
                 tenant: Optional[Dict[int, str]] = None,
                 served: Optional[Dict[str, int]] = None
                 ) -> List[Tuple[int, np.ndarray]]:
    """Order ``(slot_key, sources)`` demand entries by packing policy.

    The one ordering rule shared by ``BatchAssembler.assemble`` (within a
    graph) and the service's global budget allocation (across graphs), so
    "who drains first" and "who gets the tick budget" always agree.
    Entries are reordered *whole* — a slot's rows are never split or
    interleaved here, which preserves the per-slot row order the bitwise
    fused-parity guarantee rests on.

    * ``"fifo"`` — the caller's order (the pre-QoS behavior).
    * ``"deadline"`` — ascending deadline slack (``slack[key]`` seconds
      until the slot's deadline; missing keys sort last). Stable: ties
      keep the caller's order.
    * ``"fair"`` — greedy per-tenant fair share: repeatedly drain the
      entry whose tenant (``tenant[key]``, default ``"default"``) has
      the fewest cumulative rows, counting both this call and the
      caller's history (``served``, e.g. rows drained in earlier ticks);
      ties break toward tighter slack, then the caller's order.
    """
    if pack not in PACKS:
        raise ValueError(f"pack must be one of {PACKS}, got {pack!r}")
    entries = list(demand)
    if pack == "fifo" or len(entries) <= 1:
        return entries
    sl = slack or {}
    if pack == "deadline":
        return sorted(entries, key=lambda e: sl.get(e[0], math.inf))
    tn = tenant or {}
    totals: Dict[str, int] = dict(served or {})
    out: List[Tuple[int, np.ndarray]] = []
    remaining = entries
    while remaining:
        j = min(range(len(remaining)), key=lambda i: (
            totals.get(tn.get(remaining[i][0], "default"), 0),
            sl.get(remaining[i][0], math.inf), i))
        key, srcs = remaining.pop(j)
        t = tn.get(key, "default")
        totals[t] = totals.get(t, 0) + int(np.asarray(srcs).size)
        out.append((key, srcs))
    return out


@dataclasses.dataclass(frozen=True)
class FusedBatch:
    """One slot-tagged batch packed from several requests' demand.

    ``slots[j]`` is the caller's key for local slot j; ``counts[j]`` how
    many rows slot j contributed. Rows are unpadded here (every row is
    a real source, ``valid`` all True, length ≤ the assembler's
    capacity) — bucket padding, with ``valid=False`` rows tagged into a
    dump segment, happens inside the executor's ``step_segmented``.
    """

    sources: np.ndarray  # (B,) int32, B ≤ executor capacity
    valid: np.ndarray  # (B,) bool
    slot_ids: np.ndarray  # (B,) int32 in [0, n_slots)
    slots: Tuple[int, ...]  # local slot j -> caller slot key
    counts: Tuple[int, ...]  # valid rows per local slot

    @property
    def n_slots(self) -> int:
        return len(self.slots)

    @property
    def n_valid(self) -> int:
        return int(sum(self.counts))


class BatchAssembler:
    """Packs per-request source demand into fused executor batches.

    One assembler per (graph, executor): capacity and buckets come from
    the executor it feeds. ``assemble`` is pure packing — it never draws
    sources itself, so callers control each request's RNG stream — and
    ``scatter`` is the inverse, mapping the segmented step's per-slot
    rows back to caller keys. ``pack`` picks the drain order
    (``order_demand``); whichever policy runs, per-slot statistics stay
    bitwise-identical to an unfused run, because ordering moves whole
    entries and never touches a slot's row order.
    """

    def __init__(self, executor: BatchExecutor, pack: str = "fifo"):
        if pack not in PACKS:
            raise ValueError(f"pack must be one of {PACKS}, got {pack!r}")
        self.executor = executor
        self.capacity = int(executor.n_b)
        self.pack = pack

    def assemble(self, demand: Sequence[Tuple[int, np.ndarray]], *,
                 slack: Optional[Dict[int, float]] = None,
                 tenant: Optional[Dict[int, str]] = None,
                 served: Optional[Dict[str, int]] = None
                 ) -> List[FusedBatch]:
        """Pack ``(slot_key, sources)`` demand into fused batches.

        Orders the entries by the assembler's ``pack`` policy (slack /
        tenant / served feed the deadline and fair policies and are
        ignored by FIFO), concatenates each slot's sources (preserving
        every slot's row order), chops the stream at the executor
        capacity, and tags rows with batch-local slot ids. Empty demand
        entries are dropped; an empty demand list yields no batches.
        Slot keys must be distinct — ``scatter`` maps per-slot rows back
        by key, so a duplicate would silently shadow its earlier
        statistics (concatenate a slot's sources instead).
        """
        keys: List[int] = []
        parts: List[np.ndarray] = []
        tags: List[np.ndarray] = []
        ordered = order_demand(demand, self.pack, slack=slack,
                               tenant=tenant, served=served)
        for key, srcs in ordered:
            srcs = np.asarray(srcs, np.int32)
            if srcs.size == 0:
                continue
            keys.append(key)
            parts.append(srcs)
            tags.append(np.full(srcs.size, len(keys) - 1, np.int32))
        if len(set(keys)) != len(keys):
            raise ValueError(f"duplicate slot keys in demand: {keys}; "
                             f"merge each slot's sources into one entry")
        if not parts:
            return []
        stream = np.concatenate(parts)
        stream_keys = np.concatenate(tags)
        out: List[FusedBatch] = []
        for lo in range(0, stream.size, self.capacity):
            hi = min(lo + self.capacity, stream.size)
            out.append(self._one_batch(stream[lo:hi], stream_keys[lo:hi],
                                       keys))
        return out

    def _one_batch(self, sources: np.ndarray, global_tags: np.ndarray,
                   keys: List[int]) -> FusedBatch:
        # Renumber to batch-local slot ids in order of first appearance,
        # so n_slots is the number of slots *in this batch*, not overall.
        uniq, first, inverse, counts = np.unique(
            global_tags, return_index=True, return_inverse=True,
            return_counts=True)
        order = np.argsort(first)  # unique tags by first appearance
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        return FusedBatch(sources=sources,
                          valid=np.ones(sources.size, bool),
                          slot_ids=rank[inverse].astype(np.int32),
                          slots=tuple(keys[int(t)] for t in uniq[order]),
                          counts=tuple(int(c) for c in counts[order]))

    def run(self, demand: Sequence[Tuple[int, np.ndarray]], *,
            slack: Optional[Dict[int, float]] = None,
            tenant: Optional[Dict[int, str]] = None,
            served: Optional[Dict[str, int]] = None
            ) -> Iterator[Tuple[FusedBatch, Dict[int, Tuple]]]:
        """Assemble, step, scatter: yields ``(batch, per-slot moments)``.

        Convenience loop over ``assemble`` + ``step_segmented`` +
        ``scatter`` for callers (service tick, tests) that don't need to
        interleave other work between fused batches.
        """
        for fb in self.assemble(demand, slack=slack, tenant=tenant,
                                served=served):
            s1, s2, nr = self.executor.step_segmented(
                fb.sources, fb.valid, fb.slot_ids, fb.n_slots)
            yield fb, scatter(fb, (s1, s2, nr))


def scatter(fb: FusedBatch, moments: Tuple[np.ndarray, np.ndarray,
                                           np.ndarray]
            ) -> Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray, int]]:
    """Map segmented ``(S1, S2, n_reach)`` rows back to caller slot keys.

    Returns ``{slot_key: (s1_row, s2_row, n_reach_row, n_valid)}`` —
    exactly the arguments each slot's ``LambdaEstimator.update`` wants.
    """
    s1, s2, nr = moments
    return {key: (s1[j], s2[j], nr[j], fb.counts[j])
            for j, key in enumerate(fb.slots)}
