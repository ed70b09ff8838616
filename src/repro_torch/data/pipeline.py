"""Deterministic synthetic data pipelines.

A copy of ``repro/data/pipeline.py`` (numpy only): the same seeds give
the reference's arrays, bit for bit.

Every batch is a pure function of (seed, step) — the property the restart
loop relies on for bit-exact resume (``fault.py``). Token streams use a
fixed-order LCG permutation over a synthetic corpus so consecutive steps
see disjoint data; graph/recsys batches hash (seed, step) into generator
seeds.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab: int
    batch: int
    seq: int
    seed: int = 0
    corpus_tokens: int = 1 << 24  # synthetic zipf corpus length


class LMPipeline:
    """Zipf-distributed synthetic token stream (shape-faithful)."""

    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = _rng(c.seed, step)
        toks = rng.zipf(1.3, size=(c.batch, c.seq + 1)) % c.vocab
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :-1], "targets": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


@dataclasses.dataclass(frozen=True)
class RecsysDataConfig:
    total_vocab: int
    n_fields: int
    batch: int
    multi_hot: int = 1
    seed: int = 0


class RecsysPipeline:
    def __init__(self, cfg: RecsysDataConfig):
        self.cfg = cfg

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = _rng(c.seed, step)
        ids = rng.integers(0, c.total_vocab,
                           (c.batch, c.n_fields, c.multi_hot)).astype(np.int32)
        labels = rng.integers(0, 2, c.batch).astype(np.float32)
        return {"ids": ids, "labels": labels}


@dataclasses.dataclass(frozen=True)
class GraphDataConfig:
    kind: str  # full | sampled | molecule
    seed: int = 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


class GraphPipeline:
    """Graph batches: full graph (static), neighbor-sampled, or molecules."""

    def __init__(self, cfg: GraphDataConfig, graph=None, sampler=None):
        self.cfg = cfg
        self.graph = graph
        self.sampler = sampler

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        m = self.cfg.meta
        if self.cfg.kind == "molecule":
            from repro_torch.graphs.sampler import batch_molecules
            return batch_molecules(m["batch"], m["n"], m["e"], m["d"],
                                   seed=int(_rng(self.cfg.seed, step)
                                            .integers(1 << 31)))
        if self.cfg.kind == "sampled":
            rng = _rng(self.cfg.seed, step)
            seeds = rng.choice(self.graph.n, size=m["batch"], replace=False)
            return self.sampler.sample(seeds.astype(np.int64))
        raise ValueError(self.cfg.kind)
