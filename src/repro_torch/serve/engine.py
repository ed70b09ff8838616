"""Continuous-batching serving engine (slot-based, vLLM-style scheduling
at the batch level — the serving substrate for the decode cells).

A port of ``repro/serve/engine.py``. A fixed pool of ``n_slots``
sequences decodes in lockstep (static shapes). Requests join free slots
via a prefill written into the shared cache at the slot row; finished
sequences (EOS or max-tokens) free their slot immediately — no
head-of-line blocking on long generations. Per-slot position masking
keeps attention correct for heterogeneous prompt lengths.

The engine runs on its model's device and keeps the reference's schedule
exactly: slots at different positions decode in *position groups*, one
``decode_step`` per distinct position in ascending order, each over
**all** ``n_slots`` rows (under MoE the idle rows take part in the
experts' capacity, as in the reference), and only the group's rows keep
the keys/values written at that position.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


@dataclasses.dataclass
class _Slot:
    rid: int = -1
    pos: int = 0  # next cache position
    remaining: int = 0


class ServeEngine:
    def __init__(self, model: T.Transformer, *, n_slots: int,
                 max_len: int, eos_id: Optional[int] = None):
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.n_slots = n_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache = T.init_cache(self.cfg, n_slots, max_len,
                                  device=self.device)
        self.slots = [_Slot() for _ in range(n_slots)]
        self.queue: Deque[Request] = deque()
        self.active: Dict[int, Request] = {}
        self.finished: List[Request] = []
        self._tokens = np.zeros((n_slots, 1), np.int64)

    def _prefill(self, prompt: np.ndarray, slot: int) -> int:
        """One-slot prefill into the shared cache's row ``slot`` (a view,
        written in place); returns the first token."""
        ck, cv = self.cache
        one = (ck[:, slot:slot + 1], cv[:, slot:slot + 1])
        tokens = torch.as_tensor(prompt[None, :], dtype=torch.long,
                                 device=self.device)
        logits, _ = T.prefill(self.model, tokens, one)
        return int(torch.argmax(logits[:, -1], -1)[0])

    def _decode(self, pos: int, rows: List[int]) -> np.ndarray:
        """One ``decode_step`` at ``pos`` over every slot. A group's step
        must keep k/v ONLY for its own rows — a write at pos would corrupt
        the prompt history of slots already past pos — so the other rows'
        entries at pos are restored after it. Returns each row's argmax."""
        ck, cv = self.cache
        others = torch.as_tensor(
            [i for i in range(self.n_slots) if i not in rows],
            dtype=torch.long, device=self.device)
        old_k, old_v = ck[:, others, pos], cv[:, others, pos]
        toks = torch.as_tensor(self._tokens, device=self.device)
        logits, _ = T.decode_step(self.model, toks, pos, self.cache)
        ck[:, others, pos] = old_k
        cv[:, others, pos] = old_v
        return torch.argmax(logits[:, -1], -1).cpu().numpy()

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if s.rid < 0]

    def _admit(self) -> None:
        for i in self._free_slots():
            if not self.queue:
                break
            req = self.queue.popleft()
            L = int(req.prompt.shape[0])
            tok = self._prefill(req.prompt, i)
            self.slots[i] = _Slot(rid=req.rid, pos=L, remaining=req.max_new)
            self._tokens[i, 0] = tok
            req.out.append(tok)
            self.active[req.rid] = req
            self._retire_if_done(i)

    def _retire_if_done(self, i: int) -> None:
        s = self.slots[i]
        if s.rid < 0:
            return
        req = self.active[s.rid]
        s.remaining -= 1
        hit_eos = self.eos_id is not None and req.out and \
            req.out[-1] == self.eos_id
        if s.remaining <= 0 or hit_eos or s.pos >= self.max_len:
            req.done = True
            self.finished.append(req)
            del self.active[s.rid]
            self.slots[i] = _Slot()

    def step(self) -> int:
        """One engine tick: admit new requests, decode one token for every
        position-group of active slots. Returns #tokens produced."""
        self._admit()
        groups: Dict[int, List[int]] = {}
        for i, s in enumerate(self.slots):
            if s.rid >= 0:
                groups.setdefault(s.pos, []).append(i)
        produced = 0
        for pos, idxs in sorted(groups.items()):
            nxt = self._decode(pos, idxs)
            for i in idxs:
                tok = int(nxt[i])
                self._tokens[i, 0] = tok
                req = self.active[self.slots[i].rid]
                req.out.append(tok)
                self.slots[i].pos += 1
                produced += 1
                self._retire_if_done(i)
        return produced

    def run(self, max_ticks: int = 10_000) -> List[Request]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        return self.finished
