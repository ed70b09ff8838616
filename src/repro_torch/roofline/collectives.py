"""Per-device tallies of an eager step: collectives, FLOPs, bytes, memory.

The reference parses compiled HLO text (``repro/roofline/hlo_parse.py``);
an eager PyTorch step has no HLO, so ``CountingMode`` watches the step's
operations as they run instead. Entered around a step over DTensors (in a
fake world under ``FakeTensorMode``, or a real one), it sees every local
operation a rank runs on its shards, and tallies:

* each collective (``_c10d_functional`` ops, DTensor's redistributions;
  ``c10d`` ops, the BC mesh's ``dist.all_gather`` / ``all_reduce``) as a
  ``CollectiveOp`` of its kind, input and output bytes and group size;
* FLOPs, through ``torch.utils.flop_counter``'s registry (matmuls,
  convolutions, attention; elementwise ops count none, as in XLA's
  ``cost_analysis`` the matmuls dominate);
* bytes accessed: the input plus output bytes of every op that is not a
  view, which is what eager PyTorch reads and writes;
* memory: the bytes of live storages (each counted once, freed when its
  storage dies), their peak, and the arguments' bytes.

The stand-ins DTensor's sharding propagation makes of its operands'
global shapes count nothing.

A DTensor op is handed on (``NotImplemented``) to DTensor's dispatch,
whose local ops and collectives then reach the mode with local shapes:
the tallies are one rank's, i.e. per device.

Two wire metrics, as the reference's: ``operand_bytes`` (Σ input sizes)
and ``wire_bytes`` (ring estimates: all-gather = out−in, all-reduce =
2·in, reduce-scatter = in−out, all-to-all = collective-permute = in).
Every execution is recorded, so nothing scales by loop trip counts.
"""
from __future__ import annotations

import dataclasses
import sys
import weakref
from collections import defaultdict
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# op name (namespace.op) -> the reference's collective kind
_KIND = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.all_gather_into_tensor_coalesced": "all-gather",
    "_c10d_functional.all_reduce": "all-reduce",
    "_c10d_functional.all_reduce_coalesced": "all-reduce",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.reduce_scatter_tensor_coalesced": "reduce-scatter",
    "_c10d_functional.all_to_all_single": "all-to-all",
    "_c10d_functional.broadcast": "collective-permute",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allgather_": "all-gather",
    "c10d._allgather_base_": "all-gather",
    "c10d.allreduce_": "all-reduce",
    "c10d.reduce_scatter_": "reduce-scatter",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_": "all-to-all",
    "c10d.alltoall_base_": "all-to-all",
    "c10d.broadcast_": "collective-permute",
}
_SKIP = {"prim.device", "aten.detach", "aten.lift_fresh",
         "_c10d_functional.wait_tensor"}


def _tensors(tree) -> List[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    computation: str  # the op's name (the reference: its HLO computation)
    out_bytes: int
    in_bytes: int
    group_size: int = 1

    @property
    def operand_bytes(self) -> int:
        return self.in_bytes

    @property
    def wire_bytes(self) -> int:
        k = self.kind
        if k == "all-gather":
            return max(self.out_bytes - self.in_bytes, 0)
        if k == "all-reduce":
            return 2 * self.in_bytes
        if k == "reduce-scatter":
            return max(self.in_bytes - self.out_bytes, 0)
        return self.in_bytes  # all-to-all, collective-permute


@dataclasses.dataclass
class CollectiveStats:
    ops: List[CollectiveOp]

    def totals(self) -> Dict[str, float]:
        operand = wire = 0.0
        per_kind: Dict[str, float] = defaultdict(float)
        for op in self.ops:
            operand += op.operand_bytes
            wire += op.wire_bytes
            per_kind[op.kind] += op.wire_bytes
        return {"operand_bytes": operand, "wire_bytes": wire,
                "messages": float(len(self.ops)),
                **{f"wire_{k}": v for k, v in per_kind.items()}}


def _in_dtensor_internals(depth: int = 16) -> bool:
    """Whether a factory op is DTensor's sharding propagation building
    stand-ins of its operands' global shapes (no compute of the step)."""
    f = sys._getframe(2)
    for _ in range(depth):
        if f is None:
            return False
        if "distributed/tensor/_sharding_prop" in f.f_code.co_filename or \
                "distributed/tensor/_op_schema" in f.f_code.co_filename:
            return True
        f = f.f_back
    return False


def _group_size(func_name: str, args) -> int:
    """The group a collective runs over: a ``_c10d_functional`` op names
    it (its group-name argument), a ``c10d`` op passes it."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if func_name.startswith("c10d."):
        for a in args:
            if isinstance(a, dist.ProcessGroup):
                return int(a.size())
            if isinstance(a, torch.ScriptObject):
                return int(dist.ProcessGroup.unbox(a).size())
        return 1
    for a in args:
        if isinstance(a, str):
            try:
                return int(c10d._resolve_process_group(a).size())
            except Exception:
                continue
    return 1


class CountingMode(TorchDispatchMode):
    """Tallies one rank's FLOPs, bytes, collectives and live memory over
    the operations run under it (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops_of = flop_registry
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.collectives: List[CollectiveOp] = []
        self.live = 0
        self.peak = 0
        self.argument_bytes = 0
        self._seen: Dict[int, int] = {}

    # -- memory ------------------------------------------------------------
    def _track(self, t: torch.Tensor) -> None:
        from torch.distributed.tensor import DTensor

        if isinstance(t, DTensor):
            t = t._local_tensor
        try:
            st = t.untyped_storage()
        except Exception:  # a tensor without storage (sparse, nested)
            return
        key = id(st)
        if key in self._seen:
            return
        nb = st.nbytes()
        self._seen[key] = nb
        self.live += nb
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._seen.pop(key, 0)

    def add_arguments(self, args) -> None:
        """Count ``args``' (local) tensors as live from the start, and as
        the argument bytes."""
        from torch.distributed.tensor import DTensor

        for t in _tensors(args):
            loc = t._local_tensor if isinstance(t, DTensor) else t
            before = self.live
            self._track(loc)
            self.argument_bytes += self.live - before

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # DTensor runs its local ops under us
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in _SKIP or (not ins and _in_dtensor_internals()):
            return out  # bookkeeping, or DTensor's own shape inference
        kind = _KIND.get(name)
        if kind is not None:
            in_b = _nbytes(ins)
            out_b = _nbytes(outs) if not name.startswith("c10d.") else 0
            if name.startswith("c10d."):
                # in-place c10d ops: the first argument holds the outputs
                first = _tensors(args[0]) if args else []
                rest = _tensors(args[1:2]) if len(args) > 1 else []
                if kind in ("all-gather", "reduce-scatter") and rest:
                    out_b, in_b = _nbytes(first), _nbytes(rest)
                else:
                    in_b = out_b = _nbytes(first)
            self.collectives.append(CollectiveOp(
                kind, name, out_b, in_b, _group_size(name, args)))
        elif not func.is_view:
            fn = self._flops_of.get(func._overloadpacket)
            if fn is not None:
                self.flops += float(fn(*args, **kwargs, out_val=out))
            self.bytes_accessed += _nbytes(ins) + _nbytes(outs)
        if not func.is_view:  # a view holds its base's storage
            for t in outs:
                self._track(t)
        return out

    def stats(self) -> CollectiveStats:
        return CollectiveStats(list(self.collectives))
