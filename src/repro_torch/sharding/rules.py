"""Logical-axis → DTensor placement rules (MaxText-style, condensed).

A port of ``repro/sharding/rules.py``. Every parameter and activation is
annotated with a tuple of *logical* axis names; a ``ShardingPolicy`` maps
logical names to mesh axes:

  batch    → (pod, data)    — DP
  fsdp     → (pod, data)    — weight shard (ZeRO-3); all-gathered per layer
  model    → model          — TP (heads / ffn / vocab / experts)
  seq      → model          — sequence parallelism for long-context cells
  (None)   → replicated

The policy is a plain dict so perf hillclimbing can swap assignments
without touching model code.

A spec (``spec``, ``spec_for_shape``) is the reference's
``PartitionSpec`` as a tuple, one entry a tensor dim: None, a mesh axis,
or a tuple of axes (major first). A tensor is placed by DTensor
placements, one a mesh dim (``placements_for``; ``spec_of`` turns them
back into a spec). A dim over several axes, e.g. ``(pod, data)``, is
sharded by each of those mesh dims, the major first. DTensor then
redistributes it one mesh dim at a time: a gather of a ``(pod, data)``
dim is an all-gather over ``data`` and then one over ``pod``, whose ring
wire bytes add up to one over the 32 ranks (out − in), in two messages.
A flattened (pod·data, model) mesh would make it one, but cannot hold
the rules that use ``data`` apart from ``pod`` (``kv_seq`` over (data,
model), or ``expert`` over (pod, model)), and all operands of a DTensor
op share one mesh. ``AbstractMesh`` gives a policy its axis sizes
without a world (the specs only).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Logical = Tuple[Optional[str], ...]
Assignment = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Assignment, ...]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without devices (``jax.sharding.AbstractMesh``):
    enough for ``spec``/``spec_for_shape``; placing a tensor needs a
    ``DeviceMesh``."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


def axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _axes(a: Assignment) -> Tuple[str, ...]:
    if a is None:
        return ()
    return (a,) if isinstance(a, str) else tuple(a)


def _assignment(axes: Sequence[str]) -> Assignment:
    axes = tuple(axes)
    return None if not axes else (axes[0] if len(axes) == 1 else axes)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """Where a tensor lives (``jax.sharding.NamedSharding``): the mesh its
    DTensor uses and one placement a mesh dim."""
    mesh: Any
    placements: Tuple[Any, ...]


def spec_of(placements, dim_names: Sequence[str], ndim: int) -> Spec:
    """The per-tensor-dim spec of DTensor ``placements`` over a mesh with
    ``dim_names``."""
    parts = [[] for _ in range(ndim)]
    for name, pl in zip(dim_names, placements):
        if pl.is_shard():
            parts[pl.dim % ndim].append(name)
    return tuple(_assignment(p) for p in parts)


def placements_for(spec: Spec, dim_names: Sequence[str]):
    """DTensor placements, one a mesh dim of ``dim_names``, of ``spec``.
    A tensor dim over several axes is sharded by each in mesh order (the
    major axis first, as the reference's tuples are)."""
    from torch.distributed.tensor import Replicate, Shard

    out = [Replicate() for _ in dim_names]
    for d, a in enumerate(spec):
        axes = _axes(a)
        pos = []
        for ax in axes:
            if ax not in dim_names:
                raise ValueError(f"axis {ax!r} of {spec} is not a dim of "
                                 f"the mesh {tuple(dim_names)}")
            pos.append(list(dim_names).index(ax))
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} of {spec} are not in mesh order")
        for p in pos:
            if out[p].is_shard():
                raise ValueError(f"mesh dim {dim_names[p]!r} claimed twice "
                                 f"in {spec}")
            out[p] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash, as the
class ShardingPolicy:                          # reference's
    mesh: Optional[Any]  # DeviceMesh or AbstractMesh
    rules: Dict[str, object]  # logical name -> mesh axis (str|tuple|None)

    @property
    def model_size(self) -> int:
        if self.mesh is None:
            return 1
        return int(axis_sizes(self.mesh).get("model", 1))

    def spec(self, logical: Logical) -> Spec:
        """Each dim's assignment, a one-axis tuple as its axis (as a
        ``PartitionSpec`` normalizes it)."""
        return tuple(_assignment(_axes(self.rules.get(ax))) if ax else None
                     for ax in logical)

    def _axes_size(self, assignment) -> int:
        sizes = axis_sizes(self.mesh)
        return math.prod(int(sizes.get(a, 1)) for a in _axes(assignment))

    def spec_for_shape(self, logical: Logical, shape) -> Spec:
        """Like ``spec`` but (a) drops assignments a dim cannot host (e.g.
        a batch-1 decode cell over a 16-way data axis) and (b) removes mesh
        axes already claimed by an earlier dim (e.g. ``expert`` over
        (pod, model) alongside ``batch`` over (pod, data) keeps only
        ``data`` for the batch dim)."""
        parts = []
        used = set()
        for ax, dim in zip(logical, shape):
            a = self.rules.get(ax) if ax else None
            if a is not None:
                a = _assignment(x for x in _axes(a) if x not in used)
            if a is not None and dim % max(self._axes_size(a), 1) != 0:
                a = None
            if a is not None:
                used.update(_axes(a))
            parts.append(a)
        return tuple(parts)

    def _sharding(self, spec: Spec) -> Sharding:
        if isinstance(self.mesh, AbstractMesh):
            raise ValueError("placing a tensor needs a DeviceMesh policy")
        return Sharding(self.mesh,
                        placements_for(spec, self.mesh.mesh_dim_names))

    def named(self, logical: Logical) -> Optional[Sharding]:
        if self.mesh is None:
            return None
        return self._sharding(self.spec(logical))

    def named_for_shape(self, logical: Logical, shape
                        ) -> Optional[Sharding]:
        if self.mesh is None:
            return None
        return self._sharding(self.spec_for_shape(logical, shape))

    def constrain(self, x, logical: Logical):
        """``with_sharding_constraint``: no-op without a mesh; a DTensor is
        redistributed, a plain tensor (the same on every rank) placed."""
        if self.mesh is None:
            return x
        return place(x, self.named_for_shape(logical, x.shape))


def place(x: torch.Tensor, sh: Optional[Sharding]):
    """``x`` as a DTensor of sharding ``sh`` (None: unchanged). A plain
    tensor is taken as the same on every rank and cut locally (no
    collective); a DTensor is redistributed (autograd-aware both ways)."""
    from torch.distributed.tensor import DTensor, Replicate

    if sh is None:
        return x
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, sh.mesh, [Replicate()] * sh.mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(sh.placements):
        return x
    return x.redistribute(sh.mesh, sh.placements)


def replicate_over(x, axes: Assignment):
    """``x`` replicated over the mesh dims of ``axes``, its other
    placements kept: FSDP's gather of a weight before use (a plain tensor
    or nothing to gather: ``x`` itself). Its backward reduce-scatters the
    gradient back to ``x``'s placements."""
    from torch.distributed.tensor import DTensor, Replicate

    axes = _axes(axes)
    if not axes or not isinstance(x, DTensor):
        return x
    names = x.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if names[i] in axes else p
               for i, p in enumerate(x.placements))
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def abstract(shape, dtype: torch.dtype, sh: Optional[Sharding] = None,
             device="cpu"):
    """An uninitialized tensor of ``shape`` placed by ``sh``: fake under a
    ``FakeTensorMode``, else on ``device`` (``"meta"`` allocates
    nothing); a DTensor holds a shard of its own storage. The counterpart
    of ``jax.ShapeDtypeStruct``."""
    from torch.distributed.tensor import DTensor

    if sh is None:
        return torch.empty(shape, dtype=dtype, device=device)
    local = list(shape)
    coord = sh.mesh.get_coordinate()
    for i, pl in enumerate(sh.placements):  # torch.chunk's split, in order
        if pl.is_shard():
            full = -(-local[pl.dim] // sh.mesh.size(i))
            local[pl.dim] = max(0, min(full, local[pl.dim] - coord[i] * full))
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=dtype, device=device),
                              sh.mesh, sh.placements, run_check=False,
                              shape=tuple(shape), stride=stride)


NO_SHARDING = ShardingPolicy(None, {})


def make_policy(mesh, *, seq_shard: bool = False, fsdp: bool = True,
                overrides: Optional[Dict] = None) -> ShardingPolicy:
    if mesh is None:
        return NO_SHARDING
    has_pod = "pod" in mesh.mesh_dim_names
    dp = ("pod", "data") if has_pod else ("data",)
    rules = {
        "batch": dp,
        "fsdp": dp if fsdp else None,
        "model": "model",
        "expert": "model",
        "seq": "model" if seq_shard else None,
        "kv_seq": ("data", "model"),  # long-context KV cache sharding
        "vocab": "model",
    }
    if overrides:
        rules.update(overrides)
    return ShardingPolicy(mesh, rules)


def _is_logical(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def map_logical(fn, tree):
    """``fn`` over each logical tuple of a nested dict / list."""
    if isinstance(tree, dict):
        return {k: map_logical(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_logical(fn, v) for v in tree]
    if _is_logical(tree):
        return fn(tree)
    raise TypeError(f"not a logical tree: {tree!r}")


def param_sharding(policy: ShardingPolicy, logical_tree):
    """Map a tree of logical tuples to ``Sharding``s (or None)."""
    return map_logical(policy.named, logical_tree)


@contextlib.contextmanager
def scope(policy: ShardingPolicy):
    """The context a step over ``policy``'s DTensors runs in (its backward
    too): plain tensors the code makes (positions, masks, iotas) join
    DTensor ops as replicated (``implicit_replication``, but reentrant:
    an inner scope leaves an outer one on). Nothing without a mesh."""
    if policy.mesh is None:
        yield
        return
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prev = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = prev
