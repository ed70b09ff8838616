"""The (pod, data, model) mesh over ``torch.distributed`` process groups.

A port of ``repro/launch/mesh.py``. Every rank of the default process
group runs the same program (SPMD) and builds the same ``Mesh``: the ranks
laid out row-major on a grid of named axes, with one process subgroup per
line of each axis and one for the flattened batch axes (pod × data). The
distributed step (``core.dist_bc``, ``spgemm.dist``) runs every collective
over one of these subgroups through the mesh's wrappers, which count the
bytes each rank hands to them, by kind (``Mesh.comm_bytes``):

* ``gather``: the buffer an ``all_gather`` leaves on each rank (frontier
  broadcast and product re-gather);
* ``extremum``: the min/max ``all_reduce`` of a monoid reduce;
* ``tie_sum``: its tie-masked sum ``all_reduce`` (arith's plain sum too);
* ``batch``: the per-batch statistics ``all_reduce`` over the batch axes
  and the ``all_gather`` over model that hands every rank the whole
  result;
* ``stop``: the one-int whole-world flag a sweep reads each iteration.

While ``torch.profiler`` runs (``repro_torch.tracing``), each wrapper call
is a ``mesh.collective`` span (its ``kind`` and the ``bytes`` it counts),
the counter ``comm_bytes.<kind>`` grows by exactly what ``comm_bytes``
does, and the stop test's read of its flag on the host counts one
``host_syncs``.

The caller initializes the process group and chooses its backend: NCCL
for one card a rank, gloo for ranks that share a card or run on the CPU
(gloo stages CUDA tensors through the host). The mesh never picks one.
"""
from __future__ import annotations

import math
import os
from typing import Callable, Dict, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, tracing

KINDS = ("gather", "extremum", "tie_sum", "batch", "stop")
BATCH_AXES = ("pod", "data")  # the axes the source batch is sharded over

Axes = Union[str, Tuple[str, ...]]


def parse_mesh_spec(spec: str) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``"DxM"`` → ((D, M), (data, model)); ``"PxDxM"`` adds the pod axis.

    Raises ``ValueError`` on malformed specs.
    """
    try:
        dims = tuple(int(d) for d in spec.lower().split("x"))
    except ValueError:
        raise ValueError(f"mesh spec expects DxM or PxDxM (e.g. 2x4), "
                         f"got {spec!r}") from None
    if len(dims) == 2:
        names: Tuple[str, ...] = ("data", "model")
    elif len(dims) == 3:
        names = ("pod", "data", "model")
    else:
        raise ValueError(f"mesh spec expects 2 or 3 axis sizes, got {spec!r}")
    if min(dims) < 1:
        raise ValueError(f"mesh spec axis sizes must be positive, got "
                         f"{spec!r}")
    return dims, names


def _rank_device(device, rank: int) -> torch.device:
    """This rank's device: the CPU, or the card ``LOCAL_RANK`` (else the
    global rank) names modulo the visible cards, so that ranks spread over
    a host's cards and share one when there is one."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    if dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


class Mesh:
    """A grid of named axes over the ranks of the default process group.

    ``shape[i]`` ranks along ``axis_names[i]``; rank r sits at the
    row-major coordinates of r (the last axis fastest). Holds one process
    group per axis line and, when both ``pod`` and ``data`` are axes, one
    for the flattened (pod, data) batch axes, each with its ranks in axis
    order. Every rank must build its meshes in the same order: creating a
    group is a collective call.
    """

    def __init__(self, shape: Sequence[int], names: Sequence[str], *,
                 device="cuda"):
        shape = tuple(int(s) for s in shape)
        names = tuple(names)
        if len(shape) != len(names) or len(set(names)) != len(names):
            raise ValueError(f"mesh needs one distinct name per axis, got "
                             f"shape {shape} and names {names}")
        if not dist.is_initialized():
            raise RuntimeError(
                "a mesh needs the default process group: call torch."
                "distributed.init_process_group first (torchrun sets its "
                "environment; pass the backend, nccl or gloo, explicitly)")
        world = dist.get_world_size()
        if math.prod(shape) != world:
            raise ValueError(f"mesh {dict(zip(names, shape))} needs "
                             f"{math.prod(shape)} ranks, the process group "
                             f"has {world}")
        self.axis_names = names
        self.shape = shape
        self.rank = dist.get_rank()
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             shape))
        self.device = _rank_device(device, self.rank)
        self.backend = str(dist.get_backend())
        self.comm_bytes: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self._groups: Dict[Tuple[str, ...], object] = {}
        flat = tuple(a for a in BATCH_AXES if a in names)
        for axes in [(a,) for a in names] + ([flat] if len(flat) > 1 else []):
            self._groups[axes] = self._new_groups(axes)

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def _key(self, axes: Axes) -> Tuple[str, ...]:
        return (axes,) if isinstance(axes, str) else tuple(axes)

    def size(self, axes: Axes) -> int:
        return math.prod(self.axis_sizes[a] for a in self._key(axes))

    def index(self, axes: Axes) -> int:
        """This rank's index along ``axes``, flattened row-major."""
        idx = 0
        for a in self._key(axes):
            i = self.axis_names.index(a)
            idx = idx * self.shape[i] + self.coords[i]
        return idx

    def _new_groups(self, axes: Tuple[str, ...]):
        """Create the process group of every line along ``axes`` (all
        ranks, same order) and return the one holding this rank."""
        pos = [self.axis_names.index(a) for a in axes]
        grid = np.arange(math.prod(self.shape)).reshape(self.shape)
        lines = np.moveaxis(grid, pos, list(range(-len(pos), 0)))
        lines = lines.reshape(-1, math.prod(self.shape[p] for p in pos))
        mine = None
        for ranks in lines.tolist():
            group = dist.new_group(ranks)
            if self.rank in ranks:
                mine = group
        return mine

    def group(self, axes: Axes):
        key = self._key(axes)
        try:
            return self._groups[key]
        except KeyError:
            raise ValueError(f"mesh {self.axis_sizes} has no process group "
                             f"for axes {key}") from None

    def reset_counts(self) -> None:
        self.comm_bytes = dict.fromkeys(KINDS, 0)

    def _collective(self, kind: str, nbytes: int):
        """Count ``nbytes`` under ``kind``; the ``mesh.collective`` span
        of the wrapper call that hands them to a collective."""
        self.comm_bytes[kind] += nbytes
        tracing.count(f"comm_bytes.{kind}", nbytes)
        return tracing.span("mesh.collective", self.device, kind=kind,
                            bytes=nbytes)

    # -- collectives ---------------------------------------------------------
    def all_gather(self, x: torch.Tensor, axes: Axes, dim: int, *,
                   kind: str = "gather") -> torch.Tensor:
        """The blocks of every rank along ``axes``, concatenated on ``dim``
        in axis order."""
        size = self.size(axes)
        with self._collective(kind, size * x.numel() * x.element_size()):
            parts = [torch.empty_like(x) for _ in range(size)]
            dist.all_gather(parts, x.contiguous(), group=self.group(axes))
            return torch.cat(parts, dim=dim)

    def all_reduce(self, x: torch.Tensor, axes: Axes, op, *,
                   kind: str) -> torch.Tensor:
        """``x`` reduced by ``op`` over ``axes``; reduces in place when
        ``x`` is contiguous. Use the returned tensor."""
        with self._collective(kind, x.numel() * x.element_size()):
            x = x.contiguous()
            dist.all_reduce(x, op=op, group=self.group(axes))
            return x

    def any_rank(self, flag: torch.Tensor) -> Callable[[], bool]:
        """Whether ``flag`` (a bool tensor) holds anywhere on any rank of
        the world: a sweep's stop test, so that every rank runs the same
        iterations and no subgroup's collective waits on a rank that
        stopped. Starts the test and returns the function that reads its
        answer on the host; on a card, work enqueued in between runs on
        while the answer crosses (the read waits for the answer alone)."""
        x = flag.any().to(torch.int32).reshape(1)
        with self._collective("stop", x.element_size()):
            dist.all_reduce(x, op=dist.ReduceOp.MAX)
            done = None
            if x.is_cuda:
                host = torch.empty(1, dtype=torch.int32, pin_memory=True)
                host.copy_(x, non_blocking=True)
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(x.device))
                x = host

        def read() -> bool:
            tracing.count("host_syncs")
            if done is not None:
                done.synchronize()
            return bool(x.item())

        return read


def mesh_from_spec(spec: str, device="cuda") -> Mesh:
    """The mesh a CLI ``--mesh`` spec names over the initialized world;
    raises if the axis-size product is not the world size."""
    dims, names = parse_mesh_spec(spec)
    return Mesh(dims, names, device=device)


def make_debug_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """The 8-rank mesh of the multi-rank checks: (2, 2, 2) (pod, data,
    model) or (4, 2) (data, model)."""
    if multi_pod:
        return Mesh((2, 2, 2), ("pod", "data", "model"), device=device)
    return Mesh((4, 2), ("data", "model"), device=device)


def make_device_mesh(shape: Sequence[int], names: Sequence[str], *,
                     device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``names`` over the initialized
    world, ranks row-major (the last axis fastest): the mesh the model
    families' DTensors (``sharding.rules``) live on."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("a device mesh needs the default process group: "
                           "call torch.distributed.init_process_group first")
    return init_device_mesh(device_type, tuple(int(s) for s in shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh``: (16, 16) (data, model) = 256 ranks,
    or (2, 16, 16) (pod, data, model) = 512. The dry run builds it over a
    fake world on the host (``device_type="cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_device_mesh(shape, axes, device_type=device_type)
