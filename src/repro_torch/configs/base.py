"""Config system: architectures × input-shape cells.

A port of the LM, GNN and recsys families of ``repro/configs/base.py``.
Each architecture
provides an ``ArchSpec`` with:

* ``config(smoke=False)`` — the exact published configuration (or a tiny
  reduced config of the same family for CPU smoke tests);
* ``cells()``             — its input-shape cells (the 4 assigned shapes);
* ``build(cell, policy, smoke)`` — a ``StepBundle``: the step function,
  the layer loop's trip count, the analytic MODEL_FLOPS, a maker of the
  step's abstract arguments (uninitialized: fake tensors under a
  ``FakeTensorMode``, DTensors placed by ``policy`` under a mesh) and a
  maker of concrete arguments with a check of the outputs.

With a mesh in ``policy`` a cell takes the reference's production
policy: bf16 LM weights and cache, int8 moments, CE in 8 chunks; the GNN
batch padded to multiples of 512 nodes and edges; sharded placements.
Without one, the one-device policy: f32 weights and moments, plain CE.

The paper's own architecture, ``BCArch`` (``mfbc_paper``): its
one-device step is ``mfbc_batch`` over a ``DenseAdj`` (the Hopper
products on the card), its mesh step the Theorem 5.1 step of
``core.dist_bc`` at the cell's fixed iteration count.

The reference's concrete arguments draw the weights from a key and the
GNN and recsys inputs from ``np.random.default_rng`` (the key unused).
Here ``concrete_args(generator, device)`` draws both from the
generator's stream on its device (a full ``ogb_products`` batch is
245 M normals), and ``GNNArch.numpy_batch`` / ``RecsysArch.numpy_args``
build the reference's numpy inputs exactly, so that the tests feed both
packages the same ones (``batch_to_torch`` places them).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.graphs.sampler import SamplerSpec
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding.rules import (NO_SHARDING, ShardingPolicy, abstract,
                                        scope)
from repro_torch.train.train_lib import value_and_grad


@dataclasses.dataclass(frozen=True)
class Cell:
    shape_id: str
    kind: str  # train | prefill | decode | serve | retrieval
    batch: int
    seq: int = 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    trip_counts: Dict[str, int]
    model_flops: float
    # (generator, device="cuda") -> args, drawn from the generator's stream
    concrete_args: Optional[Callable] = None
    check: Optional[Callable] = None  # outputs -> None (smoke assertions)
    # () -> args, uninitialized (``sharding.abstract``), placed by the policy
    abstract_args: Optional[Callable] = None


class ArchSpec:
    arch_id: str = ""
    family: str = ""

    def config(self, smoke: bool = False):
        raise NotImplementedError

    def cells(self) -> Dict[str, Cell]:
        raise NotImplementedError

    def build(self, cell: Cell, policy: ShardingPolicy = NO_SHARDING,
              smoke: bool = False) -> StepBundle:
        raise NotImplementedError


def _batch_sharding(policy: ShardingPolicy, shape):
    return policy.named_for_shape(("batch",) + (None,) * (len(shape) - 1),
                                  shape)


# ---------------------------------------------------------------------------
# LM family.
# ---------------------------------------------------------------------------

LM_CELLS = {
    "train_4k": Cell("train_4k", "train", batch=256, seq=4096),
    "prefill_32k": Cell("prefill_32k", "prefill", batch=32, seq=32768),
    "decode_32k": Cell("decode_32k", "decode", batch=128, seq=32768),
    "long_500k": Cell("long_500k", "decode", batch=1, seq=524288),
}

LM_SMOKE_CELLS = {
    "train_4k": Cell("train_4k", "train", batch=2, seq=64),
    "prefill_32k": Cell("prefill_32k", "prefill", batch=2, seq=64),
    "decode_32k": Cell("decode_32k", "decode", batch=2, seq=64),
    "long_500k": Cell("long_500k", "decode", batch=1, seq=128),
}


def _check_logits(out) -> None:
    logits, _ = out
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")


def _check_loss(out) -> None:
    _, _, m = out
    if not bool(torch.isfinite(m["loss"])):
        raise AssertionError(f"non-finite loss: {m}")


class LMArch(ArchSpec):
    family = "lm"

    def __init__(self, arch_id: str,
                 full_cfg: Callable[[], T.TransformerConfig],
                 smoke_cfg: Callable[[], T.TransformerConfig]):
        self.arch_id = arch_id
        self._full = full_cfg
        self._smoke = smoke_cfg

    def config(self, smoke: bool = False) -> T.TransformerConfig:
        return self._smoke() if smoke else self._full()

    def cells(self) -> Dict[str, Cell]:
        return LM_CELLS

    def build(self, cell: Cell, policy: ShardingPolicy = NO_SHARDING,
              smoke: bool = False, layers_override: int = 0) -> StepBundle:
        cfg = self.config(smoke)
        if layers_override:
            cfg = dataclasses.replace(cfg, n_layers=layers_override)
        mesh = policy.mesh is not None
        if mesh:
            # production dtype policy: bf16 params/grads/KV-cache, int8
            # optimizer moments, f32 loss
            cfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        cache_dtype = torch.bfloat16 if mesh else torch.float32
        c = (LM_SMOKE_CELLS if smoke else LM_CELLS)[cell.shape_id]
        B, S = c.batch, c.seq
        n_active = cfg.n_active_params()
        trips = {"while": cfg.n_layers}

        def toks_abstract(shape):
            return abstract(shape, torch.long, _batch_sharding(policy, shape))

        def tokens(generator, shape, device):
            return torch.randint(0, cfg.vocab, shape, generator=generator,
                                 device=generator.device).to(device)

        if c.kind == "train":
            opt_cfg = adamw.AdamWConfig(
                moment_dtype="int8" if mesh else "f32")
            ce_chunks = 8 if mesh else 1

            def step(params, opt_state, toks, targets):
                """One AdamW step on the stacked tree ``params``, updated
                in place with ``opt_state`` (the reference donates both)."""
                with scope(policy):
                    loss, grads = value_and_grad(
                        lambda p: T.loss_fn((cfg, p), toks, targets, policy,
                                            chunks=ce_chunks), params)
                    params, opt_state, metrics = adamw.update(
                        opt_cfg, grads, opt_state, params)
                return params, opt_state, {"loss": loss, **metrics}

            def abstract_args():
                p = T.abstract_params(cfg, policy)
                return (p, adamw.abstract_state(p, opt_cfg.moment_dtype),
                        toks_abstract((B, S)), toks_abstract((B, S)))

            def concrete(generator, device="cuda"):
                p = T.init_tree(cfg, generator, device)
                dev = next(iter(p.values())).device
                toks = tokens(generator, (B, S), dev)
                return (p, adamw.init_state(p, opt_cfg.moment_dtype), toks,
                        toks)

            return StepBundle(step, trips, 6.0 * n_active * B * S,
                              concrete_args=concrete, check=_check_loss,
                              abstract_args=abstract_args)

        def abstract_cache():
            return T.cache_abstract(cfg, B, S, policy, dtype=cache_dtype)

        if c.kind == "prefill":
            def step(model, toks, cache):
                with torch.no_grad():
                    return T.prefill(model, toks, cache, policy)

            def abstract_args():
                return ((cfg, T.abstract_params(cfg, policy)),
                        toks_abstract((B, S)), abstract_cache())

            def concrete(generator, device="cuda"):
                model = T.init_params(cfg, generator, device)
                return (model, tokens(generator, (B, S), model.device),
                        T.init_cache(cfg, B, S, device=model.device))

            return StepBundle(step, trips, 2.0 * n_active * B * S,
                              concrete_args=concrete, check=_check_logits,
                              abstract_args=abstract_args)

        # decode
        def step(model, token, pos, cache):
            with torch.no_grad():
                return T.decode_step(model, token, pos, cache, policy)

        def abstract_args():
            return ((cfg, T.abstract_params(cfg, policy)),
                    toks_abstract((B, 1)), S // 2, abstract_cache())

        def concrete(generator, device="cuda"):
            model = T.init_params(cfg, generator, device)
            return (model, tokens(generator, (B, 1), model.device), S // 2,
                    T.init_cache(cfg, B, S, device=model.device))

        # decode attention also reads O(B·S·kv·hd) cache bytes; FLOPs are
        # 2·N_active per token + attention dot 4·B·S·K·hd·g
        attn_flops = 4.0 * B * S * cfg.n_kv * cfg.hd * (cfg.n_heads // cfg.n_kv)
        return StepBundle(step, trips,
                          2.0 * n_active * B + cfg.n_layers * attn_flops,
                          concrete_args=concrete, check=_check_logits,
                          abstract_args=abstract_args)


# ---------------------------------------------------------------------------
# GNN family.
# ---------------------------------------------------------------------------

GNN_CELLS = {
    "full_graph_sm": Cell("full_graph_sm", "train", batch=1,
                          meta=dict(n=2708, e=10556, d=1433, classes=7)),
    "minibatch_lg": Cell("minibatch_lg", "train", batch=1024,
                         meta=dict(n=232965, e=114615892, d=602, classes=41,
                                   fanout=(15, 10))),
    "ogb_products": Cell("ogb_products", "train", batch=1,
                         meta=dict(n=2449029, e=61859140, d=100, classes=47)),
    "molecule": Cell("molecule", "train", batch=128,
                     meta=dict(n=30, e=64, d=16, classes=2)),
}

GNN_SMOKE_META = {
    "full_graph_sm": dict(n=60, e=240, d=32, classes=7),
    "minibatch_lg": dict(n=200, e=800, d=16, classes=5, fanout=(3, 2),
                         batch=8),
    "ogb_products": dict(n=120, e=480, d=12, classes=4),
    "molecule": dict(n=6, e=12, d=8, classes=2, batch=4),
}


def batch_to_torch(batch: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """A numpy batch (``GNNArch.numpy_batch``) as tensors on ``device``:
    ids as int64, what ``gather`` and ``scatter_reduce_`` take; ints
    (``n_graphs``) stay ints."""
    dev = resolve_device(device)
    if "x" in batch:
        G.check_indices(batch, batch["x"].shape[0])
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            t = torch.from_numpy(np.array(v))
            out[k] = (t.long() if v.dtype.kind in "iu" else t).to(dev)
        else:
            out[k] = v
    return out


class GNNArch(ArchSpec):
    family = "gnn"

    def __init__(self, arch_id: str, kind: str, full_hp: Dict[str, Any],
                 smoke_hp: Dict[str, Any]):
        self.arch_id = arch_id
        self.kind = kind  # gcn | gin | gat | nequip
        self.full_hp = full_hp
        self.smoke_hp = smoke_hp

    def config(self, smoke: bool = False, **dims):
        hp = dict(self.smoke_hp if smoke else self.full_hp)
        hp.update(dims)
        cls = {"gcn": G.GCNConfig, "gin": G.GINConfig, "gat": G.GATConfig,
               "nequip": G.NequIPConfig}[self.kind]
        return cls(name=self.arch_id, **hp)

    def cells(self) -> Dict[str, Cell]:
        return GNN_CELLS

    def meta(self, shape_id: str, smoke: bool = False) -> Dict[str, Any]:
        return dict(GNN_SMOKE_META[shape_id] if smoke
                    else GNN_CELLS[shape_id].meta)

    def _layout(self, shape_id: str, meta):
        """The padded graph batch of a cell, unsharded: ``(fields, n1, E,
        n_graphs)``, ``fields`` mapping each array to ``(shape, what)`` in
        the reference's order (its draws from one stream follow it)."""
        if shape_id == "minibatch_lg":
            spec = SamplerSpec(meta.get("batch", 1024), tuple(meta["fanout"]))
            n1, E = spec.node_budget + 1, spec.edge_budget
        elif shape_id == "molecule":
            bsz = meta.get("batch", 128)
            n1, E = bsz * meta["n"] + 1, bsz * meta["e"]
        else:
            n1, E = meta["n"] + 1, meta["e"]
        f = {"x": ((n1, meta["d"]), "normal"), "src": ((E,), "node"),
             "dst": ((E,), "node"), "labels": ((n1,), "label")}
        if self.kind == "gcn":
            f["deg"] = ((n1,), "normal")  # drawn, then replaced by degrees
        if self.kind == "gat":
            f["edge_pad"] = ((E,), "pad")
        if self.kind == "nequip":
            f["pos"] = ((n1, 3), "normal")
        n_graphs = None
        if shape_id == "molecule":
            n_graphs = meta.get("batch", 128) + 1
            f["graph_ids"] = ((n1,), "graph_ids")
            f["labels"] = ((n_graphs,), "label")
        return f, n1, E, n_graphs

    @staticmethod
    def _graph_ids(n1: int, meta) -> np.ndarray:
        """Node → graph of a molecule batch; the dummy node (and any
        remainder) in the extra graph ``batch``."""
        per = (n1 - 1) // meta.get("batch", 1)
        return np.minimum(np.arange(n1) // max(per, 1), meta.get("batch", 1))

    def numpy_batch(self, shape_id: str, smoke: bool = False
                    ) -> Dict[str, np.ndarray]:
        """The reference's concrete batch of the cell, exactly: its
        ``np.random.default_rng(0)`` draws in its order and dtypes."""
        meta = self.meta(shape_id, smoke)
        fields, n1, _, _ = self._layout(shape_id, meta)
        rng = np.random.default_rng(0)
        b = {}
        for k, (shape, what) in fields.items():
            if what == "label":
                b[k] = rng.integers(0, meta["classes"], shape).astype(np.int32)
            elif what == "node":
                b[k] = rng.integers(0, n1 - 1, shape).astype(np.int32)
            elif what == "graph_ids":
                b[k] = self._graph_ids(n1, meta).astype(np.int32)
            elif what == "pad":
                b[k] = np.zeros(shape, bool)
            else:
                b[k] = rng.normal(size=shape).astype(np.float32)
        if self.kind == "gcn":
            b["deg"] = np.bincount(b["dst"], minlength=n1).astype(np.float32)
        return b

    def torch_batch(self, shape_id: str, generator: torch.Generator,
                    smoke: bool = False, device="cuda") -> Dict[str, Any]:
        """A batch of the cell's layout drawn from ``generator``'s stream
        on its device (normals, uniform node ids and labels), int64 ids,
        then placed on ``device``."""
        dev = resolve_device(device)
        meta = self.meta(shape_id, smoke)
        fields, n1, _, _ = self._layout(shape_id, meta)
        g, gd = generator, generator.device
        b = {}
        for k, (shape, what) in fields.items():
            if what in ("label", "node"):
                hi = meta["classes"] if what == "label" else n1 - 1
                b[k] = torch.randint(0, hi, shape, generator=g, device=gd)
            elif what == "graph_ids":
                b[k] = torch.from_numpy(self._graph_ids(n1, meta)).to(gd)
            elif what == "pad":
                b[k] = torch.zeros(shape, dtype=torch.bool, device=gd)
            elif k != "deg":
                b[k] = torch.randn(shape, generator=g, device=gd)
        if self.kind == "gcn":
            b["deg"] = torch.bincount(b["dst"], minlength=n1).float()
        return {k: v.to(dev) for k, v in b.items()}

    def _flops(self, meta, n1, E) -> float:
        d = meta["d"]
        if self.kind == "gcn":
            h = self.full_hp.get("d_hidden", 16)
            L = self.full_hp.get("n_layers", 2)
            fwd = 2.0 * (n1 * d * h + E * h) * L
        elif self.kind == "gin":
            h = self.full_hp.get("d_hidden", 64)
            L = self.full_hp.get("n_layers", 5)
            fwd = 2.0 * L * (E * h + 2 * n1 * h * h) + 2.0 * n1 * d * h
        elif self.kind == "gat":
            h = self.full_hp.get("d_hidden", 8) * self.full_hp.get("n_heads",
                                                                  8)
            L = self.full_hp.get("n_layers", 2)
            fwd = 2.0 * L * (n1 * d * h + 3 * E * h)
        else:  # nequip
            C = self.full_hp.get("channels", 32)
            L = self.full_hp.get("n_layers", 5)
            fwd = 2.0 * L * (E * C * (9 + 13 * 6) + 3 * n1 * C * C * 13)
        return 3.0 * fwd  # train ~ 3x forward

    def cell_config(self, shape_id: str, smoke: bool = False):
        """The model config of a cell: its input width and classes (a
        NequIP node head off the molecule cell, an energy on it)."""
        meta = self.meta(shape_id, smoke)
        is_mol = shape_id == "molecule"
        return self.config(
            smoke, d_in=meta["d"],
            **({"n_out": meta["classes"], "readout": "node"}
               if self.kind == "nequip" and not is_mol else
               {"n_out": 1} if self.kind == "nequip" else
               {"n_classes": meta["classes"]}))

    # the logical axes of each batch field (the reference's shardings)
    _FIELD_AXES = {"x": ("model", None), "pos": ("model", None),
                   "src": ("batch",), "dst": ("batch",),
                   "edge_pad": ("batch",), "labels": ("model",),
                   "deg": ("model",), "graph_ids": ("model",)}
    _FIELD_DTYPE = {"x": torch.float32, "pos": torch.float32,
                    "deg": torch.float32, "edge_pad": torch.bool}

    def abstract_batch(self, shape_id: str, policy: ShardingPolicy,
                       smoke: bool = False):
        """The cell's batch uninitialized (``sharding.abstract``): under a
        mesh nodes and edges padded to multiples of 512 (padding nodes are
        isolated; padding edges hit the dummy slot), each field placed as
        the reference's; ids int64. Returns ``(batch, n1, E)``; a molecule
        batch's ``n_graphs`` is left to the step, as a static int."""
        meta = self.meta(shape_id, smoke)
        fields, n1, E, n_graphs = self._layout(shape_id, meta)
        if policy.mesh is not None:
            n1, E = -(-n1 // 512) * 512, -(-E // 512) * 512
        b = {}
        for k, (shape, _) in fields.items():
            logical = self._FIELD_AXES[k]
            if k == "labels" and n_graphs is not None:
                logical = (None,)  # one label a graph, unsharded
            elif logical[0] == "batch":
                shape = (E,) + shape[1:]
            else:
                shape = (n1,) + shape[1:]
            b[k] = abstract(shape, self._FIELD_DTYPE.get(k, torch.long),
                            policy.named(logical))
        return b, n1, E

    def build(self, cell: Cell, policy: ShardingPolicy = NO_SHARDING,
              smoke: bool = False) -> StepBundle:
        meta = self.meta(cell.shape_id, smoke)
        is_mol = cell.shape_id == "molecule"
        cfg = self.cell_config(cell.shape_id, smoke)
        opt_cfg = adamw.AdamWConfig(weight_decay=0.0)
        _, n1, E, static_ng = self._layout(cell.shape_id, meta)
        if policy.mesh is not None:
            n1, E = -(-n1 // 512) * 512, -(-E // 512) * 512

        def loss(params, batch):
            if static_ng is not None:
                batch = dict(batch, n_graphs=static_ng)
            if self.kind == "nequip" and is_mol:
                e = G.nequip_forward(cfg, params, batch)[:, 0]
                lbl = batch["labels"].to(e.dtype)
                return torch.mean(torch.square(e - lbl))
            logits = G.FORWARD[self.kind](cfg, params, batch)
            if is_mol and logits.shape[0] != batch["labels"].shape[0]:
                # graph classification: pool node logits (GIN pools itself)
                logits = G._seg_sum(logits, batch["graph_ids"],
                                    batch["n_graphs"])
            logz = torch.logsumexp(logits, dim=-1)
            return torch.mean(logz - _label_logit(logits, batch["labels"]))

        def step(params, opt_state, batch):
            """One AdamW step, ``params`` and ``opt_state`` updated in
            place (the reference donates both)."""
            with scope(policy):
                lv, grads = value_and_grad(loss, params, batch)
                params, opt_state, metrics = adamw.update(opt_cfg, grads,
                                                          opt_state, params)
            return params, opt_state, {"loss": lv, **metrics}

        def concrete(generator, device="cuda"):
            p = G.INIT[self.kind](cfg, generator, device)
            return (p, adamw.init_state(p),
                    self.torch_batch(cell.shape_id, generator, smoke, device))

        def abstract_args():
            """Replicated parameters (the reference's unsharded ones), the
            state, the placed batch."""
            p = G.INIT[self.kind](cfg, torch.Generator().manual_seed(0),
                                  "cpu")
            p = _tree_abstract(p, policy)
            return (p, adamw.abstract_state(p),
                    self.abstract_batch(cell.shape_id, policy, smoke)[0])

        return StepBundle(step, {}, self._flops(meta, n1, E),
                          concrete_args=concrete, check=_check_loss,
                          abstract_args=abstract_args)


# ---------------------------------------------------------------------------
# RecSys family (xDeepFM).
# ---------------------------------------------------------------------------

RECSYS_CELLS = {
    "train_batch": Cell("train_batch", "train", batch=65536),
    "serve_p99": Cell("serve_p99", "serve", batch=512),
    "serve_bulk": Cell("serve_bulk", "serve", batch=262144),
    "retrieval_cand": Cell("retrieval_cand", "retrieval", batch=1,
                           meta=dict(n_candidates=1_000_000)),
}

RECSYS_SMOKE_CELLS = {
    "train_batch": Cell("train_batch", "train", batch=32),
    "serve_p99": Cell("serve_p99", "serve", batch=8),
    "serve_bulk": Cell("serve_bulk", "serve", batch=64),
    "retrieval_cand": Cell("retrieval_cand", "retrieval", batch=1,
                           meta=dict(n_candidates=512)),
}


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each row's logit at its label. Over DTensors a select-and-sum (the
    gathered value exactly, for finite logits): DTensor's gather along a
    sharded dim cannot reduce its partial result."""
    if not G._sharded(logits, labels):
        return torch.gather(logits, 1, labels.long()[:, None])[:, 0]
    classes = torch.arange(logits.shape[-1], device=labels.device)
    return torch.where(classes == labels.long()[:, None], logits, 0.0).sum(-1)


def _tree_abstract(tree, policy: ShardingPolicy):
    """``tree``'s leaves as uninitialized tensors of their shapes and
    dtypes, replicated under a mesh."""
    from repro_torch import tree as tree_lib

    return tree_lib.tree_map(
        lambda t: abstract(tuple(t.shape), t.dtype,
                           policy.named((None,) * t.ndim)), tree)


def _check_finite(out) -> None:
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("non-finite outputs")


class RecsysArch(ArchSpec):
    family = "recsys"
    arch_id = "xdeepfm"

    def config(self, smoke: bool = False) -> R.XDeepFMConfig:
        if smoke:
            return R.XDeepFMConfig("xdeepfm-smoke", n_fields=6,
                                   vocab_per_field=50, embed_dim=8,
                                   cin_layers=(8, 8), mlp_layers=(16, 16))
        return R.XDeepFMConfig("xdeepfm", n_fields=39,
                               vocab_per_field=1_000_000, embed_dim=10,
                               cin_layers=(200, 200, 200),
                               mlp_layers=(400, 400))

    def cells(self) -> Dict[str, Cell]:
        return RECSYS_CELLS

    def _shapes(self, cfg: R.XDeepFMConfig, shape_id: str, smoke: bool):
        """The (shape, bound) of each id / label input of a cell, in the
        reference's order of draws, and its seed."""
        c = (RECSYS_SMOKE_CELLS if smoke else RECSYS_CELLS)[shape_id]
        V, F = cfg.total_vocab, cfg.n_fields
        if c.kind == "train":
            return [((c.batch, F, 1), V), ((c.batch,), 2)], 0
        if c.kind == "serve":
            return [((c.batch, F, 1), V)], 1
        return [((1, F, 1), V), ((c.meta["n_candidates"], F, 1), V)], 2

    def numpy_args(self, shape_id: str, smoke: bool = False):
        """The reference's concrete inputs of the cell (all but the
        parameters and the optimizer state), exactly: ids int32, train
        labels float32."""
        cfg = self.config(smoke)
        shapes, seed = self._shapes(cfg, shape_id, smoke)
        rng = np.random.default_rng(seed)
        out = [rng.integers(0, hi, shape) for shape, hi in shapes]
        return [a.astype(np.float32 if a.ndim == 1 else np.int32)
                for a in out]

    def build(self, cell: Cell, policy: ShardingPolicy = NO_SHARDING,
              smoke: bool = False) -> StepBundle:
        cfg = self.config(smoke)
        c = (RECSYS_SMOKE_CELLS if smoke else RECSYS_CELLS)[cell.shape_id]
        B = c.batch
        # fwd flops: CIN dominates: 2 sum_k (B H_k m D + B H_k m D H_{k+1})
        m, D = cfg.n_fields, cfg.embed_dim
        prev = m
        fl = 0.0
        for h in cfg.cin_layers:
            fl += 2.0 * B * prev * m * D * (1 + h)
            prev = h
        d_mlp = m * D
        for h in cfg.mlp_layers:
            fl += 2.0 * B * d_mlp * h
            d_mlp = h
        shapes, _ = self._shapes(cfg, cell.shape_id, smoke)

        def abstract_args():
            """The placed parameters (and state), ids int64 over the batch
            axes (a retrieval query replicated), train labels f32."""
            p = R.abstract_params(cfg, policy)
            ins = []
            for shape, _ in shapes:
                logical = (("batch",) + (None,) * (len(shape) - 1)
                           if shape[0] > 1 else (None,) * len(shape))
                ins.append(abstract(shape, torch.float32 if len(shape) == 1
                                    else torch.long,
                                    policy.named(logical)))
            return ((p, adamw.abstract_state(p)) if c.kind == "train"
                    else (p,)) + tuple(ins)

        def concrete(generator, device="cuda"):
            """Parameters (and the train cell's optimizer state) and the
            cell's inputs, drawn from ``generator`` on its device: ids
            int64, labels float32."""
            p = R.init_params(cfg, generator, device)
            dev = resolve_device(device)
            ins = [torch.randint(0, hi, shape, generator=generator,
                                 device=generator.device) for shape, hi in
                   shapes]
            ins = [(a.float() if a.ndim == 1 else a).to(dev) for a in ins]
            return ((p, adamw.init_state(p)) if c.kind == "train"
                    else (p,)) + tuple(ins)

        if c.kind == "train":
            opt_cfg = adamw.AdamWConfig(weight_decay=0.0)

            def step(params, opt_state, ids, labels):
                """One AdamW step, in place (the reference donates
                ``params`` and ``opt_state``)."""
                with scope(policy):
                    lv, grads = value_and_grad(
                        lambda p: R.bce_loss(cfg, p, ids, labels, policy),
                        params)
                    params, opt_state, metrics = adamw.update(
                        opt_cfg, grads, opt_state, params)
                return params, opt_state, {"loss": lv, **metrics}

            return StepBundle(step, {}, 3.0 * fl, concrete_args=concrete,
                              check=_check_loss, abstract_args=abstract_args)

        if c.kind == "serve":
            def step(params, ids):
                with torch.no_grad(), scope(policy):
                    return R.forward(cfg, params, ids, policy)

            return StepBundle(step, {}, fl, concrete_args=concrete,
                              check=_check_finite,
                              abstract_args=abstract_args)

        N = c.meta["n_candidates"]

        def step(params, qids, cids):
            with torch.no_grad(), scope(policy):
                return R.retrieval_score(cfg, params, qids, cids, policy)

        fl_ret = 2.0 * N * (cfg.n_fields * cfg.embed_dim + cfg.embed_dim)
        return StepBundle(step, {}, fl_ret, concrete_args=concrete,
                          check=_check_finite, abstract_args=abstract_args)


# ---------------------------------------------------------------------------
# The paper's own architecture: MFBC batch step.
# ---------------------------------------------------------------------------

BC_CELLS = {
    "bc_web_256k": Cell("bc_web_256k", "train", batch=8192,
                        meta=dict(n=262144, iters=8)),
    "bc_dense_64k": Cell("bc_dense_64k", "train", batch=16384,
                         meta=dict(n=65536, iters=6)),
}

BC_SMOKE_CELLS = {
    "bc_web_256k": Cell("bc_web_256k", "train", batch=8,
                        meta=dict(n=48, iters=6)),
    "bc_dense_64k": Cell("bc_dense_64k", "train", batch=12,
                         meta=dict(n=32, iters=5)),
}


def dense_from_graph_on(g, device) -> torch.Tensor:
    """``graphs.formats.coo_to_dense(g)`` built on ``device`` from the
    arcs: ``inf`` off-structure, the min over duplicate arcs, an ``inf``
    diagonal; no dense array on the host."""
    n = g.n
    a = torch.full((n * n,), float("inf"), dtype=torch.float32,
                   device=device)
    src = torch.from_numpy(np.asarray(g.src, np.int64)).to(device)
    dst = torch.from_numpy(np.asarray(g.dst, np.int64)).to(device)
    w = torch.from_numpy(np.asarray(g.w, np.float32)).to(device)
    a.scatter_reduce_(0, src * n + dst, w, reduce="amin")
    a = a.view(n, n)
    a.diagonal().fill_(float("inf"))
    return a


def _check_lambda(lam) -> None:
    if not bool(torch.isfinite(lam).all()):
        raise AssertionError("non-finite λ")
    if not bool((lam >= -1e-6).all()):
        raise AssertionError(f"negative λ: {float(lam.min())}")


class BCArch(ArchSpec):
    """MFBC itself: one device's dense batch step, or the Theorem 5.1 step
    on the production mesh."""

    family = "bc"
    arch_id = "mfbc_paper"

    def config(self, smoke: bool = False):
        return {"use_kernel": not smoke}

    def cells(self) -> Dict[str, Cell]:
        return BC_CELLS

    def build(self, cell: Cell, policy: ShardingPolicy = NO_SHARDING,
              smoke: bool = False) -> StepBundle:
        """Under a mesh, the per-rank ``core.dist_bc`` step at the cell's
        fixed iteration count, no stop test (the reference's
        ``unroll=True`` lowering): its abstract arguments are this rank's
        blocks. Without one, ``mfbc_batch`` over ``DenseAdj(a, block=256)``,
        ``fori`` at the cell's ``iters``; the sources are the caller's
        (``concrete_args(..., nb=)`` cuts the batch)."""
        c = (BC_SMOKE_CELLS if smoke else BC_CELLS)[cell.shape_id]
        n, nb, iters = c.meta["n"], c.batch, c.meta["iters"]
        flops = self._flops(n, nb, iters)

        if policy.mesh is not None:
            from repro_torch.core import dist_bc
            from repro_torch.launch.mesh import Mesh

            dm = policy.mesh
            mesh = Mesh(tuple(dm.shape), tuple(dm.mesh_dim_names),
                        device=dm.device_type)
            pod = "pod" if "pod" in dm.mesh_dim_names else None
            cfg = dist_bc.BCMeshConfig(n=n, nb=nb, iters_bf=iters,
                                       iters_br=iters, pod_axis=pod,
                                       unroll=True)
            step = dist_bc.build_mfbc_step(mesh, cfg)
            shp = dist_bc.local_shapes(mesh, cfg)

            def abstract_args():
                dev = mesh.device
                return (torch.empty(shp["a"], device=dev),
                        torch.empty(shp["at"], device=dev),
                        torch.empty(shp["sources"], dtype=torch.int32,
                                    device=dev),
                        torch.empty(shp["valid"], dtype=torch.bool,
                                    device=dev))

            return StepBundle(step, {}, flops, abstract_args=abstract_args)

        from repro_torch.core.adjacency import DenseAdj
        from repro_torch.core.mfbc import mfbc_batch

        def step(a, sources, valid):
            with torch.no_grad():
                return mfbc_batch(DenseAdj(a, block=256), sources, valid,
                                  iterate="fori", max_iters_bf=iters,
                                  max_iters_br=iters)[0]

        def concrete(generator=None, device="cuda", nb: int = nb):
            """A on ``device`` from ``erdos_renyi(n, 4/n, seed=1)``'s arcs
            (``dense_from_graph_on``), sources ``0..nb-1``, all valid."""
            from repro_torch.graphs.generators import erdos_renyi

            dev = resolve_device(device)
            g = erdos_renyi(n, 4.0 / n, seed=1)
            return (dense_from_graph_on(g, dev),
                    torch.arange(nb, dtype=torch.int32, device=dev),
                    torch.ones(nb, dtype=torch.bool, device=dev))

        def abstract_args():
            return (torch.empty((n, n)), torch.empty((nb,), dtype=torch.int32),
                    torch.empty((nb,), dtype=torch.bool))

        return StepBundle(step, {"while": iters}, flops,
                          concrete_args=concrete, check=_check_lambda,
                          abstract_args=abstract_args)

    @staticmethod
    def _flops(n, nb, iters):
        # each relax: nb*n*n candidate min-plus updates (~4 vector flops),
        # 2(d+1) relaxes per batch (MFBF + MFBr)
        return 4.0 * nb * n * n * 2 * (iters + 1)
