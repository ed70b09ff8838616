"""The port's sharding rules (``repro_torch.sharding``) against the
reference's (``repro.sharding.rules``).

* For every architecture's logical trees — the LM parameters and KV
  caches, the activations the model code constrains, xDeepFM's
  parameters and inputs, the GNN batch fields — on the (16, 16) and
  (2, 16, 16) production meshes, under ``make_policy``'s rules (with and
  without sequence sharding, and the qwen3ep overrides), ``spec`` and
  ``spec_for_shape`` equal the reference's ``PartitionSpec``s. The
  reference's side is built on ``jax.sharding.AbstractMesh`` and the
  port's on its ``AbstractMesh``: no devices are needed.
* DTensor placements round-trip to the same spec (``placements_for`` /
  ``spec_of``), and a spec that claims a mesh dim twice or out of order
  raises.
* On a one-rank gloo (1, 1, 1) ``DeviceMesh``: ``abstract`` holds a shard
  of its own storage, ``place`` / ``constrain`` / ``replicate_over`` keep
  the values, ``NO_SHARDING.constrain`` is the identity.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs import base
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.sharding.rules import (NO_SHARDING, AbstractMesh, abstract,
                                        make_policy, place, placements_for,
                                        replicate_over, spec_of)

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"plain": {}, "seq": {"seq_shard": True},
            "qwen3ep": {"overrides": {"expert": ("pod", "model"),
                                      "fsdp": ("data",)}}}


def _pairs(logical, shapes):
    """(logical, shape) of each leaf of two trees of the same structure."""
    if isinstance(logical, dict):
        for k in logical:
            yield from _pairs(logical[k], shapes[k])
    elif isinstance(logical, list):
        for a, b in zip(logical, shapes):
            yield from _pairs(a, b)
    else:
        yield logical, tuple(shapes)


def cases(arch_id: str):
    """Every (logical, shape) the architecture's code places or
    constrains, at its cells' full sizes."""
    spec = get_arch(arch_id)
    out = []
    if spec.family == "lm":
        cfg = spec.config()
        for m in (1, 16):
            out += _pairs(T.param_logical_axes(cfg, m), T.param_shapes(cfg))
        for c in base.LM_CELLS.values():
            B, S = c.batch, c.seq
            out += [(("batch", "seq", None), (B, S, cfg.d_model)),
                    (("batch", None, "vocab"), (B, S, cfg.vocab)),
                    (("batch", None), (B, S))]
            for m in (1, 16):
                pol = make_policy(AbstractMesh((16, m), ("data", "model")))
                out.append((T._cache_logical(cfg, B, pol),
                            (cfg.n_layers, B, S, cfg.n_kv, cfg.hd)))
        if cfg.moe is not None:
            out.append((("expert", "batch", None),
                        (cfg.moe.n_experts, 4096, cfg.d_model)))
    elif spec.family == "recsys":
        cfg = spec.config()
        shapes = R.init_shapes(cfg)

        def walk(t):
            if isinstance(t, dict):
                for v in t.values():
                    yield from walk(v)
            elif isinstance(t, list):
                for v in t:
                    yield from walk(v)
            else:
                yield t[1], t[0]

        out += walk(shapes)
        for c in base.RECSYS_CELLS.values():
            out += [(("batch", None, None), (c.batch, cfg.n_fields, 1)),
                    (("batch",), (c.batch,)), (("batch", None), (c.batch, 10))]
    elif spec.family == "gnn":
        for sid in base.GNN_CELLS:
            meta = spec.meta(sid)
            fields, n1, E, _ = spec._layout(sid, meta)
            for k, (shape, _) in fields.items():
                logical = spec._FIELD_AXES[k]
                out.append((logical, ((E if logical[0] == "batch" else
                                       -(-n1 // 512) * 512),) + shape[1:]))
    else:  # bc: the abstract args are per-rank blocks, not placed by rules
        out.append((("batch", None), (16384, 65536)))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_specs_match_reference(arch, mesh):
    from jax.sharding import AbstractMesh as JAbstractMesh

    from repro.sharding.rules import make_policy as jmake_policy

    shape, names = MESHES[mesh]
    n = 0
    for var, kw in VARIANTS.items():
        ours = make_policy(AbstractMesh(shape, names), **kw)
        theirs = jmake_policy(JAbstractMesh(shape, names), **kw)
        assert ours.model_size == theirs.model_size
        for logical, dims in cases(arch):
            want = tuple(theirs.spec_for_shape(logical, dims))
            assert ours.spec_for_shape(logical, dims) == want, \
                (var, logical, dims)
            assert ours.spec(logical) == tuple(theirs.spec(logical)), \
                (var, logical)
            n += 1
    assert n > 0


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_round_trip(mesh):
    shape, names = MESHES[mesh]
    pol = make_policy(AbstractMesh(shape, names), seq_shard=True)
    seen = 0
    for arch in ARCHS:
        for logical, dims in cases(arch):
            spec = pol.spec_for_shape(logical, dims)
            pl = placements_for(spec, names)
            assert len(pl) == len(names)
            assert spec_of(pl, names, len(dims)) == spec
            seen += any(p.is_shard() for p in pl)
    assert seen
    with pytest.raises(ValueError, match="claimed twice"):
        placements_for(("model", "model"), names)
    with pytest.raises(ValueError, match="mesh order"):
        placements_for((("model", "data"),), names)
    with pytest.raises(ValueError, match="not a dim"):
        placements_for(("nope",), names)
    with pytest.raises(ValueError, match="DeviceMesh"):
        pol.named(("batch",))


def test_no_sharding_is_the_identity():
    x = torch.arange(6.0).reshape(2, 3)
    assert NO_SHARDING.constrain(x, ("batch", None)) is x
    assert NO_SHARDING.named(("batch",)) is None
    assert NO_SHARDING.model_size == 1
    assert make_policy(None) is NO_SHARDING


def test_place_and_constrain_on_one_rank():
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch.mesh import make_device_mesh

    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"),
                                device_type="cpu")
        pol = make_policy(mesh)
        sh = pol.named_for_shape(("batch", "model"), (4, 6))
        assert sh.placements == (Shard(0), Shard(0), Shard(1))
        a = abstract((4, 6), torch.float32, sh)
        assert isinstance(a, DTensor) and a.shape == (4, 6)
        assert a.to_local().untyped_storage().nbytes() == 4 * 24
        x = torch.arange(24.0).reshape(4, 6)
        d = place(x, sh)
        assert d.placements == sh.placements
        np.testing.assert_array_equal(d.full_tensor().numpy(), x.numpy())
        r = pol.constrain(d, (None, None))
        assert r.placements == (Replicate(),) * 3
        g = replicate_over(d, ("pod", "data"))
        assert g.placements == (Replicate(), Replicate(), Shard(1))
        assert replicate_over(x, ("pod",)) is x
    finally:
        dist.destroy_process_group()
