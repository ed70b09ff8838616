"""The port's GNNs (``repro_torch.models.gnn``) against ``repro.models.gnn``.

Each family's forward on the same small graph (built from a seed with
numpy: real edges, self-loops, and padding edges on the dummy node n),
with the reference's parameters carried bit for bit by
``params_from_reference``: GAT with an ``edge_pad`` mask, NequIP with
zero-length edges (self-loops and the padding), GIN and NequIP with a
``graph_ids`` readout. Tolerances (``tests/test_torch_lm.py``'s
docstring gives their basis): the segment helpers, a layer's functions,
rtol 1e-5, atol 1e-6; a whole model's outputs within 1e-4 of their
largest magnitude; a gradient within 1e-4 of each leaf's largest
magnitude, against ``jax.value_and_grad``. Also: the bitwise parameter
round trip, the init distribution, and NequIP's invariance under random
rotations on both packages (the reference's docstring claims it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import gnn as JG
from repro_torch import tree as tree_lib
from repro_torch.configs.base import batch_to_torch
from repro_torch.models import gnn as G

N, E_REAL, E_PAD, N_GRAPHS = 12, 40, 8, 3
CFGS = {
    "gcn": (G.GCNConfig("gcn", d_in=6, d_hidden=8, n_classes=4),
            JG.GCNConfig("gcn", d_in=6, d_hidden=8, n_classes=4)),
    "gin": (G.GINConfig("gin", n_layers=3, d_in=6, d_hidden=8, n_classes=3),
            JG.GINConfig("gin", n_layers=3, d_in=6, d_hidden=8,
                         n_classes=3)),
    "gat": (G.GATConfig("gat", d_in=6, d_hidden=4, n_heads=3, n_classes=4),
            JG.GATConfig("gat", d_in=6, d_hidden=4, n_heads=3,
                         n_classes=4)),
    "nequip": (G.NequIPConfig("nq", n_layers=2, channels=8, n_rbf=4, d_in=6),
               JG.NequIPConfig("nq", n_layers=2, channels=8, n_rbf=4,
                               d_in=6)),
}
# (kind, readout): node outputs, or pooled per graph through graph_ids
CASES = [("gcn", "node"), ("gin", "node"), ("gin", "graph"), ("gat", "node"),
         ("nequip", "node"), ("nequip", "graph")]


def make_batch(seed: int = 0, graph: bool = False) -> dict:
    """n = 12 nodes and the dummy slot 12: 40 real edges (two of them
    self-loops), 8 padding edges 12 -> 12."""
    rng = np.random.default_rng(seed)
    n1 = N + 1
    src = rng.integers(0, N, E_REAL)
    dst = rng.integers(0, N, E_REAL)
    dst[:2] = src[:2]  # self-loops: zero-length NequIP edges
    src = np.concatenate([src, np.full(E_PAD, N)]).astype(np.int32)
    dst = np.concatenate([dst, np.full(E_PAD, N)]).astype(np.int32)
    b = {"x": rng.normal(size=(n1, 6)).astype(np.float32),
         "src": src, "dst": dst,
         "deg": np.bincount(dst[:E_REAL], minlength=n1).astype(np.float32),
         "edge_pad": np.arange(src.size) >= E_REAL,
         "pos": (2.0 * rng.normal(size=(n1, 3))).astype(np.float32),
         "labels": rng.integers(0, 3, n1).astype(np.int32),
         "label_mask": rng.random(n1) < 0.7,
         "energy": rng.normal(size=N_GRAPHS).astype(np.float32)}
    b["pos"][N] = 0.0
    if graph:
        b["graph_ids"] = np.minimum(np.arange(n1) // 5,
                                    N_GRAPHS - 1).astype(np.int32)
    return b


def both(kind: str, seed: int = 0):
    """(port params, reference params, port cfg, reference cfg)."""
    cfg, jcfg = CFGS[kind]
    jp = JG.INIT[kind](jcfg, jax.random.key(seed))
    return (G.params_from_reference(jax.tree.map(np.asarray, jp), "cpu"),
            jp, cfg, jcfg)


def to_jax(b: dict, graph: bool) -> dict:
    out = {k: jnp.asarray(v) for k, v in b.items()}
    if graph:
        out["n_graphs"] = N_GRAPHS
    return out


def to_port(b: dict, graph: bool) -> dict:
    out = batch_to_torch(b, "cpu")
    if graph:
        out["n_graphs"] = N_GRAPHS
    return out


def close_to_scale(got, want, tol: float = 1e-4, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def test_segment_helpers_match_reference():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(30, 4)).astype(np.float32)
    idx = np.sort(rng.integers(0, 9, 30)).astype(np.int32)
    idx[idx == 4] = 5  # an empty segment: -inf under the max
    xt, it = torch.from_numpy(x), torch.from_numpy(idx).long()
    np.testing.assert_allclose(
        G._seg_sum(xt, it, 10).numpy(),
        np.asarray(JG._seg_sum(jnp.asarray(x), jnp.asarray(idx), 10)),
        rtol=1e-5, atol=1e-6)
    got = G._seg_max(xt, it, 10).numpy()
    want = np.asarray(JG._seg_max(jnp.asarray(x), jnp.asarray(idx), 10))
    np.testing.assert_array_equal(got, want)
    assert np.isneginf(got[4]).all()
    d = np.abs(rng.normal(size=20)).astype(np.float32) * 6
    d[:3] = [0.0, 5.0, 7.5]
    np.testing.assert_allclose(
        G._rbf(torch.from_numpy(d), 8, 5.0).numpy(),
        np.asarray(JG._rbf(jnp.asarray(d), 8, 5.0)), rtol=1e-5, atol=1e-6)


def test_zero_length_edges_are_not_real():
    """d = sqrt(0 + 1e-12) in f32 is not above 1e-6 in either package."""
    z = np.zeros((1, 3), np.float32)
    jd = jnp.sqrt(jnp.sum(jnp.asarray(z) ** 2, axis=-1) + 1e-12)
    td = torch.sqrt(torch.sum(torch.from_numpy(z) ** 2, dim=-1) + 1e-12)
    assert not bool(jd[0] > 1e-6) and not bool(td[0] > 1e-6)
    assert float(jd[0]) == float(td[0])


@pytest.mark.parametrize("kind,readout", CASES)
def test_forward_matches_reference(kind, readout):
    graph = readout == "graph"
    b = make_batch(1, graph)
    if kind != "gat":
        b.pop("edge_pad")
    p, jp, cfg, jcfg = both(kind)
    if kind == "nequip" and not graph:
        cfg = G.NequIPConfig("nq", n_layers=2, channels=8, n_rbf=4, d_in=6,
                             readout="node", n_out=3)
        jcfg = JG.NequIPConfig("nq", n_layers=2, channels=8, n_rbf=4,
                               d_in=6, readout="node", n_out=3)
        jp = JG.nequip_init(jcfg, jax.random.key(0))
        p = G.params_from_reference(jax.tree.map(np.asarray, jp), "cpu")
    want = np.asarray(JG.FORWARD[kind](jcfg, jp, to_jax(b, graph)))
    got = G.FORWARD[kind](cfg, p, to_port(b, graph)).numpy()
    assert got.shape == want.shape == (
        (N_GRAPHS if graph else N + 1),
        {"gcn": 4, "gin": 3, "gat": 4, "nequip": 1 if graph else 3}[kind])
    assert np.isfinite(got).all()
    close_to_scale(got, want, what=f"{kind} {readout}")


def test_gat_padding_edges_are_inert():
    """Padding edges masked by ``edge_pad`` change nothing: the same
    graph without them gives the same real-node outputs."""
    b = make_batch(2)
    p, _, cfg, _ = both("gat")
    full = G.gat_forward(cfg, p, to_port(b, False))
    trim = {k: (v[:E_REAL] if k in ("src", "dst", "edge_pad") else v)
            for k, v in b.items()}
    real = G.gat_forward(cfg, p, to_port(trim, False))
    np.testing.assert_allclose(full[:N].numpy(), real[:N].numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("kind", ["gcn", "gin", "gat"])
def test_node_ce_loss_and_grad_match_reference(kind):
    b = make_batch(4)
    if kind != "gat":
        b.pop("edge_pad")
    p, jp, cfg, jcfg = both(kind, seed=1)
    jl, jg = jax.value_and_grad(
        lambda q: JG.node_ce_loss(kind, jcfg, q, to_jax(b, False)))(jp)
    q = tree_lib.tree_map(lambda t: t.clone().requires_grad_(), p)
    loss = G.node_ce_loss(kind, cfg, q, to_port(b, False))
    pairs = tree_lib.leaves(q)
    grads = torch.autograd.grad(loss, [t for _, t in pairs])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = jax.tree.leaves(jg)
    assert len(want) == len(grads)
    for (path, _), g, w in zip(pairs, grads, want):
        close_to_scale(g.numpy(), w, what=str(path))


def test_energy_mse_loss_and_grad_match_reference():
    b = make_batch(5, graph=True)
    b.pop("edge_pad")
    p, jp, cfg, jcfg = both("nequip", seed=2)
    jl, jg = jax.value_and_grad(
        lambda q: JG.energy_mse_loss(jcfg, q, to_jax(b, True)))(jp)
    q = tree_lib.tree_map(lambda t: t.clone().requires_grad_(), p)
    loss = G.energy_mse_loss(cfg, q, to_port(b, True))
    pairs = tree_lib.leaves(q)
    grads = torch.autograd.grad(loss, [t for _, t in pairs],
                                allow_unused=True, materialize_grads=True)
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    for (path, _), g, w in zip(pairs, grads, jax.tree.leaves(jg)):
        w = np.asarray(w)
        if not w.any():
            # the last layer's gates act on v and t only, which the
            # scalar readout drops: a zero gradient in both packages
            assert path[-1] == "gate_w" and not g.any(), path
            continue
        close_to_scale(g.numpy(), w, what=str(path))


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_params_round_trip_bitwise(kind):
    p, jp, _, _ = both(kind, seed=3)
    back = G.params_to_numpy(p)
    ref = jax.tree.map(np.asarray, jp)
    assert jax.tree.structure(back) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the port's tree walk lists them in jax.tree.leaves' order
    assert [a.shape for _, a in tree_lib.leaves(back)] == \
        [a.shape for a in jax.tree.leaves(ref)]


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_init_draws_the_reference_distribution(kind):
    """The same tree of shapes as the reference's init; zero leaves zero;
    each drawn matrix normal with std 1/sqrt(fan_in) (fan_in = shape[0])
    within sampling error."""
    cfg, jcfg = CFGS[kind]
    big = {"gcn": dict(d_in=512, d_hidden=256), "gin": dict(d_in=512,
                                                            d_hidden=256),
           "gat": dict(d_in=512, d_hidden=32, n_heads=8),
           "nequip": dict(channels=128, d_in=256)}[kind]
    cfg = type(cfg)(**{**cfg.__dict__, **big})
    jcfg = type(jcfg)(**{**jcfg.__dict__, **big})
    got = G.INIT[kind](cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(np.asarray, JG.INIT[kind](jcfg, jax.random.key(0)))
    pairs = tree_lib.leaves(got)
    assert [(p, tuple(t.shape)) for p, t in pairs] == \
        [(p, w.shape) for (p, _), w in zip(pairs, jax.tree.leaves(want))]
    for (path, t), w in zip(pairs, jax.tree.leaves(want)):
        x = t.double().numpy()
        assert x.dtype == np.float64 and t.dtype == torch.float32
        if not w.any():
            assert not x.any(), path
            continue
        z = x * np.sqrt(max(x.shape[0], 1))
        tol = 6.0 / np.sqrt(z.size)
        assert abs(z.mean()) < tol and abs(z.std() - 1.0) < tol, (
            path, z.mean(), z.std())


def _rotation(seed: int) -> np.ndarray:
    q, r = np.linalg.qr(np.random.default_rng(seed).normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q.astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nequip_energy_is_rotation_invariant(seed):
    """Rotating every position leaves the energies unchanged, on the port
    and on the reference (within 1e-4 of their scale)."""
    b = make_batch(6, graph=True)
    b.pop("edge_pad")
    p, jp, cfg, jcfg = both("nequip", seed=seed)
    rot = dict(b, pos=(b["pos"] @ _rotation(seed).T).astype(np.float32))
    base = G.nequip_forward(cfg, p, to_port(b, True)).numpy()
    close_to_scale(G.nequip_forward(cfg, p, to_port(rot, True)).numpy(),
                   base, what="port")
    jbase = np.asarray(JG.nequip_forward(jcfg, jp, to_jax(b, True)))
    close_to_scale(np.asarray(JG.nequip_forward(jcfg, jp, to_jax(rot, True))),
                   jbase, what="reference")
    close_to_scale(base, jbase, what="port vs reference")


def test_out_of_range_ids_raise_where_a_batch_is_placed():
    b = make_batch(7)
    bad = dict(b, src=b["src"].copy())
    bad["src"][0] = N + 1
    with pytest.raises(ValueError, match="src holds ids outside"):
        batch_to_torch(bad, "cpu")
    b = dict(make_batch(7, graph=True), n_graphs=N_GRAPHS - 1)
    with pytest.raises(ValueError, match="graph_ids holds ids outside"):
        G.check_indices(b, N + 1)
