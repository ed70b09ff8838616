"""The frozen copies: the generators and graph pipeline against the port's,
byte for byte, and the bound arithmetic against ``chip_smoke.py``'s."""
from __future__ import annotations

import ast
import re

import numpy as np
import pytest

from conftest import REPO
from portbench.gen import generators as G
from portbench.metrics.common import bounds
from repro_torch.graphs import generators as P


def same(ours, theirs) -> None:
    n, src, dst, w = ours
    assert n == theirs.n
    for a, b in ((src, theirs.src), (dst, theirs.dst), (w, theirs.w)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("scale,ef,seed,weighted", [
    (5, 8, 0, True), (7, 16, 3, True), (8, 4, 2**33 + 5, False)])
def test_rmat_pipeline_matches_port(scale, ef, seed, weighted):
    ours = G.rmat(scale, ef, seed=seed, weighted=weighted, max_weight=100)
    theirs = P.rmat(scale, ef, seed=seed, weighted=weighted, max_weight=100)
    same(ours, theirs)
    same(G.remove_isolated(ours), theirs.remove_isolated()[0])


@pytest.mark.parametrize("n,p,seed,weighted", [
    (64, 4 / 64, 0, False), (300, 0.02, 11, True), (1024, 4 / 1024, 5,
                                                     False)])
def test_erdos_renyi_matches_port(n, p, seed, weighted):
    same(G.erdos_renyi(n, p, seed=seed, weighted=weighted),
         P.erdos_renyi(n, p, seed=seed, weighted=weighted))


def test_dedup_and_symmetrize_match_port():
    from repro_torch.graphs.formats import Graph

    rng = np.random.default_rng(4)
    src = rng.integers(0, 20, 200).astype(np.int32)
    dst = rng.integers(0, 20, 200).astype(np.int32)
    w = rng.integers(1, 5, 200).astype(np.float32)
    g = Graph(20, src, dst, w)
    same(G.dedup((20, src, dst, w)), g.dedup())
    same(G.symmetrize((20, src, dst, w)), g.symmetrize())


@pytest.mark.parametrize("seed", [0, 2**33 + 5])
def test_permute_vertices_relabels_the_same_graph(seed):
    g = G.remove_isolated(G.rmat(7, 8, seed=1, weighted=True))
    n, src, dst, w = g
    pn, psrc, pdst, pw = G.permute_vertices(g, seed)
    assert pn == n and pw.tobytes() == w.tobytes()
    assert psrc.dtype == src.dtype == np.int32
    label = np.empty(n, np.int64)
    label[src] = psrc  # one label a vertex, the same at every arc
    label[dst] = pdst
    assert (label[src] == psrc).all() and (label[dst] == pdst).all()
    assert sorted(label) == list(range(n)) and (label != np.arange(n)).any()
    again = G.permute_vertices(g, seed)
    assert again[1].tobytes() == psrc.tobytes()


def _smoke_bound():
    """``chip_smoke.py::bound`` and its constants, read from the source
    (the script exits at import on a host without a card)."""
    src = (REPO / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    ns = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", "").startswith("PEAK_") for t in
                node.targets):
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"), ns)
        if isinstance(node, ast.FunctionDef) and node.name == "bound":
            fn = node
    n_out = dict(re.findall(r'"(\w+_mm)": dict\(.*?n_out=(\d)', src,
                            flags=re.S))
    ns["KERNELS"] = {k: {"n_out": int(v)} for k, v in n_out.items()}
    exec(compile(ast.Module([fn], []), "chip_smoke.py", "exec"), ns)
    return ns["bound"], ns["KERNELS"]


@pytest.mark.parametrize("shape", [(64, 65536, 65536), (64, 32768, 32768),
                                   (64, 3342, 3342), (8, 16, 16),
                                   (4096, 16384, 16384)])
def test_bound_matches_chip_smoke(shape):
    bound, kernels = _smoke_bound()
    assert set(kernels) == set(bounds.N_OUT)
    for name in kernels:
        ms, _ = bound(name, *shape)
        assert bounds.product_bound_s(name, *shape) * 1e3 == pytest.approx(
            ms, rel=1e-12)
