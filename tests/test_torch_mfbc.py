"""The port's main path against the JAX package and the Brandes oracle.

Both packages get the same graphs (the port's generators must give them
byte for byte) and the same ``(n, n)`` matrix, carried across with
``dense_adj_from_arrays``; each sweep is also fed the reference's own
inputs, so it is held against its counterpart alone. ``Tw`` is held
bitwise, ``Tm`` at rtol 1e-6, ``Zp`` at rtol 1e-5 and λ at rtol 1e-5,
atol 1e-8, as in ``tests/test_mfbc_core.py``.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.graphs.formats as jfmt
import repro.graphs.generators as jgen
from repro.core import brandes_bc as jax_brandes_bc
from repro.core import dense_adj_from_graph as jax_dense_adj
from repro.core import mfbc as jax_mfbc
from repro.core import mfbf as jax_mfbf
from repro.core import mfbr as jax_mfbr
import repro_torch.graphs.formats as tfmt
import repro_torch.graphs.generators as tgen
from repro_torch.core.adjacency import dense_adj_from_arrays
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.core.mfbc import mfbc
from repro_torch.core.mfbf import mfbf
from repro_torch.core.mfbr import mfbr

REPO = Path(__file__).resolve().parents[1]

# The GRAPHS set of tests/test_mfbc_core.py, as (generator, args, kwargs)
# so each package builds it with its own generators.
GRAPHS = {
    "path8": ("path_graph", (8,), {}),
    "path8_w": ("path_graph", (8,), dict(weighted=True, seed=3)),
    "roc4x4": ("ring_of_cliques", (4, 4), {}),
    "roc3x5_w": ("ring_of_cliques", (3, 5), dict(weighted=True, seed=1)),
    "er40": ("erdos_renyi", (40, 0.15), dict(seed=7)),
    "er40_w": ("erdos_renyi", (40, 0.15),
               dict(seed=7, weighted=True, max_weight=9)),
    "er40_dir_w": ("erdos_renyi", (40, 0.12),
                   dict(seed=11, weighted=True, max_weight=7, directed=True)),
    "rmat5": ("rmat", (5, 4), dict(seed=5)),
    "rmat5_dir_w": ("rmat", (5, 3),
                    dict(seed=9, weighted=True, max_weight=5, directed=True)),
    "uni60": ("uniform_random", (60, 6.0), dict(seed=13)),
}
# Further generator calls that must agree byte for byte.
EXTRA = {
    "star9_w": ("star_graph", (9,), dict(weighted=True, seed=4)),
    "spec_rmat6_w": ("from_spec", ("rmat",), dict(scale=6, degree=8,
                                                  weighted=True, seed=2)),
    "spec_uniform6": ("from_spec", ("uniform",), dict(scale=6, degree=4)),
    "spec_er6": ("from_spec", ("er",), dict(scale=6, degree=5, seed=1)),
}


def _build(module, spec):
    fn, args, kwargs = spec
    return getattr(module, fn)(*args, **kwargs)


def _same_graph(g, h):
    assert (g.n, g.directed, g.name) == (h.n, h.directed, h.name)
    for field in ("src", "dst", "w"):
        x, y = getattr(g, field), getattr(h, field)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), field


@pytest.mark.parametrize("gname", sorted({**GRAPHS, **EXTRA}))
def test_generators_byte_identical(gname):
    spec = {**GRAPHS, **EXTRA}[gname]
    g, h = _build(tgen, spec), _build(jgen, spec)
    _same_graph(g, h)
    _same_graph(g.remove_isolated()[0], h.remove_isolated()[0])
    _same_graph(g.symmetrize(), h.symmetrize())
    assert tfmt.coo_to_dense(g).tobytes() == jfmt.coo_to_dense(h).tobytes()
    for x, y in zip(tfmt.pad_edges(g), jfmt.pad_edges(h)):
        assert x.tobytes() == y.tobytes()
    for x, y in zip(tfmt.coo_to_csr(g), jfmt.coo_to_csr(h)):
        assert x.tobytes() == y.tobytes()


def _pair(gname):
    """The reference DenseAdj and the port's, carried across on the CPU."""
    g = _build(jgen, GRAPHS[gname])
    ref = jax_dense_adj(g)
    adj = dense_adj_from_arrays(np.asarray(ref.a), np.asarray(ref.at),
                                device="cpu")
    return g, ref, adj


SWEEP_GRAPHS = ["path8_w", "roc3x5_w", "er40_dir_w", "rmat5", "uni60"]


@pytest.mark.parametrize("gname", SWEEP_GRAPHS)
def test_mfbf_matches_reference(gname):
    g, ref, adj = _pair(gname)
    sources = np.arange(min(g.n, 16), dtype=np.int32)
    Tw_r, Tm_r = jax.jit(lambda a, s: jax_mfbf(a, s))(ref, jnp.asarray(sources))
    Tw, Tm = mfbf(adj, torch.from_numpy(sources))
    np.testing.assert_array_equal(Tw.numpy(), np.asarray(Tw_r))
    np.testing.assert_allclose(Tm.numpy(), np.asarray(Tm_r), rtol=1e-6)


@pytest.mark.parametrize("gname", SWEEP_GRAPHS)
def test_mfbr_matches_reference(gname):
    g, ref, adj = _pair(gname)
    sources = np.arange(min(g.n, 16), dtype=np.int32)
    Tw, Tm = (np.array(x) for x in jax.jit(
        lambda a, s: jax_mfbf(a, s))(ref, jnp.asarray(sources)))
    rows = np.arange(sources.shape[0])
    Tw[rows, sources] = np.inf  # the t = s self-mask of _batch_contrib
    Tm[rows, sources] = 1.0
    Zp_r = jax.jit(lambda a, w, m: jax_mfbr(a, w, m))(
        ref, jnp.asarray(Tw), jnp.asarray(Tm))
    Zp = mfbr(adj, torch.from_numpy(Tw), torch.from_numpy(Tm))
    assert float(np.abs(np.asarray(Zp_r)).max()) > 0
    np.testing.assert_allclose(Zp.numpy(), np.asarray(Zp_r), rtol=1e-5)


def test_dense_adj_from_arrays_builds_the_transpose():
    g, ref, _ = _pair("er40_dir_w")
    adj = dense_adj_from_arrays(np.asarray(ref.a), device="cpu")
    assert adj.at.is_contiguous()
    np.testing.assert_array_equal(adj.at.numpy(), np.asarray(ref.at))
    assert adj.n == g.n


@pytest.mark.parametrize("gname", sorted(GRAPHS))
def test_mfbc_matches_reference_and_brandes(gname):
    g = _build(tgen, GRAPHS[gname])
    lam = mfbc(g, n_b=8, device="cpu")
    assert lam.dtype == np.float64 and lam.shape == (g.n,)
    np.testing.assert_allclose(lam, brandes_bc(g), rtol=1e-5, atol=1e-8)
    h = _build(jgen, GRAPHS[gname])
    np.testing.assert_allclose(lam, jax_mfbc(h, n_b=8), rtol=1e-5,
                               atol=1e-8)


def test_brandes_oracle_copy_matches_reference():
    g = _build(tgen, GRAPHS["er40_dir_w"])
    h = _build(jgen, GRAPHS["er40_dir_w"])
    srcs = np.array([0, 5, 9], np.int32)
    for x, y in zip(brandes_bc(g, sources=srcs, return_aux=True),
                    jax_brandes_bc(h, sources=srcs, return_aux=True)):
        np.testing.assert_array_equal(x, y)


def test_path_graph_analytic():
    """On a path 0-1-...-7, interior vertex k has λ = 2·k·(n-1-k)."""
    n = 8
    lam = mfbc(tgen.path_graph(n), n_b=4, device="cpu")
    expect = np.array([2.0 * k * (n - 1 - k) for k in range(n)])
    np.testing.assert_allclose(lam, expect, rtol=1e-6)


def test_disconnected_graph():
    """Unreachable pairs contribute nothing (and nothing NaNs out)."""
    src = np.array([0, 1, 3, 4], np.int32)
    dst = np.array([1, 0, 4, 3], np.int32)
    g = tfmt.Graph(6, src, dst, np.ones(4, np.float32), directed=False)
    lam = mfbc(g, n_b=3, device="cpu")
    assert np.all(np.isfinite(lam))
    np.testing.assert_allclose(lam, brandes_bc(g), atol=1e-8)


def test_source_subset():
    g = _build(tgen, GRAPHS["er40"])
    srcs = np.array([0, 3, 7, 21], np.int32)
    lam = mfbc(g, n_b=4, sources=srcs, device="cpu")
    np.testing.assert_allclose(lam, brandes_bc(g, sources=srcs), rtol=1e-5,
                               atol=1e-8)


def test_fori_iterate_matches_while():
    g = _build(tgen, GRAPHS["er40_w"])
    lam_w = mfbc(g, n_b=8, iterate="while", device="cpu")
    lam_f = mfbc(g, n_b=8, iterate="fori", max_iters=g.n, device="cpu")
    np.testing.assert_allclose(lam_w, lam_f, rtol=1e-6)


def test_batch_sizes_equivalent_with_ragged_tail():
    """n_b is a performance knob only; 40 = 5·7 + 5 leaves a ragged tail."""
    g = _build(tgen, GRAPHS["er40"])
    seen = []
    lam1 = mfbc(g, n_b=7, device="cpu",
                progress_cb=lambda b, nbat, lam: seen.append((b, nbat)))
    lam2 = mfbc(g, n_b=40, device="cpu")
    assert seen[-1] == (5, 6)
    np.testing.assert_allclose(lam1, lam2, rtol=1e-6)


def test_unported_backend_names_its_slice():
    """Slice 3 ported the sparse backends: COO and CSR run and agree with
    the oracle; an unknown backend or iterate mode is refused."""
    g = tgen.ring_of_cliques(3, 4, weighted=True, seed=2)
    want = brandes_bc(g)
    for backend in ("coo", "csr"):
        np.testing.assert_allclose(mfbc(g, n_b=5, backend=backend,
                                        device="cpu"),
                                   want, rtol=1e-5, atol=1e-8)
    with pytest.raises(ValueError, match="unknown backend"):
        mfbc(g, backend="ell", device="cpu")
    with pytest.raises(ValueError, match="iterate"):
        mfbc(g, iterate="scan", device="cpu")
    with pytest.raises(ValueError, match="iterate"):
        mfbc(g, backend="csr", iterate="scan", device="cpu")


def test_bc_run_cli_verifies_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.bc_run", "--graph", "rmat",
         "--scale", "5", "--device", "cpu", "--verify"],
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "verified against the Brandes oracle" in out.stdout
