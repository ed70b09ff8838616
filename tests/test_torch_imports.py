"""The PyTorch port stands alone and never runs quietly on the CPU.

* Importing every module of ``repro_torch`` loads neither jax nor any module
  of ``repro`` (checked in a fresh interpreter).
* No source of the port, nor ``chip_smoke.py``, names jax or ``repro``.
* ``repro_torch/serve/*.py`` imports only public ``repro_torch.bc`` names
  (the port's counterpart of ``tools/check_private_imports.py``).
* The entry points default to the card and raise on a host without one.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.bc import (BCQuery, ExecutionConfig, build_executor, plan,
                            solve)
from repro_torch.core.adjacency import dense_adj_from_graph
from repro_torch.core.mfbc import mfbc
from repro_torch.graphs.generators import path_graph
from repro_torch.configs import get_arch
from repro_torch.configs.base import batch_to_torch
from repro_torch.launch import bc_run, serve
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_lib import make_lm_train_step
from repro_torch.models import gnn as G
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.serve.engine import ServeEngine

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch, repro_torch.launch.bc_run, repro_torch.kernels.ops
for mod in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("OK", " ".join(sorted(m for m in sys.modules
                            if m.startswith("repro_torch"))))
"""
# The modules of each slice, so that a module dropped from the walk (a
# missing __init__) fails here instead of going unchecked.
_MODULES = {
    "repro_torch.core.mfbc", "repro_torch.core.adjacency",
    "repro_torch.kernels.ops", "repro_torch.launch.bc_run",
    # slice 2: the sampled path and the solver facade
    "repro_torch.approx", "repro_torch.approx.sampling",
    "repro_torch.approx.driver", "repro_torch.spgemm",
    "repro_torch.spgemm.cost_model", "repro_torch.spgemm.autotune",
    "repro_torch.core.metrics", "repro_torch.bc", "repro_torch.bc.config",
    "repro_torch.bc.query", "repro_torch.bc.planner",
    "repro_torch.bc.executor", "repro_torch.bc.solve",
    "repro_torch.bc.fusion", "repro_torch.bc.refine",
    # slice 3: the COO and CSR backends and the calibration command
    "repro_torch.kernels.segment_relax", "repro_torch.launch.calibrate",
    # slice 4: the metric bodies and the BFS baseline
    "repro_torch.core.metrics", "repro_torch.core.bfs_bc",
    # slice 5: the serving stack and its launcher
    "repro_torch.graphs.formats", "repro_torch.serve",
    "repro_torch.serve.cache", "repro_torch.serve.bc_service",
    "repro_torch.serve.gateway", "repro_torch.launch.bc_serve",
    # slice 6: the distributed step and the out-of-core ingest
    "repro_torch.launch.mesh", "repro_torch.spgemm.semiring",
    "repro_torch.spgemm.dist", "repro_torch.core.dist_bc",
    # slice 7's fault-tolerance half: checkpoints, restarts, elastic n_b
    "repro_torch.train", "repro_torch.train.checkpoint",
    "repro_torch.train.fault", "repro_torch.train.elastic",
    # slice 7a: LM serving
    "repro_torch.models", "repro_torch.models.layers",
    "repro_torch.models.transformer", "repro_torch.configs",
    "repro_torch.configs.base", "repro_torch.configs.lm_archs",
    "repro_torch.configs.registry", "repro_torch.serve.engine",
    "repro_torch.launch.serve",
    # slice 7b: LM training
    "repro_torch.optim", "repro_torch.optim.adamw",
    "repro_torch.optim.grad_compress", "repro_torch.tree",
    "repro_torch.train.train_lib", "repro_torch.launch.train",
    "repro_torch.data", "repro_torch.data.pipeline",
    "repro_torch.graphs.sampler",
    # slice 7c: the GNN and recsys families
    "repro_torch.models.gnn", "repro_torch.models.recsys",
    "repro_torch.models.gnn_dist", "repro_torch.configs.gnn_archs",
    # slice 7d: the sharding rules, the dry run and the roofline
    "repro_torch.sharding", "repro_torch.sharding.rules",
    "repro_torch.launch.dryrun", "repro_torch.launch.perf_hillclimb",
    "repro_torch.roofline", "repro_torch.roofline.constants",
    "repro_torch.roofline.collectives", "repro_torch.roofline.analysis",
}

_BANNED = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)\b", re.MULTILINE)


def test_port_loads_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("OK")
    loaded = set(out.stdout.split()[1:])
    assert _MODULES <= loaded, sorted(_MODULES - loaded)


def test_port_sources_name_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}"
            for f in files for m in _BANNED.finditer(f.read_text())]
    assert not hits
    # the pattern itself: it catches both packages, not the port's own name
    assert _BANNED.search("from repro.core import mfbc")
    assert _BANNED.search("import jax.numpy as jnp")
    assert not _BANNED.search("from repro_torch.core import mfbc")


def _imports(path: Path):
    """(module, names) of every absolute ``from X import ...`` and
    ``import X`` in a source file."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, [a.name for a in node.names]
        elif isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, []


def test_serve_imports_only_public_bc_names():
    """The serving stack reaches the solver through the ``repro_torch.bc``
    facade only: no private name of another subpackage of the port, no
    submodule of ``repro_torch.bc``, and from the facade only what its
    ``__all__`` exports."""
    import repro_torch.bc as tbc

    files = sorted((REPO / "src" / "repro_torch" / "serve").glob("*.py"))
    assert {f.name for f in files} >= {"__init__.py", "cache.py",
                                       "bc_service.py", "gateway.py"}
    bad = []
    for f in files:
        for module, names in _imports(f):
            if not module.startswith("repro_torch"):
                continue
            where = f"{f.name}: {module} {names}"
            if module.startswith("repro_torch.serve"):
                continue  # within the package
            if module.startswith("repro_torch.bc."):
                bad.append(f"{where} (a submodule of the facade)")
            elif module == "repro_torch.bc":
                bad += [f"{where} ({n} is not in __all__)" for n in names
                        if n not in tbc.__all__]
            elif any(part.startswith("_") for part in module.split(".")) \
                    or any(n.startswith("_") for n in names):
                bad.append(f"{where} (private)")
    assert not bad
    # the check itself: it sees the facade imports it polices
    seen = {m for f in files for m, _ in _imports(f)}
    assert "repro_torch.bc" in seen


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = path_graph(6)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mfbc(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dense_adj_from_graph(g)
    with pytest.raises(SystemExit, match="--device cpu"):
        bc_run.main(["--scale", "3"])
    q = BCQuery(n_b=4, execution=ExecutionConfig(backend="dense"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solve(g, q)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_executor(g, plan(g, q, n_devices=1))
    cfg = get_arch("gemma2-27b").config(smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(T.Transformer(cfg), n_slots=1, max_len=8)
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main(["--arch", "gemma2-27b", "--smoke"])
    with pytest.raises(SystemExit, match="--device cpu"):
        launch_train.main(["--arch", "gemma2-27b", "--smoke"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_lm_train_step(cfg, AdamWConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.init_tree(cfg, torch.Generator().manual_seed(0))
    # slice 7c: the GNN and recsys parameters, batches and cells
    gcn = get_arch("gcn-cora")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        G.gcn_init(gcn.config(smoke=True), torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        R.init_params(get_arch("xdeepfm").config(smoke=True),
                      torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch_to_torch(gcn.numpy_batch("molecule", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gcn.build(gcn.cells()["molecule"], smoke=True).concrete_args(
            torch.Generator().manual_seed(0))
