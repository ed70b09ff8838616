"""A configuration's graph, cached per configuration.

The configuration names a generator of ``portbench.gen.generators``,
gives its parameters as top-level keys and the generator's seed as
``graph_seed``; ``remove_isolated`` adds the paper's preprocessing step,
``permute_vertices`` Graph500's relabelling. The graph is the
configuration's, like a model's sizes, and a run's ``--seed`` draws the
sources it sweeps: a graph drawn from the seed would be made anew in
every run's set-up. The arrays go to
``portbench/.cache/graphs/<config>-<graph_seed>.npz`` (git-ignored)
once, as a deployment keeps its graph on disk, and later runs load them.
"""
from __future__ import annotations

import inspect
import os
from pathlib import Path

import numpy as np

from portbench.gen import generators as G

CACHE = Path("portbench") / ".cache" / "graphs"


def normalize_seed(seed: int) -> int:
    """The seed as numpy takes it: any whole number, folded into 63 bits."""
    return int(seed) % (1 << 63)


def generate(config: dict) -> G.Arcs:
    fn = getattr(G, config["generator"])
    params = inspect.signature(fn).parameters
    kwargs = {k: config[k] for k in params if k in config and k != "seed"}
    g = fn(seed=normalize_seed(config["graph_seed"]), **kwargs)
    if config.get("remove_isolated"):
        g = G.remove_isolated(g)
    if config.get("permute_vertices"):
        g = G.permute_vertices(g, normalize_seed(config["graph_seed"]))
    return g


def load(config: dict, root: Path) -> G.Arcs:
    """The configuration's graph, from the cache or made and cached
    (written to a temporary file and renamed, so that runs making it at
    once never read half a file)."""
    path = (root / CACHE
            / f"{config['name']}-{normalize_seed(config['graph_seed'])}.npz")
    if path.is_file():
        with np.load(path) as z:
            return (int(z["n"]), z["src"], z["dst"], z["w"])
    g = generate(config)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, n=np.int64(g[0]), src=g[1], dst=g[2], w=g[3])
    os.replace(tmp, path)
    return g
