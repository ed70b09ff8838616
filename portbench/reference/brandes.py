"""The plain reference: Brandes' dependencies for a batch of sources.

Plain PyTorch over the benchmark's own arrays ``(n, src, dst, w)``; it
imports nothing of the program. For each source s of the batch, over
every arc at once:

1. distances d_s by Bellman-Ford (``scatter_reduce`` amin) until no
   distance changes;
2. the arcs (u, v) on a shortest path, d_s(u) + w = d_s(v), and the
   longest such path in arcs (an integer fixed point, so exact);
3. path counts σ_s(v) = [v = s] + Σ_(u, v) σ_s(u), and dependencies
   δ_s(v) = Σ_(v, x) σ_s(v) / σ_s(x) · (1 + δ_s(x)), each by as many
   Jacobi steps as that longest path has arcs;
4. λ_batch(v) = Σ_s δ_s(v), with δ_s(s) = 0: the ordered-pair convention,
   no halving for undirected graphs.

``dtype`` is the precision of d, σ and δ: float64 for the reference,
bfloat16 for the control (``portbench/tests/test_portbench_control.py``).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


def batch_lambda(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                 sources: Sequence[int], *, dtype=torch.float64,
                 device="cpu") -> np.ndarray:
    """Σ over ``sources`` of δ_s, (n,) float64 on the host."""
    dev = torch.device(device)
    s = torch.as_tensor(np.asarray(sources, np.int64), device=dev)
    b = s.shape[0]
    rows = torch.arange(b, device=dev)
    u = torch.as_tensor(np.asarray(src, np.int64), device=dev)
    v = torch.as_tensor(np.asarray(dst, np.int64), device=dev)
    wt = torch.as_tensor(np.asarray(w, np.float32), device=dev).to(dtype)
    vv = v.expand(b, -1)
    uu = u.expand(b, -1)

    d = torch.full((b, n), float("inf"), dtype=dtype, device=dev)
    d[rows, s] = 0
    while True:
        nd = d.scatter_reduce(1, vv, d[:, u] + wt, "amin")
        if torch.equal(nd, d):
            break
        d = nd

    du = d[:, u]
    tight = torch.isfinite(du) & (du + wt == d[:, v])
    del du
    hops = torch.zeros((b, n), dtype=torch.int64, device=dev)
    while True:
        nh = hops.scatter_reduce(
            1, vv, torch.where(tight, hops[:, u] + 1, 0), "amax")
        if torch.equal(nh, hops):
            break
        hops = nh
    depth = int(hops.max())

    seed = torch.zeros((b, n), dtype=dtype, device=dev)
    seed[rows, s] = 1
    sigma = seed
    for _ in range(depth):
        sigma = seed.scatter_add(
            1, vv, torch.where(tight, sigma[:, u], 0).to(dtype))
    zero = torch.zeros((b, n), dtype=dtype, device=dev)
    delta = zero
    for _ in range(depth):
        coef = torch.where(tight, sigma[:, u] / sigma[:, v]
                           * (1 + delta[:, v]), 0).to(dtype)
        delta = zero.scatter_add(1, uu, coef)
    delta[rows, s] = 0
    return delta.to(torch.float64).sum(dim=0).cpu().numpy()
