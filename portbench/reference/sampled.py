"""The plain reference of a sampled answer: the Horvitz–Thompson estimate
over the sources a request swept, its top k, and the normal rule's
confidence halfwidths and stop over the same sources.

Plain PyTorch over the benchmark's own arrays ``(n, src, dst, w)``; it
imports nothing of the program. For the sources S a request swept, in any
order and with repeats counted, τ = |S|,

    M1(v) = Σ_(s ∈ S) δ_s(v),   M2(v) = Σ_(s ∈ S) δ_s(v)²,
    λ̂_ref(v) = (n / τ) · M1(v),

each δ_s by ``brandes.batch_lambda``'s steps with each source's row kept
(``deltas``; the ordered-pair convention, δ_s(s) = 0), summed in float64
over blocks of ``BLOCK`` sources. The top k are the k largest λ̂_ref,
descending; ties go to the smaller vertex id.

The halfwidths are the normal (CLT) rule on the normalized scale
x = δ / (n - 2), written out from its statement: the sample mean and
variance of x, δ split over the vertices as KADABRA splits it (half
uniformly, half by each vertex's share of the summed variance), and
hw(v) = z(δ_v) · σ̂(v) / √τ + 1/τ with σ̂² the unbiased variance and
z(δ_v) = √2 · erfinv(1 - δ_v) by Winitzki's closed form (a = 0.147, its
argument clipped at 1 - 1e-12), the quantile the rule names. In λ units
they are hw · n · (n - 2). A stop at the i-th epoch-boundary check
(i from 0) tests at δ / 2^(i+1) (the check sequence's budget split of
arXiv:1910.11039, Alg. 1); the Hoeffding budget is
⌈ln(2n/δ) / (2ε²)⌉ sources.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

BLOCK = 16  # sources a call of deltas: its (block, arcs) fields


def deltas(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
           sources: Sequence[int], *, dtype=torch.float64,
           device="cpu") -> torch.Tensor:
    """δ_s of each source, (len(sources), n) in ``dtype`` on ``device``:
    ``brandes.batch_lambda``'s steps 1–3 with the rows kept apart, whose
    sum over the rows is what ``batch_lambda`` returns."""
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
    return delta


def sampled_moments(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                    sources: Sequence[int], *, dtype=torch.float64,
                    device="cpu", block: int = BLOCK
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(M1, M2) over ``sources``: (n,) float64 each, on the host, summed
    over blocks of ``block`` sources. ``dtype`` is the precision of d, σ
    and δ (bfloat16 for the control)."""
    sources = np.asarray(sources, np.int64)
    if sources.size == 0:
        raise ValueError("a sampled estimate needs at least one source")
    m1 = torch.zeros(n, dtype=torch.float64, device=device)
    m2 = torch.zeros(n, dtype=torch.float64, device=device)
    for lo in range(0, sources.size, block):
        d = deltas(n, src, dst, w, sources[lo:lo + block], dtype=dtype,
                   device=device).to(torch.float64)
        m1 += d.sum(dim=0)
        m2 += (d * d).sum(dim=0)
    return m1.cpu().numpy(), m2.cpu().numpy()


def sampled_lambda(n: int, src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                   sources: Sequence[int], *, dtype=torch.float64,
                   device="cpu") -> np.ndarray:
    """λ̂_ref over ``sources``: (n,) float64 on the host."""
    m1, _ = sampled_moments(n, src, dst, w, sources, dtype=dtype,
                            device=device)
    return m1 * (n / len(sources))


def top_k(lam: np.ndarray, k: int) -> np.ndarray:
    """The ids of the k largest values, descending (ties: smaller id)."""
    order = np.lexsort((np.arange(lam.shape[0]), -np.asarray(lam)))
    return order[:k]


def _erfinv(y: torch.Tensor) -> torch.Tensor:
    """Winitzki's closed form of the inverse error function."""
    y = y.clamp(-(1 - 1e-12), 1 - 1e-12)
    a = 0.147
    l = torch.log1p(-y * y)
    t = 2.0 / (math.pi * a) + l / 2.0
    return torch.sign(y) * torch.sqrt(torch.sqrt(t * t - l / a) - t)


def halfwidths(n: int, m1: np.ndarray, m2: np.ndarray, tau: int,
               delta: float) -> np.ndarray:
    """The normal rule's halfwidths on the normalized scale, (n,) float64
    (inf where τ < 2)."""
    if tau < 2:
        return np.full(n, np.inf)
    c = float(max(n - 2, 1))
    x1 = torch.as_tensor(m1, dtype=torch.float64) / c
    x2 = torch.as_tensor(m2, dtype=torch.float64) / (c * c)
    mean = x1 / tau
    var = (x2 / tau - mean * mean).clamp(min=0.0)
    total = float(var.sum())
    share = (0.5 / n + 0.5 * var / total if total > 0
             else torch.full_like(var, 1.0 / n))
    z = math.sqrt(2.0) * _erfinv(1.0 - delta * share)
    return (z * torch.sqrt(var * tau / (tau - 1) / tau) + 1.0 / tau).numpy()


def hoeffding_budget(n: int, eps: float, delta: float) -> int:
    """Sources after which an (ε, δ) estimate of every vertex holds a
    priori."""
    return math.ceil(math.log(2.0 * max(n, 2) / delta) / (2.0 * eps * eps))
