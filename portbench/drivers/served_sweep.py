"""Served top-k queries: the throughput of ``repro_torch.serve.BCService``
answering a closed loop of concurrent approximate top-k requests, in TEPS.

The configuration gives the service (``n_slots``, ``fuse``, ``pack``,
``tick_budget``) beside its graph; the mix (``traffic/<name>.json``)
gives the requests:

* ``live``: how many clients each keep one request outstanding;
* ``eps_mix``: the ε cycled over the request ids (rid r asks ε =
  ``eps_mix[r % len]``, as ``benchmarks/bc_serve.py`` cycles it), with
  ``delta``, ``k`` and ``rule`` for every request;
* ``warm_retired``: how many requests the warm-up's closed loop retires;
* ``trace_seconds``: how long the window of a traced run lasts.

Set-up loads the configuration's graph (``harness.graphs``; where its
cache is missing, a process of its own makes it first, so that the
generator's temporaries never pass through this process's heap, whose
later numpy passes the window times) and builds
``BCService({name: g}, ..., device=...)`` with the planner's own plan,
then warms it: every (row bucket, slot bucket) shape a fused batch can
run at and the lone batch go through the graph's executor once, each
ε's per-request plan is made, and then the window's closed loop runs on
throwaway requests until ``warm_retired`` of them have retired: ``live``
at once, and after each tick one more for each that retired in it. The
warm-up's rids start at ``WARM_RID``, outside the window's, and its seed
is fixed, so every run's set-up does the same work and hands the window
the same ``live`` requests in flight. They start fresh, all at their
first epoch, and by then the live mix has drifted to where the loop
holds it: toward the tight ε, whose requests live longest.

The window goes on with that closed loop: after each tick one new rid is
submitted for each request that retired in it, before the next tick;
rids 0, 1, 2, … in the order they are submitted, each with the run's
seed. Ticks run until ``seconds`` have passed, and the last one
completes.
``teps`` is the graph's arcs times the sources the ticks swept (the sum
of ``BCService.step()``'s returns, valid rows only) over the seconds
from the start of the first tick to the end of the last; ``setup_s``
runs from the process's start to the window's.

The answer of each request that retires in the window, the warm-up's
included (its top k, their λ̂ and halfwidths, τ, its epochs, whether it
claims convergence, and the sources it swept, in the order they drained,
from ``BCResponse.sources``) is kept. After the
window, the program's state freed, a sample of them drawn from the seed
is held whole on the card against the plain reference
(``reference/sampled.py``): together at least ``check.sources`` sources
over at least ``check.requests`` requests, one of them of ε ≤ 0.1 where
one retired; a request that would take the sample past
``check.max_sources`` is passed over unless the sample needs it. For each
request, over its own sources:

* ``lam_rel_err``: its λ̂ against λ̂_ref at its top k;
* ``hw_rel_err``: its halfwidths against the normal rule's at its δ, at
  its top k;
* ``tau_mismatch``: τ against the number of its sources;
* ``topk_mismatch``: the ids on the wrong side of λ̂_ref's k-th value
  (its top k is λ̂_ref's up to ties within ``lam_rel_err``'s limit);
* ``stop_excess``: how far the reference finds its stop from legal. A
  request that claims convergence after e epochs stopped legally where,
  at the e-th check's δ / 2^e, the largest normalized halfwidth is at
  most ε, or its top k (λ̂_ref's) is separated from the rest by the
  halfwidths, or τ has reached the Hoeffding budget; the excess is the
  least of (largest halfwidth − ε) / ε and (the rest's highest upper end
  − the top k's lowest lower end) / max(λ̂_ref's k-th, 1), and 0 at the
  budget. One that does not claim it must have reached its cap (the
  request's, else the budget): its excess is the share of it left.

A program whose responses carry no swept sources cannot be checked: the
run ends at once, before the graph is loaded, with no result.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from portbench.drivers.exact_sweep import _launch_counters as launch_counters
from portbench.harness import graphs, trace
from portbench.harness.device import log
from portbench.harness.result import LayerContext, Record, lam_rel_err
from portbench.harness.spec import Cell
from portbench.reference import sampled

WARM_RID = 1 << 40  # the warm-up's first rid; the window's is 0
WARM_SEED = 1  # fixed: every run's warm-up sweeps the same sources


@dataclasses.dataclass
class Answer:
    """What a retired request answered, as the check needs it."""

    rid: int
    eps: float
    delta: float
    topk: np.ndarray  # (k,) vertex ids
    lam: np.ndarray  # (k,) λ̂ at those ids
    halfwidth: np.ndarray  # (k,) their CI halfwidths, λ units
    n_samples: int  # τ
    n_epochs: int
    converged: bool
    cap: Optional[int]  # the request's own sample cap, if any
    sources: np.ndarray  # the swept sources, in drain order

    @classmethod
    def of(cls, resp, req) -> "Answer":
        return cls(rid=resp.rid, eps=req.eps, delta=req.delta,
                   topk=np.asarray(resp.topk, np.int64),
                   lam=np.asarray(resp.lam, np.float64),
                   halfwidth=np.asarray(resp.halfwidth, np.float64),
                   n_samples=int(resp.n_samples),
                   n_epochs=int(resp.n_epochs),
                   converged=bool(resp.converged), cap=req.max_samples,
                   sources=np.asarray(resp.sources))


def swept_sources_exposed() -> bool:
    """Whether the program's responses carry the sources they swept."""
    from repro_torch.serve.bc_service import BCResponse

    return "sources" in {f.name for f in dataclasses.fields(BCResponse)}


def request(mix: Dict, graph: str, rid: int, seed: int, **kw):
    from repro_torch.serve.bc_service import BCRequest

    eps = mix["eps_mix"]
    return BCRequest(rid=rid, graph=graph, k=int(mix["k"]),
                     eps=float(eps[rid % len(eps)]),
                     delta=float(mix["delta"]), rule=mix["rule"], seed=seed,
                     **kw)


def load_graph(cell: Cell):
    """The configuration's arrays, made by a spawned process if uncached."""
    cfg = cell.config
    path = (cell.root / graphs.CACHE / f"{cfg['name']}-"
            f"{graphs.normalize_seed(cfg['graph_seed'])}.npz")
    if not path.is_file():
        import multiprocessing

        p = multiprocessing.get_context("spawn").Process(
            target=graphs.load, args=(cfg, cell.root))
        p.start()
        p.join()
        if p.exitcode != 0:
            raise RuntimeError(f"making the graph of {cfg['name']} failed "
                               f"(exit code {p.exitcode})")
    return graphs.load(cfg, cell.root)


def relax_counts(ex) -> Optional[Dict[str, int]]:
    """The CSR adjacency's own counts of the relaxes a compacted frontier
    served and of those that fell back to every arc (the executor's
    ``occupancy_summary`` leaves fused batches out); None on other
    formats."""
    adj = getattr(ex, "_adj", None)
    if not hasattr(adj, "compact_hits"):
        return None
    return {"compact_hits": adj.compact_hits, "overflows": adj.overflows}


def service(cell: Cell, g, device: str):
    from repro_torch.serve.bc_service import BCService

    c = cell.config
    return BCService({cell.config_name: g}, n_slots=int(c["n_slots"]),
                     fuse=bool(c["fuse"]), pack=c["pack"],
                     tick_budget=c["tick_budget"], device=device)


def warm(svc, cell: Cell, n: int, reqs: Dict[int, object]) -> int:
    """The set-up's warm-up (module docstring), which leaves its closed
    loop's requests in flight, each in ``reqs`` by rid; returns how many
    batches it ran outside the loop."""
    name, mix = cell.config_name, cell.traffic
    ex = svc.executor_for(name)
    for j in range(len(mix["eps_mix"])):
        svc.request_plan(request(mix, name, j, 0))
    rng = np.random.default_rng(WARM_SEED)
    calls = 0
    for b in ex.buckets:
        s = 1
        while s <= min(b, svc.n_slots):
            src = rng.integers(0, n, b).astype(np.int32)
            ex.step_segmented(src, np.ones(b, bool),
                              (np.arange(b) % s).astype(np.int32), s)
            calls += 1
            s <<= 1
    ex.step(rng.integers(0, n, ex.n_b).astype(np.int32),
            np.ones(ex.n_b, bool))
    def submit():
        req = request(mix, name, WARM_RID + len(reqs), WARM_SEED)
        reqs[req.rid] = req
        svc.submit(req)

    for _ in range(int(mix["live"])):
        submit()
    while len(svc.finished) < int(mix["warm_retired"]):
        seen = len(svc.finished)
        svc.step()
        for _ in svc.finished[seen:]:
            submit()
    return calls + 1


def serve(cell: Cell, *, seed: int, seconds: float, traced: bool,
          t_start: float, device: str) -> Dict:
    """Set-up and the window; the retired answers and the graph for the
    check, and what the readers read."""
    import torch

    from repro_torch.graphs.formats import Graph

    if not swept_sources_exposed():
        raise RuntimeError("the program's BCResponse carries no swept "
                           "sources: the served cell cannot check its "
                           "answers")
    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    t_ready = time.perf_counter() - t_start
    t0 = time.perf_counter()
    n, src, dst, w = load_graph(cell)
    g = Graph(n, src, dst, w, directed=False, name=cell.config_name)
    t_graph = time.perf_counter() - t0
    name, mix = cell.config_name, cell.traffic
    t0 = time.perf_counter()
    svc = service(cell, g, device)
    ex = svc.executor_for(name)
    pl = ex.plan
    t_build = time.perf_counter() - t0
    log(f"graph {name}: n={n} arcs={g.m} ({t_graph:.3f}s); plan: "
        f"backend={pl.backend} n_b={pl.n_b} buckets={tuple(ex.buckets)}; "
        f"service n_slots={svc.n_slots} fuse={svc.fuse} pack={svc.pack} "
        f"tick_budget={svc.tick_budget}; built in {t_build:.3f}s")
    t0 = time.perf_counter()
    reqs: Dict[int, object] = {}
    calls = warm(svc, cell, n, reqs)
    t_warm = time.perf_counter() - t0
    n_warm = len(svc.finished)
    plans = {e: svc.request_plan(request(mix, name, j, 0)).n_b
             for j, e in enumerate(mix["eps_mix"])}
    eps_live = sorted(r.eps for r in svc.pending)  # in slots or queued
    log(f"warm-up: {calls} shapes, {n_warm} requests retired in "
        f"{t_warm:.3f}s; per-request n_b by eps {plans}; eps in flight "
        f"{eps_live}")

    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    if traced and mix.get("trace_seconds"):
        seconds = min(seconds, float(mix["trace_seconds"]))
    seed_n = graphs.normalize_seed(seed)
    rid = 0

    def submit():
        nonlocal rid
        req = request(mix, name, rid, seed_n)
        reqs[rid] = req
        svc.submit(req)
        rid += 1

    before = launch_counters()
    occ0 = relax_counts(ex)
    setup_s = time.perf_counter() - t_start
    swept = ticks = 0
    times = []
    with trace.profiler(traced, dev.type) as prof:
        with trace.span("window"):
            seen = n_warm
            w0 = time.perf_counter()
            while True:
                t1 = time.perf_counter()
                with trace.span("tick"):
                    swept += svc.step()
                end = time.perf_counter()
                times.append(end - t1)
                ticks += 1
                if end - w0 >= seconds:
                    break
                for _ in svc.finished[seen:]:
                    submit()
                seen = len(svc.finished)
            window_s = end - w0
    after = launch_counters()
    occ1 = relax_counts(ex)
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    answers = [Answer.of(resp, reqs[resp.rid])
               for resp in svc.finished[n_warm:]]
    in_flight = len(reqs) - len(svc.finished)
    epochs = sum(r.n_epochs for r in svc.finished[n_warm:])
    dt, batches = None, 0
    if prof is not None:
        from repro_torch import tracing

        t0 = time.perf_counter()
        dt = trace.reduce(prof, dev.type)
        batches = len(tracing.snapshot(clear=False).named("batch"))
        log(f"trace: {len(dt.ops) if dt else 0} device operations, "
            f"{batches} executor batches, read in "
            f"{time.perf_counter() - t0:.3f}s")
    occ = None
    if occ0 is not None:
        occ = {k: occ1[k] - occ0[k] for k in occ0}
        occ["relax_calls"] = occ["compact_hits"] + occ["overflows"]
    log(f"set-up: imports and device {t_ready:.3f}s, graph {t_graph:.3f}s, "
        f"service and executor {t_build:.3f}s, warm {t_warm:.3f}s; "
        f"setup_s {setup_s:.3f}")
    q1, q2, q3 = np.percentile(times, [25, 50, 75])
    taus = sorted(a.n_samples for a in answers)
    log(f"window: {ticks} ticks, {swept} sources in {window_s:.3f}s; "
        f"seconds a tick: min {min(times):.6f} q1 {q1:.6f} median "
        f"{q2:.6f} q3 {q3:.6f} max {max(times):.6f}; {len(answers)} "
        f"retired ({epochs} epochs; {rid} of the window's rids "
        f"submitted), {in_flight} in flight; tau of the "
        f"retired {taus[:4]}..{taus[-4:]}")
    out = dict(ticks=ticks, swept=swept, window_s_host=window_s,
               setup_s=setup_s, arcs=g.m, graph=(n, src, dst, w),
               answers=answers, trace=dt, batches=batches,
               launches={k: after[k] - before[k] for k in after},
               occupancy=occ,
               peak=max(setup_peak, window_peak), peak_window=window_peak)
    del svc, ex, g
    if cuda:
        torch.cuda.empty_cache()
    return out


def pick(answers: Sequence[Answer], seed: int, check: Dict) -> List[Answer]:
    """The check's sample (module docstring), drawn from the seed."""
    order = np.random.default_rng(
        [graphs.normalize_seed(seed), 3]).permutation(len(answers))
    want_s, want_r = int(check["sources"]), int(check["requests"])
    cap = int(check["max_sources"])
    chosen: List[int] = []
    total = 0
    tight = [i for i in order if answers[i].eps <= 0.1]
    if tight:  # the first in the seed's order that fits, else the least
        fits = [i for i in tight if answers[i].n_samples <= cap]
        i = fits[0] if fits else min(tight,
                                     key=lambda j: answers[j].n_samples)
        chosen.append(int(i))
        total += answers[i].n_samples
    for i in order:
        if total >= want_s and len(chosen) >= want_r:
            break
        if i in chosen or total + answers[i].n_samples > cap:
            continue
        chosen.append(int(i))
        total += answers[i].n_samples
    for i in sorted(order, key=lambda j: answers[j].n_samples):
        if total >= want_s and len(chosen) >= want_r:
            break
        if i not in chosen:  # the sample's needs go before the cap
            chosen.append(int(i))
            total += answers[i].n_samples
    return [answers[i] for i in chosen]


def topk_violations(ref: np.ndarray, topk: np.ndarray, k: int,
                    limit: float) -> int:
    """Ids on the wrong side of λ̂_ref's k-th value: reported ones below
    it, or left-out ones above it, by more than ``limit`` (relative where
    it is 1 or more, as ``lam_rel_err``). Zero iff ``topk`` is λ̂_ref's
    top k up to ties within the limit."""
    k = min(k, ref.shape[0])
    vk = float(np.sort(ref)[::-1][k - 1])
    tol = limit * max(abs(vk), 1.0)
    inside = np.zeros(ref.shape[0], bool)
    inside[topk] = True
    return int(np.sum(ref[inside] < vk - tol)
               + np.sum(ref[~inside] > vk + tol)
               + abs(int(inside.sum()) - k))


def stop_excess(a: Answer, n: int, m1: np.ndarray, m2: np.ndarray) -> float:
    """How far the reference finds ``a``'s stop from legal (module
    docstring); 0 where it is legal."""
    tau = a.sources.size
    budget = sampled.hoeffding_budget(n, a.eps, a.delta)
    if not a.converged:
        cap = budget if a.cap is None else min(a.cap, budget)
        return max(0.0, 1.0 - tau / cap)
    if tau >= budget:
        return 0.0
    hw = sampled.halfwidths(n, m1, m2, tau, a.delta / 2.0 ** a.n_epochs)
    by_eps = (float(hw.max()) - a.eps) / a.eps
    k = a.topk.size
    if not 0 < k < n:
        return max(0.0, by_eps)
    lam = m1 * (n / tau)
    h = hw * n * max(n - 2, 1)
    top = sampled.top_k(lam, k)
    rest = np.ones(n, bool)
    rest[top] = False
    gap = float(np.max((lam + h)[rest]) - np.min((lam - h)[top]))
    by_gap = gap / max(abs(float(lam[top[-1]])), 1.0)
    return max(0.0, min(by_eps, by_gap))


def check_answers(arcs, sample: Sequence[Answer], limits: Dict[str, float],
                  *, device: str) -> Tuple[List[Tuple[str, float, float]],
                                           int]:
    """The sample against the reference: each compared number's worst
    beside its limit, and how many answers exceed any limit."""
    import torch

    n, src, dst, w = arcs
    dev = "cuda:0" if device == "cuda" else "cpu"
    lam_limit = float(limits["lam_rel_err"])
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    for a in sample:
        got = {"tau_mismatch": float(a.n_samples != a.sources.size),
               "lam_rel_err": float("inf"), "hw_rel_err": float("inf"),
               "topk_mismatch": float(a.topk.size),
               "stop_excess": float("inf")}
        if a.sources.size:
            m1, m2 = sampled.sampled_moments(n, src, dst, w, a.sources,
                                             dtype=torch.float64,
                                             device=dev)
            tau = a.sources.size
            ref = m1 * (n / tau)
            got["lam_rel_err"] = lam_rel_err(a.lam, ref[a.topk])
            got["topk_mismatch"] = float(topk_violations(
                ref, a.topk, a.topk.size, lam_limit))
            hw = sampled.halfwidths(n, m1, m2, tau, a.delta)[a.topk]
            got["hw_rel_err"] = lam_rel_err(a.halfwidth,
                                            hw * n * max(n - 2, 1))
            got["stop_excess"] = stop_excess(a, n, m1, m2)
        for key, v in got.items():
            worst[key] = max(worst[key], v)
        failed += int(any(not v <= float(limits[key])
                          for key, v in got.items()))
    return [(key, v, float(limits[key])) for key, v in worst.items()], failed


def run(cell: Cell, *, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda") -> Record:
    import torch

    r0 = serve(cell, seed=seed, seconds=seconds, traced=traced,
               t_start=t_start, device=device)
    chk = cell.workload["check"]
    sample = pick(r0["answers"], seed, chk)
    t0 = time.perf_counter()
    checks, failed = check_answers(r0["graph"], sample, chk["limits"],
                                   device=device)
    log(f"check: {len(sample)} of {len(r0['answers'])} answers, "
        f"{sum(a.n_samples for a in sample)} sources (eps "
        f"{sorted(a.eps for a in sample)}), against the reference in "
        f"{time.perf_counter() - t0:.3f}s")
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(r0["peak"])}
    dt = r0["trace"]
    if dt is not None:
        dev_info["busy_s"] = float(dt.busy_s)
        dev_info["window_s"] = float(dt.window_s)
    return Record(
        end_to_end={"teps": r0["arcs"] * r0["swept"] / r0["window_s_host"],
                    "setup_s": r0["setup_s"]},
        attempted=len(r0["answers"]), failed=failed, checks=checks,
        device=dev_info,
        layers=LayerContext(
            batches=r0["batches"], trace=dt, launches=r0["launches"],
            product_shape=None, occupancy=r0["occupancy"],
            peak_window_bytes=r0["peak_window"]))
