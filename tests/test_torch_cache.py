"""The port's content identity and result cache against the reference.

* ``repro_torch.graphs.graph_digest`` is the reference's string for the
  same graph — directed, undirected, weighted, with duplicate or shuffled
  arcs — and ``GraphStats.from_graph`` plans as the graph does.
* Mirrors of ``tests/test_cache.py`` on ``repro_torch.serve``, held to
  the same assertions: the hit/refine/miss state machine, tightest-ε
  inserts, the LRU cap, the bitwise refine contract on the service's own
  executor, and the ``BCResponse`` wire form, pinned by the checked-in
  golden fixture, which both packages reproduce byte for byte.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

import repro.bc as jbc
import repro.graphs.formats as jfmt
import repro.serve.bc_service as jsvc
from repro.graphs.generators import rmat as jrmat
from repro.graphs.generators import ring_of_cliques as jring
import repro_torch.bc as tbc
from repro_torch.bc import ApproxCheckpoint, resume_approx
from repro_torch.graphs import Graph, GraphStats, graph_digest
from repro_torch.graphs.generators import rmat
from repro_torch.serve.bc_service import BCRequest, BCResponse, BCService
from repro_torch.serve.cache import HIT, MISS, REFINE, ResultCache

_CACHE = {}
GOLDEN = pathlib.Path(__file__).parent / "data" / "bc_response_golden.json"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    if "g" not in _CACHE:
        g = rmat(6, 8, seed=5)
        g, _ = g.remove_isolated()
        _CACHE["g"] = g
    return _CACHE["g"]


def _ckpt_stub(n: int = 4) -> ApproxCheckpoint:
    return ApproxCheckpoint(n=n, eps=0.1, delta=0.1, rule="normal", n_b=n,
                            s1=np.zeros(n), s2=np.zeros(n), tau=0,
                            n_epochs=0, sampler_state={}, prefix_exact=True)


_KW = dict(delta=0.1, k=10, rule="normal", tier="normal")


# ------------------------------------------------------- content identity
def _port(g) -> Graph:
    return Graph(g.n, g.src, g.dst, g.w, g.directed, g.name)


def _variants():
    """name -> a reference graph; each goes through both digests."""
    base = jrmat(6, 8, seed=5).remove_isolated()[0]
    rng = np.random.default_rng(0)
    perm = rng.permutation(base.nnz)
    dup = rng.integers(0, base.nnz, 40)
    heavier = base.w[dup] + 3.0  # duplicates above the kept weight
    return {
        "undirected": base,
        "directed": jfmt.Graph(base.n, base.src, base.dst, base.w, True,
                               base.name),
        "ring of cliques": jring(4, 5),
        "weighted": jrmat(6, 8, seed=5, weighted=True,
                          max_weight=9).remove_isolated()[0],
        "shuffled": jfmt.Graph(base.n, base.src[perm], base.dst[perm],
                               base.w[perm], base.directed, base.name),
        "duplicates": jfmt.Graph(
            base.n, np.concatenate([base.src, base.src[dup]]),
            np.concatenate([base.dst, base.dst[dup]]),
            np.concatenate([base.w, heavier]), base.directed, base.name),
        "self loops": jfmt.Graph(
            base.n, np.concatenate([base.src, np.arange(5)]),
            np.concatenate([base.dst, np.arange(5)]),
            np.concatenate([base.w, np.ones(5, np.float32)]),
            base.directed, base.name),
    }


@pytest.mark.parametrize("name", sorted(_variants()))
def test_digest_equals_reference(name):
    g = _variants()[name]
    d = graph_digest(_port(g))
    assert d == jfmt.graph_digest(g)
    assert len(d) == 64 and int(d, 16) >= 0
    # arc order, duplicates and loops do not change the identity
    if name in ("shuffled", "duplicates", "self loops"):
        assert d == graph_digest(_port(_variants()["undirected"]))
    # the chunk interleaving (src, dst, w per chunk) is the reference's too
    assert graph_digest(_port(g), chunk=7) == jfmt.graph_digest(g, chunk=7)


def test_digest_separates_graphs():
    v = _variants()
    digests = {graph_digest(_port(v[k])) for k in (
        "undirected", "directed", "ring of cliques", "weighted")}
    assert len(digests) == 4  # the directed flag is part of the identity


@pytest.mark.parametrize("weighted", [False, True])
def test_graph_stats_plan_as_the_graph(weighted):
    jg = jrmat(7, 8, seed=5, weighted=weighted,
               max_weight=9).remove_isolated()[0]
    g = _port(jg)
    stats = GraphStats.from_graph(g, digest=graph_digest(g))
    want = jfmt.GraphStats.from_graph(jg, digest=jfmt.graph_digest(jg))
    assert dataclasses.asdict(stats) == dataclasses.asdict(want)
    for q in (tbc.BCQuery(), tbc.BCQuery(mode="approx", eps=0.05,
                                         delta=0.1, topk=10)):
        a = tbc.plan(stats, q, device="cpu").to_json()
        assert a == tbc.plan(g, q, device="cpu").to_json()
    a = tbc.plan_for_request(stats, eps=0.1, delta=0.1, tier="batch",
                             device="cpu")
    b = tbc.plan_for_request(g, eps=0.1, delta=0.1, tier="batch",
                             device="cpu")
    assert a.to_json() == b.to_json()
    assert a.to_json() == jbc.plan_for_request(
        want, eps=0.1, delta=0.1, tier="batch", n_devices=1).to_json()


def test_service_digest_sources():
    """A stats-only registration carries its own digest, a plain graph
    gets ``graph_digest`` lazily, and a (graph, digest) pair keeps the
    digest it was given — as in the reference."""
    g = _graph()
    d = graph_digest(g)
    svc = BCService({"plain": g, "pair": (g, "given"),
                     "stats": GraphStats.from_graph(g, digest=d),
                     "anon": GraphStats.from_graph(g)}, device="cpu")
    assert svc.digest("plain") == d == svc.digest("stats")
    assert svc.digest("pair") == "given"
    assert svc.digest("anon") is None


# ---------------------------------------------------------- state machine
def test_lookup_state_machine():
    """ε ordering: tighter-or-equal cached → HIT, looser cached with a
    checkpoint → REFINE, empty → MISS."""
    c = ResultCache()
    assert c.lookup("d1", eps=0.05, **_KW) == (None, MISS)
    c.put("d1", eps=0.1, payload={"v": 1}, checkpoint=_ckpt_stub(), **_KW)
    entry, kind = c.lookup("d1", eps=0.1, **_KW)  # equal ε
    assert kind == HIT and entry.payload == {"v": 1}
    _, kind = c.lookup("d1", eps=0.2, **_KW)  # looser request
    assert kind == HIT
    entry, kind = c.lookup("d1", eps=0.05, **_KW)  # tighter request
    assert kind == REFINE and entry.checkpoint is not None
    assert c.stats()["hits"] == 2 and c.stats()["refines"] == 1


def test_refine_requires_checkpoint():
    """A looser entry with no checkpoint cannot satisfy a tighter request
    — reported as MISS, never as a silent loose answer."""
    c = ResultCache()
    c.put("d1", eps=0.1, payload={}, checkpoint=None, **_KW)
    assert c.lookup("d1", eps=0.05, **_KW) == (None, MISS)
    _, kind = c.lookup("d1", eps=0.1, **_KW)
    assert kind == HIT


def test_key_mismatches_miss():
    """Any differing key component — digest, δ, k, rule, tier, metric —
    misses: those change the answer, not just its accuracy."""
    c = ResultCache()
    c.put("d1", eps=0.1, payload={}, checkpoint=_ckpt_stub(), **_KW)
    assert c.lookup("d2", eps=0.1, **_KW)[1] == MISS  # digest
    for field, other in [("delta", 0.05), ("k", 5),
                         ("rule", "bernstein"), ("tier", "batch"),
                         ("metric", "closeness")]:
        kw = {**_KW, field: other}
        assert c.lookup("d1", eps=0.1, **kw)[1] == MISS, field
    assert c.lookup(None, eps=0.1, **_KW)[1] == MISS  # digest-less graph


def test_metric_keyed_entries_never_collide():
    """Same (digest, ε, δ, k, rule, tier) under different metrics are
    different analytics: each metric keeps its own entry, its own
    tightest-ε rule and its own refine path."""
    c = ResultCache()
    for m in ("betweenness", "closeness", "khop:2", "khop:3"):
        c.put("d1", eps=0.1, payload={"metric": m},
              checkpoint=_ckpt_stub(), **_KW, metric=m)
    assert len(c) == 4  # no shared slots across metrics (or hop bounds)
    for m in ("betweenness", "closeness", "khop:2", "khop:3"):
        entry, kind = c.lookup("d1", eps=0.1, **_KW, metric=m)
        assert kind == HIT and entry.payload == {"metric": m}, m
    c.put("d1", eps=0.01, payload={"metric": "closeness", "tight": True},
          checkpoint=_ckpt_stub(), **_KW, metric="closeness")
    entry, kind = c.lookup("d1", eps=0.1, **_KW, metric="closeness")
    assert kind == HIT and entry.payload.get("tight")
    entry, kind = c.lookup("d1", eps=0.05, **_KW, metric="betweenness")
    assert kind == REFINE  # betweenness still at ε=0.1, refines
    entry, kind = c.lookup("d1", eps=0.1, **_KW)
    assert kind == HIT and entry.payload == {"metric": "betweenness"}


def test_put_keeps_tightest_entry():
    """A looser result never overwrites a tighter cached one."""
    c = ResultCache()
    c.put("d1", eps=0.05, payload={"tight": True}, **_KW)
    entry = c.put("d1", eps=0.2, payload={"loose": True}, **_KW)
    assert entry.eps == 0.05  # the tighter entry survived
    got, kind = c.lookup("d1", eps=0.1, **_KW)
    assert kind == HIT and got.payload == {"tight": True}
    assert len(c) == 1


def test_lru_eviction_cap():
    """Insertions past max_entries evict least-recently-used keys; a
    lookup refreshes recency."""
    c = ResultCache(max_entries=3)
    for i in range(3):
        c.put(f"d{i}", eps=0.1, payload={"i": i}, **_KW)
    c.lookup("d0", eps=0.1, **_KW)  # refresh d0: d1 is now LRU
    c.put("d3", eps=0.1, payload={"i": 3}, **_KW)
    assert len(c) == 3 and c.evictions == 1
    assert c.lookup("d1", eps=0.1, **_KW)[1] == MISS  # evicted
    assert c.lookup("d0", eps=0.1, **_KW)[1] == HIT  # survived

    with pytest.raises(ValueError, match="max_entries"):
        ResultCache(max_entries=0)


# --------------------------------------------------------- refine contract
def _serve_one(eps: float, *, rid: int = 0, k: int = 10):
    """One checkpointing service run; rid pins the (seed, rid) stream."""
    svc = BCService({"web": _graph()}, checkpoints=True, device="cpu")
    svc.submit(BCRequest(rid=rid, graph="web", eps=eps, delta=0.1,
                         k=k, rule="normal"))
    out = svc.run()
    assert len(out) == 1 and not svc.exhausted
    return out[0], svc


def test_refined_bitwise_equals_scratch_tight():
    """The headline contract: loose run + checkpointed refine to tight ε
    == from-scratch tight run over the same stream, bitwise."""
    loose, svc = _serve_one(0.15)
    assert loose.checkpoint is not None and loose.checkpoint.prefix_exact
    ex = svc.executor_for("web")
    refined, _ = resume_approx(ex, loose.checkpoint, eps=0.05, topk=10)

    scratch, _ = _serve_one(0.05)
    ids = refined.topk(10)
    assert ids.tolist() == scratch.topk
    assert np.array_equal(refined.lam[ids], scratch.lam)
    assert np.array_equal(refined.halfwidth[ids], scratch.halfwidth)
    assert refined.n_samples == scratch.n_samples
    assert refined.n_epochs == scratch.n_epochs
    assert refined.converged


def test_refine_reuses_cached_samples():
    """Refinement continues from the cached sums — it never draws fewer
    samples than the loose run already paid for."""
    loose, svc = _serve_one(0.2)
    ex = svc.executor_for("web")
    refined, ckpt2 = resume_approx(ex, loose.checkpoint, eps=0.1, topk=10)
    assert refined.n_samples >= loose.n_samples
    assert ckpt2.n_epochs == refined.n_epochs
    refined2, _ = resume_approx(ex, ckpt2, eps=0.05, topk=10)
    assert refined2.n_samples >= refined.n_samples


def test_capped_run_checkpoint_not_prefix_exact():
    """A run truncated by its Hoeffding cap records prefix_exact=False."""
    svc = BCService({"web": _graph()}, checkpoints=True, device="cpu")
    svc.submit(BCRequest(rid=0, graph="web", eps=0.1, delta=0.1,
                         rule="bernstein"))
    out = svc.run()
    ck = out[0].checkpoint
    assert ck is not None and not ck.prefix_exact


def test_no_checkpoint_by_default():
    """checkpoints=False (the default) keeps responses lean."""
    svc = BCService({"web": _graph()}, device="cpu")
    svc.submit(BCRequest(rid=0, graph="web", eps=0.2))
    assert svc.run()[0].checkpoint is None


# ------------------------------------------------------------- wire form
def _no_numpy(v):
    if isinstance(v, dict):
        return all(_no_numpy(x) for x in v.values())
    if isinstance(v, (list, tuple)):
        return all(_no_numpy(x) for x in v)
    return not isinstance(v, (np.generic, np.ndarray, torch.Tensor))


def test_response_json_roundtrip():
    """to_json → dumps → loads → from_json restores every field, float64
    bit-exactly (shortest-repr float serialization is lossless)."""
    resp, _ = _serve_one(0.15)
    d = json.loads(json.dumps(resp.to_json()))
    back = BCResponse.from_json(d)
    assert back.rid == resp.rid and back.graph == resp.graph
    assert back.topk == resp.topk
    assert np.array_equal(back.lam, np.asarray(resp.lam))
    assert np.array_equal(back.halfwidth, np.asarray(resp.halfwidth))
    assert (back.n_samples, back.n_epochs, back.converged) == \
        (resp.n_samples, resp.n_epochs, resp.converged)
    assert back.digest == resp.digest and back.tier == resp.tier
    assert back.plan is not None
    assert dataclasses.asdict(back.plan) == dataclasses.asdict(resp.plan)
    assert _no_numpy(resp.to_json())


def test_response_golden_fixture():
    """The wire schema is pinned by the reference's checked-in fixture:
    the port's from_json accepts it and to_json reproduces it byte for
    byte, as the reference's does."""
    text = GOLDEN.read_text()
    golden = json.loads(text)
    resp = BCResponse.from_json(golden)
    assert resp.to_json() == golden
    ours = json.dumps(resp.to_json(), indent=2)
    assert ours == json.dumps(
        jsvc.BCResponse.from_json(golden).to_json(), indent=2)
    assert ours.strip() == text.strip()
    assert _no_numpy(resp.to_json())
