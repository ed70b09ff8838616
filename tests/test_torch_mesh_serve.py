"""Serving on a multi-process mesh: ``BCService(mesh=)`` against the
port's single-host service and the reference's mesh service.

* One spawned world of 4 gloo ranks on the CPU (``tests/_torch_world.py``)
  serves R-MAT scale 7 on the (2, 2) mesh: rank 0 serves, ranks 1–3 call
  ``follow()`` until rank 0's ``close()``. The cases: the requests of the
  reference's ``test_bc_service_mesh_path``, a fused pair under every
  ``pack`` policy, and a gateway miss then a refine at a tighter ε.
  Each answer has the same ``n_samples``, ``n_epochs`` and ``converged``
  as the same requests on the port's single-host dense service and on the
  reference's ``BCService(mesh=)`` over a 2 × 2 host-device mesh (a
  subprocess); λ̂ and the halfwidths agree within rtol 1e-5.
* The refusals: a closeness request raises on rank 0 (its plan has no
  mesh step), as do a closeness step, ``labels()`` and a batch over
  ``n_b`` on the executor, before anything is sent: the followers run
  no call and return from ``follow()`` after ``close()``. ``follow()`` on
  rank 0 and ``close()`` off rank 0 raise. A failure of rank 0's lazy
  context upload raises before anything is sent, too.
* A server idle for 1.5 × its control group's timeout, before and after
  a call, keeps its followers (rank 0's keep-alives).

The module imports neither jax nor ``repro`` at the top: the spawned ranks
import it. The tests import the reference inside their bodies.
"""
import datetime
import json
import time
import traceback

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.bc import ExecutionConfig
from repro_torch.graphs.generators import rmat
from repro_torch.launch.mesh import Mesh
from repro_torch.serve import BCGateway, BCService, GatewayConfig
from repro_torch.serve.bc_service import BCRequest

from _torch_world import finish_reference, run_reference, run_world

WORLD = 4
SHAPE, NAMES = (2, 2), ("data", "model")
ANSWER = ("topk", "lam", "halfwidth", "n_samples", "n_epochs", "converged")
# One request list per service: (service keywords, requests).
CASES = {
    # the reference's test_bc_service_mesh_path
    "mesh_path": (dict(n_slots=1, iters=32),
                  [dict(rid=0, graph="web", k=5, rule="normal")]),
    **{f"fused_{pack}": (dict(n_slots=2, pack=pack, iters=32),
                         [dict(rid=0, graph="web", eps=0.1,
                               priority="interactive", tenant="a"),
                          dict(rid=1, graph="web", eps=0.3, tenant="b",
                               seed=3)])
       for pack in ("deadline", "fair", "fifo")},
}
# The gateway case: a miss, then a tighter ε that refines its checkpoint.
POSTS = ({"graph": "web", "eps": 0.1}, {"graph": "web", "eps": 0.07})
IDLE_TIMEOUT_S = 2.0  # the idle case's control-group timeout


def _graph():
    return rmat(7, 8, seed=5).remove_isolated()[0]


def _answer(doc: dict) -> dict:
    return {k: doc[k] for k in ANSWER}


def _serve(svc, reqs) -> list:
    for r in reqs:
        svc.submit(BCRequest(**r))
    out = svc.run()
    assert not svc.exhausted
    return [_answer(r.to_json()) for r in sorted(out, key=lambda r: r.rid)]


def _gateway(svc) -> list:
    """Each POST, drained inline: the final status documents' answers."""
    gw = BCGateway(svc, GatewayConfig(horizon_s=1e9))
    docs = []
    for post in POSTS:
        rid = gw.submit(dict(post))["rid"]
        gw.drain()
        doc = gw.get(rid)
        assert doc["status"] == "done", doc
        docs.append(doc)
    assert docs[1]["refined"]
    return [_answer(d["result"]) for d in docs]


def _expect(exc, fn) -> str:
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"{fn} did not raise {exc.__name__}")


def _rank_cases(rank: int, mesh) -> dict:
    """Every case on this rank, each service constructed on every rank in
    the same order. Rank 0's answers; the followers' call counts."""
    g = _graph()
    out = {}
    for key, (kw, reqs) in CASES.items():
        svc = BCService({"web": g}, mesh=mesh, **kw)
        if rank == 0:
            try:
                out[key] = _serve(svc, reqs)
                out[key + "_mirrored"] = svc.mirrored
            finally:
                svc.close()
        else:
            out[key] = svc.follow()
    svc = BCService({"web": g}, mesh=mesh, checkpoints=True)
    if rank == 0:
        try:
            out["gateway"] = _gateway(svc)
            out["gateway_mirrored"] = svc.mirrored
        finally:
            svc.close()
    else:
        out["gateway"] = svc.follow()
    # the refusals: nothing is sent, the followers return on close()
    svc = BCService({"web": g}, mesh=mesh)
    if rank == 0:
        try:
            out["follow_on_0"] = _expect(RuntimeError, svc.follow)
            svc.submit(BCRequest(rid=0, graph="web", metric="closeness"))
            out["closeness"] = _expect(ValueError, svc.run)
            ex = svc.executor_for("web")
            src, val = np.zeros(4, np.int32), np.ones(4, bool)
            out["closeness_step"] = _expect(NotImplementedError, lambda: (
                ex.step(src, val, metric="closeness")))
            out["labels"] = _expect(NotImplementedError, ex.labels)
            big = np.zeros(ex.n_b + 1, np.int32)
            out["oversize"] = _expect(ValueError, lambda: ex.step(
                big, np.ones(big.shape[0], bool)))
            out["refused_mirrored"] = svc.mirrored
        finally:
            svc.close()
        svc.close()  # a second close sends nothing
    else:
        out["close_off_0"] = _expect(RuntimeError, svc.close)
        out["refused"] = svc.follow()
    # rank 0's context upload fails (as out of memory would): nothing sent
    svc = BCService({"web": g}, mesh=mesh)
    if rank == 0:
        try:
            ex = svc.executor_for("web")

            def upload():
                raise RuntimeError("the upload failed on rank 0")

            ex._context = upload
            svc.submit(BCRequest(rid=0, graph="web", eps=0.3))
            out["upload"] = _expect(RuntimeError, svc.run)
            out["upload_mirrored"] = svc.mirrored
        finally:
            svc.close()
    else:
        out["upload"] = svc.follow()
    # idle longer than the control group's timeout, before and after a call
    svc = BCService({"web": g}, mesh=mesh, ctrl_timeout=datetime.timedelta(
        seconds=IDLE_TIMEOUT_S))
    if rank == 0:
        try:
            time.sleep(1.5 * IDLE_TIMEOUT_S)
            out["idle"] = _serve(svc, [dict(rid=0, graph="web", eps=0.3)])
            time.sleep(1.5 * IDLE_TIMEOUT_S)
            out["idle_mirrored"] = svc.mirrored
        finally:
            svc.close()
    else:
        out["idle"] = svc.follow()
    return out


def _world_main(rank: int, store: str, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        out = _rank_cases(rank, Mesh(SHAPE, NAMES, device="cpu"))
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro.graphs.generators import rmat
from repro.serve import BCGateway, BCService, GatewayConfig
from repro.serve.bc_service import BCRequest

spec = json.loads(sys.argv[1])
g = rmat(7, 8, seed=5).remove_isolated()[0]
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
keys = spec["answer"]
out = {}
for key, (kw, reqs) in spec["cases"].items():
    svc = BCService({"web": g}, mesh=mesh, **kw)
    for r in reqs:
        svc.submit(BCRequest(**r))
    got = sorted(svc.run(), key=lambda r: r.rid)
    out[key] = [{k: r.to_json()[k] for k in keys} for r in got]
gw = BCGateway(BCService({"web": g}, mesh=mesh, checkpoints=True),
               GatewayConfig(horizon_s=1e9))
out["gateway"] = []
for post in spec["posts"]:
    rid = gw.submit(dict(post))["rid"]
    gw.drain()
    out["gateway"].append({k: gw.get(rid)["result"][k] for k in keys})
with open(spec["out"], "w") as f:
    json.dump(out, f)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port results by rank, the reference's answers): the 4-rank world
    and the reference subprocess run side by side."""
    path = str(tmp_path_factory.mktemp("ref") / "ref.json")
    proc = run_reference(_REFERENCE, {"out": path, "cases": CASES,
                                      "posts": POSTS, "answer": ANSWER})
    try:
        got = run_world(_world_main, WORLD)
    finally:
        finish_reference(proc)
    with open(path) as f:
        return got, json.load(f)


@pytest.fixture(scope="module")
def single_host():
    """The same cases on the port's single-host service, on the dense
    backend of the mesh step."""
    g = _graph()
    kw = dict(device="cpu", execution=ExecutionConfig(backend="dense"))
    out = {key: _serve(BCService({"web": g}, **kw, **case_kw), reqs)
           for key, (case_kw, reqs) in CASES.items()}
    out["gateway"] = _gateway(BCService({"web": g}, checkpoints=True, **kw))
    return out


def _same(got: list, want: list, rtol: float) -> None:
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a["n_samples"], a["n_epochs"], a["converged"]) == \
            (b["n_samples"], b["n_epochs"], b["converged"])
        np.testing.assert_allclose(a["lam"], b["lam"], rtol=rtol)
        np.testing.assert_allclose(a["halfwidth"], b["halfwidth"], rtol=rtol)


@pytest.mark.parametrize("case", [*CASES, "gateway"])
def test_mesh_service_matches_single_host_and_reference(world, single_host,
                                                        case):
    got, ref = world
    answers = got[0][case]
    _same(answers, single_host[case], rtol=1e-5)
    _same(answers, ref[case], rtol=1e-5)
    # every mirrored call ran on every follower
    for r in range(1, WORLD):
        assert got[r][case] == got[0][case + "_mirrored"] > 0


def test_mesh_path_converges_to_the_top_k(world):
    """The reference's assertions on its mesh-path request."""
    from repro_torch.core.brandes_ref import brandes_bc

    (ans,) = world[0][0]["mesh_path"]
    assert ans["converged"]
    top_ref = set(np.argsort(brandes_bc(_graph()))[::-1][:5].tolist())
    assert len(top_ref & set(ans["topk"])) >= 4


def test_mesh_refusals_raise_before_anything_is_sent(world):
    got, _ = world
    r0 = got[0]
    assert "mesh placement is betweenness-only" in r0["closeness"]
    assert "runs betweenness only" in r0["closeness_step"]
    assert "no fixed-point metric entry" in r0["labels"]
    assert "exceeds the executor's n_b" in r0["oversize"]
    assert r0["refused_mirrored"] == 0
    assert all(got[r]["refused"] == 0 for r in range(1, WORLD))


def test_a_failed_upload_on_rank_0_sends_nothing(world):
    got, _ = world
    assert "the upload failed on rank 0" in got[0]["upload"]
    assert got[0]["upload_mirrored"] == 0
    assert all(got[r]["upload"] == 0 for r in range(1, WORLD))


def test_idle_followers_outlive_the_control_timeout(world):
    got, _ = world
    (ans,) = got[0]["idle"]
    assert ans["converged"] and ans["n_samples"] > 0
    for r in range(1, WORLD):
        assert got[r]["idle"] == got[0]["idle_mirrored"] > 0


def test_follow_and_close_belong_to_their_ranks(world):
    got, _ = world
    assert "rank 0 serves" in got[0]["follow_on_0"]
    for r in range(1, WORLD):
        assert "runs on rank 0" in got[r]["close_off_0"]
