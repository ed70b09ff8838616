"""Cross-request batch fusion in the port: the fused-parity property of
``tests/test_fusion.py`` on ``repro_torch``'s executor.

For any mix of concurrent requests — random slot interleavings, ragged
demand over several buckets, every packing policy — the per-slot
``(S1, S2, n_reach)`` of a fused ``step_segmented`` batch is bitwise what
each request's rows give alone on the same executor, also across a
mid-epoch preemption; the fused rows agree with the reference's fused step
within rtol 1e-5. On the CPU that holds because the plain products and
``segment_fold`` do not depend on the batch size; on the card the
executor also fixes the kernels' split count (the ``cuda`` case below,
which skips without a card; on the card:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_fusion.py``).
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # bare local run: deterministic fallback sweep
    from _hypothesis_fallback import given, settings, strategies as st

from repro_torch.approx.sampling import AdaptiveSampler
from repro_torch.bc import (PACKS, BatchAssembler, BCQuery, ExecutionConfig,
                            FusedBatch, build_executor, bucket_sizes,
                            order_demand, plan, plan_for_request, scatter)
from repro_torch.graphs.generators import rmat
from repro_torch.kernels.tropical_mm import (pick_splits, resolve_splits,
                                             sm_count)

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
_DENSE = ExecutionConfig(backend="dense")


def _graph():
    if "g" not in _CACHE:
        _CACHE["g"] = rmat(6, 8, seed=5).remove_isolated()[0]
    return _CACHE["g"]


def _host_executor():
    if "host" not in _CACHE:
        g = _graph()
        _CACHE["host"] = build_executor(
            g, plan(g, BCQuery(mode="approx", n_b=64, execution=_DENSE),
                    n_devices=1, device="cpu"), device="cpu")
    return _CACHE["host"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


# ------------------------------------------------------------- assembler
def test_assembler_packs_contiguous_and_chops():
    asm = BatchAssembler(_host_executor())
    demand = [(3, np.arange(40, dtype=np.int32)),
              (7, np.arange(40, 70, dtype=np.int32)),
              (1, np.zeros(0, np.int32)),  # empty demand is dropped
              (5, np.arange(70, 100, dtype=np.int32))]
    batches = asm.assemble(demand)
    assert [len(b.sources) for b in batches] == [64, 36]
    assert batches[0].slots == (3, 7) and batches[0].counts == (40, 24)
    assert batches[1].slots == (7, 5) and batches[1].counts == (6, 30)
    joined = np.concatenate([b.sources for b in batches])
    np.testing.assert_array_equal(joined, np.arange(100, dtype=np.int32))
    assert all(isinstance(b, FusedBatch) and b.valid.all() for b in batches)
    assert asm.assemble([]) == []
    with pytest.raises(ValueError, match="duplicate slot keys"):
        asm.assemble([(3, np.arange(4, dtype=np.int32)),
                      (3, np.arange(4, dtype=np.int32))])


def test_bucket_sizes_and_bucket_for():
    assert bucket_sizes(64) == (8, 16, 32, 64)
    assert bucket_sizes(100) == (8, 16, 32, 64, 100)
    assert bucket_sizes(4) == (4,)
    ex = _host_executor()
    assert ex.bucket_for(1) == 8
    assert ex.bucket_for(33) == 64
    with pytest.raises(ValueError, match="exceeds"):
        ex.bucket_for(65)
    with pytest.raises(ValueError, match="exceeds"):
        ex.step(np.zeros(65, np.int32), np.ones(65, bool))


# -------------------------------------------------- fused parity property
def _fused_vs_sequential(ex, n, slot_lens, order_seed, pack="fifo"):
    """Bitwise leg: every slot's fused rows == the same rows alone. Numeric
    leg: per-slot totals == the plain ``step`` over the whole demand."""
    rng = np.random.default_rng(order_seed)
    demand = [(j, rng.integers(0, n, ln).astype(np.int32))
              for j, ln in enumerate(slot_lens) if ln > 0]
    if not demand:
        return
    rng.shuffle(demand)
    slack = {j: float(rng.uniform(-1.0, 5.0)) for j, _ in demand}
    tenant = {j: f"t{int(rng.integers(0, 2))}" for j, _ in demand}
    asm = BatchAssembler(ex, pack=pack)
    fused = {}
    for fb in asm.assemble(demand, slack=slack, tenant=tenant):
        s1, s2, nr = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids,
                                       fb.n_slots)
        for j, key in enumerate(fb.slots):
            rows = fb.sources[(fb.slot_ids == j) & fb.valid]
            assert rows.shape[0] == fb.counts[j]
            b1, b2, bn = ex.step_segmented(
                rows, np.ones(rows.shape[0], bool),
                np.zeros(rows.shape[0], np.int32), 1)
            np.testing.assert_array_equal(s1[j], b1[0])
            np.testing.assert_array_equal(s2[j], b2[0])
            np.testing.assert_array_equal(nr[j], bn[0])
            acc = fused.setdefault(
                key, [np.zeros(n), np.zeros(n), np.zeros(n, np.int64), 0])
            acc[0] += s1[j]
            acc[1] += s2[j]
            acc[2] += nr[j]
            acc[3] += fb.counts[j]
    for key, srcs in demand:
        assert fused[key][3] == srcs.shape[0]
        m1 = np.zeros(n)
        mn = np.zeros(n, np.int64)
        for lo in range(0, srcs.shape[0], ex.n_b):
            c = srcs[lo:lo + ex.n_b]
            r1, _, rn = ex.step(c, np.ones(c.shape[0], bool))
            m1 += r1
            mn += rn
        np.testing.assert_allclose(fused[key][0], m1, rtol=1e-4, atol=1e-6)
        np.testing.assert_array_equal(fused[key][2], mn)


@settings(max_examples=12, deadline=None)
@given(st.lists(st.integers(min_value=0, max_value=50), min_size=1,
                max_size=5),
       st.integers(min_value=0, max_value=2 ** 16),
       st.integers(min_value=0, max_value=len(PACKS) - 1))
def test_fused_parity_single_host(lens, order_seed, pack_idx):
    _fused_vs_sequential(_host_executor(), _graph().n, lens, order_seed,
                         pack=PACKS[pack_idx])


@settings(max_examples=8, deadline=None)
@given(st.lists(st.integers(min_value=1, max_value=50), min_size=2,
                max_size=4),
       st.integers(min_value=0, max_value=2 ** 16),
       st.integers(min_value=0, max_value=len(PACKS) - 1))
def test_fused_parity_survives_preemption_defer(lens, cut_seed, pack_idx):
    """Each slot's demand split at a random point and drained over two
    assembler calls: every slot runs exactly its rows in order, and its
    accumulated statistics are bitwise those of the same chunks alone."""
    ex = _host_executor()
    n = _graph().n
    rng = np.random.default_rng(cut_seed)
    demand = [(j, rng.integers(0, n, ln).astype(np.int32))
              for j, ln in enumerate(lens)]
    cuts = {j: int(rng.integers(0, srcs.size + 1)) for j, srcs in demand}
    slack = {j: float(rng.uniform(-1.0, 5.0)) for j, _ in demand}
    tenant = {j: f"t{int(rng.integers(0, 2))}" for j, _ in demand}
    asm = BatchAssembler(ex, pack=PACKS[pack_idx])
    fused = {j: [np.zeros(n), np.zeros(n)] for j, _ in demand}
    seq = {j: [np.zeros(n), np.zeros(n)] for j, _ in demand}
    ran_rows = {j: [] for j, _ in demand}
    drains = ([(j, srcs[:cuts[j]]) for j, srcs in demand],
              [(j, srcs[cuts[j]:]) for j, srcs in demand])
    for drain in drains:
        for fb in asm.assemble(drain, slack=slack, tenant=tenant):
            s1, s2, nr = ex.step_segmented(fb.sources, fb.valid,
                                           fb.slot_ids, fb.n_slots)
            for key, (r1, r2, _, _cnt) in scatter(fb, (s1, s2, nr)).items():
                fused[key][0] += r1
                fused[key][1] += r2
            for j, key in enumerate(fb.slots):
                rows = fb.sources[(fb.slot_ids == j) & fb.valid]
                ran_rows[key].append(rows)
                b1, b2, _ = ex.step_segmented(
                    rows, np.ones(rows.size, bool),
                    np.zeros(rows.size, np.int32), 1)
                seq[key][0] += b1[0]
                seq[key][1] += b2[0]
    for j, srcs in demand:
        np.testing.assert_array_equal(
            np.concatenate(ran_rows[j]) if ran_rows[j] else
            np.zeros(0, np.int32), srcs)
        np.testing.assert_array_equal(fused[j][0], seq[j][0])
        np.testing.assert_array_equal(fused[j][1], seq[j][1])


def test_fused_rows_match_the_reference_fused_step():
    import repro.bc as jbc

    g = _graph()
    rng = np.random.default_rng(11)
    srcs = rng.integers(0, g.n, 48).astype(np.int32)
    tags = np.sort(rng.integers(0, 3, 48)).astype(np.int32)
    ref_ex = jbc.build_executor(g, jbc.BCPlanner(calibration=None).plan(
        g, jbc.BCQuery(mode="approx", n_b=64, execution=jbc.ExecutionConfig(
            backend="dense", use_kernel=False)), n_devices=1))
    ours = _host_executor().step_segmented(srcs, np.ones(48, bool), tags, 3)
    ref = ref_ex.step_segmented(srcs, np.ones(48, bool), tags, 3)
    np.testing.assert_allclose(ours[0], ref[0], rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ours[1], ref[1], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(ours[2], ref[2])


# ---------------------------------------------------- packing policies
def test_order_demand_policies():
    a = np.arange(10, dtype=np.int32)
    b = np.arange(20, dtype=np.int32)
    c = np.arange(5, dtype=np.int32)
    demand = [(0, a), (1, b), (2, c)]
    assert [k for k, _ in order_demand(demand, "fifo")] == [0, 1, 2]
    out = order_demand(demand, "deadline", slack={0: 5.0, 2: -1.0})
    assert [k for k, _ in out] == [2, 0, 1]
    out = order_demand(demand, "fair", tenant={0: "x", 1: "x", 2: "y"},
                       served={"x": 100})
    assert [k for k, _ in out][0] == 2
    assert {id(s) for _, s in out} == {id(a), id(b), id(c)}
    with pytest.raises(ValueError, match="pack"):
        order_demand(demand, "lifo")
    with pytest.raises(ValueError, match="pack"):
        BatchAssembler(_host_executor(), pack="nope")


# --------------------------------------------------------- demand surface
def test_sampler_demand_matches_epoch_assembly():
    a = AdaptiveSampler(100, n_b=16, cap=200, seed=9)
    b = AdaptiveSampler(100, n_b=16, cap=200, seed=9)
    via_epochs = []
    for ei, batches in a.epochs():
        for batch in batches:
            via_epochs.append(batch.sources[batch.valid])
        if ei == 2:
            a.stop()
    via_demand = []
    while True:
        nxt = b.next_epoch()
        if nxt is None:
            break
        ei, tau = nxt
        via_demand.append(b.draw(tau))
        if ei == 2:
            b.stop()
    np.testing.assert_array_equal(np.concatenate(via_epochs),
                                  np.concatenate(via_demand))
    assert a.drawn == b.drawn


def test_sampler_demand_respects_cap_and_stop():
    s = AdaptiveSampler(100, n_b=16, cap=40, seed=0)
    assert s.next_epoch() == (0, 16)
    s.draw(16)
    assert s.next_epoch() == (1, 24)
    s.draw(24)
    assert s.capped and s.next_epoch() is None
    s2 = AdaptiveSampler(100, n_b=16, seed=0)
    s2.next_epoch()
    s2.stop()
    assert s2.next_epoch() is None


def test_plan_for_request_sizes_nb_from_eps():
    g = _graph()
    tight = plan_for_request(g, eps=0.03, delta=0.1, n_devices=1)
    loose = plan_for_request(g, eps=0.4, delta=0.1, n_devices=1)
    assert loose.n_b <= tight.n_b
    assert tight.buckets[-1] == tight.n_b
    assert list(tight.to_json()["buckets"]) == list(tight.buckets)


# ------------------------------------------------------------- the card
def test_split_count_is_fixed_only_on_the_card():
    """On the CPU ``for_batches`` changes nothing (the plain products have
    no slices); an explicit split count must leave no slice empty."""
    ex = _host_executor()
    assert ex._adj.splits is None
    assert ex._adj.for_batches(128) is ex._adj
    cpu = torch.device("cpu")
    assert resolve_splits(3, 8, 100, 100, cpu) == 3  # 7 k-tiles: 3+3+1
    assert resolve_splits(4, 8, 100, 100, cpu) == 4  # 2+2+2+1
    for bad in (0, 5, 8):  # 5 slices of 7 tiles leave one empty
        with pytest.raises(ValueError, match="empty slice"):
            resolve_splits(bad, 8, 100, 100, cpu)


@pytest.mark.cuda
def test_rows_bitwise_across_buckets_on_the_card(cuda):
    """One executor of n_b = 128 on the card, at scale 12, where
    ``pick_splits`` alone would give bucket 128 another split count than
    buckets 8 and 64: the same rows give bitwise the same per-slot
    statistics at all three, twice in a row."""
    g = rmat(12, 16, seed=0, weighted=True,
             max_weight=100).remove_isolated()[0]
    sms = sm_count(cuda.index or 0)
    assert len({pick_splits(b, g.n, g.n, sms) for b in (8, 64, 128)}) > 1
    ex = build_executor(g, plan(g, BCQuery(mode="approx", n_b=128,
                                           execution=_DENSE), n_devices=1),
                        device=cuda)
    assert ex._adj.splits == pick_splits(128, g.n, g.n, sms)
    rng = np.random.default_rng(0)
    rows = rng.integers(0, g.n, 5).astype(np.int32)
    alone = ex.step_segmented(rows, np.ones(5, bool), np.zeros(5, np.int32),
                              1)
    assert ex.bucket_for(5) == 8
    for b in (64, 128):
        src = np.concatenate([rows, rng.integers(0, g.n, b - 5).astype(
            np.int32)])
        sid = np.repeat(np.array([0, 1], np.int32), [5, b - 5])
        assert ex.bucket_for(src.size) == b
        for _ in range(2):
            fused = ex.step_segmented(src, np.ones(b, bool), sid, 2)
            for x, y in zip(fused, alone):
                np.testing.assert_array_equal(x[0], y[0])


@pytest.mark.cuda
def test_csr_rows_bitwise_across_buckets_on_the_card(cuda):
    """The CSR backend on the card, executors of n_b = 64 and 128 at R-MAT
    scale 12: a slot's rows give bitwise the same statistics alone (bucket
    8) and fused at buckets 64 and 128, though each batch's union frontier
    picks its own capacity buckets: the segment sums add in arc order."""
    g = rmat(12, 16, seed=0, weighted=True,
             max_weight=100).remove_isolated()[0]
    rng = np.random.default_rng(1)
    rows = rng.integers(0, g.n, 5).astype(np.int32)
    for n_b in (64, 128):
        ex = build_executor(g, plan(g, BCQuery(
            mode="approx", n_b=n_b, execution=ExecutionConfig(
                backend="csr")), n_devices=1), device=cuda)
        alone = ex.step_segmented(rows, np.ones(5, bool),
                                  np.zeros(5, np.int32), 1)
        src = np.concatenate([rows, rng.integers(0, g.n, n_b - 5).astype(
            np.int32)])
        sid = np.repeat(np.array([0, 1], np.int32), [5, n_b - 5])
        for _ in range(2):
            fused = ex.step_segmented(src, np.ones(n_b, bool), sid, 2)
            for x, y in zip(fused, alone):
                np.testing.assert_array_equal(x[0], y[0])
