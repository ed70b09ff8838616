#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout on a host with one CUDA card. Phases, in
order; any failed check raises and the script exits non-zero:

1. build — compile every CUDA kernel of the path from
   ``src/repro_torch/kernels/csrc`` (one ``nvcc`` per source, all started
   together); print the build seconds and the card's name and power limit.
2. kernels — each kernel against its plain PyTorch version on the card,
   over the shape sweep of ``tests/test_kernels.py`` plus the main path's
   shapes, on an empty frontier, tie-heavy unit weights and random inputs
   with inactive entries: ``w`` and ``c`` bitwise, ``m`` within rtol 1e-6,
   ``p`` within rtol 1e-5. The sweep includes shapes that split the
   contraction (split-K) and one whose k is shorter than a slice. Two
   launches of each kernel on the same inputs must agree bitwise. Then
   each kernel, its plain version and the SP-DAG child count are timed
   with CUDA events at the main path's shapes, with each kernel's grid and
   split count S.
3. main path — exact betweenness of a weighted R-MAT graph at scale 12
   (edge factor 16, Graph500 quadrant mix, integer weights in [1, 100],
   isolated vertices removed) through ``repro_torch.core.mfbc.mfbc`` on the
   card, counting each kernel's launches (the child count's too); λ over
   the first 64 sources is held against the numpy Brandes oracle (rtol
   1e-5, atol 1e-8) and against the same batch run with the plain
   versions on the card.
4. scale 14 — one 64-source batch of a weighted scale-14 R-MAT graph: its
   seconds, peak device memory, and λ over its first 8 sources against the
   oracle; then each kernel alone and the child count are timed at
   (64, 12536, 12536).
5. the sampled path — ``repro_torch.bc.solve`` of an approximate query
   (ε = 0.05, δ = 0.1, top-10, n_b = 64, dense, one device) through the
   planner, the executor and the adaptive epochs:
   a. scale 12: plan, samples, epochs, seconds and launches; λ̂ within ε
      of phase 3's exact λ on the normalized scale (max|λ̂ − λ| / (n(n−2)))
      and the top-10 precision;
   b. scale 14, full size: the same, with TEPS (model) = m·τ/t and peak
      device memory; the first sample batch's (S1, S2, n_reach) against
      the same batch with the plain products on the card (S1, S2 rtol
      1e-5, n_reach bitwise);
   c. fused batches: requests of 5, 20 and 39 sources packed by a
      ``BatchAssembler`` into one 64-row batch, each slot bitwise equal to
      its rows alone at their own buckets (8, 32, 64), and the fused batch
      bitwise equal over two launches; the same with an n_b = 128
      executor and 104 rows (buckets 8, 32, 64, 64 alone, 128 fused), at
      both scales. Also printed: how many elements a bucket-8 and a
      bucket-128 run of the same rows would differ in if each bucket took
      its own split count (what the executor's fixed count prevents), and
      the time of the in-order segmented sum.

6. the COO and CSR backends, with the third kernel, the sparse relax:
   a. the sparse-relax kernel, MFBF and MFBr, against its plain version
      run on the CPU, bitwise in every field and over two launches, at
      long-run thresholds 0, 32 and the default: runs across the chunk
      boundaries (31, 32, 33, 4095, 4097 arcs), all-ties runs whose sums
      depend on their order, empty runs, ±inf weights, a dead tail past
      offsets[n], a row with no finite candidate, a 25,231-arc run;
   b. scale 14, one 64-source batch through the dense, COO and CSR
      executors: ``w``, ``m``, the child counts ``c`` and ``n_reach``
      bitwise equal across the three (max ``m`` printed, below 2^24),
      S1/S2 within rtol 1e-5; CSR against CSR with caps ((1, 1),),
      bitwise in every field; fused == alone on CSR at n_b 64 and 128 at
      scales 12 and 14, bitwise;
   c. scale-12 exact BC through an unpinned ``solve`` (the planner picks
      CSR) against phase 3's dense λ (rtol 1e-5, atol 1e-8), with its
      seconds, TEPS (model) and occupancy;
   d. scale 18 (n = 173,847, 7,610,770 arcs), an unpinned ``solve`` of
      ε = 0.05, δ = 0.1, top-10 on the planner's own backend and n_b: the
      plan, samples, epochs, seconds, TEPS (model), peak device memory and
      occupancy. Its first sample batch: ``Tw`` bitwise equal to scipy's
      Dijkstra, the ladder bitwise equal to the forced fallback, λ of one
      source against ``brandes_bc``; the sparse relax checked and timed
      (with its plain version, ``scatter_reduce_`` and ``index_add_`` and
      its bound) at the full-edge-list MFBF shape and at a bucket-2 MFBr
      shape. ``max_samples`` is capped if the budget's batches would take
      more than ``EPOCH_LIMIT_S``;
   e. ``launch.calibrate`` at scale 14 into a temporary file under
      ``build/``, its rates, and the plan it gives phase 6d's query.

7. the metric registry, through ``solve`` and the executor:
   a. scale 12: closeness, khop (hops 2 and 3) and components, exact,
      pinned to dense, COO and CSR and unpinned: khop and components
      bitwise equal to their oracles, closeness within rtol 1e-5, atol
      1e-5, with the seconds of each. The all-sources oracles come from
      scipy (``farness``, ``khop_counts``), which are held first to the
      repo's ``closeness_ref`` / ``khop_ref`` over 8 sources; components
      against ``cc_ref``;
   b. cross-metric fusion: one ``step_segmented`` with a betweenness and a
      closeness slot on dense at n_b 64 and on CSR at n_b 16, and two khop
      slots, each slot bitwise equal to its rows alone; a khop + closeness
      batch raises;
   c. scale 18: unpinned approximate closeness and khop (hops 2) of
      ε = 0.05, δ = 0.1, top-10 (``max_samples`` capped as in 6d), the
      first sample batch's S1 and n_reach against scipy over its sources;
      unpinned exact components bitwise equal to ``cc_ref``;
   d. the BFS baseline on an unweighted scale-12 R-MAT, dense and COO at
      n_b 64 with ``max_depth`` the largest BFS depth scipy finds: against
      the port's dense ``mfbc`` (rtol 1e-5, atol 1e-8), and its first
      batch against ``brandes_bc`` over sources 0..63.

8. serving, through ``repro_torch.serve``'s HTTP gateway on an ephemeral
   port (urllib; the solver on the gateway's worker thread). Each
   graph's executor is built and run once on the main thread first, and
   that warm-up is timed apart. Requests are posted to the listener
   before the worker starts, so they are admitted in one tick:
   a. scale 14, dense (``ExecutionConfig(backend="dense")``, the
      planner's n_b, checkpoints on): a betweenness ε 0.1 interactive and
      a closeness ε 0.1 normal request, fused; the identical repeat (HTTP
      200, the byte-identical payload); ε 0.07 (202, ``refining``, then
      ``refined``). Then, on the service's own executor: each answer
      bitwise equal to the same request served alone, the lone
      betweenness request to ``solve`` over its (seed, rid) stream, and
      the refined answer to a scratch run at ε 0.07;
   b. scale 18 (phase 6d's graph), unpinned, 4 slots: betweenness ε 0.1
      (interactive), closeness ε 0.1 (normal), khop 2 (batch) and
      components; each request's submit→done latency, samples and
      epochs, the cache hit's round trip, ``/v1/graphs``, the learned
      admission corrections and peak device memory; the components labels
      bitwise ``cc_ref`` (7c's), the betweenness and khop answers bitwise
      ``solve`` over their streams;
   c. overload without a race: 12 batch-tier requests at a horizon of
      1.5 predicted solves before the worker starts draw one 202 and
      eleven 429s with ``Retry-After``; an interactive request is
      admitted; then the worker drains both; under ``overload="degrade"``
      a request is served at ε 0.3 with ``degraded_from``.
   Any error status, error count, poll timeout or dead worker fails.
9. the distributed Theorem 5.1 step (``repro_torch.launch.mesh``,
   ``core.dist_bc``, ``bc.MeshExecutor``):
   a. each product at the mesh's local shapes, (64, 6268, 6268) on
      data 2 × model 2 and (32, 6268, 12536) on pod 2 × data 1 × model 2
      at scale 14, against its blocked plain version on the card (``w``,
      ``c`` bitwise, ``m`` rtol 1e-6, ``p`` rtol 1e-5), timed beside its
      bound;
   b. four spawned ranks sharing the card over gloo (gloo stages the CUDA
      tensors through the host; NCCL refuses two ranks on one card): on
      each of (2, 2) and (2, 1, 2) a 64-source scale-14 batch through
      ``MeshExecutor`` (the mean seconds of ``MESH_REPEATS`` after the
      first) against the single-host dense batch (``n_reach``
      bitwise, S1/S2 rtol 1e-5, atol 1e-8) and identical on every rank,
      with each rank's bytes per collective kind beside
      ``model_mesh_bytes``; exact λ of scale 12 on (2, 2) against phase
      3's; an (ε, δ) = (0.1, 0.1) ``solve(mesh=)`` at scale 14, n_b 64,
      against the single-host ``solve`` (the same samples and epochs, λ̂
      rtol 1e-5); the streamed upload of a written binary COO file
      (``EdgeListReader`` → ``build_sharded_adjacency``), its batch
      bitwise the eager upload's; then serving on the (2, 2) mesh
      (``BCService(mesh=, checkpoints=True)``, built on every rank): rank
      0 serves scale 14 behind the HTTP gateway — betweenness ε 0.1
      interactive and ε 0.1 normal posted before its worker starts (one
      fused tick), the identical repeat (a byte-identical cache hit), ε
      0.07 (a refine) — while ranks 1–3 ``follow()`` until its
      ``close()``; every answer has the samples, epochs and convergence of
      the same requests on a single-host dense service on the card, λ̂ and
      the halfwidths within rtol 1e-5, every follower ran each call rank 0
      mirrored, with each request's submit→done latency and the control
      broadcast's ms a call. Times are of 4 ranks sharing one card, not of
      a multi-card mesh: ``tools/torch_mesh_cards.py`` runs this phase
      over NCCL on four cards, one a rank;
   c. a one-rank NCCL mesh (1 × 1) in this process: one scale-14 batch
      bitwise the single-host dense batch, and a ``BCService`` on it
      serving betweenness ε 0.1 bitwise the single-host dense service.
10. a resumable run: ``launch.bc_run`` exact at scale 12 (phase 3's graph)
    on dense, n_b 64, ``--ckpt-dir`` under ``build/``: an uninterrupted
    run, then a run killed after saving global batch 20 and run again, so
    that it resumes at batch 21; its λ equals phase 3's (rtol 1e-5, atol
    1e-8) and the uninterrupted run's (rtol 1e-12). The runs' seconds and
    a save's ms a batch.
11. LM serving (``repro_torch.models``, ``serve.engine``, ``launch.serve``),
    f32 with TF32 off (the flag is printed; the phase fails if it is on):
    a. gemma2-27b at its full width (d_model 4608, 32 query / 16 KV heads of
       128, d_ff 36864 GeGLU, vocab 256000, softcaps 50 / 30, alternating
       4096-window local / global layers, tied scaled embeddings), 8 of its
       46 layers, weights drawn on the card from a seeded CUDA generator: a
       ``ServeEngine`` of 4 slots and ``max_len`` 4352 serves 6 requests
       (prompts of 16, 128, 512, 1000, 4200 and 64 tokens; the 4200-token
       one passes the window), so slots recycle and position groups
       differ. Every token equals the argmax of one teacher-forced pass
       over its request's prompt and its own tokens (``forward_hidden``,
       then the LM head at the generated positions only), but where the two
       tokens' logits are within 1e-4 · max|logit| (counted). Printed: the
       parameter bytes, each prefill's ms, ms a ``decode_step`` beside its
       bound (the parameter bytes at 3.35 TB/s), tokens per second, ticks
       and peak device memory;
       Then one ``decode_step`` over the 4 slots by CUDA events and under
       ``torch.profiler``: the device's busy share and its top kernels;
    b. moonshot-v1-16b-a3b at its full width (MoE of 64 experts, top 6, 2
       shared), 2 of its 48 layers: one prefill of 2 × 256 tokens and 8
       ``decode_step``s on the card against the same calls on the CPU with
       the weights copied there, in f64 (logits and caches within rtol
       1e-4, atol 1e-4 · max(1, max|x|); layer 0's MoE on one identical
       input within 1e-6 of its scale: the dispatch by ``index_add_``
       atomics) and in f32 (the difference printed; see ``phase11b``);
    c. ``launch.serve.main(["--arch", a, "--smoke", "--device", d])`` for
       each of the five architectures on the card and on the CPU: the
       printed line, the shape, and the same token ids (a row may differ
       from a near tie on, judged on the CPU's logits).
    Phase 11 runs none of the three kernels: the LM's products are
    ``torch.matmul`` / ``torch.einsum``, as the reference computes them
    outside any Pallas kernel. It fails if one of them launched.
12. LM training (``repro_torch.train.train_lib``, ``optim``,
    ``launch.train``), f32 with TF32 off (printed; the phase fails if it
    is on):
    a. gemma2-27b at its full width, 4 of its 46 layers (3.445 B
       parameters; weights, gradients and both AdamW moments in f32 are
       55.1 GB), remat full, CE in 8 chunks, weights drawn on the card
       from a seeded CUDA generator, one sequence of 4096 tokens a step
       from ``LMPipeline`` (seed 0), ``launch.train``'s AdamW (lr 3e-4,
       warm-up over the run, clip 1.0). First step 0's gradient against
       the loss along ``g/|g|``: central differences at two step sizes
       (the loss moved by about 1e-2 and 1e-3), the closer within 1e-2 of
       |g|. Then 6 steps of ``make_lm_train_step``: every loss finite and
       the last below the first. Printed: the state's bytes, step 0's ms,
       the median ms of steps 1-5 (host clock around a synced step),
       tokens/s, the model FLOPs of a step (6·N·B·S) and the TFLOP/s they
       give beside 67 TFLOP/s f32, peak device memory, the optimizer
       alone by CUDA events beside its bound (28 B a parameter at 3.35
       TB/s), whether step 0 repeats the check's loss and grad norm
       bitwise, and one step under ``torch.profiler`` (busy share, top
       kernels);
    b. moonshot-v1-16b-a3b at its full width, 1 of 48 layers: whether
       step 0 run twice from one state on the card is bitwise equal (the
       MoE dispatch adds by atomics); then one step of the train cell's
       AdamW on 2 x 256 tokens on the card and on the CPU from one state,
       in f32 and f64; in f64 the loss, the grad norm and every updated
       parameter within rtol 1e-4, atol 1e-4 · max(1, max|x|); m and the
       updates' directions printed, and the f32 differences;
    c. ``launch.train.main(["--arch", a, "--smoke", "--steps", "20",
       "--device", d])`` for the five architectures on the card and on
       the CPU: the first 8 losses within rtol 1e-4;
    d. ``launch.train --arch gemma2-27b --smoke --compress int8
       --ckpt-dir`` on the card with failures at steps 4 and 8 against the
       run without them: the final checkpoints' parameters within rtol
       1e-6.
    Phase 12 runs none of the three kernels either.
13. the GNN and recsys families (``repro_torch.models.{gnn,recsys,
    gnn_dist}``, ``configs.base.GNNArch`` / ``RecsysArch``), f32 with
    TF32 off, at their published widths:
    a. gcn-cora, gin-tu, nequip and gat-cora on ``full_graph_sm``,
       ``minibatch_lg`` and ``molecule`` at the cells' sizes, through
       ``build(cell).fn`` with state and batch drawn on the card: ms a
       step (median of 5 after one), model TFLOP/s beside 67, peak
       memory; then one step in f64 on the card and the CPU from one
       state: the loss within rtol 1e-4, every parameter within rtol
       1e-4, atol 1e-4 · max(1, max|x|), every leaf's update at cosine
       ≥ 0.999;
    b. ``ogb_products`` full-batch (2,449,029 nodes, 61,859,140 edges)
       for gcn-cora (step 0's gradient against central differences
       along g/|g|, as 12a; one step under ``torch.profiler``), gin-tu
       and gat-cora (listed with its peak if it does not fit): ms a
       step, edges/s (E × layers / step), model TFLOP/s, peak memory.
       nequip × ogb_products is listed, not run: its (E, 32, 3, 3)
       tensors are 71.3 GB each and need the mesh;
    c. xDeepFM at full width (a 39,000,064 × 10 table, CIN (200, 200,
       200), MLP (400, 400)): the serve and retrieval steps on 64 rows /
       4,096 candidates and one train step on 64 rows, card against CPU
       in f64 (within 1e-4 of their scale; the train step as 13a); then
       ``train_batch`` at the largest of 65,536 / 32,768 / 16,384 rows
       that fits (ms a step, examples/s, one step under the profiler),
       ``serve_p99`` (512 rows: p50 and p99 over 200 calls),
       ``serve_bulk`` (262,144 rows in chunks of 32,768; examples/s) and
       ``retrieval_cand`` (10^6 candidates, ms);
    d. ``examples/torch_gnn_train.py``'s two loops (the port's
       ``examples/gnn_train.py``) on the card and the CPU from the same
       initial parameters: the losses fall as the example asserts, the
       first 8 within rtol 1e-4;
    e. ``models.gnn_dist``'s 2D GCN (gcn-cora's width, d_in 100, 47
       classes) on phase 6d's scale-18 graph with its ids permuted, on
       four gloo ranks sharing the card ((2, 2)) and on a one-rank NCCL
       mesh: loss within rtol 1e-5 and gradients within rtol 2e-4, atol
       1e-6 of the single-device GCN; seconds a step; bytes a rank by
       kind, one forward's equal to |H|/R + |H|/C.
    Phase 13 runs none of the three kernels either.
14. the paper's own architecture, the dry run and a sharded LM step:
    a. ``get_arch("mfbc_paper")``'s ``bc_dense_64k`` cell built with
       ``NO_SHARDING`` at its full n = 65,536 and 6 iterations, its A
       built on the card from ``erdos_renyi(n, 4/n, seed=1)``'s arcs, the
       batch cut from 16,384 to 64 sources (``BC64K_NB``): ``bundle.fn``
       launches both products at (64, 65536, 65536); λ finite and ≥
       -1e-6; the step's seconds and peak memory; the step again under
       ``torch.profiler`` (busy share, top kernels). Then one relax of each
       product at that shape against its plain version on 128 output
       columns: one whole 64-column tile at a seeded offset and 64
       columns ``k * 1021 % n``, at every offset in a tile (``w``, ``c``
       bitwise, ``m`` rtol 1e-6, ``p`` rtol 1e-5), and timed beside its
       bound; the iterations MFBF and MFBr need uncapped on the graph;
       each product at bc_web_256k's per-device shape on the multi mesh,
       (4096, 16384, 16384), held on 128 columns chosen the same way and
       timed beside its bound and the tile model
       (``launch.perf_hillclimb.hillclimb_bc_blocks``);
    b. ``python -m repro_torch.launch.dryrun`` of one cell a family on
       the multi mesh (512 fake ranks on the host), each in a subprocess
       (all four at once), then ``roofline.analysis`` over the records:
       each record's per-device peak bytes, FLOPs and wire bytes;
    c. gemma2-27b at full width, 2 layers, bf16, the train cell's step
       (``build(cell, make_policy(mesh))``: int8 moments, CE in 8 chunks)
       on a one-rank NCCL (1, 1, 1) DeviceMesh, its parameters DTensors
       placed by the policy, 3 steps of 2,048 tokens; its losses against
       the same step without a mesh on the card (rtol 1e-5), and its
       parameters after the last step against that step's (the norm of
       their difference within 1e-3 of the norm of the update, which
       must not be 0).
    Phase 14a's step is a main-path run of the dense kernels and the
    child count kernel, which is then held bitwise to its plain form on
    MFBF's distances at (64, 65536) and timed beside its bound and the
    plain form's time.

Each main-path run (phases 3, 4, 5a, 5b on the dense kernels, 6c and 6d
on the sparse relax, every run of 7a, 7c and 7d on its backend's
kernels, the served requests of 8a on the dense kernels, 8b and 8c on
the sparse relax, every mesh run of 9b on every rank, 9c's batch and
service and 10's resumed run on the dense kernels) starts with the launch
counts at 0 and fails if a kernel of its path did not launch in it. The
line before the last is one JSON object with each kernel's launches
(summed over those runs, and over the ranks), error, times and bound; the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import gc
import io
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np
import torch
import torch.distributed as dist

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.approx.sampling import AdaptiveSampler  # noqa: E402
from repro_torch.bc import (BatchAssembler, BCPlanner,  # noqa: E402
                            BCQuery, ExecutionConfig, build_executor, plan,
                            solve)
from repro_torch.core import monoids  # noqa: E402
from repro_torch.core.adjacency import (DenseAdj,  # noqa: E402
                                        dense_adj_from_graph)
from repro_torch.core.bfs_bc import bfs_bc, bfs_bc_batch  # noqa: E402
from repro_torch.core.brandes_ref import (brandes_bc, cc_ref,  # noqa: E402
                                          closeness_ref, khop_ref)
from repro_torch.core.mfbc import (mfbc, mfbc_batch,  # noqa: E402
                                   mfbc_batch_moments,
                                   mfbc_batch_moments_segmented,
                                   segment_fold)
from repro_torch.core.metrics import components_graph  # noqa: E402
from repro_torch.core.mfbf import mfbf  # noqa: E402
from repro_torch.core.dist_bc import (MeshBCContext,  # noqa: E402
                                      model_mesh_bytes)
from repro_torch.core.monoids import Centpath, Multpath  # noqa: E402
from repro_torch.graphs.formats import (EdgeListReader,  # noqa: E402
                                        GraphStats, build_sharded_adjacency,
                                        write_binary_coo)
from repro_torch.graphs.generators import rmat  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels.centpath_mm import centpath_matmul_cuda  # noqa: E402
from repro_torch.kernels.child_count import child_count_cuda  # noqa: E402
from repro_torch.kernels.segment_relax import (LONG_RUN,  # noqa: E402
                                               segment_relax_cuda)
from repro_torch.kernels.tropical_mm import (BM, BN,  # noqa: E402
                                             multpath_matmul_cuda,
                                             pick_splits, sm_count)
from repro_torch.launch import bc_run, calibrate  # noqa: E402
from repro_torch.serve import (BCGateway, BCService,  # noqa: E402
                               GatewayConfig, start_gateway)
from repro_torch.serve.bc_service import BCRequest  # noqa: E402
from repro_torch.serve.gateway import (GatewayHTTPServer,  # noqa: E402
                                       GatewayServer)
from repro_torch.spgemm.cost_model import load_calibration  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.configs import ARCHS, get_arch  # noqa: E402
from repro_torch.launch import serve as lm_serve  # noqa: E402
from repro_torch.models import layers as LL  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.data.pipeline import LMDataConfig, LMPipeline  # noqa: E402
from repro_torch.launch import train as lm_train  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.train.train_lib import (make_lm_train_step,  # noqa: E402
                                         value_and_grad)
from repro_torch.models import gnn as G  # noqa: E402
from repro_torch.models import gnn_dist as GD  # noqa: E402
from repro_torch.models import recsys as R  # noqa: E402
from repro_torch.core.mfbr import mfbr  # noqa: E402
from repro_torch.launch import perf_hillclimb  # noqa: E402
from repro_torch.launch.mesh import make_device_mesh  # noqa: E402
from repro_torch.roofline import analysis as roofline  # noqa: E402
from repro_torch.sharding.rules import (NO_SHARDING,  # noqa: E402
                                        make_policy)

INF = float("inf")
DEV = torch.device("cuda")
# H100 SXM: instruction issue outside the tensor cores (132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz boost) and the HBM3 data-sheet rate.
PEAK_INSTR_PER_S = 33.5e12
PEAK_BYTES_PER_S = 3.35e12
EPOCH_LIMIT_S = 180  # phase 6d caps max_samples past about 3 minutes
SWEEP = [(8, 16, 16), (8, 128, 128), (16, 200, 136), (128, 128, 256),
         (1, 64, 300), (130, 257, 129), (64, 4096, 4096),
         # split-K: k shorter than one slice, and a single row
         (64, 17, 1000), (1, 5000, 64)]
KERNELS = {
    "multpath_mm": dict(
        wrapper=multpath_matmul_cuda, plain=ref.multpath_matmul_ref,
        source="src/repro_torch/kernels/csrc/multpath_mm.cu",
        replaces="src/repro/kernels/tropical_mm.py:63", n_out=2,
        # (field, rtol); rtol None = bitwise
        fields=(("w", None), ("m", 1e-6))),
    "centpath_mm": dict(
        wrapper=centpath_matmul_cuda, plain=ref.centpath_matmul_ref,
        source="src/repro_torch/kernels/csrc/centpath_mm.cu",
        replaces="src/repro/kernels/centpath_mm.py:60", n_out=3,
        fields=(("w", None), ("p", 1e-5), ("c", None))),
}
# The sparse relax of the COO and CSR backends (phase 6). No Pallas kernel
# stands behind it: it replaces the gather, jax.ops.segment_min/max and
# jax.ops.segment_sum of the reference's multpath_relax_coo (the
# "replaces" line) and of the other sparse relaxes.
SEGMENT_RELAX = dict(
    wrapper=segment_relax_cuda,
    source="src/repro_torch/kernels/csrc/segment_relax.cu",
    replaces="src/repro/core/monoids.py:219")
# The dense SP-DAG child count (phases 2, 3, 4 and 14a). No Pallas kernel
# stands behind it either: it replaces the reference's jnp count.
CHILD_COUNT = dict(
    wrapper=child_count_cuda,
    source="src/repro_torch/kernels/csrc/child_count.cu",
    replaces="src/repro/core/monoids.py:186")
WRAPPERS = {**{name: k["wrapper"] for name, k in KERNELS.items()},
            "segment_relax": segment_relax_cuda,
            "child_count": child_count_cuda}
DENSE_PATH = tuple(KERNELS)  # the kernels each dense run must launch
# and each single-host dense run (a mesh counts children by a product)
DENSE_COUNT_PATH = DENSE_PATH + ("child_count",)
SPARSE_PATH = ("segment_relax",)  # and each COO / CSR run


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def reset_counts() -> None:
    for wrapper in WRAPPERS.values():
        wrapper.launches = 0


def tally(total: dict, names, label: str) -> dict:
    """The launches of the run that just ended (counts reset before it):
    fail unless every kernel of ``names`` launched, add them to
    ``total``."""
    got = {name: WRAPPERS[name].launches for name in names}
    if not all(got.values()):
        raise AssertionError(f"a kernel of {label} never ran: {got}")
    for name, v in got.items():
        total[name] += v
    return got


def inputs(kind: str, which: str, nb: int, n: int, n2: int,
           gen: torch.Generator):
    """(fw, f2, adjacency) on the card for one kernel and input kind."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=DEV
                             ).float()

    def rand(shape):
        return torch.rand(shape, generator=gen, device=DEV)

    adj = torch.where(rand((n, n2)) < 0.3, ints(1, 10, (n, n2)), INF)
    off = INF if which == "multpath_mm" else -INF
    if kind == "empty":
        return torch.full((nb, n), off, device=DEV), \
            torch.zeros(nb, n, device=DEV), adj
    if kind == "ties":  # complete structure, unit weights: every path ties
        fw = torch.full((nb, n), 1.0 if off > 0 else 10.0, device=DEV)
        return fw, torch.full((nb, n), 2.0 if off > 0 else 0.5,
                              device=DEV), torch.ones(n, n2, device=DEV)
    active = rand((nb, n)) < 0.5
    fw = torch.where(active, ints(0, 20, (nb, n)), off)
    f2 = (ints(1, 5, (nb, n)) if off > 0 else rand((nb, n)))
    return fw, torch.where(active, f2, 0.0), adj


def max_abs_err(x: torch.Tensor, y: torch.Tensor) -> float:
    d = torch.where(x == y, 0.0, (x - y).abs())
    return float(d.max()) if d.numel() else 0.0


def compare(name: str, got, want, where: str) -> float:
    """Hold a kernel's outputs against its plain version's; return the
    largest absolute difference."""
    err = 0.0
    for (field, rtol), x, y in zip(KERNELS[name]["fields"], got, want):
        if rtol is None:
            if not torch.equal(x, y):
                raise AssertionError(f"{name} {where}: {field} not bitwise "
                                     f"equal (max |d| {max_abs_err(x, y)})")
        else:
            torch.testing.assert_close(x, y, rtol=rtol, atol=0.0,
                                       msg=lambda m: f"{name} {where} "
                                       f"{field}: {m}")
        err = max(err, max_abs_err(x, y))
    return err


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(name: str, nb: int, n: int, n2: int):
    """(bound_ms, bound_by): the instruction floor against the bytes.

    A min-plus or max-minus cell on float32 takes at least two
    instructions, an add and a min/max: neither has a tensor-core form,
    and Hopper's fused add-min (DPX) takes integers only. The data sheet's
    67 TFLOP/s float32 counts an FFMA as two operations per instruction,
    so dividing 2·nb·n·n2 operations by it halved the floor; the floor is
    2·nb·n·n2 instructions at the card's issue rate. Against it, each
    input read once and each output written once at the memory peak."""
    instr = 2.0 * nb * n * n2
    nbytes = 4.0 * (2 * nb * n + n * n2 + KERNELS[name]["n_out"] * nb * n2)
    t_ops, t_bytes = instr / PEAK_INSTR_PER_S, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def child_count_bound(nb: int, n: int):
    """(bound_ms, bound_by) of one dense child count of nb rows over n
    vertices: a product's shape, (nb, n) x (n, n), each candidate cell an
    add and a compare (2·nb·n·n instructions), against Tw read as the rows
    and as the targets, A once and the int32 counts written once."""
    instr = 2.0 * nb * n * n
    nbytes = 4.0 * (2 * nb * n + n * n + nb * n)
    t_ops, t_bytes = instr / PEAK_INSTR_PER_S, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_child_count(adj, Tw: torch.Tensor, label: str, plain_iters: int):
    """Hold the child count kernel (``adj.count_sp_children`` on the card)
    bitwise to the plain form on ``Tw``, time both and log them beside the
    bound. Returns (ms, plain_ms, bound_ms, bound_by)."""
    def plain():
        return monoids.count_sp_children_dense(Tw, adj.a, block=adj.block)

    before = child_count_cuda.launches
    got = adj.count_sp_children(Tw)
    torch.cuda.synchronize()
    if child_count_cuda.launches != before + 1:
        raise AssertionError(f"{label}: the child count kernel did not run")
    want = plain()
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: child count not bitwise equal to "
                             f"the plain form ({int((got != want).sum())} "
                             f"of {got.numel()} differ)")
    hits = int(want.sum())
    del got, want
    ms = time_ms(lambda: adj.count_sp_children(Tw), iters=20)
    plain_ms = time_ms(plain, iters=plain_iters, warmup=1)
    nb, n = Tw.shape
    b_ms, b_by = child_count_bound(nb, n)
    log(f"time child_count {(nb, n, n)} ({label}, {hits} children): kernel "
        f"{ms:.4f} ms, plain (block {adj.block}) {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound; "
        f"S={pick_splits(nb, n, n, sm_count(0))}; bitwise equal to the "
        "plain form")
    return ms, plain_ms, b_ms, b_by


def launch_shape(nb: int, n: int, n2: int) -> str:
    """The grid and split count S the wrappers launch at this shape."""
    splits = pick_splits(nb, n, n2, sm_count(0))
    grid = (-(-n2 // BN), -(-nb // BM), splits)
    return f"grid {grid}, S={splits}, {grid[0] * grid[1] * splits} blocks"


def time_kernel(name: str, args, shape, with_plain: bool = True):
    """Time one kernel (and its plain version) at ``shape``; log it with
    its bound, grid and S. Returns (ms, plain_ms or None, bound_ms, by)."""
    k = KERNELS[name]
    ms = time_ms(lambda: k["wrapper"](*args), iters=50)
    plain_ms = (time_ms(lambda: k["plain"](*args), iters=5, warmup=1)
                if with_plain else None)
    b_ms, b_by = bound(name, *shape)
    plain = f"plain {plain_ms:.4f} ms, " if with_plain else ""
    log(f"time {name} {tuple(shape)}: kernel {ms:.4f} ms, {plain}bound "
        f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms:.1f}% of bound; "
        f"{launch_shape(*shape)}")
    return ms, plain_ms, b_ms, b_by


class PlainDenseAdj(DenseAdj):
    """``DenseAdj`` whose relaxations run the plain PyTorch k-scan on the
    card: the yardstick for one batch of the main path."""

    def relax_mp(self, F):
        return monoids.multpath_relax_dense(F, self.a, block=self.block)

    def relax_cp(self, F):
        return monoids.centpath_relax_dense(F, self.at, block=self.block)


def approx_query(n_b: int = 64) -> BCQuery:
    """Phase 5's query: ε = 0.05, δ = 0.1, top-10, dense, one device."""
    return BCQuery(mode="approx", eps=0.05, delta=0.1, topk=10, n_b=n_b,
                   execution=ExecutionConfig(backend="dense",
                                             placement="single_host"))


def sampled_path(g, label: str, device) -> dict:
    """Phase 5a/5b: ``solve`` one approximate query on ``device``, as a
    user calls it (planning and the adjacency upload included in
    ``wall_s``; ``seconds`` is the epoch loop alone)."""
    q = approx_query()
    pl = plan(g, q, device=device)
    log(f"{label}: {pl.summary()} execution={pl.execution.describe()} "
        f"sample budget {pl.sample_budget}")
    epochs = []
    t0 = time.perf_counter()
    res = solve(g, q, plan=pl, device=device,
                progress_cb=lambda e, tau, hw: epochs.append((e, tau, hw)))
    wall = time.perf_counter() - t0
    for e, tau, hw in epochs:
        log(f"{label}: epoch {e}: tau={tau} max halfwidth {hw:.4f}")
    a = res.approx
    if res.plan is not pl:
        raise AssertionError("solve did not pass the plan through")
    if a.lam.shape != (g.n,) or not (np.all(np.isfinite(a.lam))
                                     and np.all(np.isfinite(a.halfwidth))):
        raise AssertionError(f"{label}: λ̂ or its CI is not finite of (n,)")
    if a.n_samples <= 0 or a.n_samples > pl.sample_budget:
        raise AssertionError(f"{label}: {a.n_samples} samples outside "
                             f"(0, {pl.sample_budget}]")
    return dict(res=a, seconds=res.seconds, wall_s=wall,
                teps=g.m * a.n_samples / res.seconds)


def first_batch_check(ex, g, label: str) -> None:
    """Phase 5b: the first sample batch of phase 5's stream through the
    executor (kernels) and through the plain products on the card."""
    q = approx_query()
    sampler = AdaptiveSampler(g.n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                              seed=q.seed)
    _, tau0 = sampler.next_epoch()
    src = sampler.draw(min(tau0, ex.n_b))
    valid = np.ones(src.size, bool)
    got = ex.step(src, valid)
    adj = ex._adj
    plain = PlainDenseAdj(adj.a, adj.at, adj.block)
    want = mfbc_batch_moments(plain, torch.from_numpy(src).to(adj.a.device),
                              torch.from_numpy(valid).to(adj.a.device))
    want = [x.cpu().numpy() for x in want]
    for what, x, y in zip(("S1", "S2"), got, want):
        np.testing.assert_allclose(x, y, rtol=1e-5, atol=0,
                                   err_msg=f"{label} first batch {what}")
    np.testing.assert_array_equal(got[2], want[2],
                                  err_msg=f"{label} first batch n_reach")
    log(f"{label}: first sample batch (S1, S2, n_reach) matches the plain "
        f"products on the card (rtol 1e-5; n_reach bitwise); max |dS1| "
        f"{float(np.abs(got[0] - want[0]).max()):.3g}")


def fused_check(ex, g, lens, label: str) -> None:
    """Phase 5c: one fused batch of requests of ``lens`` sources; each
    slot bitwise equal to its rows alone, the batch to its repeat."""
    rng = np.random.default_rng(len(lens))
    demand = [(j, rng.integers(0, g.n, k).astype(np.int32))
              for j, k in enumerate(lens)]
    (fb,) = BatchAssembler(ex).assemble(demand)
    fused = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids, fb.n_slots)
    again = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids, fb.n_slots)
    for x, y in zip(fused, again):
        np.testing.assert_array_equal(x, y, err_msg=f"{label}: repeat")
    buckets = []
    for j, key in enumerate(fb.slots):
        rows = demand[key][1]
        alone = ex.step_segmented(rows, np.ones(rows.size, bool),
                                  np.zeros(rows.size, np.int32), 1)
        buckets.append(ex.bucket_for(rows.size))
        for what, x, y in zip(("S1", "S2", "n_reach"), fused, alone):
            np.testing.assert_array_equal(
                x[j], y[0], err_msg=f"{label}: slot {j} {what}")
    splits = getattr(ex._adj, "splits", None)
    log(f"{label}: fused {fb.sources.size} rows at bucket "
        f"{ex.bucket_for(fb.sources.size)} == each slot alone at buckets "
        f"{buckets} (bitwise), and == its repeat"
        + ("" if splits is None else
           f"; split count S={splits} for every bucket"))


def own_split_drift(ex, g, label: str) -> None:
    """Phase 5c, informational: the elements in which 5 rows' segmented
    statistics differ between bucket 8 and bucket ``n_b`` when each bucket
    takes ``pick_splits``' own count, i.e. without the executor's fix."""
    adj = dataclasses.replace(ex._adj, splits=None)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, g.n, ex.n_b).astype(np.int32)
    out = []
    for b in (8, ex.n_b):
        sid = np.where(np.arange(b) < 5, 0, 1).astype(np.int32)
        s = mfbc_batch_moments_segmented(
            adj, torch.from_numpy(rows[:b]).to(DEV),
            torch.ones(b, dtype=torch.bool, device=DEV), sid, n_slots=2)
        out.append([x[0].cpu().numpy() for x in s])
    diff = [int(np.sum(x != y)) for x, y in zip(*out)]
    own = [pick_splits(b, g.n, g.n, sm_count(0)) for b in (8, ex.n_b)]
    log(f"{label}: with each bucket's own split count (S={own[0]} at 8, "
        f"S={own[1]} at {ex.n_b}) the same 5 rows differ in (S1, S2, "
        f"n_reach) elements {diff} of {g.n}")


# -- phase 6: the COO and CSR backends --------------------------------------

# name: (nb, run lengths); as tests/test_torch_segment_relax.py's cases
RELAX_CASES = {
    "chunk edges": (5, [31, 32, 33, 0, 4095, 0, 4097, 1, 2, 255, 256, 257]),
    "all ties": (40, [3, 40, 300, 600, 0, 1, 70]),
    "inf weights": (16, [7, 0, 513, 64, 2]),
    "a 25231-arc run": (16, [25231] + list(range(40))),
}


def relax_case(name: str, kind: str):
    """Phase 6a: one run set's inputs on the card — (fw, f2) and the arcs
    grouped into runs — with a dead tail past offsets[n], integer
    candidates that tie, order-sensitive values (2**24 and 1.0 mixed in
    "all ties"), ±inf weights and a last row with no finite candidate."""
    nb, runs = RELAX_CASES[name]
    rng = np.random.default_rng(6)
    mp = kind == "mp"
    n = len(runs)
    seg = np.concatenate([np.repeat(np.arange(n), runs), np.full(9, n)])
    seg = seg[rng.permutation(seg.size)]
    col = rng.integers(0, n, seg.size)
    off = INF if mp else -INF
    if name == "all ties":
        fw = np.zeros((nb, n), np.float32)
        f2 = np.ones((nb, n), np.float32)
        f2[:, 0] = 2.0 ** 24
        w = np.ones(seg.size, np.float32)
    else:
        active = rng.random((nb, n)) < 0.6
        fw = np.where(active, rng.integers(0, 6, (nb, n)), off)
        f2 = np.where(active, rng.random((nb, n)) * 3 + 0.1, 0)
        w = rng.integers(1, 4, seg.size).astype(np.float32)
        if name == "inf weights":
            w[rng.random(seg.size) < 0.2] = INF
            if not mp:
                w[rng.random(seg.size) < 0.1] = -INF
    fw, f2 = fw.astype(np.float32), f2.astype(np.float32)
    fw[-1], f2[-1] = off, 0
    runs_t = monoids.arc_runs(*(torch.from_numpy(x).to(DEV)
                                for x in (seg, col, w)), n)
    return (torch.from_numpy(fw).to(DEV), torch.from_numpy(f2).to(DEV),
            runs_t)


def plain_relax(kind: str):
    return (ref.multpath_segment_relax_ref if kind == "mp"
            else ref.centpath_segment_relax_ref)


def relax_check(kind, fw, f2, runs, where: str,
                thresholds=(LONG_RUN,)) -> float:
    """The kernel twice at each long-run threshold (bitwise equal) against
    its plain version run on the CPU, bitwise in every field; returns
    max |d| (0)."""
    want = plain_relax(kind)(fw.cpu(), f2.cpu(), runs.col.cpu(),
                             runs.seg.cpu(), runs.w.cpu())
    for threshold in thresholds:
        args = (fw, f2, runs.col, runs.w, runs.offsets)
        first = segment_relax_cuda(*args, centpath=kind == "cp",
                                   threshold=threshold)
        second = segment_relax_cuda(*args, centpath=kind == "cp",
                                    threshold=threshold)
        torch.cuda.synchronize()
        for field, x, y, z in zip("wxc", first, second, want):
            if not torch.equal(x, y):
                raise AssertionError(f"segment_relax {kind} {where}: two "
                                     f"launches differ in {field}")
            x = x.cpu()
            if not torch.equal(x, z):
                raise AssertionError(
                    f"segment_relax {kind} {where} threshold {threshold}: "
                    f"{field} not bitwise equal to the plain version (max "
                    f"|d| {max_abs_err(x, z)})")
    return 0.0


def phase6a() -> float:
    """The sparse-relax kernel, both instances, against its plain version
    on the CPU over the adversarial run sets, every run down the long path
    (threshold 0), split between the paths (32) and at the default."""
    err = 0.0
    for name, (nb, runs) in RELAX_CASES.items():
        for kind in ("mp", "cp"):
            fw, f2, r = relax_case(name, kind)
            err = max(err, relax_check(kind, fw, f2, r, name,
                                       thresholds=(0, 32, LONG_RUN)))
        log(f"6a: segment_relax {name} (nb={nb}, {int(np.sum(runs))} arcs): "
            "MFBF and MFBr bitwise equal to the plain version on the CPU at "
            f"thresholds 0, 32, {LONG_RUN}, and over two launches")
    return err


def batch_fields(ex, src: np.ndarray) -> dict:
    """Phase 6b: one batch through an executor, and its sweeps' fields."""
    adj = ex._adj
    s = torch.from_numpy(src).to(DEV)
    Tw, Tm = mfbf(adj, s)
    Tw_m = Tw.clone()
    Tw_m[torch.arange(src.size, device=DEV), s.long()] = INF
    c = adj.count_sp_children(Tw_m)
    s1, s2, nr = ex.step(src, np.ones(src.size, bool))
    return dict(w=Tw.cpu(), m=Tm.cpu(), c=c.cpu(), S1=s1, S2=s2,
                n_reach=nr)


def csr_executor(g, n_b: int):
    return build_executor(g, plan(g, BCQuery(
        mode="approx", n_b=n_b, execution=ExecutionConfig(
            backend="csr", placement="single_host")), device=DEV),
        device=DEV)


def phase6b(g12, g) -> None:
    """Scale 14, one 64-source batch through the dense, COO and CSR
    executors; CSR against CSR with caps ((1, 1),); fused == alone on CSR
    at n_b 64 and 128, at scales 12 and 14 (phase 5c's batches)."""
    for scale, gs in ((12, g12), (14, g)):
        for n_b, lens in ((64, (5, 20, 39)), (128, (5, 20, 39, 40))):
            fused_check(csr_executor(gs, n_b), gs, lens,
                        f"6b: CSR fused s{scale} n_b={n_b}")
    src = np.random.default_rng(14).integers(0, g.n, 64).astype(np.int32)
    out = {}
    for be in ("dense", "coo", "csr"):
        ex = build_executor(g, plan(g, BCQuery(
            mode="approx", n_b=64, execution=ExecutionConfig(
                backend=be, placement="single_host")), device=DEV),
            device=DEV)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[be] = batch_fields(ex, src)
        log(f"6b: {be} batch fields in {time.perf_counter() - t0:.3f}s")
        if be == "csr":
            tiny = dataclasses.replace(ex._adj, caps=((1, 1),))
            ex._adj, adj = tiny, ex._adj
            forced = batch_fields(ex, src)
            ex._adj = adj
            for k, v in out["csr"].items():
                np.testing.assert_array_equal(
                    np.asarray(forced[k]), np.asarray(v),
                    err_msg=f"6b: CSR caps ((1, 1),) {k}")
            log("6b: CSR with caps ((1, 1),) (every relax on the fallback) "
                "== CSR with its ladder, bitwise in w, m, c, S1, S2, "
                "n_reach")
        del ex
        torch.cuda.empty_cache()
    for be in ("coo", "csr"):
        for k in ("w", "m", "c", "n_reach"):
            np.testing.assert_array_equal(
                np.asarray(out[be][k]), np.asarray(out["dense"][k]),
                err_msg=f"6b: {be} {k} against dense")
        for k in ("S1", "S2"):
            np.testing.assert_allclose(out[be][k], out["dense"][k],
                                       rtol=1e-5, atol=1e-8,
                                       err_msg=f"6b: {be} {k}")
    m = out["dense"]["m"]
    max_m = float(m[torch.isfinite(out["dense"]["w"])].max())
    if max_m >= 2 ** 24:
        raise AssertionError(f"6b: max m {max_m} is not exact in float32")
    log(f"6b: dense, COO and CSR agree: w, m, c, n_reach bitwise, S1/S2 "
        f"within rtol 1e-5; max m {max_m:.0f} (< 2^24)")


def first_sparse_batch(ex, g, q) -> float:
    """Phase 6d: the first sample batch of the query's stream. ``Tw``
    bitwise against scipy's Dijkstra; the ladder bitwise against the
    forced fallback; λ of its first source against ``brandes_bc``.
    Returns (seconds of one ``step`` of the batch, its Tw, its Tm)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    sampler = AdaptiveSampler(g.n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                              seed=q.seed)
    _, tau0 = sampler.next_epoch()
    src = sampler.draw(min(tau0, ex.n_b))
    s = torch.from_numpy(src).to(DEV)
    Tw, Tm = mfbf(ex._adj, s)
    t0 = time.perf_counter()
    dist = dijkstra(csr_matrix((g.w.astype(np.float64), (g.src, g.dst)),
                               shape=(g.n, g.n)), indices=src)
    t_dij = time.perf_counter() - t0
    off = np.ones(dist.shape, bool)
    off[np.arange(src.size), src] = False  # MFBF's T(s, s) is a cycle
    got = Tw.cpu().numpy()
    if not np.array_equal(got[off], dist.astype(np.float32)[off]):
        raise AssertionError("6d: Tw differs from scipy's Dijkstra")
    log(f"6d: first batch ({src.size} sources) Tw == scipy dijkstra "
        f"distances, bitwise ({t_dij:.1f}s on the host)")
    valid = torch.ones(src.size, dtype=torch.bool, device=DEV)
    ladder = mfbc_batch_moments(ex._adj, s, valid)
    fallback = mfbc_batch_moments(
        dataclasses.replace(ex._adj, caps=((1, 1),)), s, valid)
    for what, x, y in zip(("S1", "S2", "n_reach"), ladder, fallback):
        if not torch.equal(x, y):
            raise AssertionError(f"6d: ladder and fallback differ in {what}")
    log("6d: first batch through the ladder == through the forced fallback "
        "(caps ((1, 1),)), bitwise in S1, S2, n_reach")
    one = np.array([src[0]], np.int32)
    lam = ex.step_sum(one, np.ones(1, bool))
    t0 = time.perf_counter()
    want = brandes_bc(g, sources=one)
    log(f"oracle: 1 source in {time.perf_counter() - t0:.1f}s (CPU)")
    np.testing.assert_allclose(lam, want, rtol=1e-5, atol=1e-8)
    log(f"6d: λ of source {int(one[0])} matches brandes_bc (rtol 1e-5, "
        "atol 1e-8)")
    src_np = src.astype(np.int32)
    ex.step(src_np, np.ones(src.size, bool))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.step(src_np, np.ones(src.size, bool))
    return time.perf_counter() - t0, Tw, Tm


def relax_bound(runs, nb: int, n: int, outputs: int):
    """(bound_ms, bound_by, gathered bytes) of one sparse relax on this
    data: the bytes that must cross DRAM — col (8 B) and w (4 B) of each
    live arc (those before offsets[n]), the offsets, F's two fields once
    and the outputs — at 3.35 TB/s, against 5 instructions per (row, live
    arc) at the issue rate. The gathers of F through L2 (8 B per row and
    arc) are stated beside the bound, not in it."""
    arcs = float(runs.offsets[-1])
    nbytes = 12.0 * arcs + 8.0 * (n + 1) + 4.0 * nb * n * (2 + outputs)
    t_ops = 5.0 * nb * arcs / PEAK_INSTR_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes", 8.0 * nb * arcs)


def relax_shapes(ex, Tw, Tm) -> dict:
    """Phase 6d's two timing shapes on the scale-18 path, from the first
    batch's distances: the full-edge-list MFBF relax of a saturated
    frontier (the COO fallback), and an MFBr relax on capacity bucket 2
    whose frontier holds about 0.585 of the bucket's slots in live arcs
    (a scale-18 bucket-2 MFBr relax averaged 2.45 M live arcs of 4,194,304
    slots; PERF.md §5). Returns name -> (kind, fw, f2, runs)."""
    adj = ex._adj
    n = adj.n
    gen = torch.Generator(device=DEV)
    gen.manual_seed(18)
    vcap, ecap = adj.caps[2]
    deg = (adj.indptr_in[1:] - adj.indptr_in[:-1])
    order = torch.randperm(n, generator=gen, device=DEV)
    take = torch.cumsum(deg[order], 0) <= int(0.585 * ecap)
    cols = torch.zeros(n, dtype=torch.bool, device=DEV)
    cols[order[take]] = True
    active = cols & torch.isfinite(Tw)
    fw = torch.where(active, Tw, -INF)
    fp = torch.where(active, torch.rand(Tw.shape, generator=gen,
                                        device=DEV), 0.0)
    runs = monoids.csr_runs(fw, adj.indptr_in, adj.src_in, adj.w_in, n,
                            vcap=vcap, ecap=ecap)
    return {"fallback MFBF": ("mp", Tw, Tm, adj.coo.runs_mp),
            "bucket-2 MFBr": ("cp", fw, fp, runs)}


def relax_timing(ex, Tw, Tm) -> dict:
    """Phase 6d: the sparse relax at the scale-18 path's shapes
    (``relax_shapes``): the kernel against its plain version on the CPU
    (bitwise), the times of the kernel, of its plain version on the card
    and of the two library calls that compute the same function
    (``scatter_reduce_`` amin/amax of the candidates, ``index_add_`` of
    the tie-masked values; timed apart), and the bound. Returns the
    fallback shape's numbers (the JSON line's)."""
    out = {}
    for name, (kind, fw, f2, runs) in relax_shapes(ex, Tw, Tm).items():
        nb, n = fw.shape
        err = relax_check(kind, fw, f2, runs, f"{name} at {tuple(fw.shape)}")
        args = (fw, f2, runs.col, runs.w, runs.offsets)
        ms = time_ms(lambda: segment_relax_cuda(*args, centpath=kind == "cp"),
                     iters=20)
        plain = plain_relax(kind)
        plain_ms = time_ms(lambda: plain(fw, f2, runs.col, runs.seg, runs.w),
                           iters=5, warmup=1)
        # the library calls' operands, built outside the timing
        g = fw.index_select(1, runs.col)
        if kind == "mp":
            cand, how = g + runs.w, "amin"
        else:
            cand = torch.where(torch.isfinite(g) & torch.isfinite(runs.w),
                               g - runs.w, -INF)
            how = "amax"
        best = torch.full((nb, n + 1), INF if kind == "mp" else -INF,
                          device=DEV)
        index = runs.seg.expand_as(cand)
        scatter_ms = time_ms(lambda: best.scatter_reduce_(
            1, index, cand, how, include_self=True), iters=5, warmup=1)
        masked = torch.where(
            (cand == best.index_select(1, runs.seg)) & torch.isfinite(cand),
            f2.index_select(1, runs.col), 0.0)
        acc = torch.zeros((nb, n + 1), device=DEV)
        add_ms = time_ms(lambda: acc.index_add_(1, runs.seg, masked),
                         iters=5, warmup=1)
        del g, cand, best, index, masked, acc
        b_ms, b_by, gathered = relax_bound(runs, nb, n,
                                           2 if kind == "mp" else 3)
        arcs = int(runs.offsets[-1])
        log(f"time segment_relax {name}: ({nb}, {n}) x {arcs} live arcs of "
            f"{runs.col.shape[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, scatter_reduce_ {how} {scatter_ms:.4f} ms + index_add_ "
            f"{add_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms:.1f}% of bound; gathers through L2 "
            f"{gathered / 1e9:.3f} GB ({gathered / ms / 1e9:.1f} TB/s at "
            "the kernel's time); bitwise equal to the plain version on the "
            "CPU")
        out[name] = dict(err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                         bound_by=b_by, library_ms=scatter_ms + add_ms,
                         library_parts_ms={f"scatter_reduce_ {how}":
                                           scatter_ms, "index_add_": add_ms})
        torch.cuda.empty_cache()
    return out["fallback MFBF"]


def phase6c(g12, lam, launches) -> None:
    """Scale-12 exact BC through an unpinned ``solve`` (the planner picks
    CSR) against phase 3's dense λ."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(g12, BCQuery(), device=DEV)
    dt = time.perf_counter() - t0
    phase = tally(launches, SPARSE_PATH, "6c")
    occ = res.plan.occupancy
    log(f"6c: unpinned exact solve, rmat scale 12: {res.plan.summary()}; "
        f"{dt:.3f}s, {g12.m * g12.n / dt:,.0f} TEPS (model), launches "
        f"{phase}; occupancy: hit rate {occ['hit_rate']:.4f}, overflows "
        f"{occ['overflows']}, relax calls {occ['relax_calls']}, batches "
        f"{occ['batches']}")
    if res.plan.backend != "csr":
        raise AssertionError(f"6c: the planner chose {res.plan.backend}")
    np.testing.assert_allclose(res.lam, lam, rtol=1e-5, atol=1e-8)
    log("6c: λ matches phase 3's dense λ (rtol 1e-5, atol 1e-8)")


def phase6d(launches, scale: int):
    """Approximate BC of a scale-18 R-MAT graph through an unpinned
    ``solve``, on the planner's own backend and n_b; the first batch's
    checks and the sparse relax's timing at this path's shapes. Returns
    (the graph, the relax's timing at the fallback shape)."""
    t0 = time.perf_counter()
    g = graph(scale)
    log(f"6d: rmat scale {scale} weighted: n={g.n} m={g.m} (built on "
        f"the host in {time.perf_counter() - t0:.1f}s)")
    q = BCQuery(mode="approx", eps=0.05, delta=0.1, topk=10)
    pl = plan(g, q, device=DEV)
    log(f"6d: {pl.summary()} execution={pl.execution.describe()}; sample "
        f"budget {pl.sample_budget}, predicted {pl.predicted_seconds:.3f}s "
        "(the reference's analytic model)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = build_executor(g, pl, device=DEV)
    torch.cuda.synchronize()
    log(f"6d: executor built (adjacency upload) in "
        f"{time.perf_counter() - t0:.3f}s")
    t_batch, Tw, Tm = first_sparse_batch(ex, g, q)
    relax_times = relax_timing(ex, Tw, Tm)
    del ex, Tw, Tm
    torch.cuda.empty_cache()
    est = -(-pl.sample_budget // pl.n_b) * t_batch
    if est > EPOCH_LIMIT_S:
        cap = max(pl.n_b, int(EPOCH_LIMIT_S / t_batch) * pl.n_b)
        log(f"6d: one batch {t_batch:.3f}s, the budget's "
            f"{-(-pl.sample_budget // pl.n_b)} batches ≈ {est:.0f}s > "
            f"{EPOCH_LIMIT_S}s: max_samples capped at {cap} (budget "
            f"{pl.sample_budget})")
        q = dataclasses.replace(q, max_samples=cap)
    else:
        log(f"6d: one batch {t_batch:.3f}s, the budget's batches ≈ "
            f"{est:.0f}s: not capped")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(g, q, device=DEV)
    wall = time.perf_counter() - t0
    phase = tally(launches, SPARSE_PATH, "6d")
    peak = torch.cuda.max_memory_allocated()
    a, occ = res.approx, res.plan.occupancy
    log(f"6d: {res.plan.summary()}: {a.n_samples} samples, {a.n_epochs} "
        f"epochs, converged={a.converged}, {res.seconds:.3f}s in the epochs "
        f"({wall:.3f}s with planning and upload), "
        f"{g.m * a.n_samples / res.seconds:,.0f} TEPS (model), launches "
        f"{phase}, peak device memory {peak / 2**30:.2f} GiB")
    log(f"6d: occupancy: hit rate {occ['hit_rate']:.4f}, overflows "
        f"{occ['overflows']}, relax calls {occ['relax_calls']}, batches "
        f"{occ['batches']}")
    if (res.plan.backend, res.plan.n_b) != (pl.backend, pl.n_b):
        raise AssertionError("6d: solve ran another plan than the planner's")
    if a.lam.shape != (g.n,) or not (np.all(np.isfinite(a.lam))
                                       and np.all(np.isfinite(a.halfwidth))):
        raise AssertionError("6d: λ̂ or its CI is not finite of (n,)")
    top = a.topk(10)
    log(f"6d: top-10 {top.tolist()} halfwidths "
        f"{np.round(a.halfwidth[top], 1).tolist()}")
    return g, relax_times


def phase6e(g, scale: int) -> None:
    """``launch.calibrate`` at ``scale`` into a temporary file, and the
    plan that calibration gives phase 6d's query on ``g``."""
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "cost_calibration_torch.json")
        t0 = time.perf_counter()
        calibrate.main(["--scale", str(scale), "--device", DEV.type,
                        "--out", path])
        cal = load_calibration(path)
    rates = ", ".join(f"{k} {r.ops_per_s:.4e} ops/s + "
                      f"{r.overhead_s * 1e3:.3f} ms/call"
                      for k, r in sorted(cal.rates.items()))
    log(f"6e: calibration at scale {scale} in "
        f"{time.perf_counter() - t0:.1f}s: {rates}")
    pl_cal = BCPlanner(calibration=cal).plan(g, BCQuery(
        mode="approx", eps=0.05, delta=0.1, topk=10), device=DEV)
    log(f"6e: with it, n={g.n} plans backend={pl_cal.backend} "
        f"n_b={pl_cal.n_b} predicted {pl_cal.predicted_seconds:.3f}s")


# -- phase 7: the metric registry --------------------------------------------

# The kernels a metric run must launch, by backend: forward-only metrics
# relax with the multpath product alone on dense.
METRIC_PATH = {"dense": ("multpath_mm",), "coo": SPARSE_PATH,
               "csr": SPARSE_PATH}
# phase 7a's queries: (label, metric, hops)
METRIC_CASES = (("closeness", "closeness", 0), ("khop2", "khop", 2),
                ("khop3", "khop", 3), ("components", "components", 0))


def csgraph(g, weighted: bool = True):
    from scipy.sparse import csr_matrix

    w = g.w.astype(np.float64) if weighted else np.ones(g.nnz)
    return csr_matrix((w, (g.src, g.dst)), shape=(g.n, g.n))


def farness(g, sources) -> np.ndarray:
    """``closeness_ref`` over ``sources`` by scipy's Dijkstra: Σ_s τ(s, v)
    over finite distances, s ≠ v."""
    from scipy.sparse.csgraph import dijkstra

    d = dijkstra(csgraph(g), indices=sources)
    d[np.arange(len(sources)), sources] = INF
    return np.where(np.isfinite(d), d, 0.0).sum(axis=0)


def khop_counts(g, sources, hops: int) -> np.ndarray:
    """``khop_ref`` over ``sources`` by scipy's BFS: |{s : v within
    ``hops`` edges of s, v ≠ s}|."""
    from scipy.sparse.csgraph import shortest_path

    d = shortest_path(csgraph(g, weighted=False), unweighted=True,
                      indices=sources)
    d[np.arange(len(sources)), sources] = INF
    return (d <= hops).sum(axis=0).astype(np.float64)


def metric_query(metric: str, hops: int, backend=None, **kw) -> BCQuery:
    return BCQuery(metric=metric, hops=hops, execution=ExecutionConfig(
        backend=backend, placement="single_host" if backend else None),
        **kw)


def metric_solve(g, q, launches, label: str):
    """One ``solve`` of a metric query as a main-path run: the counts at 0
    before, the backend's kernels launched after. Returns (result, wall
    seconds, launches of this run)."""
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(g, q, device=DEV)
    wall = time.perf_counter() - t0
    return res, wall, tally(launches, METRIC_PATH[res.plan.backend], label)


def phase7a(g, launches) -> None:
    """Scale 12: every metric, exact, on each backend pinned and unpinned,
    against the oracles."""
    all_src = np.arange(g.n)
    t0 = time.perf_counter()
    few = all_src[:8]
    np.testing.assert_array_equal(farness(g, few),
                                  closeness_ref(g, sources=few))
    for hops in (2, 3):
        np.testing.assert_array_equal(khop_counts(g, few, hops),
                                      khop_ref(g, sources=few, hops=hops))
    oracles = {"closeness": farness(g, all_src),
               "khop2": khop_counts(g, all_src, 2),
               "khop3": khop_counts(g, all_src, 3), "components": cc_ref(g)}
    log(f"7a: oracles in {time.perf_counter() - t0:.1f}s (CPU): scipy "
        "farness and hop counts over all sources, equal to closeness_ref / "
        "khop_ref over sources 0..7; cc_ref (union-find) "
        f"{len(np.unique(oracles['components']))} component(s)")
    for backend in ("dense", "coo", "csr", None):
        for label, metric, hops in METRIC_CASES:
            where = f"7a: {label} {backend or 'unpinned'}"
            res, wall, phase = metric_solve(
                g, metric_query(metric, hops, backend), launches, where)
            want = oracles[label]
            if metric == "closeness":
                np.testing.assert_allclose(res.lam, want, rtol=1e-5,
                                           atol=1e-5, err_msg=where)
                check = ("within rtol 1e-5, atol 1e-5 (max |d| "
                         f"{float(np.abs(res.lam - want).max()):.3g})")
            else:
                np.testing.assert_array_equal(res.lam, want, err_msg=where)
                check = "bitwise"
            if res.plan.occupancy is not None:  # metrics run untraced
                raise AssertionError(f"{where}: the plan carries occupancy")
            log(f"{where}: {res.plan.summary()}; {wall:.3f}s "
                f"({res.seconds:.3f}s in solve's driver), launches {phase}; "
                f"== oracle {check}")


def metric_fused_check(ex, g, slots, hops: int, label: str) -> None:
    """Phase 7b: one fused batch of ``slots`` ((metric, rows) pairs); each
    slot bitwise equal to its rows alone under its own metric."""
    rng = np.random.default_rng(len(slots) + hops)
    demand = [(j, rng.integers(0, g.n, k).astype(np.int32))
              for j, (_, k) in enumerate(slots)]
    (fb,) = BatchAssembler(ex).assemble(demand)
    metrics = tuple(slots[key][0] for key in fb.slots)
    fused = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids, fb.n_slots,
                              metrics=metrics, hops=hops)
    for j, key in enumerate(fb.slots):
        rows = demand[key][1]
        alone = ex.step_segmented(rows, np.ones(rows.size, bool),
                                  np.zeros(rows.size, np.int32), 1,
                                  metrics=(metrics[j],), hops=hops)
        for what, x, y in zip(("S1", "S2", "n_reach"), fused, alone):
            np.testing.assert_array_equal(
                x[j], y[0], err_msg=f"{label}: slot {j} {what}")
    log(f"{label}: fused {fb.sources.size} rows {metrics} at bucket "
        f"{ex.bucket_for(fb.sources.size)} == each slot alone, bitwise in "
        "S1, S2, n_reach")


def phase7b(g) -> None:
    """Cross-metric fusion on dense at n_b 64 and CSR at n_b 16."""
    for backend, n_b, lens in (("dense", 64, (20, 39)), ("csr", 16, (5, 9))):
        ex = build_executor(g, plan(g, BCQuery(
            mode="approx", n_b=n_b, execution=ExecutionConfig(
                backend=backend, placement="single_host")), device=DEV),
            device=DEV)
        where = f"7b: {backend} n_b={n_b}"
        metric_fused_check(ex, g, (("betweenness", lens[0]),
                                   ("closeness", lens[1])), 0, where)
        metric_fused_check(ex, g, (("khop", lens[0]), ("khop", lens[1])), 2,
                           where)
        src = np.arange(lens[0], dtype=np.int32)
        try:
            ex.step_segmented(src, np.ones(src.size, bool),
                              (src % 2).astype(np.int32), 2,
                              metrics=("khop", "closeness"), hops=2)
        except ValueError as e:
            log(f"{where}: a khop + closeness batch raises: {e}")
        else:
            raise AssertionError(f"{where}: khop + closeness did not raise")
        del ex
        torch.cuda.empty_cache()


def first_metric_batch(g, q, metric: str, hops: int):
    """Phase 7c: the first sample batch of ``q``'s stream through the
    planned executor, against scipy over its sources; returns (the seconds
    of one ``step`` of it, the plan)."""
    pl = plan(g, q, device=DEV)
    ex = build_executor(g, pl, device=DEV)
    sampler = AdaptiveSampler(g.n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                              seed=q.seed)
    _, tau0 = sampler.next_epoch()
    src = sampler.draw(min(tau0, ex.n_b)).astype(np.int32)
    valid = np.ones(src.size, bool)
    s1, s2, nr = ex.step(src, valid, metric=metric, hops=hops)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex.step(src, valid, metric=metric, hops=hops)
    t_batch = time.perf_counter() - t0
    t0 = time.perf_counter()
    if metric == "closeness":
        want = farness(g, src)
        np.testing.assert_allclose(s1, want, rtol=1e-5,
                                   err_msg="7c: closeness first batch S1")
        reach, check = khop_counts(g, src, g.n), "rtol 1e-5"  # all finite
    else:
        want = khop_counts(g, src, hops)
        np.testing.assert_array_equal(s1, want,
                                      err_msg="7c: khop first batch S1")
        reach, check = want, "bitwise"
    np.testing.assert_array_equal(nr, reach,
                                  err_msg=f"7c: {metric} first batch n_reach")
    if not (np.all(np.isfinite(s1)) and np.all(np.isfinite(s2))):
        raise AssertionError(f"7c: {metric} first batch S1/S2 not finite")
    log(f"7c: {metric} first batch ({src.size} sources) on {pl.summary()}: "
        f"S1 == scipy over its sources ({check}; max |d| "
        f"{float(np.abs(s1 - want).max()):.3g}), n_reach bitwise, "
        f"max S2 {float(s2.max()):.4g}; oracle {time.perf_counter() - t0:.1f}s"
        f" (CPU); one step {t_batch:.3f}s")
    del ex
    torch.cuda.empty_cache()
    return t_batch, pl


def phase7c(g, launches) -> np.ndarray:
    """Scale 18: approximate closeness and khop (hops 2), and exact
    components, all unpinned. Returns ``cc_ref`` of ``g``."""
    for metric, hops in (("closeness", 0), ("khop", 2)):
        q = metric_query(metric, hops, mode="approx", eps=0.05, delta=0.1,
                         topk=10)
        t_batch, pl = first_metric_batch(g, q, metric, hops)
        est = -(-pl.sample_budget // pl.n_b) * t_batch
        if est > EPOCH_LIMIT_S:
            cap = max(pl.n_b, int(EPOCH_LIMIT_S / t_batch) * pl.n_b)
            log(f"7c: {metric}: the budget's batches ≈ {est:.0f}s > "
                f"{EPOCH_LIMIT_S}s: max_samples capped at {cap} (budget "
                f"{pl.sample_budget})")
            q = dataclasses.replace(q, max_samples=cap)
        torch.cuda.reset_peak_memory_stats()
        res, wall, phase = metric_solve(g, q, launches, f"7c: {metric}")
        a = res.approx
        peak = torch.cuda.max_memory_allocated()
        if a.lam.shape != (g.n,) or not (np.all(np.isfinite(a.lam)) and
                                         np.all(np.isfinite(a.halfwidth))):
            raise AssertionError(f"7c: {metric}: λ̂ or its CI not finite")
        log(f"7c: {metric}: {res.plan.summary()}: {a.n_samples} samples, "
            f"{a.n_epochs} epochs, converged={a.converged}, "
            f"{res.seconds:.3f}s in the epochs ({wall:.3f}s with planning "
            f"and upload), launches {phase}, peak device memory "
            f"{peak / 2**30:.2f} GiB; top-10 {a.topk(10).tolist()}")
    torch.cuda.reset_peak_memory_stats()
    res, wall, phase = metric_solve(g, metric_query("components", 0),
                                    launches, "7c: components")
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    want = cc_ref(g)
    t_ref = time.perf_counter() - t0
    np.testing.assert_array_equal(res.lam, want, err_msg="7c: components")
    t0 = time.perf_counter()
    components_graph(g)
    t_graph = time.perf_counter() - t0
    relaxes = max(phase.values())
    log(f"7c: components: {res.plan.summary()}: {wall:.3f}s "
        f"({res.seconds:.3f}s in labels(), of which about {t_graph:.3f}s "
        f"builds the zero-weight graph on the host), {relaxes} relaxes "
        f"(iterations), launches {phase}, peak device memory "
        f"{peak / 2**30:.2f} GiB; {len(np.unique(want))} component(s), "
        f"bitwise equal to cc_ref ({t_ref:.1f}s on the host)")
    return want


def phase7d(launches) -> None:
    """The BFS baseline on an unweighted scale-12 R-MAT, dense and COO."""
    from scipy.sparse.csgraph import shortest_path

    g, _ = rmat(12, 16, seed=0, weighted=False).remove_isolated()
    hops = shortest_path(csgraph(g, weighted=False), unweighted=True)
    depth = int(hops[np.isfinite(hops)].max())
    del hops
    lam_mfbc = mfbc(g, n_b=64, device=DEV)
    out = {}
    for backend, path in (("dense", DENSE_PATH), ("coo", SPARSE_PATH)):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[backend] = bfs_bc(g, n_b=64, backend=backend, max_depth=depth,
                              device=DEV)
        dt = time.perf_counter() - t0
        phase = tally(launches, path, f"7d: bfs_bc {backend}")
        np.testing.assert_allclose(out[backend], lam_mfbc, rtol=1e-5,
                                   atol=1e-8, err_msg=f"7d: {backend}")
        log(f"7d: bfs_bc unweighted rmat scale 12 (n={g.n}, m={g.m}) on "
            f"{backend}, n_b=64, max_depth={depth} (scipy's largest BFS "
            f"depth): {dt:.3f}s, launches {phase}; == mfbc (rtol 1e-5, atol "
            "1e-8)")
    src = torch.arange(64, device=DEV)
    first = bfs_bc_batch(dense_adj_from_graph(g, device=DEV), src,
                         torch.ones(64, dtype=torch.bool, device=DEV),
                         max_depth=depth).cpu().numpy().astype(np.float64)
    t0 = time.perf_counter()
    want = brandes_bc(g, sources=np.arange(64))
    log(f"oracle: 64 sources in {time.perf_counter() - t0:.1f}s (CPU)")
    np.testing.assert_allclose(first, want, rtol=1e-5, atol=1e-8)
    log("7d: bfs_bc_batch over sources 0..63 matches brandes_bc (rtol 1e-5, "
        "atol 1e-8)")


# -- phase 8: serving --------------------------------------------------------

POLL_S = 600  # deadline of one request, submit to done (a tick holds the lock)
HOST = "127.0.0.1"


def http(method: str, url: str, doc=None):
    """(HTTP status, JSON document, headers) of one call to the gateway."""
    data = None if doc is None else json.dumps(doc).encode()
    req = urllib.request.Request(url, data=data, method=method, headers={
        "Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=POLL_S) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def listener(gw) -> GatewayServer:
    """The gateway's HTTP front on an ephemeral port with its worker not
    started: what is posted now is queued before the first tick."""
    httpd = GatewayHTTPServer((HOST, 0), gw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return GatewayServer(gateway=gw, httpd=httpd, thread=thread)


def post(srv, doc, expect, label: str):
    st, out, headers = http("POST", f"{srv.url}/v1/bc", doc)
    if st not in expect:
        raise AssertionError(f"{label}: POST {doc} answered {st} {out}")
    return st, out, headers


def poll_done(srv, rid: int, label: str) -> dict:
    """Poll one request until it is done; fail on an error status, on a
    worker that is not alive after a poll, or past ``POLL_S``."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < POLL_S:
        st, doc, _ = http("GET", f"{srv.url}/v1/bc/{rid}")
        worker = srv.gateway._worker
        if worker is None or not worker.is_alive():
            raise AssertionError(f"{label}: the gateway's worker is not "
                                 f"alive (rid {rid})")
        if st != 200 or doc["status"] == "error":
            raise AssertionError(f"{label}: rid {rid}: HTTP {st} {doc}")
        if doc["status"] == "done":
            return doc
        time.sleep(0.02)
    raise AssertionError(f"{label}: rid {rid} not done within {POLL_S}s")


def close_clean(srv, label: str) -> dict:
    """The metrics document, with no error counted; then the server closed
    (which re-raises whatever stopped its worker)."""
    _, m, _ = http("GET", f"{srv.url}/v1/metrics")
    srv.close()
    if m["totals"]["errors"]:
        raise AssertionError(f"{label}: errors counted: {m['totals']}")
    return m


ANSWER = ("topk", "lam", "halfwidth", "n_samples", "n_epochs", "converged")


def same_answer(got: dict, want: dict, label: str) -> None:
    """Two wire payloads hold one answer, bitwise: JSON writes each float64
    in its shortest exact form."""
    for field in ANSWER:
        if got[field] != want[field]:
            raise AssertionError(f"{label}: {field} differs: {got[field]} "
                                 f"vs {want[field]}")


def alone(svc, req) -> dict:
    """One request served alone, on the service's own executor, on the
    main thread (the gateway closed): its wire payload."""
    svc.submit(req)
    (resp,) = svc.run()
    svc.finished.clear()
    return resp.to_json()


def solved(g, svc, name: str, req) -> dict:
    """``solve`` over the (seed, rid) stream of ``req`` on the service's
    executor, as a wire payload's answer fields. ``req`` must plan the
    executor's n_b: the service then runs it as ``solve`` does."""
    ex = svc.executor_for(name)
    if svc.request_plan(req).n_b != ex.n_b:
        raise AssertionError(f"rid {req.rid} plans another n_b than the "
                             "executor's: it would not run as solve does")
    res = solve(g, BCQuery(mode="approx", eps=req.eps, delta=req.delta,
                           topk=req.k, rule=req.rule, seed=(req.seed,
                                                            req.rid),
                           metric=req.metric, hops=req.hops),
                executor=ex, device=DEV).approx
    ids = res.topk(req.k)
    return {"topk": ids.tolist(), "lam": [float(x) for x in res.lam[ids]],
            "halfwidth": [float(x) for x in res.halfwidth[ids]],
            "n_samples": res.n_samples, "n_epochs": res.n_epochs,
            "converged": res.converged}


def warm(svc, name: str, label: str) -> None:
    """Build the graph's executor and run one source through it on the
    main thread, before any request is timed."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ex = svc.executor_for(name)
    ex.step(np.zeros(1, np.int32), np.ones(1, bool))
    torch.cuda.synchronize()
    log(f"{label}: executor built and warmed on the main thread in "
        f"{time.perf_counter() - t0:.3f}s: {ex.plan.summary()} "
        f"execution={ex.plan.execution.describe()}")


def served(label: str, doc: dict) -> str:
    r = doc["result"]
    return (f"{label} rid {doc['rid']} ({doc['tier']}): "
            f"{doc['latency_s']:.3f}s submit->done, {r['n_samples']} samples, "
            f"{r['n_epochs']} epochs, converged={r['converged']}, plan "
            f"{r['plan']['backend']} n_b={r['plan']['n_b']} predicted "
            f"{r['plan']['predicted_seconds']:.4f}s")


def phase8a(launches) -> dict:
    """Dense serving at scale 14 through the HTTP gateway: a betweenness
    and a closeness request fused, the cache hit, a refine; then each
    answer against the same request alone, ``solve`` and a scratch run."""
    name = "rmat-s14-w"
    g = graph(14)
    svc = BCService({name: g}, execution=ExecutionConfig(backend="dense"),
                    checkpoints=True, device=DEV)
    warm(svc, name, "8a")
    gw = BCGateway(svc, GatewayConfig(horizon_s=1e9))
    srv = listener(gw)
    bc = {"graph": name, "eps": 0.1, "priority": "interactive"}
    cl = {"graph": name, "eps": 0.1, "metric": "closeness"}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rid_bc = post(srv, bc, (202,), "8a")[1]["rid"]
    rid_cl = post(srv, cl, (202,), "8a")[1]["rid"]
    gw.start()  # both queued: admitted in one tick, fused
    done = {rid: poll_done(srv, rid, "8a") for rid in (rid_bc, rid_cl)}
    t_pair = time.perf_counter() - t0
    t1 = time.perf_counter()
    st, hit, _ = post(srv, bc, (200,), "8a: the identical repeat")
    t_hit = time.perf_counter() - t1
    if not hit["cached"] or json.dumps(hit["result"]) != json.dumps(
            done[rid_bc]["result"]):
        raise AssertionError("8a: the cache hit is not the byte-identical "
                             "payload")
    tight = {**bc, "eps": 0.07}
    _, part, _ = post(srv, tight, (202,), "8a: the tighter request")
    if not (part["status"] == "partial" and part.get("refining")
            and part["result"] == done[rid_bc]["result"]):
        raise AssertionError(f"8a: the tighter request is not a refine: "
                             f"{part}")
    refined = poll_done(srv, part["rid"], "8a")
    if not refined["refined"]:
        raise AssertionError("8a: the tighter request did not end refined")
    t_all = time.perf_counter() - t0
    phase = tally(launches, DENSE_PATH, "8a")
    m = close_clean(srv, "8a")
    for doc in (*done.values(), refined):
        log(served("8a", doc))
    log(f"8a: the pair in {t_pair:.3f}s; cache hit HTTP {st} in "
        f"{1e3 * t_hit:.2f} ms, byte-identical; refine 0.1 -> 0.07: "
        f"{refined['result']['n_samples']} samples; served in {t_all:.3f}s, "
        f"launches {phase}; admission correction "
        f"{m['admission_correction']}")

    # each answer against the same request alone, solve and a scratch run
    pair = {rid_bc: BCRequest(rid=rid_bc, graph=name, eps=0.1,
                              priority="interactive"),
            rid_cl: BCRequest(rid=rid_cl, graph=name, eps=0.1,
                              metric="closeness")}
    lone = {}
    for rid, req in pair.items():
        lone[rid] = alone(svc, req)
        same_answer(done[rid]["result"], lone[rid],
                    f"8a: rid {rid} fused vs alone")
    same_answer(lone[rid_bc], solved(g, svc, name, pair[rid_bc]),
                "8a: lone betweenness vs solve")
    loose = done[rid_bc]["result"]
    scratch = alone(svc, dataclasses.replace(pair[rid_bc], eps=0.07))
    if loose["n_samples"] >= loose["plan"]["sample_budget"]:
        raise AssertionError("8a: the loose run reached its sample budget: "
                             "its checkpoint is not prefix-exact")
    same_answer(refined["result"], scratch, "8a: refined vs scratch")
    log("8a: fused betweenness and closeness == each alone, the lone "
        "betweenness == solve over its (seed, rid) stream, refined == a "
        "scratch run at ε 0.07, bitwise (λ̂, halfwidths, top-k, samples, "
        "epochs)")
    del svc, gw, srv
    torch.cuda.empty_cache()
    return phase


def phase8b(g, cc, launches) -> dict:
    """Sparse serving at scale 18 through the HTTP gateway (unpinned: the
    planner's backend): betweenness, closeness, khop 2 and components
    across the three tiers; the answers against ``cc_ref`` and ``solve``.
    Returns the service (its executor is warm) for 8c."""
    name = "rmat-s18-w"
    svc = BCService({name: g}, n_slots=4, checkpoints=True, device=DEV)
    warm(svc, name, "8b")
    gw = BCGateway(svc, GatewayConfig(horizon_s=1e9))
    srv = listener(gw)
    reqs = [{"graph": name, "eps": 0.1, "priority": "interactive"},
            {"graph": name, "eps": 0.1, "metric": "closeness"},
            {"graph": name, "eps": 0.1, "metric": "khop", "hops": 2,
             "priority": "batch"},
            {"graph": name, "metric": "components"}]
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [post(srv, doc, (202,), "8b")[1]["rid"] for doc in reqs]
    gw.start()
    done = {rid: poll_done(srv, rid, "8b") for rid in rids}
    wall = time.perf_counter() - t0
    phase = tally(launches, SPARSE_PATH, "8b")
    peak = torch.cuda.max_memory_allocated()
    t1 = time.perf_counter()
    st, hit, _ = post(srv, reqs[0], (200,), "8b: the identical repeat")
    t_hit = time.perf_counter() - t1
    if json.dumps(hit["result"]) != json.dumps(done[rids[0]]["result"]):
        raise AssertionError("8b: the cache hit is not byte-identical")
    _, graphs, _ = http("GET", f"{srv.url}/v1/graphs")
    m = close_clean(srv, "8b")
    for rid in rids:
        log(served("8b", done[rid]))
    log(f"8b: served in {wall:.3f}s, launches {phase}, peak device memory "
        f"{peak / 2**30:.2f} GiB; cache hit HTTP {st} in {1e3 * t_hit:.2f} "
        "ms, byte-identical")
    for row in graphs["graphs"]:
        log(f"8b: /v1/graphs: {row['name']} n={row['n']} m={row['m']} "
            f"digest={row['digest'][:16]} plan {row['plan']['backend']} "
            f"n_b={row['plan']['n_b']}")
    log(f"8b: /v1/metrics admission correction (observed / predicted "
        f"seconds): {m['admission_correction']}")

    res = done[rids[3]]["result"]
    if res["lam"] != np.sort(cc)[::-1][:10].tolist() or \
            res["lam"] != cc[res["topk"]].tolist():
        raise AssertionError("8b: components top-10 differs from cc_ref")
    np.testing.assert_array_equal(svc.executor_for(name).labels(), cc,
                                  err_msg="8b: components labels")
    for rid, kw in ((rids[0], dict(priority="interactive")),
                    (rids[2], dict(metric="khop", hops=2,
                                   priority="batch"))):
        req = BCRequest(rid=rid, graph=name, eps=0.1, **kw)
        same_answer(done[rid]["result"], solved(g, svc, name, req),
                    f"8b: rid {rid} vs solve")
    log("8b: components labels == cc_ref, bitwise (the top-10 on the wire "
        "and all n from the executor); the betweenness (fused with "
        "closeness) and khop answers == solve over their streams, bitwise")
    return svc, phase


def phase8c(svc, launches) -> dict:
    """Overload at scale 18 without a race: the listener takes the burst
    before the worker starts; then the worker drains."""
    name = "rmat-s18-w"
    pred = float(svc.request_plan(BCRequest(
        rid=0, graph=name, eps=0.2, priority="batch")).predicted_seconds)
    gw = BCGateway(svc, GatewayConfig(horizon_s=1.5 * pred))
    srv = listener(gw)
    flood = {"graph": name, "eps": 0.2, "priority": "batch"}
    codes, admitted = [], []
    for _ in range(12):
        st, doc, headers = post(srv, flood, (202, 429), "8c")
        codes.append(st)
        if st == 429:
            if "Retry-After" not in headers or doc["retry_after_s"] <= 0:
                raise AssertionError(f"8c: a 429 without Retry-After: {doc}")
        else:
            admitted.append(doc["rid"])
    st, doc, _ = post(srv, {**flood, "priority": "interactive"}, (202,),
                      "8c: interactive under the flood")
    admitted.append(doc["rid"])
    _, m, _ = http("GET", f"{srv.url}/v1/metrics")
    tiers = m["tiers"]
    if codes != [202] + [429] * 11 or tiers["batch"]["rejected"] != 11 \
            or tiers["interactive"]["rejected"]:
        raise AssertionError(f"8c: burst {codes}, tiers {tiers}")
    log(f"8c: horizon 1.5 x {pred:.4f}s predicted: the batch flood drew "
        f"{codes}; Retry-After on each 429; the interactive request "
        "admitted (202)")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gw.start()
    for rid in admitted:
        poll_done(srv, rid, "8c")
    dt = time.perf_counter() - t0
    phase = tally(launches, SPARSE_PATH, "8c")
    m = close_clean(srv, "8c")
    if m["totals"]["completed"] != len(admitted):
        raise AssertionError(f"8c: {m['totals']}")
    gw = BCGateway(svc, GatewayConfig(horizon_s=0.5 * pred,
                                      overload="degrade", degrade_eps=0.3))
    srv = start_gateway(gw, host=HOST)
    st, doc, _ = post(srv, {"graph": name, "eps": 0.1}, (202,), "8c")
    doc = poll_done(srv, doc["rid"], "8c")
    m = close_clean(srv, "8c")
    if doc.get("degraded_from") != 0.1 or doc["eps"] != 0.3 \
            or m["totals"]["degraded"] != 1:
        raise AssertionError(f"8c: degrade not recorded: {doc}")
    log(f"8c: drained {len(admitted)} admitted requests in {dt:.3f}s, "
        f"launches {phase}, errors 0; overload='degrade' served ε 0.1 at "
        f"ε {doc['eps']} with degraded_from {doc['degraded_from']} in "
        f"{doc['latency_s']:.3f}s")
    return phase


# -- phase 9: the distributed step -------------------------------------------

MESH_RANKS = 4  # phase 9b's ranks, all on the one card, over gloo
MESH_REPEATS = 5  # 9b's timed batches per mesh, after the first
MESH_CASES = {"2x2": ((2, 2), ("data", "model")),
              "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
# the local products of those meshes at scale 14 (n = 12536), n_b 64
LOCAL_SHAPES = ((64, 6268, 6268), (32, 6268, 12536))
MESH_QUERY = BCQuery(mode="approx", eps=0.1, delta=0.1, n_b=64)
EXACT_NB = 3344  # 9b's exact scale-12 sweep: every source in one batch
RANK_TIMEOUT_S = 600
# The blocked plain relax of the CPU path, on the card: the products'
# plain versions at shapes whose whole candidate block would not fit.
PLAIN_BLOCKED = {
    "multpath_mm": lambda fw, fm, a: tuple(monoids.multpath_relax_dense(
        Multpath(fw, fm), a, block=128)),
    "centpath_mm": lambda fw, fp, b: tuple(monoids.centpath_relax_dense(
        Centpath(fw, fp, None), b, block=128)),
}


def phase9a(gen, errs: dict) -> dict:
    """Each product at the mesh's local shapes against its blocked plain
    version on the card: ``w`` and ``c`` bitwise, ``m`` rtol 1e-6, ``p``
    rtol 1e-5; then its time and % of ``bound``."""
    out = {}
    for nb, n, n2 in LOCAL_SHAPES:
        for name, k in KERNELS.items():
            fw, f2, adj = inputs("random", name, nb, n, n2, gen)
            got = k["wrapper"](fw, f2, adj)
            torch.cuda.synchronize()
            want = PLAIN_BLOCKED[name](fw, f2, adj)
            err = compare(name, got, want, f"9a {(nb, n, n2)}")
            errs[name] = max(errs[name], err)
            del got, want
            ms = time_ms(lambda: k["wrapper"](fw, f2, adj), iters=20)
            plain_ms = time_ms(lambda: PLAIN_BLOCKED[name](fw, f2, adj),
                               iters=1, warmup=0)
            b_ms, b_by = bound(name, nb, n, n2)
            log(f"9a: {name} {(nb, n, n2)} matches its plain version "
                f"(max |d| {err:.3g}); kernel {ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{100 * b_ms / ms:.1f}% of bound; "
                f"{launch_shape(nb, n, n2)}")
            out[(name, nb, n, n2)] = ms
            del fw, f2, adj
            torch.cuda.empty_cache()
    return out


def _counts() -> dict:
    return {name: w.launches for name, w in WRAPPERS.items()}


def mesh_rank(rank: int, store: str, results, payload: dict) -> None:
    """One rank of phase 9b: every case on both meshes, on the card (the
    card ``LOCAL_RANK`` names when there are several), over
    ``payload["backend"]``. Puts (rank, {case: results}) on ``results``,
    or a traceback."""
    try:
        dist.init_process_group(payload["backend"],
                                init_method=f"file://{store}",
                                rank=rank, world_size=MESH_RANKS,
                                timeout=datetime.timedelta(
                                    seconds=RANK_TIMEOUT_S))
        g12, g14 = payload["g12"], payload["g14"]
        src = np.arange(64, dtype=np.int32)
        val = np.ones(64, bool)
        meshes = {key: Mesh(shape, names, device="cuda")
                  for key, (shape, names) in MESH_CASES.items()}
        out = {"device": str(meshes["2x2"].device),
               "setup_s": time.time() - payload["spawned"]}
        for key, mesh in meshes.items():
            ex = build_executor(g14, plan(g14, MESH_QUERY, mesh=mesh),
                                mesh=mesh)
            t0 = time.perf_counter()
            ctx = ex._context()  # pad, permute and upload A and Aᵀ blocks
            torch.cuda.synchronize()
            upload_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            ex.step(src, val)  # the first batch: warm-up, timed apart
            first_s = time.perf_counter() - t0
            mesh.reset_counts()
            reset_counts()
            batch_s = []
            for _ in range(MESH_REPEATS):
                t0 = time.perf_counter()
                moments = ex.step(src, val)
                batch_s.append(time.perf_counter() - t0)
            out[key] = dict(moments=moments, upload_s=upload_s,
                            first_s=first_s, batch_s=batch_s,
                            seconds=sum(batch_s) / MESH_REPEATS,
                            bytes={k: v // MESH_REPEATS
                                   for k, v in mesh.comm_bytes.items()},
                            sweeps=ctx.sweeps,
                            n_pad=ctx.n_pad, splits=ctx.splits,
                            launches=_counts())
            del ex, ctx
            torch.cuda.empty_cache()
        mesh = meshes["2x2"]
        reset_counts()
        t0 = time.perf_counter()
        res = solve(g12, BCQuery(mode="exact", n_b=EXACT_NB), mesh=mesh)
        out["exact12"] = dict(lam=res.lam, seconds=time.perf_counter() - t0,
                              n_b=res.plan.n_b, launches=_counts())
        torch.cuda.empty_cache()
        reset_counts()
        t0 = time.perf_counter()
        res = solve(g14, MESH_QUERY, mesh=mesh)
        a = res.approx
        out["solve14"] = dict(lam=a.lam, n_samples=a.n_samples,
                              n_epochs=a.n_epochs, converged=a.converged,
                              seconds=time.perf_counter() - t0,
                              launches=_counts())
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ctx = MeshBCContext(GraphStats.from_graph(g14), mesh)
        build_sharded_adjacency(EdgeListReader(payload["path"],
                                               chunk_edges=1 << 16), ctx)
        ctx.for_batches(MESH_QUERY.n_b)
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        moments = ctx.run_moments(src, val, nb=64)
        out["stream"] = dict(moments=moments, upload_s=upload_s,
                             seconds=time.perf_counter() - t0,
                             launches=_counts())
        out["serve"] = serve_rank(mesh, g14)
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


SERVE_NAME = "rmat-s14-w"
# 9b's requests: a pair posted before the gateway's worker starts (one
# fused tick), then the identical repeat (a cache hit) and a tighter ε (a
# refine of the first answer's checkpoint).
SERVE_PAIR = ({"graph": SERVE_NAME, "eps": 0.1, "priority": "interactive"},
              {"graph": SERVE_NAME, "eps": 0.1})
SERVE_TIGHT = {**SERVE_PAIR[0], "eps": 0.07}


def serve_http(svc) -> dict:
    """Rank 0 of 9b: the requests through an HTTP gateway over the mesh
    service. The wire documents of the pair and the refine, the hit."""
    gw = BCGateway(svc, GatewayConfig(horizon_s=1e9))
    srv = listener(gw)
    try:
        rids = [post(srv, doc, (202,), "9b serve")[1]["rid"]
                for doc in SERVE_PAIR]
        gw.start()  # both queued: admitted in one tick, fused
        done = [poll_done(srv, rid, "9b serve") for rid in rids]
        t0 = time.perf_counter()
        _, hit, _ = post(srv, SERVE_PAIR[0], (200,), "9b: the repeat")
        hit_ms = 1e3 * (time.perf_counter() - t0)
        if not hit["cached"] or json.dumps(hit["result"]) != json.dumps(
                done[0]["result"]):
            raise AssertionError("9b: the cache hit is not the "
                                 "byte-identical payload")
        _, part, _ = post(srv, SERVE_TIGHT, (202,), "9b: the tighter one")
        if not (part["status"] == "partial" and part.get("refining")):
            raise AssertionError(f"9b: the tighter request is not a "
                                 f"refine: {part}")
        refined = poll_done(srv, part["rid"], "9b serve")
        if not refined["refined"]:
            raise AssertionError("9b: the tighter request did not end "
                                 "refined")
        _, m, _ = http("GET", f"{srv.url}/v1/metrics")
        if m["totals"]["errors"]:
            raise AssertionError(f"9b: errors counted: {m['totals']}")
    finally:
        srv.close()  # re-raises what stopped the worker, if anything did
    return dict(docs=done + [refined], hit_ms=hit_ms)


def serve_rank(mesh, g) -> dict:
    """9b's serving case on one rank: ``BCService(mesh=)`` built on every
    rank; rank 0 serves, the others follow until its ``close()``. The
    launches are counted on every rank from construction to the end."""
    svc = BCService({SERVE_NAME: g}, mesh=mesh, checkpoints=True,
                    ctrl_timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    reset_counts()
    t0 = time.perf_counter()
    if mesh.rank == 0:
        try:
            out = serve_http(svc)
        finally:
            svc.close()
        out.update(mirrored=svc.mirrored)
    else:
        out = dict(followed=svc.follow())
    out.update(seconds=time.perf_counter() - t0, launches=_counts())
    return out


def serve_inline(svc) -> list:
    """9b's requests through a gateway drained inline on this thread: the
    status documents of the pair and the refine (the same rids as rank
    0's)."""
    gw = BCGateway(svc, GatewayConfig(horizon_s=1e9))
    rids = [gw.submit(dict(doc))["rid"] for doc in SERVE_PAIR]
    gw.drain()
    if gw.submit(dict(SERVE_PAIR[0]))["http_status"] != 200:
        raise AssertionError("9b reference: the repeat is not a hit")
    rids.append(gw.submit(dict(SERVE_TIGHT))["rid"])
    gw.drain()
    return [gw.get(rid) for rid in rids]


def same_served(got: list, want: list, label: str) -> None:
    """Served answers of two services: the same samples, epochs and
    convergence; λ̂ and the halfwidths within rtol 1e-5."""
    for a, b in zip(got, want):
        ra, rb = a["result"], b["result"]
        keys = ("n_samples", "n_epochs", "converged")
        if [ra[k] for k in keys] != [rb[k] for k in keys]:
            raise AssertionError(f"{label} rid {a['rid']}: "
                                 f"{[ra[k] for k in keys]} vs "
                                 f"{[rb[k] for k in keys]}")
        for k in ("lam", "halfwidth"):
            np.testing.assert_allclose(ra[k], rb[k], rtol=1e-5,
                                       err_msg=f"{label} rid {a['rid']} {k}")


def run_ranks(payload: dict, tmp: str, target=None, label: str = "9b"
              ) -> dict:
    """Spawn ``MESH_RANKS`` ranks of ``target`` (phase 9b's ``mesh_rank``
    by default); their results by rank. Fails with the first rank's
    traceback, or after ``RANK_TIMEOUT_S``; every rank is joined or
    killed before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=target or mesh_rank, args=(
        r, os.path.join(tmp, "store"), results, payload))
        for r in range(MESH_RANKS)]
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < MESH_RANKS:
            rank, out = results.get(timeout=RANK_TIMEOUT_S)
            if isinstance(out, str):
                raise AssertionError(f"{label}: rank {rank} failed:\n{out}")
            got[rank] = out
    except queue.Empty:
        raise AssertionError(f"{label}: the ranks gave no answer in "
                             f"{RANK_TIMEOUT_S}s ({len(got)} answered)")
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return got


def rank_launches(got: dict, case: str, total: dict) -> dict:
    """Launches of one case summed over the ranks; fails unless every rank
    launched both products in it."""
    summed = {name: 0 for name in DENSE_PATH}
    for rank, out in got.items():
        counts = out[case]["launches"]
        if not all(counts[name] for name in DENSE_PATH):
            raise AssertionError(f"9b {case}: a product never ran on rank "
                                 f"{rank}: {counts}")
        for name in DENSE_PATH:
            summed[name] += counts[name]
    for name, v in summed.items():
        total[name] += v
    return summed


def same_moments(got, want, label: str, bitwise: bool) -> None:
    for what, x, y in zip(("S1", "S2"), got, want):
        if bitwise:
            np.testing.assert_array_equal(x, y, err_msg=f"{label} {what}")
        else:
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-8,
                                       err_msg=f"{label} {what}")
    np.testing.assert_array_equal(got[2], want[2],
                                  err_msg=f"{label} n_reach")


def model_bytes(key: str, out: dict) -> float:
    """``model_mesh_bytes`` of one rank's batch on mesh ``key``."""
    shape, names = MESH_CASES[key]
    n_mp, n_cp, _ = out["sweeps"]
    return model_mesh_bytes(out["n_pad"], MESH_QUERY.n_b, (n_mp + n_cp) / 2,
                            dict(zip(names, shape)))


def mesh_bytes_line(key: str, out: dict) -> str:
    """Counted bytes per kind of one batch on one rank beside the model."""
    n_mp, n_cp, _ = out["sweeps"]
    b = out["bytes"]
    model = model_bytes(key, out)
    relax = b["gather"] + b["extremum"] + b["tie_sum"]
    kinds = ", ".join(f"{k} {v / 1e6:.3f} MB" for k, v in b.items())
    return (f"{kinds}; relaxes mp {n_mp} cp {n_cp}, whose collectives "
            f"{relax / 1e6:.3f} MB against the model's {model / 1e6:.3f} "
            f"MB: ratio {relax / model:.3f}")


def phase9b(g12, lam12, launches, backend: str = "gloo") -> dict:
    """Four ranks at scale 14 (and exact λ at scale 12) over ``backend``,
    against the single-host dense path on the card: sharing the one card
    over gloo here, one card a rank over NCCL in
    ``tools/torch_mesh_cards.py``. Returns the numbers by case."""
    t0 = time.perf_counter()
    g14 = graph(14)
    src = np.arange(64, dtype=np.int32)
    val = np.ones(64, bool)
    host = build_executor(g14, plan(g14, approx_query(64), device=DEV),
                          device=DEV)
    ref = host.step(src, val)
    del host
    single = solve(g14, dataclasses.replace(MESH_QUERY, execution=(
        ExecutionConfig(backend="dense", placement="single_host"))),
        device=DEV).approx
    served_host = serve_inline(BCService(
        {SERVE_NAME: g14}, execution=ExecutionConfig(backend="dense"),
        checkpoints=True, device=DEV))
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0
    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = write_binary_coo(os.path.join(tmp, "rmat14.rcoo"), g14)
        t0 = time.perf_counter()
        got = run_ranks(dict(g12=g12, g14=g14, path=path, backend=backend,
                             spawned=time.time()), tmp)
        wall = time.perf_counter() - t0
    r0 = got[0]
    cards = sorted({out["device"] for out in got.values()})
    where = (f"{MESH_RANKS} ranks sharing one H100 over {backend}"
             if len(cards) == 1 else
             f"{MESH_RANKS} ranks over {backend}, one H100 a rank")
    log(f"9b: single-host references in {t_ref:.1f}s; {where} "
        f"({', '.join(cards)}) answered in {wall:.1f}s, of which spawn, "
        f"imports and mesh groups "
        f"{max(out['setup_s'] for out in got.values()):.1f}s")
    report = {"backend": backend, "cards": cards}
    for key in MESH_CASES:
        out = r0[key]
        summed = rank_launches(got, key, launches)
        same_moments(out["moments"], ref, f"9b {key}", bitwise=False)
        for r in range(1, MESH_RANKS):
            same_moments(got[r][key]["moments"], out["moments"],
                         f"9b {key} rank {r}", bitwise=True)
        log(f"9b {key}: a 64-source batch at scale 14 in "
            f"{out['seconds']:.4f}s (mean of {MESH_REPEATS}: "
            f"{', '.join(f'{t:.4f}' for t in out['batch_s'])}) on {where} "
            f"(the first {out['first_s']:.3f}s; upload "
            f"{out['upload_s']:.3f}s; S={out['splits']}); "
            f"launches {summed}; == the single-host batch (n_reach bitwise, "
            f"S1/S2 rtol 1e-5), identical on every rank")
        for r in range(MESH_RANKS):
            log(f"9b {key} rank {r} bytes per batch: "
                f"{mesh_bytes_line(key, got[r][key])}")
        report[key] = dict(seconds=out["seconds"], first_s=out["first_s"],
                           batch_s=out["batch_s"],
                           bytes=[got[r][key]["bytes"]
                                  for r in range(MESH_RANKS)],
                           model_bytes=model_bytes(key, out))
    out = r0["exact12"]
    summed = rank_launches(got, "exact12", launches)
    np.testing.assert_allclose(out["lam"], lam12, rtol=1e-5, atol=1e-8)
    for r in range(1, MESH_RANKS):
        np.testing.assert_array_equal(got[r]["exact12"]["lam"], out["lam"])
    log(f"9b: exact λ at scale 12 on 2x2 (n_b {out['n_b']}) in "
        f"{out['seconds']:.3f}s on {where}; launches {summed}; == phase "
        f"3's λ (rtol 1e-5, atol 1e-8)")
    report["exact12"] = out["seconds"]
    out = r0["solve14"]
    summed = rank_launches(got, "solve14", launches)
    if (out["n_samples"], out["n_epochs"]) != (single.n_samples,
                                               single.n_epochs):
        raise AssertionError(
            f"9b: the mesh solve took {out['n_samples']} samples in "
            f"{out['n_epochs']} epochs, single host {single.n_samples} in "
            f"{single.n_epochs}")
    np.testing.assert_allclose(out["lam"], single.lam, rtol=1e-5, atol=1e-8)
    for r in range(1, MESH_RANKS):
        np.testing.assert_array_equal(got[r]["solve14"]["lam"], out["lam"])
    log(f"9b: (ε, δ) = (0.1, 0.1) solve at scale 14 on 2x2: "
        f"{out['n_samples']} samples in {out['n_epochs']} epochs "
        f"(converged={out['converged']}), {out['seconds']:.3f}s on "
        f"{where}; launches {summed}; == single host (same samples and "
        f"epochs, λ̂ rtol 1e-5)")
    report["solve14"] = out["seconds"]
    out = r0["stream"]
    summed = rank_launches(got, "stream", launches)
    for r in range(MESH_RANKS):
        same_moments(got[r]["stream"]["moments"], got[r]["2x2"]["moments"],
                     f"9b streamed rank {r}", bitwise=True)
    log(f"9b: streamed upload of the written binary COO file "
        f"(EdgeListReader, 65536-arc chunks) in {out['upload_s']:.3f}s; its "
        f"batch ({out['seconds']:.3f}s) bitwise the eager upload's on every "
        f"rank; launches {summed}")
    out = r0["serve"]
    summed = rank_launches(got, "serve", launches)
    same_served(out["docs"], served_host, "9b serve vs the single host")
    for r in range(1, MESH_RANKS):
        if got[r]["serve"]["followed"] != out["mirrored"]:
            raise AssertionError(f"9b serve: rank {r} ran "
                                 f"{got[r]['serve']['followed']} calls, "
                                 f"rank 0 mirrored {out['mirrored']}")
    for doc in out["docs"]:
        log(served("9b serve on 2x2", doc))
    log(f"9b: served on the 2x2 mesh ({where}; "
        f"rank 0 behind the HTTP gateway, ranks 1-3 following) in "
        f"{out['seconds']:.3f}s: the fused pair, the cache hit "
        f"({out['hit_ms']:.2f} ms, byte-identical) and the refine 0.1 -> "
        f"0.07; {out['mirrored']} executor calls mirrored; launches "
        f"{summed}; == the single-host dense service (samples, epochs, "
        f"converged; λ̂, halfwidths rtol 1e-5)")
    report["serve"] = dict(seconds=out["seconds"], mirrored=out["mirrored"],
                           hit_ms=out["hit_ms"],
                           latency_s=[d["latency_s"] for d in out["docs"]])
    return report


def phase9c(launches) -> None:
    """A one-rank NCCL mesh (1 x 1) in this process, one batch at scale
    14 against the single-host dense batch."""
    g14 = graph(14)
    src = np.arange(64, dtype=np.int32)
    val = np.ones(64, bool)
    host = build_executor(g14, plan(g14, approx_query(64), device=DEV),
                          device=DEV)
    ref = host.step(src, val)
    del host
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), device="cuda")
        ex = build_executor(g14, plan(g14, MESH_QUERY, mesh=mesh),
                            mesh=mesh)
        ex._context()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ex.step(src, val)  # the first batch: warm-up, timed apart
        first_s = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        got = ex.step(src, val)
        dt = time.perf_counter() - t0
        phase = tally(launches, DENSE_PATH, "9c")
        same_moments(got, ref, "9c", bitwise=True)
        log(f"9c: one-rank NCCL mesh (1x1, backend {mesh.backend}): one "
            f"64-source batch at scale 14 in {dt:.3f}s (the first "
            f"{first_s:.3f}s), launches {phase}; bitwise the single-host "
            f"dense batch")
        del ex
        torch.cuda.empty_cache()
        req = BCRequest(rid=0, graph=SERVE_NAME, eps=0.1)
        svc = BCService({SERVE_NAME: g14}, mesh=mesh)
        reset_counts()
        t0 = time.perf_counter()
        try:
            svc.submit(req)
            (resp,) = svc.run()
        finally:
            svc.close()
        dt = time.perf_counter() - t0
        phase = tally(launches, DENSE_PATH, "9c serve")
        host = BCService({SERVE_NAME: g14}, device=DEV,
                         execution=ExecutionConfig(backend="dense"))
        host.submit(req)
        (want,) = host.run()
        same_answer(resp.to_json(), want.to_json(), "9c serve vs the "
                    "single host")
        log(f"9c: BCService on the one-rank NCCL mesh served betweenness "
            f"ε 0.1 in {dt:.3f}s ({resp.n_samples} samples, "
            f"{resp.n_epochs} epochs, {svc.mirrored} calls mirrored), "
            f"launches {phase}; bitwise the single-host dense service's "
            f"answer")
        del svc, host
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()


# -- phase 10: a resumable run ----------------------------------------------

KILL_AFTER = 20  # phase 10's first run dies after saving this global batch


class Killed(Exception):
    """Phase 10's simulated kill of a ``bc_run`` process."""


def run_cli(argv, label: str):
    """``bc_run.main(argv)`` with its output kept: (λ, seconds, output)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            lam = bc_run.main(argv)
    except Killed:
        lam = None
    dt = time.perf_counter() - t0
    lines = buf.getvalue().splitlines()
    log(f"{label}: {dt:.3f}s; {lines[-1] if lines else ''}")
    return lam, dt, buf.getvalue()


def phase10(lam12, launches) -> None:
    """Exact BC at scale 12 through ``bc_run --ckpt-dir`` on dense, n_b 64:
    an uninterrupted run, and a run killed after global batch
    ``KILL_AFTER`` then resumed at the next; λ against phase 3's and the
    uninterrupted run's."""
    argv = ["--graph", "rmat", "--scale", "12", "--degree", "16",
            "--weighted", "--nb", "64", "--backend", "dense", "--device",
            "cuda"]
    saves = []
    save = ckpt_lib.save

    def timed_save(ckpt_dir, step, tree, **kw):
        t0 = time.perf_counter()
        out = save(ckpt_dir, step, tree, **kw)
        saves.append(time.perf_counter() - t0)
        if kill is not None and step == kill:
            raise Killed
        return out

    build = os.path.join(ROOT, "build")
    os.makedirs(build, exist_ok=True)
    ckpt_lib.save = timed_save
    try:
        with tempfile.TemporaryDirectory(dir=build) as tmp:
            kill = None
            whole, t_whole, _ = run_cli(
                argv + ["--ckpt-dir", os.path.join(tmp, "whole")],
                "10: uninterrupted --ckpt-dir run")
            save_ms = 1e3 * sum(saves) / len(saves)
            n_batches = len(saves)
            kill = KILL_AFTER
            ck = os.path.join(tmp, "killed")
            _, t_killed, _ = run_cli(argv + ["--ckpt-dir", ck],
                                     f"10: a run killed after batch "
                                     f"{KILL_AFTER}")
            if ckpt_lib.latest_step(ck) != KILL_AFTER:
                raise AssertionError(f"10: the killed run left step "
                                     f"{ckpt_lib.latest_step(ck)}")
            kill = None
            reset_counts()
            torch.cuda.synchronize()
            lam, t_resumed, text = run_cli(argv + ["--ckpt-dir", ck],
                                           "10: the resumed run")
            phase = tally(launches, DENSE_PATH, "10")
    finally:
        ckpt_lib.save = save
    if f"resuming at batch {KILL_AFTER + 1} (nb=64)" not in text:
        raise AssertionError("10: the second run did not resume at batch "
                             f"{KILL_AFTER + 1}")
    np.testing.assert_allclose(lam, lam12, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(lam, whole, rtol=1e-12, atol=0)
    log(f"10: exact λ at scale 12 through bc_run --ckpt-dir (dense, n_b "
        f"64, {n_batches} batches): uninterrupted {t_whole:.3f}s; killed "
        f"after batch {KILL_AFTER} at {t_killed:.3f}s, resumed at batch "
        f"{KILL_AFTER + 1} in {t_resumed:.3f}s; a checkpoint save "
        f"{save_ms:.3f} ms a batch; launches of the resumed run {phase}; "
        f"== phase 3's λ (rtol 1e-5, atol 1e-8) and the uninterrupted "
        f"run's (rtol 1e-12)")


# 11. LM serving at gemma2-27b's full width. Only depth is cut: all 46
# layers are 108.9 GB in f32, 8 (four local/global pairs) 22.84 GB.
LM_ARCH, LM_LAYERS = "gemma2-27b", 8
LM_SLOTS, LM_MAX_LEN = 4, 4352
# (prompt length, max_new): six requests through four slots; the 4200-token
# prompt passes the local layers' 4096 window
LM_REQUESTS = ((16, 16), (128, 8), (512, 32), (1000, 4), (4200, 8), (64, 24))
MOE_ARCH, MOE_LAYERS = "moonshot-v1-16b-a3b", 2
LM_ARCHS = [a for a, spec in ARCHS.items() if spec.family == "lm"]
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 2, 256, 8
LM_TIE = 1e-4  # a differing token's logit within this share of max|logit|
PROFILE_STEPS = 3  # 11a's decode steps under the profiler


def lm_config(arch: str, n_layers: int):
    """A published config at its full width, ``n_layers`` deep (as
    ``LMArch.build``'s ``layers_override`` cuts it)."""
    return dataclasses.replace(get_arch(arch).config(), n_layers=n_layers)


def param_bytes(model) -> int:
    return sum(p.numel() * p.element_size() for p in model.parameters())


def tie_or_fail(row: torch.Tensor, got: int, want: int, what: str) -> None:
    """Accept token ``got`` where ``want`` is the argmax of ``row`` only if
    their logits are within ``LM_TIE`` of max|logit|."""
    gap = float(row[want] - row[got])
    bound = LM_TIE * float(row.abs().max())
    if gap > bound:
        raise AssertionError(f"{what}: token {got}, argmax {want}, "
                             f"{gap:.3e} apart (near-tie bound {bound:.3e})")


def teacher_forced(model, req, label: str) -> int:
    """Each of ``req``'s tokens against the argmax of one teacher-forced
    pass over its prompt and its own tokens (the LM head only at the
    generated positions); returns the near ties it accepted."""
    cfg = model.cfg
    seq = np.concatenate([req.prompt, np.asarray(req.out[:-1], np.int64)])
    toks = torch.as_tensor(seq[None], dtype=torch.long, device=model.device)
    at = torch.arange(len(req.prompt) - 1, len(seq), device=model.device)
    h = T.forward_hidden(model, toks)[:, at]
    logits = LL.lm_logits(model.head(), h, cap=cfg.final_softcap,
                          tied=cfg.tie_embeddings)[0]
    best = torch.argmax(logits, -1).cpu().numpy()
    ties = 0
    for i, tok in enumerate(req.out):
        if tok != best[i]:
            tie_or_fail(logits[i], tok, int(best[i]),
                        f"{label}: request {req.rid} token {i}")
            ties += 1
    return ties


def timed(fn, into: list):
    """``fn`` with each call's host seconds (it ends in a device-to-host
    read) appended to ``into``."""
    def call(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        into.append(time.perf_counter() - t0)
        return out
    return call


def phase11a() -> None:
    """``ServeEngine`` over gemma2-27b at full width, ``LM_LAYERS`` deep,
    f32: six requests through four slots, every token held against a
    teacher-forced pass."""
    cfg = lm_config(LM_ARCH, LM_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(0),
                          DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = param_bytes(model)
    if nbytes != 4 * cfg.n_params():
        raise AssertionError(f"11a: {nbytes} parameter bytes, "
                             f"{4 * cfg.n_params()} expected")
    eng = ServeEngine(model, n_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    pre_s, dec_s = [], []
    eng._prefill = timed(eng._prefill, pre_s)
    eng._decode = timed(eng._decode, dec_s)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, n), max_new=m)
            for i, (n, m) in enumerate(LM_REQUESTS)]
    for r in reqs:
        eng.submit(r)
    t0 = time.perf_counter()
    ticks = 0
    while eng.queue or eng.active:
        eng.step()
        ticks += 1
    t_run = time.perf_counter() - t0
    if [len(r.out) for r in reqs] != [m for _, m in LM_REQUESTS]:
        raise AssertionError(f"11a: {[len(r.out) for r in reqs]} tokens")
    t0 = time.perf_counter()
    ties = sum(teacher_forced(model, r, "11a") for r in reqs)
    t_check = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    profile = decode_profile(eng)
    n_tok = sum(len(r.out) for r in reqs)
    kv = 2 * 4 * cfg.n_layers * LM_SLOTS * LM_MAX_LEN * cfg.n_kv * cfg.hd
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_kv = (nbytes + kv) / PEAK_BYTES_PER_S * 1e3
    dec = np.asarray(dec_s) * 1e3
    log(f"11a: {cfg.name} at full width (d {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv} heads of {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
        f"softcaps {cfg.attn_softcap}/{cfg.final_softcap}, windows "
        f"{sorted(set(cfg.layer_windows().tolist()))}), {cfg.n_layers} of "
        f"46 layers, f32: {cfg.n_params():,} parameters, {nbytes:,} bytes, "
        f"drawn on the card in {t_init:.3f}s; KV cache {kv:,} bytes")
    log(f"11a: prefill ms by prompt length: " + ", ".join(
        f"{len(r.prompt)}: {1e3 * s:.3f}" for r, s in zip(reqs, pre_s)))
    log(f"11a: {len(dec)} decode_steps over {LM_SLOTS} slots: mean "
        f"{dec.mean():.3f} ms, median {np.median(dec):.3f}, min "
        f"{dec.min():.3f}, max {dec.max():.3f}; bound {bound:.3f} ms "
        f"(parameter bytes / 3.35 TB/s; {bound_kv:.3f} ms with the KV "
        f"cache's bytes)")
    log(f"11a: {n_tok} tokens in {ticks} ticks, {t_run:.3f}s: "
        f"{n_tok / t_run:.3f} tokens/s; peak device memory "
        f"{peak / 2**30:.3f} GiB; every token the teacher-forced argmax "
        f"({ties} near ties within {LM_TIE} of max|logit|), checked in "
        f"{t_check:.3f}s")
    log(f"11a: a decode_step over the 4 slots (the engine's cache, at "
        f"position {LM_MAX_LEN - 8}; profiler over {PROFILE_STEPS}): "
        f"{profile['ms']:.3f} ms by CUDA events, device busy "
        + (f"{profile['busy']:.3f} of its wall time" if profile["busy"]
           else "not measured (the profiler saw no device time)")
        + "; by kernel, ms a step: "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in profile["top"]))


def decode_profile(eng) -> dict:
    """Where a ``decode_step`` over every slot spends its device time:
    its CUDA-event ms (a mean of 5 after a warm-up step), and under
    ``torch.profiler`` the device's busy share and the kernels with the
    most device time, ms a step. Runs on the finished engine's cache."""
    model = eng.model
    toks = torch.as_tensor(eng._tokens, device=DEV)
    pos = LM_MAX_LEN - 8

    def step(i):
        T.decode_step(model, toks, pos + i, eng.cache)

    step(0)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for i in range(5):
        step(i)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1]) / 5
    out = profiled(lambda: [step(i) for i in range(PROFILE_STEPS)],
                   PROFILE_STEPS, top=6, width=48)
    return {"ms": ms, **out}


def profiled(run, per: int, top: int, width: int) -> dict:
    """``run()`` under ``torch.profiler``: its wall time, the device's busy
    share of it, and the ``top`` kernels by device time (ms over ``per``,
    names cut to ``width``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    best = sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall": wall, "busy": busy_us * 1e-6 / wall if busy_us else None,
            "top": [(e.key[:width], e.self_device_time_total * 1e-3 / per)
                    for e in best]}


def astype_tree(tree, dtype):
    """A nested dict of numpy arrays cast to ``dtype``."""
    return {k: astype_tree(v, dtype) if isinstance(v, dict)
            else v.astype(dtype) for k, v in tree.items()}


def moe_calls(model, prompts, feed) -> tuple:
    """One prefill of ``prompts`` and ``MOE_STEPS`` decode steps fed the
    tokens of ``feed`` (or, when it is empty, the model's own argmax, which
    it appends): each call's logits, the final cache and each call's
    seconds, on the host."""
    cfg = model.cfg
    cache = T.init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_STEPS,
                         dtype=cfg.dtype, device=model.device)
    own = not feed
    outs, secs = [], []
    for i in range(MOE_STEPS + 1):
        if model.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            x = torch.as_tensor(prompts, device=model.device)
            logits, cache = T.prefill(model, x, cache)
        else:
            x = feed[i - 1].to(model.device)
            logits, cache = T.decode_step(model, x, MOE_PROMPT + i - 1,
                                          cache)
        logits = logits.cpu()
        secs.append(time.perf_counter() - t0)
        outs.append(logits)
        if own:
            feed.append(torch.argmax(logits[:, -1], -1)[:, None])
    return outs, [c.cpu() for c in cache], secs


def phase11b() -> None:
    """moonshot-v1-16b-a3b at full width, ``MOE_LAYERS`` deep: one prefill
    and ``MOE_STEPS`` decode steps on the card against the same calls on
    the CPU with the weights copied there (the card's tokens fed to
    both), in f32 and in f64. The f64 run holds the MoE dispatch on CUDA
    (``index_add_`` by atomics) to the CPU's: each call's logits and the
    caches within rtol 1e-4 and atol 1e-4 · max(1, max|x|) (the caches
    reach 55). Rope computes its angles in f32 in both precisions, as the
    reference does, and the attention logits reach hundreds (wq, wk drawn
    with fan_in = the head count, no softcap), so the card's and the CPU's
    f32 sin/cos, one ulp apart, move the softmax: about 1e-4 of layer 0's
    attention output. The f32 run adds the products' rounding; its
    difference is printed, not held."""
    cfg = lm_config(MOE_ARCH, MOE_LAYERS)
    t0 = time.perf_counter()
    card = T.init_params(cfg, torch.Generator(device=DEV).manual_seed(1), DEV)
    tree = T.params_to_numpy(card)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab,
                                                (MOE_BATCH, MOE_PROMPT))
    for dtype in (torch.float32, torch.float64):
        c = dataclasses.replace(cfg, dtype=dtype)
        if dtype == torch.float64:
            t0 = time.perf_counter()
            tree = astype_tree(tree, np.float64)
            card = T.params_from_reference(c, tree, DEV)
        host = T.params_from_reference(c, tree, "cpu")
        t_copy = time.perf_counter() - t0
        feed = []
        got = moe_calls(card, prompts, feed)
        want = moe_calls(host, prompts, feed)
        pairs = ([(f"call {i} logits", a, b)
                  for i, (a, b) in enumerate(zip(got[0], want[0]))]
                 + [("k cache", got[1][0], want[1][0]),
                    ("v cache", got[1][1], want[1][1])])
        if dtype == torch.float64:
            for what, a, b in pairs:
                np.testing.assert_allclose(
                    a.numpy(), b.numpy(), rtol=1e-4,
                    atol=1e-4 * max(1.0, float(b.abs().max())),
                    err_msg=f"11b f64 {what}")
        err_l = max(max_abs_err(a, b) for _, a, b in pairs[:-2])
        err_kv = max(max_abs_err(a, b) for _, a, b in pairs[-2:])
        held = "within rtol 1e-4, atol 1e-4 · max(1, max|x|) of the " \
            "CPU's" if dtype == torch.float64 else "not held"
        log(f"11b: {cfg.name} at full width (d {cfg.d_model}, "
            f"{cfg.moe.n_experts} experts top-{cfg.moe.top_k}, "
            f"{cfg.moe.n_shared} shared), {cfg.n_layers} of 48 layers, "
            f"{str(dtype)[6:]}, {param_bytes(card):,} bytes: prefill "
            f"{MOE_BATCH} x {MOE_PROMPT} and {MOE_STEPS} decode_steps, card "
            f"{1e3 * got[2][0]:.3f} ms + {1e3 * np.mean(got[2][1:]):.3f} ms "
            f"a step, CPU {want[2][0]:.3f}s + {np.mean(want[2][1:]):.3f}s a "
            f"step (weights placed in {t_copy:.3f}s); card vs CPU max abs "
            f"err: logits {err_l:.3e} (max|logit| "
            f"{float(want[0][-1].abs().max()):.3f}), caches {err_kv:.3e} "
            f"(max|k| {float(want[1][0].abs().max()):.3f}); {held}")
        if dtype == torch.float64:
            layer0_check(card, host, prompts)
        del card, host
        torch.cuda.empty_cache()
    del tree


def layer0_check(card, host, prompts) -> None:
    """Layer 0's attention and MoE on the card against the CPU on one
    identical f64 input each: the MoE dispatch within 1e-6 · max(1,
    max|x|), attention (rope's f32 sin/cos one ulp apart, logits in the
    hundreds) within 1e-4 · max(1, max|x|)."""
    pos = torch.arange(MOE_PROMPT).expand(MOE_BATCH, MOE_PROMPT)
    bc, bh = card.layers[0], host.layers[0]
    x = LL.embed_tokens(host.head(), torch.as_tensor(prompts))
    h = bh.norm_attn(x)
    a_h, _ = bh.attn(h, pos)
    a_c, _ = bc.attn(h.to(DEV), pos.to(DEV))
    m_in = bh.norm_mlp(x + a_h)
    m_h, m_c = bh.moe(m_in), bc.moe(m_in.to(DEV))
    out = []
    for what, got, want, tol in (("attention", a_c, a_h, 1e-4),
                                 ("MoE", m_c, m_h, 1e-6)):
        got = got.cpu()
        scale = max(1.0, float(want.abs().max()))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=tol * scale,
                                   err_msg=f"11b layer 0 {what}")
        out.append(f"{what} {max_abs_err(got, want):.3e} (max|x| "
                   f"{scale:.3f}, held at {tol} of it)")
    log(f"11b: layer 0 on one identical f64 input, card vs CPU max abs "
        f"err: {'; '.join(out)}")


def phase11c() -> None:
    """``launch.serve.main`` on each architecture's smoke config, on the
    card and on the CPU: the printed line, the shape, the same token ids
    (a row may differ from its first near tie on, judged on the CPU's
    logits)."""
    for arch in LM_ARCHS:
        argv = ["--arch", arch, "--smoke"]
        cfg = get_arch(arch).config(smoke=True)
        out = {}
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                out[dev] = lm_serve.main(argv + ["--device", dev])
            line = buf.getvalue().splitlines()[0]
            if not line.startswith(f"[serve] arch={cfg.name} batch=4 "
                                   f"prompt=32 gen=16 tok/s "):
                raise AssertionError(f"11c {arch} {dev}: {line!r}")
            if out[dev].shape != (4, 16):
                raise AssertionError(f"11c {arch} {dev}: {out[dev].shape}")
            if dev == "cuda":
                log(f"11c: {line}")
        ties = 0
        if not np.array_equal(out["cuda"], out["cpu"]):
            model, prompts = lm_serve.model_and_prompts(cfg, 4, 32, "cpu")
            _, logits = lm_serve.generate(model, prompts, 16)
            for r in range(4):
                diff = np.flatnonzero(out["cuda"][r] != out["cpu"][r])
                if diff.size:
                    j = int(diff[0])
                    tie_or_fail(logits[r, j], int(out["cuda"][r, j]),
                                int(out["cpu"][r, j]), f"11c {arch} row {r}")
                    ties += 1
        log(f"11c: {arch} --device cuda == --device cpu token ids "
            f"({ties} row(s) from a near tie on)")


# 12. LM training at gemma2-27b's full width. Only depth and batch are cut:
# training holds 16 B a parameter (weights, gradients, m, v in f32), so 4
# layers (3.445 B parameters, 55.1 GB) fit the card and 8 (91.4 GB) do not.
TRAIN_ARCH, TRAIN_LAYERS, TRAIN_SEQ = "gemma2-27b", 4, 4096
TRAIN_STEPS, TRAIN_CHUNKS = 6, 8
F32_PEAK = 67e12  # H100 SXM f32 FLOP/s outside the tensor cores
# the finite-difference steps move the loss by about these: the larger
# meets the loss's curvature, the smaller its f32 rounding
FD_MOVES = (1e-2, 1e-3)
FD_TOL = 1e-2
OPT_REPEATS = 3
TRAIN_MOE_LAYERS, TRAIN_MOE_BATCH, TRAIN_MOE_SEQ = 1, 2, 256
LAUNCH_STEPS, LAUNCH_HELD = 20, 8  # 12c: run 20 steps, hold the first 8


def train_opt(steps: int) -> adamw.AdamWConfig:
    """``launch.train``'s AdamW settings for a run of ``steps``."""
    return adamw.AdamWConfig(lr=3e-4, warmup_steps=min(20, steps),
                             total_steps=steps)


def tree_bytes(tree) -> int:
    return sum(x.numel() * x.element_size() for _, x in tree_lib.leaves(tree))


def on_card(batch: dict) -> tuple:
    return tuple(torch.as_tensor(batch[k], device=DEV).long()
                 for k in ("tokens", "targets"))


def displaced(params, d, step: float) -> float:
    """Moves ``params`` by ``step · d`` in place; returns d · (the move
    the rounding to f32 made), which ``step · |d|²`` only approximates."""
    dot = 0.0
    with torch.no_grad():
        for (_, p), (_, x) in zip(tree_lib.leaves(params),
                                  tree_lib.leaves(d)):
            new = torch.add(p, x, alpha=step)
            dot += float(torch.dot((new - p).reshape(-1), x.reshape(-1)))
            p.copy_(new)
            del new
    return dot


def gradient_fd_check(loss_of, draw, label: str) -> dict:
    """Step 0's gradient ``g`` of ``loss_of`` at the parameters ``draw()``
    gives, against the loss along ``d = g/|g|``:
    ``(L(θ+εd) − L(θ−εd)) / (2ε)`` against ``|g|``, with ε = move / |g|
    for each move of ``FD_MOVES``; held where the closer of the two is
    within ``FD_TOL``. The moves are made in f32 and read back exactly,
    so the quotient divides by the moves made (``displaced``); the
    nominal one is printed beside it. θ is redrawn from its seed for each
    side."""
    params = draw()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss0, d = value_and_grad(loss_of, params)
    gnorm = adamw.global_norm(d)
    torch.cuda.synchronize()
    t_vag = time.perf_counter() - t0
    peak_vag = torch.cuda.max_memory_allocated()
    with torch.no_grad():
        for _, x in tree_lib.leaves(d):
            x.div_(gnorm)
    g = float(gnorm)
    rels = []
    for i, move in enumerate(FD_MOVES):
        eps = move / g
        out = {}
        for sign in (1, -1):
            if i or sign < 0:  # θ was moved: draw it again
                del params
                params = draw()
            moved = displaced(params, d, sign * eps)
            with torch.no_grad():
                out[sign] = (float(loss_of(params)), abs(moved))
        fd = (out[1][0] - out[-1][0]) / (out[1][1] + out[-1][1])
        nominal = (out[1][0] - out[-1][0]) / (2 * eps)
        rels.append(abs(fd - g) / g)
        log(f"{label}: gradient check at step 0, loss move {move}: ε "
            f"{eps:.4e}, L(θ+εd) {out[1][0]:.7f}, L(θ−εd) {out[-1][0]:.7f}; "
            f"directional derivative {fd:.6e} over the moves made "
            f"({(out[1][1] + out[-1][1]) / (2 * eps):.6f} of 2ε), "
            f"{nominal:.6e} over 2ε; relative difference from |g| "
            f"{rels[-1]:.3e}")
    del params, d
    log(f"{label}: |g| {g:.6e}, loss {float(loss0):.7f}; the closer "
        f"directional derivative within {min(rels):.3e} of |g| (held at "
        f"{FD_TOL}); value_and_grad {t_vag:.3f}s, peak "
        f"{peak_vag / 2**30:.3f} GiB")
    if not min(rels) <= FD_TOL:
        raise AssertionError(f"{label}: the gradient disagrees with the "
                             f"loss: relative differences {rels}")
    return {"loss": float(loss0), "grad_norm": g}


def optimizer_ms(opt, state) -> list:
    """``adamw.update`` alone on ``state`` (CUDA events), fed constant
    gradients made before each timed call."""
    out = []
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    for _ in range(OPT_REPEATS):
        grads = tree_lib.tree_map(lambda p: torch.full_like(p, 1e-6),
                                  state["params"])
        torch.cuda.synchronize()
        ev[0].record()
        adamw.update(opt, grads, state["opt"], state["params"])
        ev[1].record()
        torch.cuda.synchronize()
        out.append(ev[0].elapsed_time(ev[1]))
        del grads
    return out


def phase12a() -> None:
    """``make_lm_train_step`` on gemma2-27b at full width, ``TRAIN_LAYERS``
    deep, remat full, chunked CE, f32: the gradient check, then
    ``TRAIN_STEPS`` steps over ``LMPipeline``; their times, the
    optimizer's alone and one step under the profiler."""
    cfg = lm_config(TRAIN_ARCH, TRAIN_LAYERS)
    if cfg.remat != "full":
        raise AssertionError(f"12a: remat {cfg.remat!r}")
    opt = train_opt(TRAIN_STEPS)
    pipe = LMPipeline(LMDataConfig(vocab=cfg.vocab, batch=1, seq=TRAIN_SEQ,
                                   seed=0))
    torch.cuda.reset_peak_memory_stats()
    toks, tgts = on_card(pipe.batch(0))
    fd = gradient_fd_check(
        lambda p: T.loss_fn((cfg, p), toks, tgts, chunks=TRAIN_CHUNKS),
        lambda: T.init_tree(cfg, torch.Generator(device=DEV).manual_seed(0),
                            DEV), "12a")
    del toks, tgts
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    init_fn, step_fn = make_lm_train_step(cfg, opt, device=DEV,
                                          chunks=TRAIN_CHUNKS)
    t0 = time.perf_counter()
    state = init_fn(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = tree_bytes(state)
    n = cfg.n_params()
    if tree_bytes(state["params"]) != 4 * n:
        raise AssertionError(f"12a: {tree_bytes(state['params'])} bytes of "
                             f"parameters, {4 * n} expected")
    secs, metrics = [], []
    for k in range(TRAIN_STEPS):
        batch = pipe.batch(k)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        m = {key: float(v) for key, v in m.items()}
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        metrics.append(m)
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in metrics]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"12a: losses {losses}")
    same = (metrics[0]["loss"] == fd["loss"],
            metrics[0]["grad_norm"] == fd["grad_norm"])
    med = float(np.median(secs[1:]))
    flops = 6.0 * cfg.n_active_params() * 1 * TRAIN_SEQ
    opt_ms = optimizer_ms(opt, state)
    opt_bound = 28.0 * n / PEAK_BYTES_PER_S * 1e3
    batch = pipe.batch(TRAIN_STEPS)
    profile = profiled(lambda: step_fn(state, batch), 1, top=8, width=56)
    log(f"12a: {cfg.name} at full width, {cfg.n_layers} of 46 layers, remat "
        f"{cfg.remat}, CE in {TRAIN_CHUNKS} chunks, f32: {n:,} parameters; "
        f"train state {nbytes:,} bytes ({nbytes / 2**30:.3f} GiB: params, "
        f"m, v) drawn on the card in {t_init:.3f}s; one sequence of "
        f"{TRAIN_SEQ} tokens a step (LMPipeline seed 0), AdamW lr 3e-4, "
        f"warm-up {opt.warmup_steps}, clip 1.0")
    log(f"12a: losses " + ", ".join(f"{x:.6f}" for x in losses)
        + "; grad norms " + ", ".join(f"{m['grad_norm']:.4f}"
                                      for m in metrics)
        + "; lr " + ", ".join(f"{m['lr']:.3e}" for m in metrics))
    log(f"12a: step 0 {1e3 * secs[0]:.3f} ms (cuBLAS set-up), steps 1-"
        f"{TRAIN_STEPS - 1} median {1e3 * med:.3f} ms (min "
        f"{1e3 * min(secs[1:]):.3f}, max {1e3 * max(secs[1:]):.3f}); "
        f"{TRAIN_SEQ / med:.3f} tokens/s; model FLOPs a step "
        f"6·N_active·B·S = {flops:.4e}: {flops / med / 1e12:.3f} TFLOP/s, "
        f"{flops / med / F32_PEAK:.4f} of 67 TFLOP/s f32; peak device "
        f"memory {peak / 2**30:.3f} GiB ({peak:,} bytes)")
    log(f"12a: the optimizer alone (adamw.update, CUDA events, "
        f"{OPT_REPEATS} calls): " + ", ".join(f"{x:.3f}" for x in opt_ms)
        + f" ms against its bound {opt_bound:.3f} ms (28 B a parameter at "
        f"3.35 TB/s)")
    log(f"12a: step 0 repeats the gradient check's loss and grad norm "
        f"bitwise: {same[0]}, {same[1]}")
    log(f"12a: one step under torch.profiler: wall {profile['wall']:.3f}s, "
        f"device busy "
        + (f"{profile['busy']:.4f} of it" if profile["busy"]
           else "not measured (the profiler saw no device time)")
        + "; by kernel, ms: "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in profile["top"]))


def leaf_pairs(a, b):
    for (p, x), (q, y) in zip(tree_lib.leaves(a), tree_lib.leaves(b)):
        assert p == q, (p, q)
        yield "/".join(map(str, p)), x, y


def card_vs_cpu(got, want, old, dtype, what: str, label: str = "12b"
                ) -> dict:
    """Each leaf of ``got`` (on the card) against ``want`` (on the CPU,
    moved to the card leaf by leaf): the largest difference, held in f64
    within rtol 1e-4, atol 1e-4 · max(1, max|x|) when ``old`` is None
    (the parameters), else over each leaf's scale (printed only); with
    ``old``, also the smallest cosine between the two updates (a leaf the
    CPU's update leaves must stay on the card too)."""
    out = {"err": 0.0, "rel": 0.0, "cos": 1.0}
    for name, x, y in leaf_pairs(got, want):
        y = y.to(DEV)
        diff = (x - y).abs()
        scale = float(y.abs().max())
        out["err"] = max(out["err"], float(diff.max()))
        out["rel"] = max(out["rel"], float(diff.max()) / max(scale, 1e-30))
        if what == "params" and dtype == torch.float64:
            atol = 1e-4 * max(1.0, scale)
            if not bool((diff <= atol + 1e-4 * y.abs()).all()):
                raise AssertionError(f"{label} f64 {name}: card vs CPU "
                                     f"{float(diff.max())} (atol {atol})")
        if old is not None:
            o = old[name].to(DEV, torch.float64)
            du, dw = x.double() - o, y.double() - o
            if float(dw.norm()):
                out["cos"] = min(out["cos"], float(
                    (du * dw).sum() / (du.norm() * dw.norm())))
            elif float(du.norm()):  # a leaf the CPU left must stay
                raise AssertionError(f"{label} {name}: moved on the card by "
                                     f"{float(du.abs().max())}, not on "
                                     f"the CPU")
        del y, diff
    return out


def phase12b() -> None:
    """moonshot-v1-16b-a3b at full width, ``TRAIN_MOE_LAYERS`` deep: one
    ``make_lm_train_step`` step (the train cell's AdamW: lr 3e-4 after 100
    warm-up steps) on 2 × 256 tokens on the card and on the CPU, from one
    state copied to both, in f32 and in f64. In f64 the loss, the grad
    norm and every updated parameter are held within rtol 1e-4, atol 1e-4
    · max(1, max|x|); m (0.1 × the clipped gradient) and the cosine of
    each leaf's update are printed beside. The f32 difference is
    printed."""
    cfg = lm_config(MOE_ARCH, TRAIN_MOE_LAYERS)
    opt = adamw.AdamWConfig()
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (TRAIN_MOE_BATCH, TRAIN_MOE_SEQ + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    with open("/proc/meminfo") as f:
        mem = {ln.split(":")[0]: ln.split()[1] for ln in f}
    log(f"12b: host memory {int(mem['MemTotal']) / 2**20:.1f} GiB, "
        f"available {int(mem['MemAvailable']) / 2**20:.1f} GiB")
    init_fn, card_step = make_lm_train_step(cfg, opt, device=DEV)
    card = init_fn(torch.Generator(device=DEV).manual_seed(1))
    host = {"/".join(p): x.cpu() for p, x in tree_lib.leaves(card["params"])}
    # step 0 twice from one state on the card: the MoE adds by atomics
    twin = tree_lib.tree_map(torch.clone, card)
    card_step(card, batch)
    card_step(twin, batch)
    repeat = all(torch.equal(x, y) for _, x, y in leaf_pairs(card, twin))
    del card, twin
    torch.cuda.empty_cache()
    log(f"12b: step 0 run twice from one state on the card is bitwise "
        f"equal: {repeat}")
    for dtype in (torch.float32, torch.float64):
        c = dataclasses.replace(cfg, dtype=dtype)
        t0 = time.perf_counter()
        states = {}
        for d in (DEV, "cpu"):
            params = tree_lib.unflatten(
                (tuple(k.split("/")), x.to(d, dtype, copy=True))
                for k, x in host.items())
            states[d] = {"params": params, "opt": adamw.init_state(params)}
        t_copy = time.perf_counter() - t0
        secs, ms = {}, {}
        for d, st in states.items():
            _, step = make_lm_train_step(c, opt, device=d)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step(st, batch)
            ms[d] = {k: float(v) for k, v in m.items()}
            secs[d] = time.perf_counter() - t0
        got, want = states[DEV], states["cpu"]
        par = card_vs_cpu(got["params"], want["params"], host, dtype,
                          "params")
        mom = card_vs_cpu(got["opt"]["m"], want["opt"]["m"], None, dtype,
                          "m")
        a, b = ms[DEV], ms["cpu"]
        if dtype == torch.float64:
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                           err_msg=f"12b f64 {k}")
        held = "held within rtol 1e-4, atol 1e-4 · max(1, max|x|)" \
            if dtype == torch.float64 else "not held"
        log(f"12b: {cfg.name} at full width ({cfg.moe.n_experts} experts "
            f"top-{cfg.moe.top_k}, {cfg.moe.n_shared} shared), "
            f"{cfg.n_layers} of 48 layers, {cfg.n_params():,} parameters, "
            f"{str(dtype)[6:]} (states placed in {t_copy:.3f}s): one step "
            f"on {TRAIN_MOE_BATCH} x {TRAIN_MOE_SEQ} tokens, card "
            f"{1e3 * secs[DEV]:.3f} ms, CPU {secs['cpu']:.3f}s; loss card "
            f"{a['loss']:.9f} CPU {b['loss']:.9f}, grad norm "
            f"{a['grad_norm']:.9f} / {b['grad_norm']:.9f}; card vs CPU: "
            f"params max abs err {par['err']:.3e} ({held}), m "
            f"{mom['rel']:.3e} of its scale, smallest cosine of a leaf's "
            f"update {par['cos']:.6f}")
        del states, got, want
        torch.cuda.empty_cache()
    del host


def phase12c() -> None:
    """``launch.train.main`` on each architecture's smoke config, on the
    card and on the CPU, ``LAUNCH_STEPS`` steps (so that the loss has
    fallen by the last: 8 leave command-r's and qwen3's smoke losses
    within their batches' spread on the CPU): the first ``LAUNCH_HELD``
    losses within rtol 1e-4, the largest difference of all printed."""
    for arch in LM_ARCHS:
        argv = ["--arch", arch, "--smoke", "--steps", str(LAUNCH_STEPS)]
        cfg = get_arch(arch).config(smoke=True)
        out, secs = {}, {}
        for dev in ("cuda", "cpu"):
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                out[dev] = np.asarray(lm_train.main(argv + ["--device",
                                                            dev]))
            secs[dev] = time.perf_counter() - t0
            line = buf.getvalue().splitlines()[0]
            if not line.startswith(f"[train] arch={cfg.name} "):
                raise AssertionError(f"12c {arch} {dev}: {line!r}")
        rel = np.abs(out["cuda"] - out["cpu"]) / np.abs(out["cpu"])
        np.testing.assert_allclose(out["cuda"][:LAUNCH_HELD],
                                   out["cpu"][:LAUNCH_HELD], rtol=1e-4,
                                   err_msg=f"12c {arch}")
        log(f"12c: {arch} smoke: {LAUNCH_STEPS} steps, card "
            f"{secs['cuda']:.3f}s, CPU {secs['cpu']:.3f}s; losses "
            f"{out['cuda'][0]:.6f} -> {out['cuda'][-1]:.6f}; card vs CPU "
            f"relative: first {LAUNCH_HELD} steps {rel[:LAUNCH_HELD].max():.3e} "
            f"(held at 1e-4), all {rel.max():.3e}")


def phase12d() -> None:
    """``launch.train --arch gemma2-27b --smoke --compress int8`` under
    ``--ckpt-dir`` on the card, with failures injected at steps 4 and 8
    (before the first save: each restarts from a fresh initial state)
    against the same run without them: the final checkpoints' parameters
    within rtol 1e-6."""
    base = ["--arch", "gemma2-27b", "--smoke", "--compress", "int8",
            "--device", "cuda"]
    final = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for label, extra in (("clean", []), ("failed", ["--fail-at", "4",
                                                        "8"])):
            d = os.path.join(tmp, label)
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                losses = lm_train.main(base + ["--ckpt-dir", d] + extra)
            final[label] = (ckpt_lib.restore(d)[0], len(losses),
                            time.perf_counter() - t0)
    (a, na, ta), (b, nb, tb) = final["clean"], final["failed"]
    keys = sorted(k for k in a if k.startswith("params/"))
    err = 0.0
    for k in keys:
        np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=f"12d {k}")
        err = max(err, float(np.abs(b[k] - a[k]).max()))
    bitwise = all(np.array_equal(a[k], b[k]) for k in a)
    log(f"12d: launch.train gemma2 smoke, int8 compression, --ckpt-dir: "
        f"clean {na} steps in {ta:.3f}s, with failures at 4 and 8 {nb} "
        f"steps (the restarts re-run 0-3 and 0-7) in {tb:.3f}s; final "
        f"parameters within rtol 1e-6 (max abs err {err:.3e}; the whole "
        f"checkpoint bitwise equal: {bitwise})")


def phase12() -> None:
    """Phase 12, f32 with TF32 off: it fails if a BC kernel launched."""
    # the earlier phases leave reference cycles (11a's timed wrappers
    # hold its engine, whose model and cache are 23.4 GiB): collect them
    gc.collect()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"12: torch.backends.cuda.matmul.allow_tf32 = {tf32}, float32 "
        f"matmul precision {torch.get_float32_matmul_precision()!r}; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    if tf32:
        raise AssertionError("12: TF32 is on; the LM path is held in f32")
    reset_counts()
    for part in (phase12a, phase12b, phase12c, phase12d):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        log(f"{part.__name__} in {time.perf_counter() - t0:.1f}s")
    ran = {name: w.launches for name, w in WRAPPERS.items() if w.launches}
    if ran:
        raise AssertionError(f"12: the LM training path launched BC "
                             f"kernels: {ran}")


# -- phase 13: the GNN and recsys families ------------------------------------

GNN_ARCHS = ("gcn-cora", "gin-tu", "nequip", "gat-cora")
GNN_SMALL = ("full_graph_sm", "minibatch_lg", "molecule")
OGB_ARCHS = ("gcn-cora", "gin-tu", "gat-cora")
GNN_TIMED = 5  # timed steps a cell, after one warm-up
XDFM_BATCHES = (65536, 32768, 16384)  # train_batch's, then halved
BULK_CHUNK = 32768  # serve_bulk's rows a call
P99_CALLS = 200
XDFM_ROWS, XDFM_CANDS = 64, 4096  # the slices held against the CPU
GNN_MESH = ((2, 2), ("data", "model"))
GNN_MESH_CLASSES, GNN_MESH_DIN = 47, 100
GNN_MESH_REPEATS = 3


def placed(tree, device, dtype=None):
    """A copy of a tree of tensors on ``device``, floats cast to
    ``dtype`` (ints, bools and plain ints kept)."""
    def put(t):
        if not isinstance(t, torch.Tensor):
            return t
        want = dtype if dtype is not None and t.is_floating_point() \
            else t.dtype
        return t.to(device=device, dtype=want, copy=True)

    return tree_lib.tree_map(put, tree)


def by_name(tree) -> dict:
    return {"/".join(map(str, p)): x for p, x in tree_lib.leaves(tree)}


def timed_steps(fn, n: int) -> tuple:
    """``fn()`` ``1 + n`` times, each synced on the host clock; (seconds of
    each, the last output)."""
    secs, out = [], None
    for _ in range(1 + n):
        del out
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs, out


def step_card_vs_cpu(b, host_params, host_args, label: str) -> dict:
    """One step of bundle ``b`` in f64 on the card and on the CPU from the
    same state (the CPU's ``host_params``, f32, and ``host_args``): the
    loss within rtol 1e-4; the grad norm, which AdamW sums in f32 as the
    reference does, within rtol 1e-6; the gradient, read back from AdamW's
    first moment (0.1 × the clipped gradient) over the clip's scale that
    each side took, within 3e-7 of each leaf's largest magnitude on the
    CPU, and exactly zero on the card where it is zero on the CPU; the
    parameters by ``card_vs_cpu`` (held in f64, the smallest cosine of a
    leaf's update at least 0.999). The moments are f32, as the
    reference's: the two sides' f64 gradients agree to rounding, but each
    is rounded to f32 twice (the cast, then 0.1 ×), so they may differ by
    2^-22 of a value."""
    clip = adamw.AdamWConfig().grad_clip  # the cells' clip
    out = {}
    for d in (DEV, "cpu"):
        p = placed(host_params, d, torch.float64)
        args = placed(host_args, d, torch.float64)
        opt = adamw.init_state(p)
        t0 = time.perf_counter()
        _, _, m = b.fn(p, opt, *args)
        secs = time.perf_counter() - t0
        # clip_by_global_norm's scale, by the same ops on the same device
        scale = torch.clamp(clip / torch.clamp(m["grad_norm"], min=1e-9),
                            max=1.0).double()
        out[d] = (p, opt["m"], scale, float(m["loss"]),
                  float(m["grad_norm"]), secs)
        del args
    old = by_name(host_params)
    par = card_vs_cpu(out[DEV][0], out["cpu"][0], old, torch.float64,
                      "params", label)
    grad_rel = 0.0
    for name, x, y in leaf_pairs(out[DEV][1], out["cpu"][1]):
        x = x.double() / out[DEV][2]
        y = y.to(DEV, torch.float64) / out["cpu"][2].to(DEV)
        top, err = float(y.abs().max()), float((x - y).abs().max())
        if not top:
            if err:
                raise AssertionError(f"{label} {name}: gradient {err} on "
                                     f"the card, 0 on the CPU")
            continue
        grad_rel = max(grad_rel, err / top)
        if err > 3e-7 * top:
            raise AssertionError(f"{label} f64 {name}: gradient card vs CPU "
                                 f"{err} of {top}")
        del x, y
    np.testing.assert_allclose(out[DEV][3], out["cpu"][3], rtol=1e-4,
                               err_msg=f"{label} f64 loss")
    np.testing.assert_allclose(out[DEV][4], out["cpu"][4], rtol=1e-6,
                               err_msg=f"{label} f64 grad norm")
    if not par["cos"] >= 0.999:
        raise AssertionError(f"{label}: an update's cosine {par['cos']}")
    return {"loss": (out[DEV][3], out["cpu"][3]),
            "norm": (out[DEV][4], out["cpu"][4]), "grad_rel": grad_rel,
            "cpu_s": out["cpu"][5], **par}


def phase13a() -> None:
    """Each GNN at its published width on ``full_graph_sm``,
    ``minibatch_lg`` and ``molecule`` at the cells' sizes: steps of
    ``build(cell).fn`` on the card (f32), then one step in f64 on the
    card and the CPU from one state."""
    gen = torch.Generator(device=DEV)
    for arch in GNN_ARCHS:
        spec = get_arch(arch)
        for shape in GNN_SMALL:
            b = spec.build(spec.cells()[shape])
            gen.manual_seed(0)
            params, opt, batch = b.concrete_args(gen, DEV)
            host = (placed(params, "cpu"), (placed(batch, "cpu"),))
            torch.cuda.reset_peak_memory_stats()
            secs, out = timed_steps(lambda: b.fn(params, opt, batch),
                                    GNN_TIMED)
            b.check(out)
            peak = torch.cuda.max_memory_allocated()
            med = float(np.median(secs[1:]))
            del params, opt, out
            held = step_card_vs_cpu(b, *host, f"13a {arch} {shape}")
            meta = spec.meta(shape)
            log(f"13a: {arch} x {shape} (nodes+1 {batch['x'].shape[0]:,}, "
                f"edges {batch['src'].shape[0]:,}, d {meta['d']}): "
                f"{1e3 * med:.3f} ms a step (median of {GNN_TIMED}; "
                f"warm-up {1e3 * secs[0]:.3f}), model FLOPs "
                f"{b.model_flops:.4e}: {b.model_flops / med / 1e12:.4f} "
                f"TFLOP/s of 67; peak {peak / 2**30:.3f} GiB; f64 card vs "
                f"CPU loss {held['loss'][0]:.12f} / {held['loss'][1]:.12f}, "
                f"grad norm {held['norm'][0]:.9f} / {held['norm'][1]:.9f}, "
                f"gradient {held['grad_rel']:.3e} of each leaf's scale, "
                f"params max abs err {held['err']:.3e}, smallest update "
                f"cosine {held['cos']:.6f} (CPU step {held['cpu_s']:.3f}s)")
            del batch, host
            torch.cuda.empty_cache()


def phase13b() -> dict:
    """``ogb_products`` full-batch (2,449,029 nodes, 61,859,140 edges, d
    100) for GCN, GIN and GAT: GCN's gradient against central differences,
    then ``GNN_TIMED`` steps each; a cell that does not fit is listed with
    its peak. One GCN step under the profiler."""
    gen = torch.Generator(device=DEV)
    profile = None
    for arch in OGB_ARCHS:
        spec = get_arch(arch)
        b = spec.build(spec.cells()["ogb_products"])
        meta = spec.meta("ogb_products")
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            gen.manual_seed(0)
            t0 = time.perf_counter()
            batch = spec.torch_batch("ogb_products", gen, device=DEV)
            torch.cuda.synchronize()
            t_batch = time.perf_counter() - t0
            cfg = spec.cell_config("ogb_products")
            if arch == "gcn-cora":
                gradient_fd_check(
                    lambda p: G.node_ce_loss("gcn", cfg, p, batch),
                    lambda: G.gcn_init(cfg, gen.manual_seed(0), DEV),
                    "13b gcn-cora")
            gen.manual_seed(0)
            params = G.INIT[spec.kind](cfg, gen, DEV)
            opt = adamw.init_state(params)
            secs, out = timed_steps(lambda: b.fn(params, opt, batch),
                                    GNN_TIMED)
            b.check(out)
            losses = float(out[2]["loss"])
            if arch == "gcn-cora":
                profile = profiled(lambda: b.fn(params, opt, batch), 1,
                                   top=8, width=56)
        except torch.cuda.OutOfMemoryError as e:
            if arch != "gat-cora":
                raise
            oom = str(e).splitlines()[0][:160]
        else:
            oom = None
        if oom is not None:  # outside the handler: its frames are freed
            batch = params = opt = out = None
            gc.collect()
            torch.cuda.empty_cache()
            log(f"13b: {arch} x ogb_products does not fit the card: out of "
                f"memory at a peak of "
                f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                f"allocated ({oom})")
            continue
        peak = torch.cuda.max_memory_allocated()
        med = float(np.median(secs[1:]))
        L = cfg.n_layers
        E = batch["src"].shape[0]
        log(f"13b: {arch} x ogb_products (nodes+1 {batch['x'].shape[0]:,}, "
            f"edges {E:,}, d {meta['d']}, batch drawn on the card in "
            f"{t_batch:.3f}s): {1e3 * med:.3f} ms a step (median of "
            f"{GNN_TIMED}; warm-up {1e3 * secs[0]:.3f}, min "
            f"{1e3 * min(secs[1:]):.3f}, max {1e3 * max(secs[1:]):.3f}), "
            f"{E * L / med / 1e9:.4f} G edges/s (E x {L} layers / step), "
            f"model FLOPs {b.model_flops:.4e}: "
            f"{b.model_flops / med / 1e12:.4f} TFLOP/s of 67; peak "
            f"{peak / 2**30:.3f} GiB; last loss {losses:.6f}")
        del batch, params, opt, out
        torch.cuda.empty_cache()
    e = get_arch("nequip").meta("ogb_products")["e"]
    log(f"13b: nequip x ogb_products is not run: it needs the mesh (its "
        f"gathered rank-2 features and messages, (E, 32, 3, 3) f32, are "
        f"{e * 32 * 9 * 4 / 1e9:.1f} GB each)")
    log("13b: a gcn-cora ogb_products step under torch.profiler: wall "
        f"{profile['wall']:.3f}s, device busy "
        + (f"{profile['busy']:.4f} of it" if profile["busy"]
           else "not measured (the profiler saw no device time)")
        + "; by kernel, ms: "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in profile["top"]))
    return profile


def xdfm_ids(gen, cfg, rows: int) -> torch.Tensor:
    return torch.randint(0, cfg.total_vocab, (rows, cfg.n_fields, 1),
                         generator=gen, device=DEV)


def phase13c() -> None:
    """xDeepFM at its published width (39 fields, a 39,000,064-row table
    of 10, CIN (200, 200, 200), MLP (400, 400)): ``train_batch`` at the
    largest of ``XDFM_BATCHES`` that fits, ``serve_p99``, ``serve_bulk``
    in chunks of ``BULK_CHUNK`` rows and ``retrieval_cand``, each held
    against the CPU in f64 on a slice."""
    spec = get_arch("xdeepfm")
    cfg = spec.config()
    gen = torch.Generator(device=DEV).manual_seed(0)
    t0 = time.perf_counter()
    params = R.init_params(cfg, gen, DEV)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    nbytes = tree_bytes(params)
    if nbytes != 4 * cfg.n_params():
        raise AssertionError(f"13c: {nbytes} parameter bytes")
    opt = adamw.init_state(params)
    cells = spec.cells()
    train = spec.build(cells["train_batch"])
    serve_b = spec.build(cells["serve_p99"])
    ret = spec.build(cells["retrieval_cand"])
    # the card against the CPU in f64 on slices, from the drawn state
    ids = xdfm_ids(gen, cfg, XDFM_ROWS)
    lbl = torch.randint(0, 2, (XDFM_ROWS,), generator=gen,
                        device=DEV).float()
    q, cands = xdfm_ids(gen, cfg, 1), xdfm_ids(gen, cfg, XDFM_CANDS)
    host = placed(params, "cpu")
    f64 = {d: placed(host, d, torch.float64) for d in (DEV, "cpu")}
    errs = {}
    for name, fn, args in (("serve", serve_b.fn, (ids,)),
                           ("retrieval", ret.fn, (q, cands))):
        got = fn(f64[DEV], *args)
        want = fn(f64["cpu"], *placed(args, "cpu"))
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-4, atol=1e-4 * float(
                                       want.abs().max()),
                                   err_msg=f"13c {name} f64")
        errs[name] = float((got.cpu() - want).abs().max())
    del f64
    held = step_card_vs_cpu(train, host, (ids, lbl), "13c train")
    del host
    gc.collect()
    torch.cuda.empty_cache()
    log(f"13c: xdeepfm at full width: {cfg.n_params():,} parameters "
        f"({nbytes / 2**30:.3f} GiB, drawn on the card in {t_init:.3f}s), "
        f"train state {tree_bytes(opt) / 2**30 + nbytes / 2**30:.3f} GiB; "
        f"f64 card vs CPU: serve on {XDFM_ROWS} rows max abs err "
        f"{errs['serve']:.3e}, retrieval on {XDFM_CANDS} candidates "
        f"{errs['retrieval']:.3e} (held within 1e-4 of their scale); one "
        f"train step on {XDFM_ROWS} rows: loss {held['loss'][0]:.12f} / "
        f"{held['loss'][1]:.12f}, grad norm {held['norm'][0]:.9f} / "
        f"{held['norm'][1]:.9f}, gradient {held['grad_rel']:.3e} of each "
        f"leaf's scale, params max abs err {held['err']:.3e}, "
        f"smallest update cosine {held['cos']:.6f} (CPU step "
        f"{held['cpu_s']:.3f}s)")
    # train_batch at the largest batch that fits
    for B in XDFM_BATCHES:
        ids = xdfm_ids(gen, cfg, B)
        lbl = torch.randint(0, 2, (B,), generator=gen, device=DEV).float()
        torch.cuda.reset_peak_memory_stats()
        try:
            secs, out = timed_steps(lambda: train.fn(params, opt, ids, lbl),
                                    GNN_TIMED)
            break
        except torch.cuda.OutOfMemoryError:
            pass
        # outside the handler, whose frames hold the step's activations
        del ids, lbl
        gc.collect()
        torch.cuda.empty_cache()
        log(f"13c: train_batch at batch {B:,} does not fit: out of memory "
            f"at a peak of {torch.cuda.max_memory_allocated() / 2**30:.3f} "
            f"GiB")
    else:
        raise AssertionError("13c: no train batch fits")
    train.check(out)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(secs[1:]))
    flops = train.model_flops * B / cells["train_batch"].batch
    profile = profiled(lambda: train.fn(params, opt, ids, lbl), 1, top=8,
                       width=56)
    log(f"13c: train_batch at batch {B:,} (the cell's "
        f"{cells['train_batch'].batch:,} cut): {1e3 * med:.3f} ms a step "
        f"(median of {GNN_TIMED}; warm-up {1e3 * secs[0]:.3f}), "
        f"{B / med:,.0f} examples/s, model FLOPs {flops:.4e}: "
        f"{flops / med / 1e12:.4f} TFLOP/s of 67; peak {peak / 2**30:.3f} "
        f"GiB; loss {float(out[2]['loss']):.6f}")
    log("13c: a train step under torch.profiler: wall "
        f"{profile['wall']:.3f}s, device busy "
        + (f"{profile['busy']:.4f} of it" if profile["busy"]
           else "not measured (the profiler saw no device time)")
        + "; by kernel, ms: "
        + "; ".join(f"{name} {ms:.3f}" for name, ms in profile["top"]))
    del ids, lbl, out, opt
    gc.collect()
    torch.cuda.empty_cache()
    # serve_p99: one call at a time
    ids = xdfm_ids(gen, cfg, cells["serve_p99"].batch)
    lat = []
    for _ in range(1 + P99_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = serve_b.fn(params, ids)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    serve_b.check(logits)
    p50, p99 = (1e3 * float(np.percentile(lat[1:], k)) for k in (50, 99))
    # serve_bulk: the cell's rows in chunks; a row's logit is its own
    rows = cells["serve_bulk"].batch
    bulk = xdfm_ids(gen, cfg, rows)

    def bulk_pass():
        return torch.cat([serve_b.fn(params, bulk[i:i + BULK_CHUNK])
                          for i in range(0, rows, BULK_CHUNK)])

    torch.cuda.reset_peak_memory_stats()
    secs, logits = timed_steps(bulk_pass, 3)
    peak_bulk = torch.cuda.max_memory_allocated()
    serve_b.check(logits)
    alone = serve_b.fn(params, bulk[:512])
    np.testing.assert_allclose(logits[:512].cpu().numpy(),
                               alone.cpu().numpy(), rtol=1e-5, atol=1e-5)
    bulk_s = float(np.median(secs[1:]))
    # retrieval_cand: a million candidates
    n = cells["retrieval_cand"].meta["n_candidates"]
    q, cands = xdfm_ids(gen, cfg, 1), xdfm_ids(gen, cfg, n)
    secs, scores = timed_steps(lambda: ret.fn(params, q, cands), 5)
    ret.check(scores)
    log(f"13c: serve_p99 (batch {ids.shape[0]}): p50 {p50:.3f} ms, p99 "
        f"{p99:.3f} ms over {P99_CALLS} calls; serve_bulk ({rows:,} rows in "
        f"chunks of {BULK_CHUNK:,}): {bulk_s:.3f}s a pass, "
        f"{rows / bulk_s:,.0f} examples/s, peak {peak_bulk / 2**30:.3f} GiB "
        f"(the first 512 rows equal a lone call's within 1e-5); "
        f"retrieval_cand ({n:,} candidates): "
        f"{1e3 * float(np.median(secs[1:])):.3f} ms (median of 5)")
    del params, bulk, logits, cands, scores
    torch.cuda.empty_cache()


def phase13d() -> None:
    """``examples/torch_gnn_train.py``'s loops (``examples/gnn_train.py``
    through the port) on the card and on the CPU from the same initial
    parameters: the losses fall as the example asserts, the card's first
    8 within rtol 1e-4 of the CPU's."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    import torch_gnn_train as TGT

    cases = (("GCN (neighbor-sampled)", TGT.train_gcn_sampled,
              lambda g: G.gcn_init(TGT.GCN_CFG, g, "cpu")),
             ("NequIP (molecules)", TGT.train_nequip,
              lambda g: G.nequip_init(TGT.NEQUIP_CFG, g, "cpu")))
    for name, loop, init in cases:
        p0 = init(torch.Generator().manual_seed(0))
        out, secs = {}, {}
        for d in (DEV, "cpu"):
            t0 = time.perf_counter()
            out[d] = np.asarray(loop(d, params=placed(p0, d)))
            secs[d] = time.perf_counter() - t0
        a = out[DEV]
        if not (np.mean(a[-5:]) < (a[0] if "GCN" in name
                                   else np.mean(a[:5]))):
            raise AssertionError(f"13d {name}: losses {a}")
        np.testing.assert_allclose(a[:LAUNCH_HELD], out["cpu"][:LAUNCH_HELD],
                                   rtol=1e-4, err_msg=f"13d {name}")
        rel = np.abs(a - out["cpu"]) / np.abs(out["cpu"])
        log(f"13d: {name}: {len(a)} steps, card {secs[DEV]:.3f}s, CPU "
            f"{secs['cpu']:.3f}s; loss {a[0]:.4f} -> mean of the last 5 "
            f"{np.mean(a[-5:]):.4f}; card vs CPU relative: first "
            f"{LAUNCH_HELD} {rel[:LAUNCH_HELD].max():.3e} (held at 1e-4), "
            f"all {rel.max():.3e}")


def gnn_mesh_problem(g, path: str) -> None:
    """Phase 13e's problem, written to ``path`` (npz): ``g``'s arcs with
    vertex ids permuted (seed 0; R-MAT's low ids are its hubs, and a 2D
    bucket of them would overflow its 1.5x budget), ``md_gnn2d_check``'s
    normalized coefficients, d_in features, labels and GCN weights at
    gcn-cora's width."""
    rng = np.random.default_rng(0)
    perm = rng.permutation(g.n)
    src, dst = perm[g.src].astype(np.int32), perm[g.dst].astype(np.int32)
    deg = np.bincount(dst, minlength=g.n).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    coef = (dinv[src] * dinv[dst]).astype(np.float32)
    h = get_arch("gcn-cora").config().d_hidden
    dims = (GNN_MESH_DIN, h, GNN_MESH_CLASSES)
    np.savez(path, n=g.n, src=src, dst=dst, coef=coef,
             x=rng.normal(size=(g.n, GNN_MESH_DIN)).astype(np.float32),
             labels=rng.integers(0, GNN_MESH_CLASSES, g.n).astype(np.int32),
             w0=(rng.normal(size=dims[:2]) / np.sqrt(dims[0])
                 ).astype(np.float32),
             w1=(rng.normal(size=dims[1:]) / np.sqrt(dims[1])
                 ).astype(np.float32))


def gnn_mesh_run(mesh, path: str) -> dict:
    """The 2D GCN on ``mesh``: loss, synced gradients, seconds a step
    (mean of ``GNN_MESH_REPEATS`` after one), bytes a step by kind, one
    forward's bytes."""
    z = np.load(path)
    n = int(z["n"])
    grid = GD.make_grid(mesh, n, z["src"].size)
    src_b, dst_b, coef_b = GD.bucket_edges(grid, z["src"], z["dst"],
                                           z["coef"])
    lay = lambda a: GD.layout_features(grid, a)  # noqa: E731
    lp = lay(z["labels"][:, None].astype(np.float32))[:, 0].astype(np.int32)
    mask = lay(np.ones((n, 1), np.float32))[:, 0] > 0
    args = GD.rank_inputs(mesh, grid, lay(z["x"]), src_b, dst_b, coef_b, lp,
                          mask)
    loss_fn = GD.build_gcn2d_loss(mesh, grid, n_layers=2)
    params = {"w": [torch.from_numpy(z[k]).to(mesh.device)
                    for k in ("w0", "w1")]}
    mesh.reset_counts()
    with torch.no_grad():
        loss_fn(params, *args)
    fwd = dict(mesh.comm_bytes)

    def step():
        loss, grads = value_and_grad(lambda p: loss_fn(p, *args), params)
        return loss, GD.sync_grads(mesh, grid, grads["w"])

    step()  # warm-up
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GNN_MESH_REPEATS):
        loss, grads = step()
    torch.cuda.synchronize()
    secs = (time.perf_counter() - t0) / GNN_MESH_REPEATS
    return {"loss": float(loss), "grads": [x.cpu().numpy() for x in grads],
            "seconds": secs, "fwd": fwd, "n_pad": grid.n_pad,
            "R": grid.R, "C": grid.C, "e_max": grid.e_max,
            "bytes": {k: v // GNN_MESH_REPEATS
                      for k, v in mesh.comm_bytes.items() if v}}


def gnn_rank(rank: int, store: str, results, payload: dict) -> None:
    """One rank of phase 13e on the shared card over gloo."""
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=MESH_RANKS,
                                timeout=datetime.timedelta(
                                    seconds=RANK_TIMEOUT_S))
        mesh = Mesh(*GNN_MESH, device="cuda")
        out = gnn_mesh_run(mesh, payload["path"])
        out["launches"] = _counts()
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def gnn_single(path: str) -> tuple:
    """``md_gnn2d_check``'s single-device GCN (messages only, no self
    loop) on the card: loss, gradients, ms a step (median of 3)."""
    z = np.load(path)
    n = int(z["n"])
    put = lambda k: torch.from_numpy(z[k]).to(DEV)  # noqa: E731
    x, coef, labels = put("x"), put("coef"), put("labels").long()
    src, dst = put("src").long(), put("dst").long()

    def loss_of(p):
        h = x
        for i, w in enumerate(p["w"]):
            h = G._seg_sum(G._gather(h @ w, src) * coef[:, None], dst, n)
            if i == 0:
                h = torch.relu(h)
        gold = torch.gather(h, 1, labels[:, None])[:, 0]
        return torch.mean(torch.logsumexp(h, dim=-1) - gold)

    params = {"w": [put("w0"), put("w1")]}
    secs, (loss, grads) = timed_steps(
        lambda: value_and_grad(loss_of, params), 3)
    return float(loss), [g.cpu().numpy() for g in grads["w"]], \
        float(np.median(secs[1:]))


def mesh_held(out: dict, want: tuple, label: str) -> None:
    loss, grads, _ = want
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5,
                               err_msg=f"{label} loss")
    for a, b in zip(out["grads"], grads):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6,
                                   err_msg=f"{label} grads")


def phase13e(g18) -> None:
    """``models.gnn_dist``: the 2D GCN at gcn-cora's width on phase 6d's
    scale-18 graph (ids permuted), on four gloo ranks sharing the card
    ((2, 2)) and on a one-rank NCCL mesh in this process, against the
    single-device GCN: loss rtol 1e-5, gradients rtol 2e-4, atol 1e-6."""
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        path = os.path.join(tmp, "gcn2d.npz")
        gnn_mesh_problem(g18, path)
        want = gnn_single(path)
        t0 = time.perf_counter()
        got = run_ranks({"path": path}, tmp, target=gnn_rank, label="13e")
        wall = time.perf_counter() - t0
        for rank, out in got.items():
            mesh_held(out, want, f"13e rank {rank}")
        r0 = got[0]
        h = sum(r0["n_pad"] * d * 4 for d in (16, GNN_MESH_CLASSES))
        log(f"13e: 2D GCN (d_in {GNN_MESH_DIN}, 16 hidden, "
            f"{GNN_MESH_CLASSES} classes) on rmat s18 (n {g18.n:,}, "
            f"{g18.m:,} arcs, ids permuted): single device "
            f"{1e3 * want[2]:.3f} ms a step, loss {want[0]:.7f}; "
            f"{MESH_RANKS} gloo ranks on one card, (2, 2), e_max "
            f"{r0['e_max']:,}: {r0['seconds']:.3f}s a step (rank 0, mean "
            f"of {GNN_MESH_REPEATS}; the world in {wall:.1f}s), every rank's "
            f"loss and gradients held; bytes a rank a step by kind "
            f"{r0['bytes']}; one forward {r0['fwd']} against |H|/R + |H|/C "
            f"= {h // r0['R'] + h // r0['C']:,} (+ 8 B of loss sums)")
        if r0["fwd"].get("gather", 0) != h // r0["C"] or \
                r0["fwd"].get("tie_sum", 0) != h // r0["R"] + 8:
            raise AssertionError(f"13e: forward bytes {r0['fwd']}")
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
        try:
            out = gnn_mesh_run(Mesh((1, 1), ("data", "model"),
                                    device="cuda"), path)
        finally:
            dist.destroy_process_group()
        mesh_held(out, want, "13e nccl 1x1")
        log(f"13e: one-rank NCCL mesh (1x1): {1e3 * out['seconds']:.3f} ms "
            f"a step, loss and gradients held")
    torch.cuda.empty_cache()


def phase13(g18) -> None:
    """Phase 13, f32 with TF32 off: it fails if a BC kernel launched."""
    gc.collect()
    torch.cuda.empty_cache()
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("13: TF32 is on; the GNN path is held in f32")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    log(f"13: {smi}; torch.backends.cuda.matmul.allow_tf32 = False; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    reset_counts()
    for name, part in (("13a", phase13a), ("13b", phase13b),
                       ("13c", phase13c), ("13d", phase13d),
                       ("13e", lambda: phase13e(g18))):
        t0 = time.perf_counter()
        part()
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase{name} in {time.perf_counter() - t0:.1f}s")
    ran = {name: w.launches for name, w in WRAPPERS.items() if w.launches}
    if ran:
        raise AssertionError(f"13: the GNN and recsys paths launched BC "
                             f"kernels: {ran}")


# -- phase 14: the paper's own architecture, the dry run, a sharded LM ------

BC64K_NB = 64  # bc_dense_64k's 16,384 sources cut to 64 (PERF.md §4)
BC64K_COLS = 128  # output columns of a relax held against its plain version
WEB_SHAPE = (4096, 16384, 16384)  # bc_web_256k's per-device product, multi
DRYRUN_CELLS = (("gemma2-27b", "decode_32k"), ("gcn-cora", "molecule"),
                ("xdeepfm", "serve_p99"), ("mfbc_paper", "bc_dense_64k"))
LM14_LAYERS, LM14_SEQ, LM14_STEPS = 2, 2048, 3
LM14_RTOL = 1e-5  # the losses; the card's runs measured them bitwise equal
LM14_PARAM_TOL = 1e-3  # |p_sharded - p_unsharded| over |p_unsharded - p_0|


def check_columns(n: int, seed: int) -> torch.Tensor:
    """``BC64K_COLS`` output columns of an (nb, k, n) product: the whole
    64-column tile (``BN``) at a seeded tile offset, then 64 columns
    ``k * 1021 % n``, which fall at every offset within their tiles."""
    tile = BN * int(torch.randint(n // BN, (1,), generator=torch.Generator(
    ).manual_seed(seed)))
    strided = torch.arange(BC64K_COLS - BN) * 1021 % n
    return torch.cat([torch.arange(tile, tile + BN), strided]).to(DEV)


def column_check(name: str, args, cols: torch.Tensor, where: str) -> float:
    """One launch of ``name`` on ``args`` against its plain version on the
    columns ``cols`` of the adjacency operand, a few at a time (the plain
    version holds an (nb, k, columns) candidate)."""
    k = KERNELS[name]
    got = k["wrapper"](*args)
    torch.cuda.synchronize()
    nb, kk = args[0].shape
    step = max(1, 2**31 // (4 * nb * kk))
    err = 0.0
    for i in range(0, len(cols), step):
        c = cols[i:i + step]
        want = k["plain"](args[0], args[1], args[2][:, c].contiguous())
        err = max(err, compare(name, [g[:, c] for g in got], want, where))
        del want
    del got
    return err


def phase14a(launches, errs: dict) -> dict:
    """mfbc_paper x bc_dense_64k on one card; returns the products' ms at
    (64, 65536, 65536) and at ``WEB_SHAPE``."""
    spec = get_arch("mfbc_paper")
    cell = spec.cells()["bc_dense_64k"]
    n, iters = cell.meta["n"], cell.meta["iters"]
    b = spec.build(cell, NO_SHARDING)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    a, src, valid = b.concrete_args(None, DEV, nb=BC64K_NB)
    torch.cuda.synchronize()
    t_a = time.perf_counter() - t0
    arcs = int(torch.isfinite(a).sum())
    log(f"14a: mfbc_paper x bc_dense_64k: n={n}, {arcs} arcs "
        f"(erdos_renyi(n, 4/n, seed=1)), A built on the card in "
        f"{t_a:.3f}s ({a.numel() * 4 / 1e9:.2f} GB); batch {BC64K_NB} of "
        f"the cell's {cell.batch} sources, {iters} iterations")
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam = b.fn(a, src, valid)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    got = tally(launches, DENSE_COUNT_PATH, "14a")
    b.check(lam)
    peak = torch.cuda.max_memory_allocated()
    log(f"14a: step {dt:.3f}s, launches {got}, peak device memory "
        f"{peak / 2**30:.2f} GiB; λ finite, min {float(lam.min()):.6g}, "
        f"max {float(lam.max()):.6g}")
    del lam
    torch.cuda.empty_cache()
    prof = profiled(lambda: b.fn(a, src, valid), 1, top=8, width=64)
    log(f"14a: the step under torch.profiler: {prof['wall']:.3f}s, busy "
        f"{prof['busy']}; top kernels (ms): "
        + "; ".join(f"{k} {v:.3f}" for k, v in prof["top"]))
    torch.cuda.empty_cache()

    adj = DenseAdj(a, block=256)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(14)
    f_w = adj.gather_rows(src.long())
    active = torch.rand((BC64K_NB, n), generator=gen, device=DEV) < 0.5
    c_w = torch.where(active, torch.randint(0, 20, (BC64K_NB, n),
                                            generator=gen,
                                            device=DEV).float(), -INF)
    args = {"multpath_mm": (f_w, torch.isfinite(f_w).float(), adj.a),
            "centpath_mm": (c_w, torch.where(active, torch.rand(
                (BC64K_NB, n), generator=gen, device=DEV), 0.0), adj.at)}
    cols = check_columns(n, 14)
    shape = (BC64K_NB, n, n)
    out = {}
    for name in KERNELS:
        errs[name] = max(errs[name], column_check(
            name, args[name], cols, f"14a {shape} ({BC64K_COLS} columns)"))
        out[name] = time_kernel(name, args[name], shape, with_plain=False)
    log(f"14a: both products match their plain versions at {shape} on "
        f"{BC64K_COLS} columns (w, c bitwise; m rtol 1e-6, p rtol 1e-5)")
    del args, f_w, c_w, active
    Tw, Tm, tr_bf = mfbf(adj, src.long(), trace=True)
    Tw[torch.arange(BC64K_NB, device=DEV), src.long()] = INF
    Tm[torch.arange(BC64K_NB, device=DEV), src.long()] = 1.0
    out["child_count"] = time_child_count(adj, Tw, "14a, MFBF's distances",
                                          plain_iters=1)
    _, tr_br = mfbr(adj, Tw, Tm, trace=True)
    log(f"14a: uncapped, MFBF runs {tr_bf.iters} iterations and MFBr "
        f"{tr_br.iters} on this graph; the cell caps both at {iters} "
        f"({'truncates' if max(tr_bf.iters, tr_br.iters) > iters else 'no truncation'})")
    del adj, Tw, Tm, a
    torch.cuda.empty_cache()

    web = {}
    for name in KERNELS:
        fw, f2, adjw = inputs("random", name, *WEB_SHAPE, gen)
        cw = check_columns(WEB_SHAPE[2], 15)
        errs[name] = max(errs[name], column_check(
            name, (fw, f2, adjw), cw,
            f"14a {WEB_SHAPE} ({BC64K_COLS} columns)"))
        web[name] = time_kernel(name, (fw, f2, adjw), WEB_SHAPE,
                                with_plain=False)
        del fw, f2, adjw
        torch.cuda.empty_cache()
    rec = perf_hillclimb.hillclimb_bc_blocks(
        {name: web[name][0] for name in KERNELS})
    for name, m in rec["kernel_tile_model"].items():
        log(f"14a: bcblock {name} at {WEB_SHAPE}: measured "
            f"{web[name][0]:.3f} ms; tile model {m['bytes'] / 1e9:.3f} GB "
            f"({1e3 * m['t_memory_s']:.3f} ms at 3.35 TB/s), "
            f"{1e3 * m['t_compute_s']:.3f} ms of instructions")
    return {"dense_64k": out, "web": web}


def phase14b() -> None:
    """One dry-run cell a family on the multi mesh, in subprocesses
    started together, then the roofline over their records."""
    out = os.path.join(ROOT, "build", "dryrun_smoke")
    if os.path.isdir(out):
        for f in os.listdir(out):
            os.remove(os.path.join(out, f))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.perf_counter()
    procs = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "multi", "--out", out],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)) for cell in DRYRUN_CELLS]
    for cell, proc in procs:
        try:
            so, se = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
        if proc.returncode != 0:
            raise AssertionError(f"14b: dry run of {cell} failed "
                                 f"(rc {proc.returncode}): {se[-3000:]}")
        for line in so.strip().splitlines():
            if line.startswith("[dryrun]"):
                log(f"14b: {line}")
    rows = roofline.main(["--dryrun", out, "--out",
                          out + "_roofline.md", "--json-out",
                          out + "_roofline.json"])
    recs = {(r["arch"], r["shape"]): r for r in roofline.load_all(out)}
    if len(rows) != len(DRYRUN_CELLS):
        raise AssertionError(f"14b: {len(rows)} roofline rows, expected "
                             f"{len(DRYRUN_CELLS)}")
    for r in rows:
        rec = recs[(r["arch"], r["shape"])]
        if not rec["flops_per_device"] >= 0 or rec["n_devices"] != 512:
            raise AssertionError(f"14b: bad record {rec}")
        log(f"14b: {r['arch']} x {r['shape']} x multi: peak/dev "
            f"{rec['memory']['peak_bytes']} B, flops/dev "
            f"{rec['flops_per_device']:.6g}, wire/dev "
            f"{rec['collectives']['wire_bytes']:.6g} B; roofline "
            f"{r['dominant']}, step ≥ {r['t_step_s']:.6g} s")
    log(f"14b: {len(rows)} cells in {time.perf_counter() - t0:.1f}s")


def _param_leaves(tree) -> list:
    """The parameter tree's leaves as plain tensors (a one-rank mesh's
    DTensor holds the whole tensor)."""
    return [t.full_tensor() if hasattr(t, "full_tensor") else t
            for _, t in sorted(tree_lib.leaves(tree), key=lambda pt: pt[0])]


def _norm(pairs) -> float:
    """The norm of the differences of the pairs of tensors."""
    return float(sum(float(((a.float() - b.float()) ** 2).sum())
                     for a, b in pairs)) ** 0.5


def phase14c() -> None:
    """The sharded LM train step on a one-rank NCCL mesh against the same
    step without a mesh: the losses, and the parameters after the last
    step."""
    spec = get_arch(TRAIN_ARCH)
    cell = spec.cells()["train_4k"]
    toks = None
    losses, final, update = {}, None, {}
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"),
                                device_type="cuda")
        for label, policy in (("sharded", make_policy(mesh)),
                              ("unsharded", NO_SHARDING)):
            cfg = dataclasses.replace(spec.config(), n_layers=LM14_LAYERS,
                                      dtype=torch.bfloat16)
            gen = torch.Generator(device=DEV)
            gen.manual_seed(0)
            tree = T.init_tree(cfg, gen, DEV)
            if toks is None:
                toks = torch.randint(0, cfg.vocab, (1, LM14_SEQ),
                                     generator=gen, device=DEV)
            if policy.mesh is not None:  # the train cell's own step
                tree = T.place_params(cfg, tree, policy)
                fn = spec.build(cell, policy,
                                layers_override=LM14_LAYERS).fn
            else:
                opt_cfg = adamw.AdamWConfig(moment_dtype="int8")

                def fn(params, state, x, y):
                    loss, grads = value_and_grad(
                        lambda p: T.loss_fn((cfg, p), x, y, chunks=8),
                        params)
                    params, state, m = adamw.update(opt_cfg, grads, state,
                                                    params)
                    return params, state, {"loss": loss, **m}
            state = adamw.init_state(tree, "int8")
            start = [t.detach().clone() for t in _param_leaves(tree)]
            got = []
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(LM14_STEPS):
                tree, state, m = fn(tree, state, toks, toks)
                got.append(float(m["loss"]))
            torch.cuda.synchronize()
            losses[label] = got
            log(f"14c: gemma2-27b, {LM14_LAYERS} layers, bf16, "
                f"{LM14_SEQ} tokens, {label}: losses {got} in "
                f"{time.perf_counter() - t0:.3f}s")
            end = _param_leaves(tree)
            update[label] = _norm(zip(end, start))
            if final is None:
                final = [t.detach().clone() for t in end]
            else:
                diff = _norm(zip(final, end))
            del tree, state, fn, start, end
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    del final
    np.testing.assert_allclose(losses["sharded"], losses["unsharded"],
                               rtol=LM14_RTOL)
    for x in losses["sharded"]:
        if not np.isfinite(x):
            raise AssertionError("14c: non-finite loss")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["sharded"],
                                                  losses["unsharded"]))
    if not (update["sharded"] > 0 and update["unsharded"] > 0
            and diff <= LM14_PARAM_TOL * update["unsharded"]):
        raise AssertionError(f"14c: parameters after step {LM14_STEPS}: "
                             f"|sharded - unsharded| {diff:.6g}, updates "
                             f"{update}")
    log(f"14c: the one-rank (1, 1, 1) mesh step holds the unsharded "
        f"step's losses, max relative difference {rel:.3g} "
        f"(rtol {LM14_RTOL}); parameters after step {LM14_STEPS}: "
        f"|sharded - unsharded| {diff:.6g} against updates "
        f"{update['sharded']:.6g} / {update['unsharded']:.6g} "
        f"(tolerance {LM14_PARAM_TOL} of the update)")


def phase14(launches, errs: dict) -> dict:
    t = time.perf_counter()
    times = phase14a(launches, errs)
    log(f"14a in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase14b()
    log(f"14b in {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    phase14c()
    log(f"14c in {time.perf_counter() - t:.1f}s")
    return times


def graph(scale: int):
    g, _ = rmat(scale, 16, seed=0, weighted=True, max_weight=100
                ).remove_isolated()
    return g


def main() -> None:
    t_start = time.perf_counter()
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[smoke] nvidia-smi: {smi}", flush=True)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")

    # 1. build
    t0 = time.perf_counter()
    build_logs = _build.build_all()
    log(f"build: {time.perf_counter() - t0:.2f}s "
        f"({', '.join(build_logs) or 'cached'})")
    for name, out in build_logs.items():
        for line in out.strip().splitlines():
            log(f"nvcc {name}: {line}")

    # 2. kernels against their plain versions
    g12 = graph(12)
    n12 = g12.n
    gen = torch.Generator(device=DEV)
    gen.manual_seed(0)
    errs = {name: 0.0 for name in KERNELS}
    for nb, n, n2 in SWEEP + [(64, n12, n12)]:  # n12 = 3342
        for kind_in in ("empty", "ties", "random"):
            for name, k in KERNELS.items():
                fw, f2, adj = inputs(kind_in, name, nb, n, n2, gen)
                got = k["wrapper"](fw, f2, adj)
                torch.cuda.synchronize()
                want = k["plain"](fw, f2, adj)
                errs[name] = max(errs[name], compare(
                    name, got, want, f"{kind_in} {(nb, n, n2)}"))
                del fw, f2, adj, got, want
        log(f"kernels match plain at {(nb, n, n2)} (empty, ties, random)")
    torch.cuda.empty_cache()

    # timing at the main path's shapes: the scale-12 adjacency and a real
    # first frontier (sources 0..63) for multpath; Aᵀ and a random centpath
    # frontier for centpath. Each product reads A from L2, as in the loop.
    adj12 = dense_adj_from_graph(g12, device=DEV)
    src = torch.arange(64, device=DEV)
    f_w = adj12.gather_rows(src)
    f_m = torch.isfinite(f_w).float()
    active = torch.rand((64, n12), generator=gen, device=DEV) < 0.5
    c_w = torch.where(active, torch.randint(0, 20, (64, n12), generator=gen,
                                            device=DEV).float(), -INF)
    c_p = torch.where(active, torch.rand((64, n12), generator=gen,
                                         device=DEV), 0.0)
    args = {"multpath_mm": (f_w, f_m, adj12.a),
            "centpath_mm": (c_w, c_p, adj12.at)}
    for name, k in KERNELS.items():  # split-K folds in order: repeatable
        first = k["wrapper"](*args[name])
        second = k["wrapper"](*args[name])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, second)):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ")
        del first, second
    log(f"kernels bitwise repeatable at (64, {n12}, {n12})")
    timing = {name: time_kernel(name, args[name], (64, n12, n12))
              for name in KERNELS}
    for name in KERNELS:  # a square reference shape
        fw, f2, adj = inputs("random", name, 64, 4096, 4096, gen)
        time_kernel(name, (fw, f2, adj), (64, 4096, 4096))
        del fw, f2, adj
    Tw12, _ = mfbc_batch(adj12, src, torch.ones(64, dtype=torch.bool,
                                                 device=DEV))[1:]
    time_child_count(adj12, Tw12, "s12", plain_iters=10)
    del args, f_w, f_m, c_w, c_p, Tw12
    torch.cuda.empty_cache()

    # 3. main path: exact BC at scale 12 through the kernels
    log(f"main path: rmat scale 12 weighted: n={g12.n} m={g12.m}")
    batch0 = {}

    def progress(b, n_batches, lam):
        if b == 0:
            batch0["lam"] = lam.copy()

    launches = {name: 0 for name in WRAPPERS}
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam = mfbc(g12, n_b=64, device="cuda", progress_cb=progress)
    dt = time.perf_counter() - t0
    phase = tally(launches, DENSE_COUNT_PATH, "the scale-12 main path")
    n_batches = -(-g12.n // 64)
    log(f"main path: {n_batches} batches in {dt:.3f}s, "
        f"{g12.m * g12.n / dt:,.0f} TEPS (model), launches {phase}")
    if lam.shape != (g12.n,) or not np.all(np.isfinite(lam)):
        raise AssertionError("λ is not finite of shape (n,)")
    t0 = time.perf_counter()
    lam_ref = brandes_bc(g12, sources=np.arange(64))
    log(f"oracle: 64 sources in {time.perf_counter() - t0:.1f}s (CPU)")
    np.testing.assert_allclose(batch0["lam"], lam_ref, rtol=1e-5, atol=1e-8)
    log("main path: λ over sources 0..63 matches brandes_bc "
        "(rtol 1e-5, atol 1e-8)")
    plain = PlainDenseAdj(adj12.a, adj12.at, adj12.block)
    lam_plain = mfbc_batch(plain, src, torch.ones(64, dtype=torch.bool,
                                                  device=DEV))[0]
    np.testing.assert_allclose(batch0["lam"],
                               lam_plain.cpu().numpy().astype(np.float64),
                               rtol=1e-5, atol=1e-8)
    log("main path: batch 0 λ_partial matches the plain versions on the card")
    del adj12, plain, lam_plain
    torch.cuda.empty_cache()

    # 4. one 64-source batch at scale 14
    g14 = graph(14)
    log(f"scale 14: rmat weighted: n={g14.n} m={g14.m}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    adj14 = dense_adj_from_graph(g14, device=DEV)
    torch.cuda.synchronize()
    t_adj = time.perf_counter() - t0
    valid = torch.zeros(64, dtype=torch.bool, device=DEV)
    valid[:8] = True  # all 64 sources run; λ keeps the first 8
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lam8, Tw14, _ = mfbc_batch(adj14, src, valid)
    lam8 = lam8.cpu().numpy().astype(np.float64)
    dt14 = time.perf_counter() - t0
    launches14 = tally(launches, DENSE_COUNT_PATH, "the scale-14 batch")
    peak = torch.cuda.max_memory_allocated()
    log(f"scale 14: adjacency upload {t_adj:.3f}s, one 64-source batch "
        f"{dt14:.3f}s, launches {launches14}, peak device memory "
        f"{peak / 2**30:.2f} GiB")
    t0 = time.perf_counter()
    ref8 = brandes_bc(g14, sources=np.arange(8))
    log(f"oracle: 8 sources in {time.perf_counter() - t0:.1f}s (CPU)")
    np.testing.assert_allclose(lam8, ref8, rtol=1e-5, atol=1e-8)
    log("scale 14: λ over sources 0..7 matches brandes_bc")

    # each kernel alone at scale 14's shape: A (0.63 GB) exceeds the L2
    n14 = g14.n
    f_w = adj14.gather_rows(src)
    c_w = torch.where(torch.rand((64, n14), generator=gen, device=DEV) < 0.5,
                      torch.randint(0, 20, (64, n14), generator=gen,
                                    device=DEV).float(), -INF)
    args14 = {"multpath_mm": (f_w, torch.isfinite(f_w).float(), adj14.a),
              "centpath_mm": (c_w, torch.isfinite(c_w).float(), adj14.at)}
    for name in KERNELS:
        time_kernel(name, args14[name], (64, n14, n14), with_plain=False)
    time_child_count(adj14, Tw14, "s14", plain_iters=3)
    del adj14, f_w, c_w, args14, Tw14
    torch.cuda.empty_cache()

    # 5. the sampled path through solve, at scale 12 and 14
    runs = {12: (g12, lam), 14: (g14, None)}
    for scale, (g, lam_exact) in runs.items():
        label = f"sampled s{scale}"
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        torch.cuda.synchronize()
        out = sampled_path(g, label, DEV)
        phase = tally(launches, DENSE_PATH, label)
        peak = torch.cuda.max_memory_allocated()
        a = out["res"]
        log(f"{label}: n={g.n} m={g.m}: {a.n_samples} samples, "
            f"{a.n_epochs} epochs, converged={a.converged}, "
            f"{out['seconds']:.3f}s in the epochs ({out['wall_s']:.3f}s "
            f"with planning and upload), {out['teps']:,.0f} TEPS (model), "
            f"launches {phase}, peak device memory {peak / 2**30:.2f} GiB")
        if lam_exact is not None:  # 5a: against phase 3's exact λ
            err = float(np.abs(a.lam - lam_exact).max()) / (g.n * (g.n - 2))
            top = set(np.argsort(lam_exact)[::-1][:10].tolist())
            prec = len(top & set(a.topk(10).tolist())) / 10
            log(f"{label}: max|λ̂ − λ| / (n(n−2)) = {err:.5f} (eps 0.05), "
                f"top-10 precision {prec:.1f}")
            if err > 0.05:
                raise AssertionError(f"{label}: error {err} exceeds eps")
    for scale, (g, _) in runs.items():
        for n_b, lens in ((64, (5, 20, 39)), (128, (5, 20, 39, 40))):
            label = f"fused s{scale} n_b={n_b}"
            ex = build_executor(g, plan(g, approx_query(n_b), device=DEV),
                                device=DEV)
            if scale == 14 and n_b == 64:
                first_batch_check(ex, g, f"sampled s{scale}")
            fused_check(ex, g, lens, label)
            if n_b == 128:
                own_split_drift(ex, g, label)
            del ex
            torch.cuda.empty_cache()
    x = torch.rand((64, 3, n14), generator=gen, device=DEV)
    for n_slots in (1, 3):
        sid = np.sort(np.arange(64) % n_slots).astype(np.int32)
        ms = time_ms(lambda: segment_fold(x, sid, n_slots), iters=10)
        log(f"time segment_fold (64 rows, {n_slots} slot(s), 3 x {n14}): "
            f"{ms:.4f} ms")

    del x
    torch.cuda.empty_cache()

    # 6. the COO and CSR backends
    relax_err = phase6a()
    phase6b(g12, g14)
    del g14
    torch.cuda.empty_cache()

    phase6c(g12, lam, launches)
    g18, relax_times = phase6d(launches, 18)
    phase6e(g18, 14)

    # 7. the metric registry
    t7 = time.perf_counter()
    phase7a(g12, launches)
    phase7b(g12)
    cc18 = phase7c(g18, launches)
    phase7d(launches)
    log(f"phase 7 in {time.perf_counter() - t7:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 8. serving through the HTTP gateway
    t8 = time.perf_counter()
    served_8a = phase8a(launches)
    svc18, served_8b = phase8b(g18, cc18, launches)
    served_8c = phase8c(svc18, launches)
    log(f"phase 8 in {time.perf_counter() - t8:.1f}s, launches 8a "
        f"{served_8a}, 8b {served_8b}, 8c {served_8c}; the script in "
        f"{time.perf_counter() - t_start:.1f}s")
    del svc18
    torch.cuda.empty_cache()

    # 9. the distributed step
    t9 = time.perf_counter()
    phase9a(gen, errs)
    phase9b(g12, lam, launches)
    phase9c(launches)
    log(f"phase 9 in {time.perf_counter() - t9:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 10. a resumable run
    t10 = time.perf_counter()
    phase10(lam, launches)
    log(f"phase 10 in {time.perf_counter() - t10:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 11. LM serving
    t11 = time.perf_counter()
    torch.cuda.empty_cache()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    log(f"11: torch.backends.cuda.matmul.allow_tf32 = {tf32}, float32 "
        f"matmul precision {torch.get_float32_matmul_precision()!r}; "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB allocated")
    if tf32:
        raise AssertionError("11: TF32 is on; the LM path is held in f32")
    reset_counts()
    phase11a()
    torch.cuda.empty_cache()
    phase11b()
    torch.cuda.empty_cache()
    phase11c()
    ran = {name: w.launches for name, w in WRAPPERS.items() if w.launches}
    if ran:
        raise AssertionError(f"11: the LM path launched BC kernels: {ran}")
    log(f"phase 11 in {time.perf_counter() - t11:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 12. LM training
    t12 = time.perf_counter()
    phase12()
    log(f"phase 12 in {time.perf_counter() - t12:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 13. the GNN and recsys families
    t13 = time.perf_counter()
    phase13(g18)
    log(f"phase 13 in {time.perf_counter() - t13:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    # 14. the paper's own architecture, the dry run, a sharded LM step
    t14 = time.perf_counter()
    times14 = phase14(launches, errs)
    log(f"phase 14 in {time.perf_counter() - t14:.1f}s; the script in "
        f"{time.perf_counter() - t_start:.1f}s")

    rows = [{"name": name, "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": launches[name],
             "max_abs_err": errs[name], "ms": timing[name][0],
             "plain_ms": timing[name][1], "bound_ms": timing[name][2],
             "bound_by": timing[name][3], "library_ms": None}
            for name, k in KERNELS.items()]
    rows.append({"name": "segment_relax", "route": "cuda",
                 "source": SEGMENT_RELAX["source"],
                 "replaces": SEGMENT_RELAX["replaces"],
                 "launches": launches["segment_relax"],
                 "max_abs_err": max(relax_err, relax_times["err"]),
                 **{k: relax_times[k] for k in (
                     "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                     "library_parts_ms")}})
    cc_ms, cc_plain, cc_bound, cc_by = times14["dense_64k"]["child_count"]
    rows.append({"name": "child_count", "route": "cuda",
                 "source": CHILD_COUNT["source"],
                 "replaces": CHILD_COUNT["replaces"],
                 "launches": launches["child_count"], "max_abs_err": 0,
                 "ms": cc_ms, "plain_ms": cc_plain, "bound_ms": cc_bound,
                 "bound_by": cc_by, "library_ms": None})
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
