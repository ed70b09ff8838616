"""BC gateway launcher: serve registered graphs over HTTP.

  PYTHONPATH=src python -m repro_torch.launch.bc_serve \
      --graph rmat:10:8 --graph uniform:8:4 [--port 8080] [--device cuda|cpu] \
      [--horizon 5.0] [--overload reject|degrade] [--degrade-eps 0.2] \
      [--slots 4] [--no-cache-refine] [--run-for SECONDS]

Each ``--graph kind:scale:degree`` spec is generated, registered with a
checkpointing ``BCService`` on ``--device`` (the card by default; ``cpu``
runs the kernels' plain PyTorch versions), and served by
``repro_torch.serve.BCGateway`` on ``--port`` (0 picks an ephemeral port,
printed on startup). Before the listener starts, every graph's executor
is built and run once on the main thread, which builds and loads the
kernels of its path, so no request pays for them; that warm-up time is
printed. Ctrl-C shuts down
cleanly. Try it::

  curl -s localhost:8080/v1/graphs
  curl -s -XPOST localhost:8080/v1/bc \
      -d '{"graph": "rmat:10:8", "eps": 0.1, "priority": "interactive"}'
  curl -s localhost:8080/v1/bc/0
  curl -s localhost:8080/v1/metrics
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.graphs.generators import from_spec
from repro_torch.serve import (BCGateway, BCService, GatewayConfig,
                               start_gateway)


def _parse_graph(spec: str):
    kind, scale, degree = (spec.split(":") + ["8"])[:3]
    return spec, from_spec(kind, scale=int(scale), degree=float(degree))


def _warm(service: BCService) -> float:
    """Build every graph's executor and run one source through it (the
    kernels of its path build and load on that first launch); returns the
    seconds it took."""
    t0 = time.perf_counter()
    for name in service.graphs:
        service.executor_for(name).step(np.zeros(1, np.int32),
                                        np.ones(1, bool))
    return time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", action="append", default=None,
                    help="kind:scale[:degree], repeatable "
                         "(default rmat:8:8)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--horizon", type=float, default=5.0,
                    help="admission horizon in predicted seconds")
    ap.add_argument("--overload", choices=("reject", "degrade"),
                    default="reject")
    ap.add_argument("--degrade-eps", type=float, default=0.2)
    ap.add_argument("--cache-entries", type=int, default=256)
    ap.add_argument("--no-cache-refine", action="store_true",
                    help="treat looser-ε cache entries as misses")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--run-for", type=float, default=None,
                    help="serve for N seconds then exit (tests/demos)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[bc_serve] {e}")

    graphs = dict(_parse_graph(s) for s in (args.graph or ["rmat:8:8"]))
    service = BCService(graphs, n_slots=args.slots, checkpoints=True,
                        device=args.device)
    warm_s = _warm(service)
    print(f"  executors built and warmed on {args.device} in {warm_s:.3f}s")
    gateway = BCGateway(service, GatewayConfig(
        horizon_s=args.horizon, overload=args.overload,
        degrade_eps=args.degrade_eps, cache_entries=args.cache_entries,
        refine=not args.no_cache_refine))
    server = start_gateway(gateway, host=args.host, port=args.port)
    for name, g in graphs.items():
        print(f"  graph {name}: n={g.n} m={g.m} "
              f"digest={service.digest(name)[:12]} "
              f"plan={service.plan_for(name).summary()}")
    print(f"bc gateway listening on {server.url} "
          f"(horizon={args.horizon}s overload={args.overload})", flush=True)
    try:
        if args.run_for is not None:
            time.sleep(args.run_for)
        else:
            while True:
                time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        print("gateway closed")


if __name__ == "__main__":
    main()
