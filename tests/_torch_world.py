"""Multi-rank harness of the port's distributed tests (not collected).

``run_world`` spawns a gloo world of CPU ranks, each running a module-level
``target(rank, store, results)`` of a test module; ``run_reference`` runs
a script of the reference package in a subprocess with 8 host devices.
Both keep jax out of the spawned ranks: they import only the test module
and the port.
"""
import json
import multiprocessing
import os
import queue
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300


def run_world(target, world: int, args=(), timeout: float = TIMEOUT_S
              ) -> dict:
    """Spawn ``world`` ranks running ``target(rank, store, results,
    *args)`` (``store``: a file path for ``init_method="file://..."``;
    each rank puts one ``(rank, result)`` on ``results``, a traceback
    string when it failed). Returns {rank: result}, or fails with the
    first traceback."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        procs = [ctx.Process(target=target,
                             args=(r, os.path.join(tmp, "store"), results,
                                   *args))
                 for r in range(world)]
        for p in procs:
            p.start()
        got = {}
        try:
            while len(got) < world:
                rank, out = results.get(timeout=timeout)
                if isinstance(out, str):
                    pytest.fail(f"rank {rank} failed:\n{out}")
                got[rank] = out
        except queue.Empty:
            pytest.fail(f"the {world}-rank world timed out after {timeout}s; "
                        f"{len(got)} ranks answered")
        finally:
            for p in procs:
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    return got


def run_reference(script: str, spec: dict):
    """Start ``script`` (reads ``json.loads(sys.argv[1])``) on the
    reference package with 8 host devices; finish with
    ``finish_reference``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    return subprocess.Popen([sys.executable, "-c", script, json.dumps(spec)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish_reference(proc) -> None:
    out, _ = proc.communicate(timeout=TIMEOUT_S)
    assert proc.returncode == 0, out
