#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` runs the same window under ``torch.profiler`` and
prints its per-layer metrics and the trace's ``breakdown``. The last line
of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and last
``checks``: each compared number beside its limit); everything else goes
to standard error. Exits non-zero with no result when the cell's cards
are missing, or when ``jax``, ``jaxlib``, ``flax`` or ``repro`` (the JAX
package) is loaded once the window has closed.

``--device cpu`` is for the harness's CPU tests only: it skips the look
for a card and runs the program's plain versions.
"""
import time

T_START = time.perf_counter()  # the process's start, for setup_s

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    # Any kernel cache lives at a fixed path inside the checkout (the
    # port's own nvcc builds go to build/repro_torch_kernels/).
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        ROOT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness.main import run_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    a = ap.parse_args(argv)
    return run_cell(a.workload, seed=a.seed, seconds=a.seconds,
                    traced=bool(a.trace), device=a.device, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
