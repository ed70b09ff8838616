"""The least seconds one sparse relax takes: ``chip_smoke.py::relax_bound``'s
arithmetic, with F counted over the columns the relax reads.

The bytes that must cross DRAM are col (8 B) and w (4 B) of each live arc,
the offsets (8 B each of n + 1), F's two fields (8 B a row) over the
``cols`` columns the relax reads, and each (rows, n) output field (4 B
an entry); the instructions, 5 per (row, live arc). The larger of the two
at the card's peaks bounds it. With ``cols = n`` this is
``chip_smoke.py::relax_bound``; counting F over the columns read keeps it a
lower bound on small frontiers whatever kernel implements the relax.
"""
from __future__ import annotations

from portbench.metrics.common.bounds import (PEAK_BYTES_PER_S,
                                             PEAK_INSTR_PER_S)


def relax_bound_s(rows: int, n: int, live_arcs: int, cols: int,
                  outputs: int) -> float:
    """Least seconds of one relax of ``rows`` frontier rows over
    ``live_arcs`` arcs leaving ``cols`` columns, writing ``outputs``
    fields."""
    nbytes = (12.0 * live_arcs + 8.0 * (n + 1) + 8.0 * rows * cols
              + 4.0 * rows * n * outputs)
    instr = 5.0 * rows * live_arcs
    return max(nbytes / PEAK_BYTES_PER_S, instr / PEAK_INSTR_PER_S)
