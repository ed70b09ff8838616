"""The least seconds one dense SP-DAG child count takes:
``chip_smoke.py::child_count_bound``'s arithmetic.

The count c0(s, v) = #{u : Tw(s,v) + A(v,u) == Tw(s,u), finite} of a
(rows, n) batch has a product's shape, (rows, n) x (n, n): each candidate
cell takes at least an add and a compare, neither with a tensor-core form,
so 2·rows·n·n instructions at the card's issue rate. Against it the bytes:
Tw read as the counted rows and as the candidates' targets (2·rows·n
floats), A once (n·n) and the int32 counts written once (rows·n), at the
memory peak. The larger of the two bounds a dense scan, whatever
implements it.
"""
from __future__ import annotations

from portbench.metrics.common.bounds import (PEAK_BYTES_PER_S,
                                             PEAK_INSTR_PER_S)


def child_count_bound_s(rows: int, n: int) -> float:
    """Least seconds of one dense child count of ``rows`` sources over an
    n-vertex adjacency."""
    instr = 2.0 * rows * n * n
    nbytes = 4.0 * (2 * rows * n + n * n + rows * n)
    return max(instr / PEAK_INSTR_PER_S, nbytes / PEAK_BYTES_PER_S)
