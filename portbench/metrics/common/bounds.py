"""The table of peaks and the kernels' operations and bytes: a frozen copy
of ``chip_smoke.py::bound``.

A min-plus (multpath) or max-minus (centpath) cell on float32 takes at
least two instructions, an add and a min or max: neither has a
tensor-core form, and Hopper's fused add-min (DPX) takes integers only.
So the floor of one (nb, n) x (n, n2) product is 2·nb·n·n2 instructions
at the card's issue rate, against each input read once and each output
written once at the memory peak; the larger of the two bounds it.
"""
from __future__ import annotations

# H100 SXM: instruction issue outside the tensor cores (132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz boost) and the HBM3 data-sheet rate.
PEAK_INSTR_PER_S = 33.5e12
PEAK_BYTES_PER_S = 3.35e12

# Output fields of each product: multpath (w, m), centpath (w, p, c).
N_OUT = {"multpath_mm": 2, "centpath_mm": 3}


def product_bound_s(kernel: str, nb: int, n: int, n2: int) -> float:
    """Least seconds one (nb, n) x (n, n2) product of ``kernel`` takes."""
    instr = 2.0 * nb * n * n2
    nbytes = 4.0 * (2 * nb * n + n * n2 + N_OUT[kernel] * nb * n2)
    return max(instr / PEAK_INSTR_PER_S, nbytes / PEAK_BYTES_PER_S)

