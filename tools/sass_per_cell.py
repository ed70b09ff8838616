#!/usr/bin/env python3
"""Instructions issued per candidate cell in each kernel's hot loop.

    python3 tools/sass_per_cell.py [--cells N] build/repro_torch_kernels/*.so
    python3 tools/sass_per_cell.py [--cells N] dump.sass  # `cuobjdump -sass`

A ``.so`` is disassembled with ``cuobjdump -sass`` (from the CUDA
toolkit); any other path is read as such a dump. For each function of the
dump the script takes the innermost loop (a backward branch and its
target) that holds the most ``FMNMX`` instructions. Each candidate cell of
a min-plus or max-minus product takes exactly one ``FMNMX`` (the min or
max of the relaxation), so the loop's instruction count over its
``FMNMX`` count is what one cell costs in issue slots, with the shared
loads, copies, barriers and loop control of that loop included. A kernel
that also takes a min or max per tile and cell (the two-pass update of
``repro_torch``'s kernels) has more ``FMNMX`` than cells: ``--cells N``
gives the cells of one loop iteration instead (TM·TN·BK = 256 there).
Prints one line per function: the loop's size, cells, instructions per
cell and its opcode mix per cell.
"""
from __future__ import annotations

import collections
import os
import re
import shutil
import subprocess
import sys

_FUNC = re.compile(r"^\s*Function : (\S+)")
_INSN = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*([^;]*);")


def read_dump(path: str) -> str:
    if not path.endswith(".so"):
        with open(path) as f:
            return f.read()
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    tool = shutil.which("cuobjdump") or os.path.join(cuda_home, "bin",
                                                      "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def functions(text: str) -> dict:
    """{mangled name: [(address, opcode, operands), ...]}."""
    out: dict = {}
    cur = None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSN.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def hot_loop(insns):
    """(instructions, FMNMX count, opcode Counter) of the innermost loop
    with the most FMNMX, or None when no loop holds one."""
    best = None
    for addr, op, args in insns:
        if not op.startswith("BRA"):
            continue
        t = re.search(r"0x([0-9a-f]+)", args)
        if not t or int(t.group(1), 16) > addr:
            continue
        lo = int(t.group(1), 16)
        body = [o for a, o, _ in insns if lo <= a <= addr
                and not o.startswith("NOP")]
        cells = sum(o.startswith("FMNMX") for o in body)
        key = (cells, -len(body))
        if cells and (best is None or key > best[0]):
            best = (key, body)
    if best is None:
        return None
    body = best[1]
    return len(body), best[0][0], collections.Counter(
        o.split(".")[0] for o in body)


def main(argv) -> None:
    cells_arg = None
    if argv[:1] == ["--cells"]:
        cells_arg, argv = int(argv[1]), argv[2:]
    for path in argv:
        for name, insns in functions(read_dump(path)).items():
            loop = hot_loop(insns)
            if loop is None:
                continue
            n, cells, mix = loop
            if cells_arg is not None and cells > cells_arg:
                cells = cells_arg
            per = ", ".join(f"{op} {c / cells:.3f}"
                            for op, c in mix.most_common())
            print(f"{os.path.basename(path)} {name}: loop of {n} "
                  f"instructions, {cells} cells, {n / cells:.3f} per cell "
                  f"({per})")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    main(sys.argv[1:])
