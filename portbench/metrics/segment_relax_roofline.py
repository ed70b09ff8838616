"""segment_relax_roofline (%): the sparse relax (``segment_relax.cu``,
prep and main kernels) against its bound: the least seconds of each relax
in the window (``common/relax_bound.py``, from the live arcs, rows and
columns of the program's ``csr.relax`` spans, ``repro_torch.tracing``),
summed, over the device seconds the trace gives the file's kernels.
Nothing unless the window's ``csr.relax`` spans number exactly the
kernel's launches in it."""
from portbench.metrics.common import kernels
from portbench.metrics.common.relax_bound import relax_bound_s


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    launches = ctx.launches.get("segment_relax", 0)
    if ctx.trace is None or not launches:
        return None
    relaxes = [s.attrs
               for s in tracing.snapshot(clear=False).named("csr.relax")]
    if len(relaxes) != launches:
        return None
    t = ctx.trace.seconds(kernels.of_kernel("segment_relax"))
    if t <= 0:
        return None
    bound = sum(relax_bound_s(a["rows"], a["n"], a["live_arcs"], a["cols"],
                              a["outputs"]) for a in relaxes)
    return 100.0 * bound / t
