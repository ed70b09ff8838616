"""mesh_products_roofline (%): rank 0's local products (``multpath_mm.cu``
and ``centpath_mm.cu``, main and fold kernels) against their bound: the
least seconds of each product in the window (``common/bounds.py``, at the
rows, k and cols of the program's ``mesh.relax`` spans,
``repro_torch.core.dist_bc``), summed, over the device seconds the trace
gives both files' kernels. Nothing unless the spans of each kind number
exactly that kernel's launches on rank 0 in the window, nor where the
trace has no time in them (the CPU)."""
from portbench.metrics.common import bounds, kernels

KERNEL = {"mp": "multpath_mm", "cp": "centpath_mm"}


def read(ctx):
    snap = getattr(ctx, "snapshot", None)
    if snap is None or ctx.trace is None:
        return None
    relaxes = [s.attrs for s in snap.named("mesh.relax")]
    if not relaxes or any(
            sum(a["kind"] == kind for a in relaxes)
            != ctx.launches.get(name, 0) for kind, name in KERNEL.items()):
        return None
    t = sum(ctx.trace.seconds(kernels.of_kernel(name))
            for name in KERNEL.values())
    if t <= 0:
        return None
    bound = sum(bounds.product_bound_s(KERNEL[a["kind"]], a["rows"], a["k"],
                                       a["cols"]) for a in relaxes)
    return 100.0 * bound / t
