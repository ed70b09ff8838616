"""mesh_products_live_roofline (%): rank 0's local products
(``multpath_mm.cu`` and ``centpath_mm.cu``, main and fold kernels)
against their bound over the k they walk: each ``mesh.relax`` span's
product (``repro_torch.core.dist_bc``) bounded at its rows and cols and
at its k times its kind's live share in the window (Σ
``products.k_live.<kernel>`` over Σ the kind's span k;
``common/live_bound.py``), summed, over the device seconds the trace
gives both files' kernels. ``mesh_products_roofline`` bounds the same
time over all of each span's k. Nothing unless the spans of each kind
number that kernel's launches on rank 0 and their k sum to
``products.k``, nor where the program counts no live k."""
from portbench.metrics.common import bounds, kernels, live_bound

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
    if snap.counters.get("products.k") != sum(a["k"] for a in relaxes):
        return None
    share = {}
    for kind, name in KERNEL.items():
        k = sum(a["k"] for a in relaxes if a["kind"] == kind)
        live = live_bound.live_k(snap, name)
        if k and live is None:
            return None
        share[kind] = live / k if k else 0.0
    t = sum(ctx.trace.seconds(kernels.of_kernel(name))
            for name in KERNEL.values())
    if t <= 0:
        return None
    bound = sum(bounds.product_bound_s(KERNEL[a["kind"]], a["rows"],
                                       a["k"] * share[a["kind"]], a["cols"])
                for a in relaxes)
    return 100.0 * bound / t
