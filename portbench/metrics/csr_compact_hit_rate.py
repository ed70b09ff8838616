"""csr_compact_hit_rate (ratio): the share of the CSR adjacency's relaxes
in the window served by a compacted frontier rather than the whole arc
list (``SingleHostExecutor.occupancy_summary()``: compact hits over relax
calls)."""


def read(ctx):
    occ = ctx.occupancy
    if not occ or not occ.get("relax_calls"):
        return None
    return occ["compact_hits"] / occ["relax_calls"]
