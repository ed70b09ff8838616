"""comm_bytes_per_batch (MB): the bytes rank 0 hands the mesh's collectives
per call: the program's ``comm_bytes.<kind>`` counters
(``repro_torch.launch.mesh``, each growing with its kind of
``Mesh.comm_bytes``) over rank 0's traced window, summed, over its calls,
in units of 1e6 bytes. Nothing where the run has no mesh, or the program
no such counters."""


def read(ctx):
    snap = getattr(ctx, "snapshot", None)
    if snap is None or not ctx.batches:
        return None
    counted = [v for k, v in snap.counters.items()
               if k.startswith("comm_bytes.")]
    if not counted:
        return None
    return sum(counted) / 1e6 / ctx.batches
