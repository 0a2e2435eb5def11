"""loop.host_syncs_per_spp: the renderer's host syncs in the traced stretch
(its spans named *.sync, the loop's and the walk's reads of a device
value, and each `render.readback`) over the samples a pixel it
rendered."""
from portbench import spans


def read(ctx):
    rec = spans.recorded()
    if rec is None or ctx["spp"] <= 0:
        return None
    n = sum(1 for s in rec[0]
            if s.name.endswith(".sync") or s.name == "render.readback")
    return n / ctx["spp"] or None
