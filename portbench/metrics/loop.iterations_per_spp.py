"""loop.iterations_per_spp: the wavefront loop's iterations in the traced
stretch (the renderer's counter loop.iterations) over the samples a pixel
it rendered."""
from portbench import spans


def read(ctx):
    rec = spans.recorded()
    if rec is None or ctx["spp"] <= 0:
        return None
    return rec[1].get("loop.iterations", 0) / ctx["spp"] or None
