"""loop.kernels_per_spp: device kernels launched in the traced stretch over
the samples a pixel it rendered (the wavefront loop's launches per sample of
the whole film)."""


def read(ctx):
    if not ctx["kernels"] or ctx["spp"] <= 0:
        return None
    return len(ctx["kernels"]) / ctx["spp"]
