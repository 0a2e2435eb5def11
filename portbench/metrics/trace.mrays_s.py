"""trace.mrays_s: rays handed to the trace kernels in the traced stretch
(lanes with tfar > 0, the renderer's counting_rays) over its wall time, in
millions a second."""


def read(ctx):
    if ctx["rays"] <= 0 or ctx["wall_s"] <= 0:
        return None
    return ctx["rays"] / ctx["wall_s"] / 1e6
