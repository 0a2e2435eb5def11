"""trace.walk_kernels_inside_pct: the part of the walk kernels' profiled
time (names walk_* or pair_*) that falls inside the resolved device
intervals of the renderer's `walk.kernel` spans, in percent. It checks the
shared clock of spans and device events on real traffic: near 100."""
from portbench import spans


def read(ctx):
    rec = spans.recorded()
    total = spans.walk_kernel_ns(ctx)
    if rec is None or not total:
        return None
    iv = spans.device_intervals(rec[0], ("walk.kernel",))
    if not iv:
        return None
    kernels = spans.merge((s, s + d) for n, s, d in ctx["kernels"]
                          if spans.WALK.search(n))
    return 100.0 * spans.overlap(kernels, iv) / total
