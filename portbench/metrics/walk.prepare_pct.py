"""walk.prepare_pct: device-busy time inside the resolved device intervals
of the walk's `walk.prepare` (sanitize, key, sort, pad) and `walk.unsort`
spans, over that plus the profiled time of the walk's kernels (names
walk_*), in percent."""
from portbench import spans


def read(ctx):
    prep = spans.busy_inside(ctx, ("walk.prepare", "walk.unsort"))
    kern = spans.walk_kernel_ns(ctx)
    if not prep or not kern:
        return None
    return 100.0 * prep / (prep + kern)
