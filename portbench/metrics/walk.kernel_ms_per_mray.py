"""walk.kernel_ms_per_mray: profiled device time of the walk's kernels
(names walk_*) in the traced stretch over the counted rays, in
milliseconds a million rays."""
import re

_WALK = re.compile(r"(^|[\s:])walk_\w+")


def read(ctx):
    ev = [e for e in ctx["kernels"] if _WALK.search(e[0])]
    if not ev or ctx["rays"] <= 0:
        return None
    return sum(d for _, _, d in ev) / 1e6 / (ctx["rays"] / 1e6)
