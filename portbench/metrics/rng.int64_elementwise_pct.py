"""rng.int64_elementwise_pct: the profiled time of the int64 elementwise
kernels (by name: the threefry draw's arithmetic is int64, as is some
index work) over the traced stretch's busy time, in percent. The guess by
name that rng.device_pct replaces, kept beside it."""
import re

_INT64 = re.compile(r"elementwise.*\blong\b")


def read(ctx):
    if ctx["busy_s"] <= 0:
        return None
    ns = sum(d for n, _, d in ctx["kernels"] if _INT64.search(n))
    return 100.0 * ns / (ctx["busy_s"] * 1e9)
