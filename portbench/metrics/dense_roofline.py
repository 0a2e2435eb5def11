"""dense_roofline: the dense closest- and any-hit kernels' (K1, K2)
least time over their profiled time, in percent. The least time is the
larger of the operations over the H100's float32 peak and the bytes over
its memory bandwidth (portbench/roofline.py): 25 operations a ray-triangle
test, every counted ray against every triangle of the scene; each counted
ray's origin, direction, near and far read once and one byte written, and
the triangles' rows read once a launch."""
import re

from portbench import roofline

_DENSE = re.compile(r"(^|[\s:])dense_(closest|anyhit)")


def read(ctx):
    ev = [e for e in ctx["kernels"] if _DENSE.search(e[0])]
    if not ev or ctx["rays"] <= 0:
        return None
    dev_s = sum(d for _, _, d in ev) / 1e9
    least = roofline.dense_least_s(ctx["rays"], ctx["n_tris"], len(ev))
    return 100.0 * least / dev_s
