"""accel.device_wait_pct: the share of the traced stretch's wall time in
which the device idled while the renderer's innermost open span was
`walk.*` or `dense.*` (the trace calls: the walk's key, sort, kernel and
unsort, the dense kernels' wrappers), in percent. The four
`*.device_wait_pct` add up to device.idle_pct (portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.wait_pct(ctx, "accel")
