"""loop.device_wait_pct: the share of the traced stretch's wall time in
which the device idled while the renderer's innermost open span was
`loop.*` or `rng.*` (the wavefront loop's dispatch, its any() syncs, the
threefry draws), in percent. The four `*.device_wait_pct` add up to
device.idle_pct (portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.wait_pct(ctx, "loop")
