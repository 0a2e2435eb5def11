"""caller.device_wait_pct: the share of the traced stretch's wall time in
which the device idled while no span of the renderer was open (the
caller's code between two renders: here the harness's float64 fold of
the film), in percent. The four `*.device_wait_pct` add up to
device.idle_pct (portbench/spans.py)."""
from portbench import spans


def read(ctx):
    return spans.wait_pct(ctx, "caller")
