"""driver.setup_wait_pct: the share of the traced stretch's wall time in
which the device idled while the renderer's innermost open span was
`render.setup` (the integrator's prepare, the pixel grid and its upload,
the base stream, up to the integrator's first call), in percent. A part of
driver.device_wait_pct."""
from portbench import spans


def read(ctx):
    return spans.span_wait_pct(ctx, "render.setup")
