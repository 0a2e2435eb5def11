"""device.idle_pct: the share of the traced stretch's wall time in which no
operation (kernel, copy or memset) ran on the device, in percent."""


def read(ctx):
    if not ctx["events"] or ctx["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["wall_s"])
