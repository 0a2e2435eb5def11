"""rng.device_pct: device-busy time inside the resolved device intervals of
the renderer's `rng.draw` spans (every threefry draw, utils/rng.py:
random_bits) over the traced stretch's busy time, in percent."""
from portbench import spans


def read(ctx):
    ns = spans.busy_inside(ctx, ("rng.draw",))
    if not ns or ctx["busy_s"] <= 0:
        return None
    return 100.0 * ns / (ctx["busy_s"] * 1e9)
