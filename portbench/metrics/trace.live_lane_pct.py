"""trace.live_lane_pct: lanes with tfar > 0 over the lanes handed to the
trace wrappers in the traced stretch (the renderer's counters
trace.live.<kind> and trace.lanes.<kind>), in percent. On the path cells
dead lanes trace tfar = 0, so this is the loop's lane occupancy."""
from portbench import spans


def read(ctx):
    rec = spans.recorded()
    if rec is None:
        return None
    lanes = sum(v for k, v in rec[1].items() if k.startswith("trace.lanes."))
    live = sum(v for k, v in rec[1].items() if k.startswith("trace.live."))
    if lanes <= 0:
        return None
    return 100.0 * live / lanes
