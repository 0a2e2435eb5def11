"""trace.mrays_s in the progressive-view cell, where it moves frame_ms_p95."""
from portbench.metrics import load

read = load("trace.mrays_s")
