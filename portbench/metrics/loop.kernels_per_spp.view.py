"""loop.kernels_per_spp in the progressive-view cell, where it moves frame_ms_p95."""
from portbench.metrics import load

read = load("loop.kernels_per_spp")
