"""The H100's peaks and the dense trace kernels' work count.

Peaks: NVIDIA's H100 SXM data sheet, 67 TFLOP/s float32 outside the tensor
cores and 3.35 TB/s of HBM3, both at the 700 W power limit (the run prints
the card's limit beside its numbers)."""
from __future__ import annotations

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
TEST_FLOPS = 25          # operations of one ray-triangle test
RAY_BYTES_IN = 32        # origin, direction, near, far: 8 float32
RAY_BYTES_OUT = 1        # the least a result takes (an any-hit flag)
TRI_BYTES = 48           # a triangle's three rows of four float32


def dense_least_s(rays: int, n_tris: int, launches: int) -> float:
    """Least time of `launches` dense launches that together test `rays`
    rays against every one of `n_tris` triangles."""
    flops = TEST_FLOPS * rays * n_tris
    bytes_ = (rays * (RAY_BYTES_IN + RAY_BYTES_OUT)
              + launches * n_tris * TRI_BYTES)
    return max(flops / F32_FLOPS, bytes_ / HBM_BYTES_S)
