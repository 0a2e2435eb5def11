"""The recorder's shared clock on the card: device spans resolve onto the
profiler's kernel intervals, and host time inside a span shows as the
device's idle time there. No JAX import, so that it runs on a machine
with a card:

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_tracing_cuda.py

It skips without a card.
"""
import time

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as ap

from rustlight_tpu_torch.utils import tracing

EDGE_NS = 20_000       # a device span's ends against its kernels'
GAP_NS = 100_000       # a host sleep against the device's idle gap


def _device_events(fn):
    """Run fn() under a device-only kineto profiler, as portbench/trace.py
    records; [(name, start_ns, end_ns)] of the device's operations."""
    p = ap.profile(use_cpu=False, use_device="cuda", use_kineto=True)
    p._prepare_trace()
    p._start_trace()
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        res = torch.autograd._disable_profiler()
    out = []
    for e in res.events():
        if e.device_type() == DeviceType.CUDA:
            s = int(e.start_ns()) if hasattr(e, "start_ns") else \
                int(e.start_us()) * 1000
            d = int(e.duration_ns()) if hasattr(e, "duration_ns") else \
                int(e.duration_us()) * 1000
            out.append((e.name(), s, s + d))
    return sorted(out, key=lambda e: e[1])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    a = torch.randn(2048, 2048, device=dev)
    (a @ a).sum().item()                       # warm the library
    return dev, a


def _idle_within(ev, t0, t1):
    """Device-idle ns within [t0, t1): its length less the events' union
    there."""
    busy, end = 0, t0
    for _, s, e in ev:
        s, e = max(s, end), min(e, t1)
        if e > s:
            busy += e - s
            end = e
    return (t1 - t0) - busy


@pytest.mark.cuda
def test_device_span_holds_its_kernels(card):
    """A device span queued behind 6 ms of busy device resolves to the
    interval of the kernels it enclosed, within EDGE_NS at each end."""
    dev, a = card

    def work():
        with tracing.root("outer"):            # the session's anchor
            torch.cuda._sleep(10_000_000)      # the queue ahead of the span
            with tracing.span("seq", dev):
                for _ in range(4):
                    b = a @ a
                b.sum()
    ev = _device_events(work)
    s = [s for s in tracing.spans() if s.name == "seq"][0]
    assert s.dev_start_ns is not None
    inside = [e for e in ev if e[1] >= ev[0][2]]   # after the spin kernel
    assert len(inside) >= 5
    first, last = inside[0][1], max(e[2] for e in inside)
    assert abs(s.dev_start_ns - first) <= EDGE_NS, (s, first)
    assert abs(s.dev_end_ns - last) <= EDGE_NS, (s, last)


@pytest.mark.cuda
def test_host_sleep_in_a_span_is_the_device_idle_gap(card):
    """A 20 ms sleep inside a span, between two synchronized kernels, is
    device-idle time over the span's host interval within GAP_NS (a clock
    offset either way would put a kernel inside it)."""
    dev, a = card

    def work():
        with tracing.root("outer"):
            (a @ a).sum().item()
            with tracing.span("nap"):
                time.sleep(0.02)
            (a @ a).sum().item()
    ev = _device_events(work)
    nap = [s for s in tracing.spans() if s.name == "nap"][0]
    length = nap.end_ns - nap.start_ns
    assert length >= 20_000_000
    assert _idle_within(ev, nap.start_ns, nap.end_ns) >= length - GAP_NS
