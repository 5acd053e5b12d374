"""The traced stretch: a call under `torch.profiler`, reduced to what the
per-layer metrics and the breakdown read.

The window is the profiler's own clock from the start of the measured
call to the card's last activity (or the call's end, if later). The
device's busy time is the union of its activities' intervals (kernels,
copies, sets) inside the window, so overlapping streams count once. An
idle gap between two device activities is named by the host operation
that was running when the gap opened (the innermost one), and gaps are
summed by that name; "host" is Python between operations.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict

TOP = 10
WINDOW = "perfbench.window"


def short(name: str) -> str:
    """A kernel's or an operation's name without its argument list."""
    name = name.removeprefix("void ").replace("(anonymous namespace)", "anon")
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:160]


def profile(body, prime=None) -> dict:
    """``prime()`` then ``body()`` under the profiler, the device
    synchronised after: window_s, busy_s, kernels {name: [seconds,
    calls]}, device_ops (top 10 [name, seconds]) and idle_gaps (top 10
    [host op, seconds]). The window opens when ``body`` starts, so work
    that ``prime`` queued keeps the card busy into it, as in a steady
    loop, and closes at the later of its end and the card's last
    activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        if prime is not None:
            prime()
        with record_function(WINDOW):
            body()
            torch.cuda.synchronize()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(span)
        else:
            host.append(span)
    return reduce(device, host)


def reduce(device: list, host: list) -> dict:
    """The figures of (start_ns, end_ns, name) device and host spans over
    the window that the host span named WINDOW opens."""
    opened = min(start for start, _, name in host if name == WINDOW)
    device = sorted((max(start, opened), end, name)
                    for start, end, name in device if end > opened)
    closed = max([end for _, end, name in host if name == WINDOW]
                 + [end for _, end, _ in device])
    kernels = defaultdict(lambda: [0.0, 0])
    for start, end, name in device:
        k = kernels[short(name)]
        k[0] += (end - start) / 1e9
        k[1] += 1
    busy, gaps, last_end = 0, [], opened
    for start, end, _ in device:
        if start > last_end:
            gaps.append((last_end, start - last_end))
        busy += max(0, end - max(start, last_end))
        last_end = max(last_end, end)
    host = sorted(h for h in host if h[2] != WINDOW)
    starts = [h[0] for h in host]
    by_op = defaultdict(float)
    for at, length in gaps:
        by_op[_running(host, starts, at)] += length / 1e9
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    return {
        "window_s": (closed - opened) / 1e9,
        "busy_s": busy / 1e9,
        "kernels": dict(kernels),
        "device_ops": [[n, v[0]] for n, v in top[:TOP]],
        "idle_gaps": sorted(([n, s] for n, s in by_op.items()),
                            key=lambda kv: -kv[1])[:TOP],
    }


def _running(host: list, starts: list, at: int) -> str:
    """The innermost host span open at ``at`` (the latest-started one that
    has not ended), or "host" where none is."""
    i = bisect.bisect_right(starts, at)
    for start, end, name in reversed(host[max(0, i - 512):i]):
        if end >= at:
            return short(name)
    return "host"


def kernel_seconds(trace: dict, names) -> tuple[float, int]:
    """Seconds and calls of the kernels whose name contains one of
    ``names``."""
    secs, calls = 0.0, 0
    for name, (s, n) in trace["kernels"].items():
        if any(part in name for part in names):
            secs += s
            calls += n
    return secs, calls
