"""Device time of one window of work, traced with ``torch.profiler``."""
from __future__ import annotations

import time

import torch
from torch.profiler import ProfilerActivity, profile


def profile_window(name: str, fn, top: int) -> dict:
    """Trace the device while ``fn()`` runs once.

    Returns the host-clock wall time (to a synchronize), the summed time
    of the device kernels, the device's idle share (1 - kernel time / wall
    time; one stream, so kernels do not overlap), the kernel launches and
    the ``top`` kernels by time.  Only the device is traced, so the
    profiler adds no per-op host work to the wall time.
    """
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {
        "window": name,
        "wall_ms": 1e3 * wall,
        "kernel_ms": busy_us / 1e3,
        "idle_share": 1.0 - busy_us / 1e6 / wall if wall > 0 else None,
        "launches": sum(e.count for e in kernels),
        "top": [{"kernel": e.key[:80], "count": e.count,
                 "ms": e.self_device_time_total / 1e3} for e in kernels[:top]],
    }
