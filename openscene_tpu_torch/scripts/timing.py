"""Helpers shared by the benchmarks: CUDA-event timing and the card line."""

from __future__ import annotations

import subprocess
import time

import torch


def time_ms(fn, device, iters: int = 10, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` calls after ``warmup``.
    On a CUDA device: CUDA events around the calls, then a synchronise (the
    device's time, launches queued back to back).  On the CPU: the host
    clock, which times the CPU's plain versions and says nothing of the
    card."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device milliseconds of ``fn()`` on the current CUDA device with
    the host's enqueue hidden: a sleep kernel holds the stream while the
    ``iters`` calls are queued behind it, and CUDA events around the calls
    time them back to back.  Beside :func:`time_ms`, which also counts the
    host's time where the host is slower than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e9 cycles a second: cover the enqueue twice over, and 1 ms
    torch.cuda._sleep(int(2e9 * (2 * iters * host_s + 1e-3)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them (a card may be set below
    its maximum power, and then runs slower under load)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]
