"""Profiling and tracing helpers (counterpart of
``stnerf_tpu/utils/profiling.py``).

``trace`` records a ``torch.profiler`` trace (the card's kernels too) and
writes it as a Chrome trace; ``phase`` times a phase on the host clock,
after waiting for the device that holds ``sync_on``; ``device_memory_stats``
reads the caching allocator's counters.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time

import torch

logger = logging.getLogger("stnerf_tpu_torch.profile")


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a trace: ``with trace("/tmp/prof"): step()`` writes
    ``logdir/trace.json`` (open it in Perfetto or chrome://tracing). The
    profiler is yielded, so ``key_averages()`` reads the sums by kernel."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profile trace written to %s", path)


def _sync(target):
    """Wait for the devices of every tensor of ``target`` (a tensor or a
    nested tuple, list or dict of them)."""
    if isinstance(target, torch.Tensor):
        if target.device.type == "cuda":
            torch.cuda.synchronize(target.device)
    elif isinstance(target, (tuple, list)):
        for x in target:
            _sync(x)
    elif isinstance(target, dict):
        for x in target.values():
            _sync(x)


@contextlib.contextmanager
def phase(name: str, sync_on=None):
    """Wall-time a phase; pass a tensor (or a tuple, list or dict of them)
    as ``sync_on``, or set ``holder["sync"]`` inside the block, to wait for
    its device before the clock stops. The yielded dict receives
    ``seconds``."""
    t0 = time.time()
    holder = {}
    try:
        yield holder
    finally:
        target = holder.get("sync", sync_on)
        if target is not None:
            _sync(target)
        dt = time.time() - t0
        holder["seconds"] = dt
        logger.info("[phase] %s: %.3fs", name, dt)


def device_memory_stats(device=None) -> dict:
    """Live and peak bytes allocated on the CUDA card and its capacity,
    under the JAX package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``); {} without a card."""
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda" or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(device).total_memory}
