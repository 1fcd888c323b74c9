"""Tracing and profiling on ``torch.profiler``.

Counterpart of the JAX package's ``utils/profiling.py``:

  * :func:`trace` — record a ``torch.profiler`` trace around a code block and
    write it as a Chrome / Perfetto trace JSON into a directory (open it in
    https://ui.perfetto.dev or ``chrome://tracing``), where JAX wrote an
    xprof directory.
  * :func:`profile_op` — one-call summary with JAX's protocol (warm-up
    calls, a synchronise, timed calls, a synchronise): wall time per call
    and the memory the call takes, and on a card the reading of the trace
    that JAX leaves to xprof: the device operations by name and the share
    of the timed window in which the device was busy.

Nothing here builds or launches anything of its own; a trace of CUDA work
needs a card.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity


def _profiler(host_tracer_level: int) -> torch.profiler.profile:
    """A profiler for ``host_tracer_level`` (see ``trace``)."""
    activities = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
    if host_tracer_level >= 1:
        activities.append(ProfilerActivity.CPU)
    if not activities:
        raise ValueError("host_tracer_level=0 records device activity only, and no CUDA card is present")
    verbose = host_tracer_level >= 3
    return torch.profiler.profile(activities=activities, record_shapes=verbose, with_stack=verbose)


@contextlib.contextmanager
def trace(log_dir: str, *, host_tracer_level: int = 2):
    """Record a ``torch.profiler`` trace of the enclosed block and write it
    into ``log_dir`` on exit (``trace_<pid>_<ns>.pt.trace.json``, Chrome /
    Perfetto trace format), also when the block raises. Yields the profiler,
    whose ``events()`` the caller may read after the block.

    Args:
      host_tracer_level: JAX's host-tracing levels mapped onto the
        profiler's switches. The device's activity (kernels, copies,
        memsets) is recorded at every level when a CUDA card is present.
        0 records no host activity; 1 (critical only) and 2 (default) record
        the host's operators and runtime calls, which the profiler cannot
        tell apart by importance; 3 (verbose) adds their input shapes
        (``record_shapes``) and Python stacks (``with_stack``).

    Usage::

        with trace("/tmp/fa_trace"):
            out = flash_attention(q, k, v, causal=True)
            torch.cuda.synchronize()
    """
    prof = _profiler(host_tracer_level)
    try:
        with prof:
            yield prof
    finally:
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.pt.trace.json"))


def _tensors(tree) -> list:
    """The tensors of a tree of dicts, lists and tuples (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensors(sub)]
    return []


def _nbytes(tree) -> int:
    """Bytes of the distinct storages under ``tree`` (views and tensors
    passed twice count once)."""
    storages = {}
    for t in _tensors(tree):
        st = t.untyped_storage()
        storages[(t.device, st.data_ptr())] = st.nbytes()
    return sum(storages.values())


def _union_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(intervals):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total


def _device_reading(events, iters: int, wall_s: float) -> dict:
    """``device_ops`` and ``device_busy_share`` from a trace's events."""
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    if not device:
        raise RuntimeError("profile_op: the trace holds no device record (CUPTI returned none); "
                           "no busy share can be read from it")
    by_name: dict[str, list] = {}
    for e in device:
        row = by_name.setdefault(e.name, [0, 0.0])
        row[0] += 1
        row[1] += e.time_range.end - e.time_range.start
    ops = [{"name": name, "count": n / iters, "device_s_per_call": us * 1e-6 / iters}
           for name, (n, us) in by_name.items()]
    ops.sort(key=lambda op: op["device_s_per_call"], reverse=True)
    busy_us = _union_us((e.time_range.start, e.time_range.end) for e in device)
    return {"device_ops": ops, "device_busy_share": busy_us * 1e-6 / (wall_s * iters)}


def profile_op(fn, *args, warmup: int = 3, iters: int = 10, log_dir: str | None = None):
    """Run ``fn(*args)`` ``warmup`` times, synchronise, then ``iters`` timed
    times and synchronise; return a summary dict.

    Keys:
      * ``wall_s_per_call``: host seconds per timed call, the synchronise
        included; ``trace_dir``: ``log_dir``, where ``trace`` wrote the
        timed calls' trace (None: none written).
      * ``memory_analysis``: JAX's four keys. ``argument_bytes`` and
        ``output_bytes`` are the bytes of the distinct storages of the
        arguments and of one call's output. On a card ``peak_bytes`` is the
        most device memory one more call (after the timed ones) allocated
        beyond what was allocated before it, and ``temp_bytes`` that less
        the output; elsewhere both are None.
      * on a card (an argument or the warm-up's output on a CUDA device),
        read from a trace of the timed calls (``log_dir``'s, or a private
        one recording device activity only): ``device_ops``, a list of
        ``{"name", "count", "device_s_per_call"}`` per device operation name
        (kernels, copies, memsets; ``count`` records a call), largest device
        time first; ``device_busy_share``, the union of every device
        operation's interval (overlaps across streams counted once) over
        the timed calls' wall time. Raises when the trace holds no device
        record.

    JAX's ``cost_analysis`` has no counterpart: eager PyTorch has no
    compiled executable to analyse (JAX leaves the key out for a function
    that is not jitted too).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    on_card = torch.cuda.is_available() and any(t.is_cuda for t in _tensors((args, out)))
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    sync()

    if log_dir:
        ctx = trace(log_dir)
    elif on_card:
        ctx = _profiler(0)
    else:
        ctx = contextlib.nullcontext()
    with ctx as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        sync()
        wall = (time.perf_counter() - t0) / iters

    summary = {"wall_s_per_call": wall, "trace_dir": log_dir}
    temp = peak = None
    if on_card:
        out = None
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn(*args)
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        temp = max(0, peak - _nbytes(out))
    summary["memory_analysis"] = {
        "argument_bytes": _nbytes(args),
        "output_bytes": _nbytes(out),
        "temp_bytes": temp,
        "peak_bytes": peak,
    }
    if on_card:
        summary.update(_device_reading(prof.events(), iters, wall))
    return summary
