"""Reading a ``torch.profiler`` trace of a stretch of a run.

The union of device intervals is copied from ``chip_smoke.py::profile``:
busy time is the union of the intervals of the device's kernels, copies and
memsets, so events that overlap (on other streams) count once. Kernel time
by name is the plain sum of each kernel's durations.

:func:`traced` profiles a callable; :func:`summarize` turns the events into
a :class:`Trace`, which keeps what the readers of the per-layer metrics and
the ``breakdown`` need and drops the rest.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

HOST_SPAN = "portbench."  # the prefix of the harness's record_function labels


class Trace(NamedTuple):
    window_s: float                       # the host's clock over the traced stretch
    busy_s: float                         # union of the device's intervals
    by_name: Dict[str, float]             # device seconds a kernel or copy name
    gaps: List[Tuple[str, float]]         # the longest idle gaps, by host activity
    nccl_busy_s: float                    # union of NCCL kernels' intervals


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def _union(intervals) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


def _gap_label(mid: float, host) -> str:
    """What the host was doing at ``mid``: the harness's span around it and
    the innermost operator, from the CPU events ``host`` ((start, end, name))."""
    span, op, op_len = "outside the harness's spans", "", float("inf")
    for start, end, name in host:
        if start <= mid <= end:
            if name.startswith(HOST_SPAN):
                span = name[len(HOST_SPAN):]
            elif end - start < op_len:
                op, op_len = name, end - start
    return f"{span}: {op}" if op else span


def summarize(prof, window_s: float, top_gaps: int = 10) -> Trace:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    device, host = [], []
    for e in prof.events():
        rng = (e.time_range.start, e.time_range.end)
        if e.name.startswith(HOST_SPAN) and e.device_type == cuda:
            continue  # a host span's mirror on the device's timeline, not device work
        if e.device_type == cuda:
            device.append((*rng, e.name))
        else:
            host.append((*rng, e.name))
    by_name: Dict[str, float] = {}
    for start, end, name in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    spans = _union((s, e) for s, e, _ in device)
    gaps = sorted(((b[0] - a[1], (a[1] + b[0]) / 2) for a, b in zip(spans, spans[1:])),
                  reverse=True)[:top_gaps]
    nccl = [(s, e) for s, e, n in device if "nccl" in n.lower()]
    return Trace(window_s=window_s, busy_s=busy_us((s, e) for s, e, _ in device) / 1e6,
                 by_name=by_name,
                 gaps=[(_gap_label(mid, host), length / 1e6) for length, mid in gaps],
                 nccl_busy_s=busy_us(nccl) / 1e6)


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` under ``torch.profiler`` (host and device), the device
    synchronised before and after; its trace summarised."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    return summarize(prof, window)


def device_seconds(trace: Optional[Trace], *tags: str) -> float:
    """Device seconds of the kernels whose name holds one of ``tags``."""
    if trace is None:
        return 0.0
    return sum(v for k, v in trace.by_name.items() if any(t in k for t in tags))


def breakdown(trace: Trace, top: int = 10) -> Dict[str, list]:
    ops = sorted(trace.by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[name[:120], secs] for name, secs in ops],
            "idle_gaps": [[label[:120], secs] for label, secs in trace.gaps[:top]]}
