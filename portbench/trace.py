"""The traced stretch of a ``--trace 1`` run: ``torch.profiler`` (CPU and
CUDA) around a run of blocks, the benchmark's own host spans around the
calls (``models.process`` around each call into the program,
``harness.wait`` around each wait for a block), and what is read from it:
device operations, spans, the device's busy time, the idle gaps and the
``breakdown`` of the result line."""
from __future__ import annotations

import contextlib
from collections import defaultdict
from types import SimpleNamespace

import torch

SPANS = ("models.process", "harness.wait")


def span(name: str, on: bool):
    """A host span the profiler records, or nothing outside a trace."""
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def collect(prof) -> SimpleNamespace:
    """Device operations (kernels, copies, fills) and benchmark spans as
    (name, start µs, end µs), on the profiler's one clock.  A span also
    shows on the device's timeline (a user annotation): it is no
    operation."""
    ops, spans = [], []
    for e in prof.events():
        rec = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.name in SPANS:
            if e.device_type == torch.autograd.DeviceType.CPU:
                spans.append(rec)
        elif e.device_type == torch.autograd.DeviceType.CUDA:
            ops.append(rec)
    ops.sort(key=lambda r: r[1])
    spans.sort(key=lambda r: r[1])
    return SimpleNamespace(ops=ops, spans=spans)


def merged(intervals):
    """The union of (start, end) intervals, sorted, as disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summary(t: SimpleNamespace) -> SimpleNamespace:
    """Busy time (the union of device operations), the traced window (the
    first span's start to the last operation's or span's end), both in
    seconds, and the busy intervals."""
    busy = merged([(s, e) for _, s, e in t.ops])
    ends = [e for _, _, e in t.ops] + [e for _, _, e in t.spans]
    starts = [s for _, s, _ in t.spans] or [s for _, s, _ in t.ops]
    if not starts:
        return SimpleNamespace(busy=busy, busy_s=0.0, window_s=0.0,
                               t0=0.0, t1=0.0)
    t0, t1 = min(starts), max(ends)
    return SimpleNamespace(busy=busy,
                           busy_s=sum(e - s for s, e in busy) * 1e-6,
                           window_s=(t1 - t0) * 1e-6, t0=t0, t1=t1)


def breakdown(t: SimpleNamespace, s: SimpleNamespace) -> dict:
    """The 10 device operations that took most time, and the 10 longest
    idle gaps named by the benchmark span the host was in when the gap
    began ("no_benchmark_span" outside both), each with seconds."""
    by_name = defaultdict(float)
    for name, a, b in t.ops:
        by_name[name] += (b - a) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [s.t0] + [x for iv in s.busy for x in iv] + [s.t1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            host = [n for n, x, y in t.spans if x <= a < y]
            gaps.append((host[-1] if host else "no_benchmark_span",
                         (b - a) * 1e-6))
    gaps.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps[:10]]}
