#!/usr/bin/env python3
"""The port's spans on a benchmark cell, on the card: each program span's
host and device milliseconds a block, and the program's counters.

    python scripts/trace_layers.py ambi_bin_o3.batch1024 [<cell> ...]
        [--blocks 40] [--seed 1]

For each cell it builds the cell's system as ``portbench/run.py`` does,
warms it up, then runs ``--blocks`` blocks, queued as the cell queues them,
under ``torch.profiler`` (CPU and CUDA).  A device operation belongs to the
span that launched it: the profiler links each one, by its launch's
correlation id, to the host event it was launched in, and a span's device
time is that of every operation launched inside it
(``FunctionEvent.device_time_total``).  One JSON line a cell: per span the
calls, host ms (inclusive) and device ms a block; the device ms a block of
every operation (to check that the root spans hold them all); per layer
the host ms a block less the nested spans (``<layer>.host_ns``), and
``ops.state_bytes`` a block.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

LAYERS = ("models", "ops", "kernels")


def trace_cell(name: str, config: dict, mix: dict, blocks: int, seed: int,
               device) -> dict:
    import torch

    from portbench import run, trace
    from spatial_audio_framework_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    system = run.load_system(config, mix, seed, device)
    loop = run.Loop(system, mix["inflight"], device)
    for _ in range(mix["warmup_blocks"]):
        loop.block()
    loop.drain()
    profiling.reset_counters()
    prof = trace.profiler(device)
    prof.start()
    for _ in range(blocks):
        loop.block()
    loop.drain()
    prof.stop()
    counts = profiling.counters()
    spans = defaultdict(lambda: [0, 0.0, 0.0])
    device_us = 0.0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation:
                device_us += e.time_range.end - e.time_range.start
        elif e.name.split(".", 1)[0] in LAYERS:
            s = spans[e.name]
            s[0] += 1
            s[1] += e.cpu_time_total
            s[2] += e.device_time_total
    system.release()
    return {
        "cell": name, "blocks": blocks,
        "card": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "power_limit": run.power_limit(),
        "spans": {n: {"calls": c / blocks, "host_ms": h / blocks / 1e3,
                      "device_ms": d / blocks / 1e3}
                  for n, (c, h, d) in sorted(spans.items())},
        "device_ms": device_us / blocks / 1e3,
        "self_host_ms": {k: counts.get(f"{k}.host_ns", 0) / blocks / 1e6
                         for k in LAYERS},
        "state_bytes": counts.get("ops.state_bytes", 0) / blocks,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="+")
    ap.add_argument("--blocks", type=int, default=40)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    import torch

    from portbench import run

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA card: this script traces the card")
    for name in args.cells:
        _, config, mix, _ = run.cell(name)
        print(json.dumps(trace_cell(name, config, mix, args.blocks,
                                    args.seed, torch.device("cuda", 0))),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
