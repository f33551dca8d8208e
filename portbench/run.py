"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <config>.<mix> --seed <n>
        --seconds <s> --trace <0|1>

A cell is a configuration (``portbench/configs/<config>.json``: the system,
its settings, its limits) under a traffic mix (``portbench/traffic/<mix>
.json``).  The run makes its inputs on the card from the seed, designs the
renderer through the program, warms up every shape the cell uses, then for
``--seconds`` keeps ``inflight`` blocks queued ahead of the device (closed
loop: before block k the host waits for block k - inflight), state carried
from block to block.  After the window it compares blocks drawn from the
seed, and the last, with the plain reference (``portbench/reference``).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (blocks of the window), ``failed`` (compared blocks over
their limit), ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics, read by ``portbench/metrics/<name>
.py`` from a profiled stretch of blocks), ``device``, ``breakdown``
(``--trace 1``), ``host`` (the host's ms a block in the program's calls
and in waits, and the seconds of the comparison: read by no metric) and,
last, ``checks`` (each number compared, with its limit).  Without a CUDA
card it exits 3 and prints no result; if JAX or the JAX package was
loaded, it exits 4.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# a library the port uses must not pull JAX in by itself
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import clock, kernel_classes, trace, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "spatial_audio_framework_tpu")


def load_config(name: str) -> dict:
    path = HERE / "configs" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no configuration {name!r} ({path})")
    return json.loads(path.read_text())


def load_system(config: dict, mix: dict, seed: int, device):
    path = HERE / "systems" / f"{config['system']}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no system adapter {path}")
    mod = importlib.import_module(f"portbench.systems.{config['system']}")
    return mod.System(config, mix, seed, device)


def load_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Sample:
    """The blocks of the window that are compared: a reservoir of ``k``
    drawn uniformly from the seed, and the last block."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.n = k, random.Random(seed), 0
        self.kept, self.last = [], None

    def offer(self, g: int, y):
        self.last = (g, y)
        if self.n < self.k:
            self.kept.append((g, y))
        else:
            j = self.rng.randrange(self.n + 1)
            if j < self.k:
                self.kept[j] = (g, y)
        self.n += 1

    def blocks(self):
        out = dict(self.kept)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return sorted(out.items())


class Loop:
    """Blocks through the program, ``inflight`` of them queued ahead.
    Once ``start`` is called it keeps, for every block, the device
    interval between its completion and the previous block's (ms), and the
    host's seconds in the program's calls and in waits."""

    def __init__(self, system, inflight: int, device):
        self.system, self.inflight, self.device = system, inflight, device
        self.g = 0
        self.pending = deque()
        self.traced = False
        self.prev = self.intervals = None
        self.step_s = self.wait_s = 0.0

    def start(self, mark):
        self.prev, self.intervals = mark, []
        self.step_s = self.wait_s = 0.0

    def _completed(self, mk):
        if self.intervals is not None:
            self.intervals.append(self.prev.elapsed_time(mk))
            self.prev = mk

    def block(self):
        if len(self.pending) >= self.inflight:
            t = time.perf_counter()
            mk = self.pending.popleft()
            with trace.span("harness.wait", self.traced):
                mk.synchronize()
            self.wait_s += time.perf_counter() - t
            self._completed(mk)
        t = time.perf_counter()
        with trace.span("models.process", self.traced):
            y = self.system.step(self.g)
        mk = clock.mark(self.device)
        mk.record()
        self.step_s += time.perf_counter() - t
        self.pending.append(mk)
        self.g += 1
        return self.g - 1, y

    def drain(self):
        clock.synchronize(self.device)
        for mk in self.pending:
            self._completed(mk)
        self.pending.clear()


def compare(system, blocks, precision: str = "fp32"):
    """Each compared block's output against the reference's: the largest
    |program - reference| over the largest |reference|, per block."""
    errs = []
    for g, y in blocks:
        ref = system.reference(g, precision)
        scale = float(ref.abs().max())
        err = float((y.float() - ref).abs().max())
        errs.append(err / scale if scale > 0 else math.inf)
    return errs


def power_limit():
    """The card's power limit as ``nvidia-smi`` gives it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def run_cell(config: dict, mix: dict, seed: int, seconds: float,
             traced: bool, device: torch.device, per_layer=(),
             t_process: float = T_PROCESS, control: bool = False) -> dict:
    """One run of a cell on ``device``; → the result line's object.
    ``control`` also renders each compared block with the reference in
    TF32 in the program's place (the control of the comparison)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    system = load_system(config, mix, seed, device)
    loop = Loop(system, mix["inflight"], device)
    held = deque(maxlen=mix["check_blocks"] + 1)
    for _ in range(mix["warmup_blocks"]):
        held.append(loop.block()[1])
    loop.drain()
    held.clear()
    sample = Sample(mix["check_blocks"], seed)
    gc.collect()
    gc.freeze()          # set-up's objects are never scanned in the window
    setup_s = time.perf_counter() - t_process

    prof, tr, n_traced = None, None, 0
    if traced:
        prof = trace.profiler(device)
        prof.start()
        loop.traced = True
    start = clock.mark(device)
    start.record()
    loop.start(start)
    n = 0
    t0 = time.perf_counter()
    t_end = t0 + seconds
    while True:
        g, y = loop.block()
        sample.offer(g, y)
        n += 1
        if loop.traced and n == mix["trace_blocks"]:
            loop.drain()
            prof.stop()
            loop.traced = False
            n_traced = n
        if time.perf_counter() >= t_end and not loop.traced:
            break
    loop.drain()
    window_s = time.perf_counter() - t0
    gc.unfreeze()
    del y
    intervals = loop.intervals
    host = {"step_ms": loop.step_s / n * 1e3, "wait_ms": loop.wait_s / n * 1e3}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if prof is not None:
        tr = trace.collect(prof)
        del prof
    work = system.work_bytes()
    system.release()
    del loop

    limit = float(config["limits"]["max_rel_err"])
    blocks = sample.blocks()
    del sample
    t_check = time.perf_counter()
    errs = compare(system, blocks)
    host["check_s"] = time.perf_counter() - t_check
    ctrl = compare(system, [(g, system.reference(g, "tf32"))
                            for g, _ in blocks]) if control else None
    worst = max(errs)
    failed = sum(1 for e in errs if not e <= limit)
    checks = {"max_rel_err": {"value": worst, "limit": limit}}
    result = {"correct": failed == 0, "attempted": n, "failed": failed}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    S, T = system.streams, system.block_samples
    if not traced:
        result["metrics"] = {
            "audio_s_per_s": {"value": S * T * n / system.fs / window_s,
                              "unit": "audio-s/s"},
            "block_ms.p95": {"value": float(np.percentile(intervals, 95)),
                             "unit": "ms"},
            "setup_s": {"value": setup_s, "unit": "s"},
        }
    else:
        s = trace.summary(tr)
        peaks = json.loads((HERE / "peaks.json").read_text())
        ctx = SimpleNamespace(
            blocks=n_traced, ops=tr.ops, spans=tr.spans, busy_s=s.busy_s,
            window_s=s.window_s, work_bytes=work,
            peak=peaks.get(dev["kind"]), is_library=kernel_classes.is_library)
        metrics = {}
        for name, unit in per_layer:
            v = load_reader(name)(ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
        result["metrics"] = metrics
        dev["busy_s"] = s.busy_s
        dev["window_s"] = s.window_s
        result["breakdown"] = trace.breakdown(tr, s)
    result["device"] = dev
    result["host"] = host
    result["checks"] = checks
    if ctrl is not None:
        result["control"] = {"max_rel_err": max(ctrl), "program": errs,
                             "tf32": ctrl}
    return result


def cell(workload: str) -> tuple[dict, dict, dict, list]:
    """The cell's entry in ``BENCHMARK.json``, its configuration, mix and
    per-layer metrics [(name, unit)]."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    per_layer = [(m["name"], m["unit"]) for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])]
    return (entry, load_config(entry["config"]), traffic.load(entry["traffic"]),
            per_layer)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    entry, config, mix, per_layer = cell(args.workload)
    chips = int(entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no CUDA card, or fewer than the {chips} this cell needs: "
              "the benchmark runs only on the card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(config, mix, args.seed, args.seconds,
                      bool(args.trace), device, per_layer)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"modules that must not load were loaded: {found}",
              file=sys.stderr)
        return 4
    result["device"]["power_limit"] = power_limit()
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    checks = result.pop("checks")
    result["checks"] = checks      # the key that comes last
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
