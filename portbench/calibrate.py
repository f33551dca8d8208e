"""The readings a cell's limits are set from, on the card, in one process:

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds 3 [--out chiprun_out/calibrate.jsonl]

For each seed, one run of the cell (``run.run_cell``, a short window at the
cell's own load and sizes) compares the program's compared blocks with the
float32 reference (the lower reading), and renders the same blocks with
the reference in TF32, the control put in the program's place (the upper
reading).  Prints, and appends to ``--out``, one JSON line a seed.  The
benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 3
    _, config, mix, _ = run.cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(config, mix, seed, args.seconds, False, device,
                         t_process=time.perf_counter(), control=True)
        line = {"workload": args.workload, "seed": seed,
                "correct": r["correct"], "attempted": r["attempted"],
                "program": r["checks"]["max_rel_err"]["value"],
                "control": r["control"]["max_rel_err"],
                "program_blocks": r["control"]["program"],
                "control_blocks": r["control"]["tf32"],
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
