#!/usr/bin/env python3
"""Phase 36 of ``chip_smoke.py`` alone: ``StreamRunner`` over the flagship
on the card (64 streams x 16 channels in, frames of 1024 samples, host
blocks of 480), synchronously and on the render thread, with the host
pieces of a frame.  Needs a CUDA card.

``--root DIR`` runs the ``chip_smoke.py`` and the port of another checkout
of the repository (for example the parent commit, unpacked with ``git
archive`` into a git-ignored directory), so that two trees can be timed on
one card in one session, in turns::

    python scripts/time_runtime.py --root _checkout/parent
    python scripts/time_runtime.py

The last line is one JSON object: the tree, the card, and each mode's wall
ms a frame, frame-clock rtf, the read's share and render_full_ri launches.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="the checkout to run (default: this one)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAIL: no CUDA device: this script times the card")
    import chip_smoke
    from spatial_audio_framework_tpu_torch.models import ambi_bin
    from spatial_audio_framework_tpu_torch.ops import _build
    from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak

    if Path(chip_smoke.__file__).resolve().parent != root:
        raise SystemExit(f"FAIL: imported {chip_smoke.__file__}, not {root}")
    _build.build()
    _build.load_library()
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    print(f"{root}: {card}")
    bcfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    bw = ambi_bin.design_ri(bcfg, device=dev)
    out = chip_smoke.phase_runtime(bcfg, bw, ak, dev,
                                   np.random.default_rng(args.seed), card)
    print(json.dumps({"root": str(root), "card": card,
                      **{m: out[m] for m in ("process_block",
                                             "render thread")}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
