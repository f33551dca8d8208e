#!/usr/bin/env python3
"""Time the port's decode + synthesis renders on the card at the shapes of
the three main paths that launch them, all (S, cin, cout, H) = (64, 64, 2,
64): ambi_bin order 7 (the (d, g) pair, shared taps), the binauraliser at
64 sources (the (d, g) pair, per-stream taps) and the non-hybrid 64 -> 2
render (spectra of H + 6 hops, shared taps).

Each render is first held against its plain version (tolerance 2e-5), then
timed with CUDA events behind a spin kernel, so the times are device times.
Beside each, as a yardstick of the read rate the card reaches, ``torch.sum``
over each of the same spectral inputs (one launch a tensor) is timed the
same way.

Usage (from the repository root, on a machine with an NVIDIA GPU and nvcc):
``python scripts/time_render_decode.py [--rounds 3]``
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from spatial_audio_framework_tpu_torch.ops import _build
    from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    print(card)
    _build.load_library()
    rng = np.random.default_rng(args.seed)
    S, cin, cout, H = cs.N_STREAMS, 64, 2, cs.HOPS
    shapes = {}
    for label, dg, ps in (("order 7 (d, g), shared taps", True, False),
                          ("binauraliser 64 (d, g), per-stream taps", True,
                           True),
                          ("non-hybrid spectra, shared taps", False, False)):
        name = ("render_decode_synthesis_dg_ri" if dg
                else "render_decode_synthesis_ri")
        front = (ak.analysis_front_dg_ri_reference if dg
                 else ak.analysis_front_ri_reference)
        spec = [t.reshape(S, cin, -1, t.shape[-1]).contiguous() for t in
                front(cs.uniform(rng, (S * cin, 15 * 128), dev, cs.ANA_AMP),
                      cs.uniform(rng, (S * cin, H * 128), dev, cs.ANA_AMP))]
        taps = cs.random_taps(ak, rng, S, cin, cout, ps, dg, dev)
        ola = cs.uniform(rng, (S, cout, 9, 128), dev)
        kw = dict(per_stream=ps) if dg else dict(per_stream=ps, hybrid=False)
        ref = getattr(ak, f"{name}_reference")(*spec, ola, taps, **kw)
        shapes[label] = (getattr(ak, name), spec, ola, taps, kw, ref)

    times = {label: [] for label in shapes}
    for label, (fn, spec, ola, taps, kw, ref) in shapes.items():
        out = fn(*spec, ola, taps, **kw)
        torch.cuda.synchronize()
        err = max((o - r).abs().max().item() for o, r in zip(out, ref))
        print(f"{label}: max |err| vs plain = {err:.3e}")
        cs.check(err <= cs.KERNEL_TOL, f"{label}: {err}")
    for _ in range(args.rounds):
        for label, (fn, spec, ola, taps, kw, ref) in shapes.items():
            times[label].append(cs.cuda_ms(
                lambda: fn(*spec, ola, taps, **kw), 20, queued=True))
    for label, r in times.items():
        spec = shapes[label][1]
        mb = sum(t.numel() for t in spec) * 4 / 1e6
        for t in spec:
            t.sum()
        rd = [cs.cuda_ms(lambda: [t.sum() for t in spec], 20, queued=True)
              for _ in range(args.rounds)]
        print(f"{label} [{card}]: {np.mean(r):.4f} ms per call (runs "
              f"{['%.4f' % t for t in r]}) = {mb / np.mean(r) / 1e3:.3f} TB/s "
              f"over its {mb:.1f} MB of spectra; torch.sum over the same "
              f"tensors {np.mean(rd):.4f} ms = {mb / np.mean(rd) / 1e3:.3f} "
              "TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
