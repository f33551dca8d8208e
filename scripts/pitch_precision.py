#!/usr/bin/env python3
"""How well conditioned the SMB pitch shifter's output is, on the CPU:

1. the port alone at the settings of ``chip_smoke.py`` phase 39 (fft 8192,
   osamp 16, two sines a channel at 0.3 and 0.1, a random shift in
   [0.5, 2] a block, 8 channels, 2 blocks of 8192): how far the output
   moves for a one-ulp relative change of the input.  A bin whose phase
   advance lies near ±π (osamp / 2 bins from a tone) wraps either way and
   moves its frequency estimate by osamp bins, so the card and the CPU can
   differ by that much;
2. the port against the JAX package on white noise at shift 0.75 (fft
   1024, osamp 8): the Nyquist bin is real, the port's rFFT gives it a +0
   imaginary part (as the C's FFT), the JAX package's matmul DFT ±1e-13,
   so atan2 gives +π against ±π there; a shift below 1 moves that bin into
   the spectrum.  Beside it, the JAX package's own move for a one-ulp
   input change, and the same noise low-passed by (1 + z^-1)/2, which has
   no energy at Nyquist.

Usage (from the repository root): ``python scripts/pitch_precision.py``
(about 20 s).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from spatial_audio_framework_tpu_torch.models import pitch_shifter as tps  # noqa: E402

ULP = np.float32(1 + 1e-7)


def port_run(cfg, x, shifts, block):
    st, outs = tps.init_state(cfg, device="cpu"), []
    for i, f in enumerate(shifts):
        y, st = tps.process(cfg, st, torch.from_numpy(
            np.ascontiguousarray(x[:, i * block:(i + 1) * block])),
            torch.tensor(f))
        outs.append(y)
    return torch.cat(outs, -1).numpy()


def main() -> None:
    rng = np.random.default_rng(0)
    fs, ch, block = 48000.0, 8, 8192
    t = np.arange(2 * block) / fs
    f0 = rng.uniform(100.0, 2000.0, (ch, 1))
    x = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 2.5 * f0 * t + 1.0)).astype(np.float32)
    shifts = rng.uniform(0.5, 2.0, 2).astype(np.float32)
    cfg = tps.PitchShifterConfig(n_ch=ch)
    d = np.abs(port_run(cfg, x, shifts, block)
               - port_run(cfg, x * ULP, shifts, block))
    print(f"1. port, fft {cfg.fft_size}, osamp {cfg.osamp}, shifts "
          f"{shifts.tolist()}: a one-ulp input change moves the output by "
          f"{d.max():.3e} (per channel {np.round(d.max(1), 6).tolist()})")

    import jax
    import jax.numpy as jnp

    from spatial_audio_framework_tpu.models import pitch_shifter as jps

    cfg_j = jps.PitchShifterConfig(n_ch=4, fft_size=1024, osamp=8)
    cfg_t = tps.PitchShifterConfig(n_ch=4, fft_size=1024, osamp=8)
    raw = (0.3 * rng.standard_normal((4, 4 * 1024 + 1))).astype(np.float32)
    noise = np.ascontiguousarray(raw[:, 1:])
    lowpassed = ((raw[:, 1:] + raw[:, :-1]) / 2).astype(np.float32)
    proc = jax.jit(lambda s, xx, f: jps.process(cfg_j, s, xx, f))

    def jax_run(xx):
        st, outs = jps.init_state(cfg_j), []
        for i in range(4):
            y, st = proc(st, jnp.asarray(xx[:, i * 1024:(i + 1) * 1024]),
                         jnp.float32(0.75))
            outs.append(np.asarray(y))
        return np.concatenate(outs, -1)

    ref = jax_run(noise)
    got = port_run(cfg_t, noise, [np.float32(0.75)] * 4, 1024)
    self_move = np.abs(ref - jax_run(noise * ULP)).max()
    lp = np.abs(port_run(cfg_t, lowpassed, [np.float32(0.75)] * 4, 1024)
                - jax_run(lowpassed)).max()
    print(f"2. noise at shift 0.75, fft 1024, osamp 8: port vs JAX "
          f"{np.abs(got - ref).max():.3e}; the JAX package's own move for a "
          f"one-ulp input change {self_move:.3e}; the noise low-passed (no "
          f"energy at Nyquist): port vs JAX {lp:.3e}")


if __name__ == "__main__":
    main()
