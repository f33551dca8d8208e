#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, the flagship ambi_bin render (order 3, MagLS,
64 streams, chunks of 8192 samples = 64 hops of 128, state carried from
chunk to chunk), through ``spatial_audio_framework_tpu_torch`` on the card:

1. card and build: the card's name and power limit, and the build of the
   CUDA kernels from ``spatial_audio_framework_tpu_torch/csrc``;
2. each kernel vs its plain PyTorch version on the card, at a small shape
   and at the flagship shape, two chained calls carrying both tails;
3. the slice: host design, 8 chunks through ``process_ri_batched`` with the
   launch counters reset just before, held against the plain path, then
   timed with CUDA events against the plain path;
4. parity with the compiled C reference (tests/goldens/c_goldens.npz):
   order 4, MagLS, N3D, yaw = π, one stream in 512-sample blocks.

Every phase checks its results and any failure exits non-zero.  The
second-to-last line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.

Usage (from the repository root): ``python chip_smoke.py [--seed N]``
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-5   # kernel vs plain, both fp32: only the sum order differs
C_TOL = 1e-4        # vs the compiled C reference (tests/test_c_goldens.py)
N_STREAMS, ORDER, HOPS, N_CHUNKS = 64, 3, 64, 8
FS = 48000.0


def fail(msg: str) -> None:
    raise SystemExit(f"FAIL: {msg}")


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, n: int) -> float:
    """Mean ms per call of ``fn`` over ``n`` calls, by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def uniform(rng, shape) -> np.ndarray:
    return rng.uniform(-1.0, 1.0, shape).astype(np.float32)


def phase_kernel_vs_plain(ak, dev, rng, card):
    """render_full_ri vs render_full_ri_reference; returns the max error and
    the flagship-shape times (ms) of both."""
    worst = 0.0
    flagship = None
    for S, cin, cout, H in ((3, 4, 2, 4), (N_STREAMS, 16, 2, HOPS)):
        M = uniform(rng, (2, 133, cout, cin))
        taps = ak.decode_taps(torch.from_numpy(M[0]),
                              torch.from_numpy(M[1])).contiguous().to(dev)
        kt = rt = torch.from_numpy(uniform(rng, (S, cin, 15 * 128))).to(dev)
        ko = ro = torch.from_numpy(uniform(rng, (S, cout, 9, 128))).to(dev)
        err = 0.0
        for _ in range(2):
            x = torch.from_numpy(uniform(rng, (S, cin, H * 128))).to(dev)
            ky, ko = ak.render_full_ri(kt, x, ko, taps)
            ry, ro = ak.render_full_ri_reference(rt, x, ro, taps)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(ky).all()) and ky.shape == ry.shape,
                  f"kernel output not finite or misshapen at {(S, cin, cout, H)}")
            err = max(err, (ky - ry).abs().max().item(),
                      (ko - ro).abs().max().item())
            kt = rt = torch.cat([kt, x], dim=-1)[..., H * 128:].contiguous()
        print(f"phase 2: render_full_ri vs plain at (S, cin, cout, H) = "
              f"{(S, cin, cout, H)}: max |err| = {err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"kernel disagrees with plain: {err}")
        worst = max(worst, err)
        flagship = (kt, x, ko, taps)
    kt, x, ko, taps = flagship
    for _ in range(3):  # warm-up
        ak.render_full_ri(kt, x, ko, taps)
        ak.render_full_ri_reference(kt, x, ko, taps)
    times = {"kernel": [], "plain": []}
    for name in ("kernel", "plain", "plain", "kernel"):
        fn = ak.render_full_ri if name == "kernel" else ak.render_full_ri_reference
        times[name].append(cuda_ms(lambda: fn(kt, x, ko, taps), 20))
    ms = {k: float(np.mean(v)) for k, v in times.items()}
    print(f"phase 2: render_full_ri at the flagship shape [{card}]: kernel "
          f"{ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms per call "
          f"(runs {times})")
    return worst, ms


def phase_slice(ambi_bin, ak, dev, rng, card):
    """The flagship render through process_ri_batched; returns the kernel's
    launch count during the main-path run."""
    t0 = time.perf_counter()
    cfg = ambi_bin.AmbiBinConfig(order=ORDER, method="magls")
    w = ambi_bin.design_ri(cfg, device=dev)
    print(f"phase 3: design (order {ORDER}, MagLS) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    T = HOPS * 128
    xs = [torch.from_numpy(uniform(rng, (N_STREAMS, cfg.nsh, T))).to(dev)
          for _ in range(N_CHUNKS)]

    def run(fused):
        st = ambi_bin.init_state_batched(cfg, N_STREAMS, dev)
        ys = []
        for x in xs:
            y, st = ambi_bin.process_ri_batched(cfg, w, st, x, fused=fused)
            ys.append(y)
        return ys, st

    ak.render_full_ri.launches = 0
    ys_k, st_k = run(True)
    torch.cuda.synchronize()
    launches = ak.render_full_ri.launches
    print(f"phase 3: main path ran {N_CHUNKS} chunks of "
          f"{(N_STREAMS, cfg.nsh, T)}; render_full_ri launches = {launches}")
    check(launches == N_CHUNKS, f"expected {N_CHUNKS} kernel launches")
    ys_p, st_p = run(False)
    torch.cuda.synchronize()
    err = 0.0
    for yk, yp in zip(ys_k, ys_p):
        check(tuple(yk.shape) == (N_STREAMS, 2, T), f"y shape {yk.shape}")
        check(bool(torch.isfinite(yk).all()), "non-finite output")
        err = max(err, (yk - yp).abs().max().item())
    err = max(err, (st_k.ola_tail - st_p.ola_tail).abs().max().item())
    check(torch.equal(st_k.in_tail, st_p.in_tail), "in_tail differs")
    print(f"phase 3: kernel path vs plain path over {N_CHUNKS} chunks: "
          f"max |err| = {err:.3e} (tol {KERNEL_TOL})")
    check(err <= KERNEL_TOL, f"slice disagrees with the plain path: {err}")

    state = {True: ambi_bin.init_state_batched(cfg, N_STREAMS, dev),
             False: ambi_bin.init_state_batched(cfg, N_STREAMS, dev)}
    it = {True: 0, False: 0}

    def step(fused):
        _, state[fused] = ambi_bin.process_ri_batched(
            cfg, w, state[fused], xs[it[fused] % N_CHUNKS], fused=fused)
        it[fused] += 1

    for fused in (True, False):  # warm-up
        for _ in range(2):
            step(fused)
    times = {True: [], False: []}
    for fused in (True, False, False, True):
        times[fused].append(cuda_ms(lambda: step(fused), N_CHUNKS))
    audio_s = N_STREAMS * T / FS
    for fused, name in ((True, "kernel"), (False, "plain")):
        ms = float(np.mean(times[fused]))
        print(f"phase 3: flagship chunk, {name} path [{card}]: {ms:.4f} ms "
              f"per chunk of {N_STREAMS} streams x {T} samples = "
              f"{audio_s / (ms / 1e3):.1f} audio-seconds per second "
              f"(runs {['%.4f' % t for t in times[fused]]})")
    return launches


def phase_c_parity(ambi_bin, sh, geo, dev, card):
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    cfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d")
    Mre, Mim = ambi_bin.design_ri(cfg, device=dev)
    R = geo.yaw_pitch_roll2_rzyx(np.pi, 0.0, 0.0).astype(np.float32)
    M_rot = torch.from_numpy(
        np.asarray(sh.get_sh_rot_mtx_real(R, 4), np.float32)).to(dev)
    w = (torch.einsum("bes,st->bet", Mre, M_rot),
         torch.einsum("bes,st->bet", Mim, M_rot))
    x = torch.from_numpy(np.ascontiguousarray(
        g["ambi_bin_enc_y"][:, None] * g["ambi_bin_in_mono"][None, :],
        np.float32))[None].to(dev)
    st = ambi_bin.init_state_batched(cfg, 1, dev)
    outs = []
    for f in range(x.shape[-1] // 512):
        y, st = ambi_bin.process_ri_batched(
            cfg, w, st, x[..., f * 512:(f + 1) * 512].contiguous())
        outs.append(y[0])
    out = torch.cat(outs, dim=-1).cpu().numpy()
    err = float(np.abs(out - g["ambi_bin_out"]).max())
    print(f"phase 4: ambi_bin order 4 vs the C reference on the card "
          f"[{card}]: max |err| = {err:.3e} (tol {C_TOL})")
    check(np.isfinite(out).all() and err <= C_TOL, f"C parity: {err}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the port on the card "
             "and has no CPU mode")
    from spatial_audio_framework_tpu_torch.models import ambi_bin
    from spatial_audio_framework_tpu_torch.modules import sh
    from spatial_audio_framework_tpu_torch.ops import _build
    from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak
    from spatial_audio_framework_tpu_torch.utils import geometry as geo

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    seconds = _build.build()
    print(f"phase 1: built {_build.library_path().name} from "
          f"{_build.SRC_DIR.relative_to(ROOT)} in {seconds:.2f} s")
    log = _build.library_path().with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"phase 1: ptxas: {line.strip()}")
    _build.load_library()

    rng = np.random.default_rng(args.seed)
    err, ms = phase_kernel_vs_plain(ak, dev, rng, card)
    launches = phase_slice(ambi_bin, ak, dev, rng, card)
    phase_c_parity(ambi_bin, sh, geo, dev, card)

    print(json.dumps({"kernels": [{
        "name": "render_full_ri", "route": "cuda",
        "source": "spatial_audio_framework_tpu_torch/csrc/render_full_ri.cu",
        "replaces": "spatial_audio_framework_tpu/ops/pallas_afstft.py:674",
        "launches": launches, "max_abs_err": err,
        "ms": ms["kernel"], "plain_ms": ms["plain"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
