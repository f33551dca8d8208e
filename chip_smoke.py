#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through ``spatial_audio_framework_tpu_torch``
on the card, 64 streams in chunks of 8192 samples (64 hops of 128) with
state carried from chunk to chunk:

* the flagship ambi_bin render (order 3, MagLS, 2 ears): cin = 16, so one
  pass of the ``render_full_ri`` kernel per chunk;
* the ambi_dec render (order 3 → the 22.x layout, 22 loudspeakers):
  cout·cin = 352, so per chunk the ``analysis_front_ri`` kernel, the
  ``wide_mix_ri`` kernel (hybrid forward and per-band mix), then the
  ``synthesis_back_ri`` kernel;
* the wide-order binaural render (ambi_bin order 7, MagLS): cin = 64 > 16,
  so per chunk the two-kernel pipeline ``analysis_front_dg_ri`` →
  ``render_decode_synthesis_dg_ri``;
* the same width on a non-hybrid bank (64 inputs → 2 outputs):
  ``analysis_front_ri`` → ``render_decode_synthesis_ri``;
* the binauraliser: 4 head-tracked sources per stream, HRTFs designed
  from a SOFA file and interpolated per chunk on the card, so per-stream
  mixing matrices: one pass of ``render_full_ri`` with per-stream taps per
  chunk; and at its full width (64 sources) the (d, g) pair;
* the panner: 4 sources per stream onto a 5.1 and a 7.1.4 layout (5 and 11
  outputs), gains looked up per chunk on the card: ``render_full_ri`` with
  per-stream taps above two outputs;
* the near-field binauraliser: the binauraliser's 4-source path with
  per-source distances (DVF shelves per chunk on the card);
* the roombinauraliser: 16 sources, each through its own BRIR set,
  interpolated per stream at the head's rotation: ``render_full_ri``; at
  64 sources the (d, g) pair;
* ambi_enc: 64 sources encoded to order 1 in frames of 128 samples; plain
  matrix products, none of the six kernels;
* array2sh: 16 Eigenmike32 recordings encoded to order 4 (32 → 25
  channels): ``analysis_front_ri``, ``wide_mix_ri`` and
  ``synthesis_back_ri``; and ambi_dec's binaural preview (order 3 → 22.x → 2 ears, one
  complex 16 → 2 decoder): ``render_full_ri``;
* one head-tracked listener through the single-stream ``ambi_bin.process``
  / ``process_ri``: plain torch, the rotation built on the card per block;
* the analysers and the decorrelator at the JAX benchmark's widths: the
  decorrelator (4 channels x 16 streams: ``analysis_front_ri`` and
  ``synthesis_back_ri`` at 64 rows around the lattice), ambi_drc (order 3 x
  64 streams: both at 1024 rows), powermap (order 3, MUSIC; 32 instances:
  ``analysis_front_ri`` at 512 rows, 8 chunks a call through
  ``analysis_chunks``) and sldoa (order 3, 32 instances: the same front),
  their single-instance paths and dirass (none of the six kernels);
* convolution and room simulation at the JAX benchmark's widths: tvconv
  (64 positions x 2 channels x 2048-tap IRs; a moving listener, a static
  one, 32 moving instances) and ambi_roomsim (order 2, 2 sources; 1
  instance and 32): ``torch.fft`` and batched products, none of the six
  kernels, as in the JAX package;
* HADES (binaural BMVDR, blocks of 1024) and the spreader (OM, 1 source,
  frames of 512): one instance many blocks a call on the plain
  single-stream filterbank, and 32 instances a call through
  ``analysis_front_ri`` (64 and 32 rows, 32 hops) and
  ``synthesis_back_ri`` (64 rows) around the closed-form 2x2 chains.

Phases:

1. card and build: the card's name and power limit, and the build of the
   CUDA kernels from ``spatial_audio_framework_tpu_torch/csrc``;
2. each kernel vs its plain PyTorch version on the card, at small shapes
   (rows not a multiple of 8, H < 9, low-delay and non-hybrid banks,
   per-stream taps, up to 11 outputs; for ``render_full_ri`` cin that its
   cluster of min(4, cin) blocks does not divide; for the two-kernel
   renders rows of spectra that start off a 16-byte boundary and more
   tiles than stay resident) and at its main path's shape, two chained
   calls carrying the tails, and for the two-kernel renders two launches
   that must agree bit for bit; then both timed with CUDA events at
   the main path's shape, the kernel enqueued behind a spin kernel so its
   time is device time (the plain version as it comes: its hundreds of
   launches a call overflow the launch queue); where one PyTorch call
   computes the same function
   (``torch.stft`` for the fronts, ``F.conv_transpose1d`` with cuDNN TF32
   off for ``synthesis_back_ri``), that call is held against the kernel's
   output and timed the same way; each kernel's bound (bytes over the HBM
   rate or operations over the fp32 rate) is computed from the shape;
3. the flagship ambi_bin slice: host design, 8 chunks through
   ``process_ri_batched`` with the launch counters reset just before, held
   against the plain path, then both paths timed, and the kernel path's
   device time per chunk with the host out of the way (its idle share;
   a chunk that makes the host wait for the device fails);
4. ambi_bin parity with the compiled C reference (tests/goldens/c_goldens.npz):
   order 4, MagLS, N3D, yaw = π, one stream in 512-sample blocks, through
   the default dispatch (the (d, g) pair) and the one-pass route;
5. the ambi_dec slice, as phase 3;
6. ambi_dec parity with the compiled C reference: order 3 → 9 loudspeakers,
   dual-band AllRAD, one stream in 128-sample blocks;
7. the ambi_bin order-7 slice, as phase 3, then the one-pass and the
   two-kernel routes timed against each other at orders 3 and 7;
8. the non-hybrid render at order-7 width, as phase 3;
9. the binauraliser slice: the default HRIR set written to a SOFA file in
   a temporary directory and read back (``sofa_save`` / ``sofa_open``),
   the host design from it, then 64 streams x 4 sources with rotation,
   as phase 3;
10. the binauraliser at 64 sources, as phase 3;
11. binauraliser parity with the compiled C reference: 2 sources, one
    stream in 128-sample blocks, without and with rotation, through the
    one-pass kernel with per-stream taps;
12. a render at hop 64: the kernels take hop 128 only, so it runs the
    plain path, launches nothing and equals ``fused=False``;
13. ambi_bin order 3 with FuMa channel order and normalisation (the
    conversion applied per chunk on the card): 3 chunks enqueued behind a
    spin kernel must not make the host wait for the device;
14. the panner slices: the 1° x 1° VBAP table (2-D for the planar 5.1
    layout, 3-D with dummies for 7.1.4) and the p-values designed on the
    host, then 64 streams x 4 sources, as phase 3, per layout;
15. the near-field binauraliser slice: phase 9's design, directions and
    head rotation plus distances uniform in 0.1-4 m (below the near-field
    limit, in the DVF range and beyond the far-field threshold), as
    phase 3;
16. the roombinauraliser slices: per source the default HRIR set with its
    directions rolled by a seeded shift, the design with the BRIR-derived
    diffuse-field EQ, then 16 sources per stream with head rotation, as
    phase 3, and 64 sources over 2 chunks;
17. ambi_enc: order 1, 64 sources, 8 chunks of 64 frames of 128 samples
    through ``process`` with the directions changing per chunk, held
    against a float64 numpy encode of the same frames; it must launch none
    of the six kernels;
18. parity with the compiled C reference on the card, one stream through
    the batched entry points in the goldens' own block sizes: panner
    (``pan``, ``pyr`` rotated, ``p2d`` planar), ambi_enc (``enc``),
    binauraliser_nf (``bnf``, ``bnfr`` rotated), roombinauraliser (``rb``,
    ``rbr`` rotated);
19. design checks: ``resample_hrirs`` against the C's resampled HRIRs (on
    the host), and ambi_bin with the SPR decoder against the C reference;
20. array2sh: the Tikhonov filters (Eigenmike32, order 4) against the C's
    on the host, then 16 recordings of 32 sensors encoded to order 4
    (800 channel pairs: ``analysis_front_ri`` at 512 rows, the einsum,
    ``synthesis_back_ri`` at 400 rows), as phase 3; phase 2 times both
    kernels at these shapes too;
21. ambi_dec's binaural preview: order 3 → 22.x → 2 ears, the HRTFs folded
    into a complex 16 → 2 decoder (``render_full_ri``), as phase 3; parity
    with the C (``adb``) through the batched path and through ``process``;
22. one listener with a head tracker: ``ambi_bin.process_ri`` and
    ``process`` at orders 3 and 7, blocks of 128 and 4096 samples, yaw,
    pitch and roll on the card and new every block (the SH rotation is built
    on the card per block): launches, wall, host enqueue and device time
    per block, the rotation's share, no block may make the host wait, and
    ``process_ri`` equals ``process_ri_batched`` with the rotation folded
    into the weights;
23. ambi_bin parity with the C through the single-stream entry points:
    order 4 at yaw = π, FuMa input with a general rotation (``abf``), the
    LS + diffuse-field-EQ and SPR decoders (``ab2``);
24. parity with the C for rotator, beamformer and the single-stream complex
    ``process`` of binauraliser (with TRI_PS: ``btp``), binauraliser_nf,
    roombinauraliser and panner.  Phases 22-24 launch none of the six
    kernels, as in the JAX package: those paths are plain torch;
25. the decorrelator, 4 channels x 16 streams (delays from the C's rand()
    stream): launches, kernel path vs ``fused=False`` (outputs and every
    state leaf), the warm chunks under ``set_sync_debug_mode("error")``,
    both paths timed, device and host ms per chunk; phase 2 times both
    kernels at its 64 rows (and at H = 1);
26. ambi_drc, order 3 x 64 streams, as phase 25 (1024 rows);
27. powermap, order 3, MUSIC, the 812-point geosphere and the 5° display
    table, 32 instances and 1, 8 chunks a call through ``analysis_chunks``,
    on scenes of two plane waves in diffuse noise, as phase 25; the eigh
    of the MUSIC map, the one host wait, let through and timed, and the
    device time taken by torch.profiler;
28. sldoa, order 3 on the 2562-point fit grid, 32 instances and 1, as
    phase 25 (directions compared as unit vectors, energy-weighted);
29. dirass, order 2 -> 6 on the t-design 18, all three modes: none of the
    six kernels, the warm blocks under the sync debug mode, the card's maps
    against the CPU's, wall, device and host ms per block;
30. parity with the C on the card at the JAX tests' tolerances: ``doa_*``
    (the maps through the (re, im) generators), ``dcr`` (rand() offset
    5016) and ``dkr``, ``drc``, ``pm``, ``pmp``, ``pmv``, ``pml``, ``pmc``,
    ``pmn``, ``sl_*``, ``dir``, ``dirn``, ``diro``, ``diru``; the
    decorrelator, ambi_drc and sldoa through their batched kernels too;
31. tvconv, 64 positions x 2 channels x 2048-tap IRs, hop 128, chunks of
    8192 samples: a moving listener (a new nearest position every chunk),
    a static one, 32 moving instances; none of the six kernels (the
    counters reset before, read after), the card against the CPU, the warm
    chunks under ``set_sync_debug_mode("error")`` (the crossfade rows are
    computed every chunk and selected on the card), wall and host enqueue
    ms per chunk, then device busy ms and launches per chunk by
    torch.profiler, audio-s/s;
32. ambi_roomsim, order 2, 2 sources, 1 receiver, reflection order 2, the
    default room and walls, 1 instance and 32, as phase 31;
33. HADES, binaural BMVDR with covariance matching, the default HRIRs
    [::4] as the 2-mic array, blocks of 1024: one instance at 64 blocks a
    call (plain, as phase 31) and 32 instances at 4 blocks a call through
    ``process_chunk_batched`` (one ``analysis_front_ri`` at 64 rows and
    one ``synthesis_back_ri`` at 64 rows a call), held against
    ``fused=False``: the front's tails and SCMs at KERNEL_TOL, the output
    and the mixing matrices printed (a DoA near tie flips with rounding:
    see CHAIN_TOL); as phase 25 otherwise;
34. the spreader, OM mode, 1 source, frames of 512: 32 frames a chunk for
    one instance (plain) and 8 frames for 32 instances through
    ``process_chunk``'s instance axis (the front at 32 rows, the back at
    64), as phase 33, its output held at CHAIN_TOL;
35. parity with the C on the card at the JAX tests' tolerances: ``mc_*``
    (both modes, and the (re, im) form), ``mtc_*``, ``tvc_*`` (both
    forms), ``ars`` (warm frames under the sync debug mode), ``cdf_*``
    (real and complex, with and without energy), ``hds``, ``hdt``,
    ``hdr``, ``hdh`` (diffuseness each block, DoA indices held equal) and
    ``spr_*`` in all three modes.  Phase 2 times both kernels at the
    HADES and spreader rows too;
36. the real-time runtime over the flagship: ``StreamRunner`` on the
    native FIFO framer and ring buffers (``runtime/native.py`` over the
    port's ``csrc/saf_runtime.cpp``, built with g++), 64 streams x 16 SH
    channels in, 64 x 2 ears out,
    frames of 1024 samples (H = 8 hops: ``render_full_ri`` once a frame),
    the host feeding blocks of 480 samples (10 ms), 2 s of audio,
    synchronously (``process_block``) and through the render thread
    (``push`` / ``pull``): the launches, the output against a direct loop
    of ``process_ri_batched`` delayed by one frame, wall ms per frame, the
    frame clock's real-time factor and the device-to-host read's share;
    the host pieces (the framer's push of a block, the rings' copies, the
    frame's staging into pinned memory in either layout);
    ``render_full_ri`` timed at (64, 16, 2, 8) too;
37. ``render_signal`` over the flagship: 64 streams, 8 blocks of 8192,
    bit-equal to a hand loop, ``render_full_ri`` 8 launches, the blocks
    under ``set_sync_debug_mode("error")``, and a ``trace_annotation`` span
    seen among torch.profiler's events;
38. the device grid (``parallel/mesh.py``) on the card's 1 x 1 grid over
    the flagship, 2 chunks: equal to the unsharded render;
39. the pitch shifter, 64 channels, fft 8192, osamp 16 (the defaults),
    blocks of 8192 samples, 2 s, a new shift factor on the card every
    block: none of the six kernels, the card against the CPU (printed),
    no host wait, wall, host and device ms per block;
40. QMF (hop 128, hybrid) and STFT (window 1024, hop 512) round trips of 64
    channels, as phase 39, the card against the CPU held at KERNEL_TOL;
41. parity with the C on the card: ``pitch_out_1p5`` / ``_0p5`` /
    ``_2p0`` (1e-3), ``qmf_spec`` (1e-3) and ``qmf_out``, the FuMa / ACN
    conversions on card tensors (``fuma_*``, ``acn_*``);
42. the flagship at 256 streams (the JAX benchmark's 256-stream cell,
    bench.py:786-804): one chunk of 8192 samples, ~170 MB of input with the
    carried tails, through ``process_ri_batched``: one ``render_full_ri``
    launch for all 256 streams (no group split), the kernel path against
    the plain path at KERNEL_TOL, device and host enqueue ms a chunk;
    ``render_full_ri`` timed at (256, 16, 2, 64).

Every phase checks its results and any failure exits non-zero.  The
second-to-last line is a JSON object describing each kernel; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device it exits non-zero
and prints no result.

Phase 2 begins with ``hrtf_taps_ri`` (the binauraliser's per-block taps
from its directions and poses) against its plain version, the torch chain
it replaced, run on the card, at small shapes and at 1024 streams x 64
sources in both interpolation modes, then timed there against its byte
bound; ``--hrtf-taps`` builds the kernels and runs that alone.  Then
``wide_mix_ri`` (the wide route's hybrid stage and per-band mix) against
its plain version, the torch glue it replaced, in every matrix form and
bank at small shapes and at the benchmark's wide cell (1024 streams, 16 →
22, H = 64), timed there against its byte bound; ``--wide-mix`` builds the
kernels and runs that alone.

Usage (from the repository root): ``python chip_smoke.py [--seed N]``;
``--profile`` instead profiles the ambi_bin order-3 and order-7, ambi_dec
22.x, non-hybrid 64 -> 2 and 64-source binauraliser main paths with
torch.profiler and prints each kernel's device time per chunk.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
KERNEL_TOL = 2e-5   # kernel vs plain, both fp32: only the order of sums differs
C_TOL = 1e-4        # vs the compiled C reference (tests/test_c_goldens.py)
N_STREAMS, HOPS, N_CHUNKS = 64, 64, 8
# the flagship's widest cell (bench.py:786-804)
WIDE_STREAMS = 256
# HADES and the spreader many instances a call, as the JAX benchmark runs
# them (bench.py:920, :1330): 32 instances of 32 hops a call (HADES 4 blocks
# of 1024, the spreader 8 frames of 512)
NB_INST, NB_HOPS = 32, 32
# the spreader's output (its solve / CDF4SAP chain), card vs CPU and kernel
# path vs plain, relative to max(1, |ref|): the C's own output moves 5.3e-4
# for a one-ulp input change (tests/test_c_goldens.py); two plain orders of
# the same front differ by 6.7e-5 on the CPU (scripts/chain_precision.py).
# Its mixing matrices are free on the rank-one prototype's null space:
# printed, not held.  HADES's output is not held either: its DoA is an
# argmin over the grid, and a near tie flips with float32 rounding (two
# plain orders of the front: 4.3e-3 in the output, from one band of one
# block, scripts/chain_precision.py); the covariances the front feeds are
# held at KERNEL_TOL on both.
CHAIN_TOL = 5e-4
# the array2sh slice: 16 Eigenmike32 recordings encoded to order 4
A2S_STREAMS, A2S_SENSORS, A2S_NSH = 16, 32, 25
# the analysers and the decorrelator, at the JAX benchmark's widths: the
# decorrelator 4 channels x 16 streams (64 rows), ambi_drc order 3 x 64
# streams (1024 rows), powermap and sldoa order 3 x 32 instances (512 rows)
DCR_STREAMS, DCR_CH = 16, 4
DRC_STREAMS, PM_INSTANCES, AN_ORDER = 64, 32, 3
# powermap's [0, 1]-normalised display maps, kernel path vs plain: its SCMs
# agree to KERNEL_TOL, and the map amplifies that through the eigh and the
# 1/x of MUSIC (tests/test_torch_powermap.py holds the JAX package's maps
# at the same 1e-4)
MAP_TOL = 1e-4
# dirass on the card vs on the CPU, [0, 1]-normalised maps and the states'
# energies and intensities: float32 sums in another order (5.5e-6 seen;
# the band-pass scan's pole-matrix powers are composed in float64 on the
# host, so the 100 Hz high-pass no longer amplifies rounding); the nearest
# mode's map is not held (a sector whose direction moves can land in the
# next display cell), its state is
DIRASS_TOL = 1e-4
FS = 48000.0
# analysis inputs at half full scale keep the spectra below |X| ~ 14, where
# KERNEL_TOL is ~10 float32 ulps (tests/test_torch_afstft_kernels.py)
ANA_AMP = 0.5
# wide_mix_ri's main path: the benchmark's ambi_dec_o3_22x.batch1024 block,
# 1024 streams, 16 -> 22, H = 64
MIX_STREAMS, MIX_CIN, MIX_COUT = 1024, 16, 22
# hrtf_taps_ri's main path: the benchmark's binauraliser_64src.track1024
# block, 1024 listeners x 64 head-tracked sources
TAPS_STREAMS, TAPS_SOURCES = 1024, 64
# a spin kernel of this many cycles (~0.2 s on an H100) holds the stream
# while a timed loop is enqueued, so the loop then runs back to back
SPIN_CYCLES = 400_000_000
# the kernels' calls with the dense C/S and A/B products, before their
# FFT-based redesigns (NVIDIA H100 80GB HBM3, 700 W; PERF.md): the flagship
# render_full_ri, and analysis_front_ri / synthesis_back_ri at the ambi_dec
# slice's shapes
EARLIER_RENDER_FULL_MS = 0.6558
EARLIER_FRONT_MS = 0.3861
EARLIER_BACK_MS = 0.6295
# ambi_enc vs a float64 encode: float32 products of 64 sources, relative to
# max(1, the reference's peak)
ENC_TOL = 1e-5
# a library call vs the kernel it is timed beside: both fp32 (cuDNN TF32
# off), relative to the kernel output's largest magnitude
LIB_TOL = 2e-5
# the least time of a kernel's work (bound_ms): H100 SXM peaks, HBM3 and
# fp32 outside the tensor cores (NVIDIA's data sheet at 700 W), against the bytes it must move (each input read once,
# each output written once, float32) and the operations its function needs:
# a 256-point real DFT or its inverse as an FFT (2.5 N log2 N), the 10-hop
# fold of a frame, the synthesis window and overlap-add per output sample
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
FFT_FLOP = 2.5 * 256 * 8
FOLD_FLOP = 2 * 5 * 256
OLA_FLOP = 2 * 10


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


def cuda_ms(fn, n: int, queued: bool = False) -> float:
    """Mean ms per call of ``fn`` over ``n`` calls, by CUDA events.
    ``queued``: the calls are enqueued behind a spin kernel, so the device
    runs them back to back whatever the host's speed (the device time of
    a call; fails if the host could not enqueue them within the spin)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    if queued:
        check(not start.query(), "the host fell behind the spin kernel")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def ab_times(fns: dict, n: int, warmup: int = 3, queued: bool = False) -> dict:
    """Times the two callables of ``fns`` ({"kernel": f, "plain": g}) in
    turns kernel, plain, plain, kernel, after a warm-up; returns
    {name: (mean ms, [ms per run])}.  ``queued``: the kernel's calls run
    behind a spin kernel (cuda_ms); the plain version's are timed as they
    come, since its hundreds of small launches a call overflow the launch
    queue behind a spin (its time is then at least its device time)."""
    for fn in fns.values():
        for _ in range(warmup):
            fn()
    runs = {name: [] for name in fns}
    for name in ("kernel", "plain", "plain", "kernel"):
        runs[name].append(cuda_ms(fns[name], n, queued and name == "kernel"))
    return {name: (float(np.mean(r)), r) for name, r in runs.items()}


def device_ms(fn, n: int):
    """``n`` calls of ``fn`` enqueued while a spin kernel holds the stream,
    so the device then runs them back to back → (device ms per call, host
    enqueue ms per call, whether the host finished enqueuing before the
    device started: False means a call waited for the device)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / n
    end.record()
    ahead = not start.query()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n, host, ahead


def uniform(rng, shape, dev, amp: float = 1.0) -> torch.Tensor:
    return torch.from_numpy(
        (amp * rng.uniform(-1.0, 1.0, shape)).astype(np.float32)).to(dev)


def chained_err(step, carry_k, carry_p, make_x, what: str) -> float:
    """Two chained calls of ``step(x, carry, kernel)`` → (outputs, carry)
    on both routes; returns the max |kernel − plain| over outputs and
    carries, after checking the kernel's outputs are finite and shaped as
    the plain version's."""
    err = 0.0
    for _ in range(2):
        x = make_x()
        ko, carry_k = step(x, carry_k, True)
        po, carry_p = step(x, carry_p, False)
        torch.cuda.synchronize()
        for k, p in zip(ko + (carry_k,), po + (carry_p,)):
            check(k.shape == p.shape and bool(torch.isfinite(k).all()),
                  f"{what}: kernel output not finite or misshapen")
            err = max(err, (k - p).abs().max().item())
    return err


def report_times(name: str, t: dict, card: str, shape: str) -> None:
    print(f"phase 2: {name} at {shape} [{card}]: kernel {t['kernel'][0]:.4f}"
          f" ms, plain {t['plain'][0]:.4f} ms per call (runs "
          f"{ {k: ['%.4f' % r for r in v[1]] for k, v in t.items()} })")


def library_time(name, call, pairs, card, what: str) -> tuple:
    """One PyTorch call computing the kernel's function on the same inputs
    (``call``; the port never makes it), held against the kernel first:
    ``pairs(out)`` gives (label, library tensor, kernel tensor) and each
    must agree to LIB_TOL of the kernel's largest magnitude.  Then timed by
    CUDA events → (mean ms, [ms per run])."""
    out = call()
    torch.cuda.synchronize()
    for label, lib, ker in pairs(out):
        scale = ker.abs().max().item()
        err = (lib - ker).abs().max().item()
        print(f"phase 2: {name} library yardstick {what}, {label}: max |err| "
              f"vs the kernel = {err:.3e} ({err / scale:.2e} of max |kernel| "
              f"{scale:.3e}; tol {LIB_TOL})")
        check(err <= LIB_TOL * scale,
              f"{name}: the library yardstick computes another function")
    for _ in range(3):
        call()
    runs = [cuda_ms(call, 20, queued=True) for _ in range(2)]
    print(f"phase 2: {name} library yardstick {what} [{card}]: "
          f"{np.mean(runs):.4f} ms per call (runs {['%.4f' % r for r in runs]})")
    return float(np.mean(runs)), runs


def stft_call(tail, x):
    """torch.stft of [tail | x] with the analysis window over 10 hops: bin
    5k of the 1280-point DFT of a windowed frame is bin k of the rDFT of
    its 256-sample fold, so [:, ::5] are the front's spectra."""
    from spatial_audio_framework_tpu_torch.ops.afstft import device_consts

    xx = torch.cat([tail, x], dim=1)
    w = device_consts(128, False, x.device)["w_ana"]
    return lambda: torch.stft(xx, n_fft=1280, hop_length=128, window=w,
                              center=False, return_complex=True)


def phase_render_full(ak, dev, rng, card):
    """render_full_ri vs render_full_ri_reference at small shapes with
    every option (per-stream taps, low-delay and non-hybrid banks, H = 1),
    at the binauraliser and panner slices' shapes (per-stream taps, cin 4,
    cout 2, 5 and 11) and at the flagship's; the last four timed.  Returns
    the max error and the flagship-shape times."""
    worst = 0.0
    # S, cin, cout, H, low_delay, per_stream, hybrid
    cases = ((3, 4, 2, 4, False, False, True),
             (2, 4, 2, 1, False, True, True),
             (3, 5, 2, 9, True, False, True),
             (2, 5, 2, 40, False, False, False),
             (2, 3, 1, 33, True, True, False),
             # cin the cluster of min(4, cin) blocks does not divide
             (2, 1, 2, 31, False, False, True),
             (2, 7, 1, 33, False, True, True),
             (2, 6, 3, 64, True, False, True),
             (1, 127, 1, 5, False, False, False),
             (1, 64, 2, 64, False, False, True),
             # cout above 3: ear passes of 2, 2, .., 1
             (2, 4, 5, 33, False, False, True),
             (2, 4, 5, 9, False, True, True),
             (2, 4, 11, 33, False, False, True),
             (1, 4, 11, 9, True, True, True),
             (N_STREAMS, 4, 2, HOPS, False, True, True),
             # the panner slices: 5.1 and 7.1.4, three and six ear passes
             (N_STREAMS, 4, 5, HOPS, False, True, True),
             (N_STREAMS, 4, 11, HOPS, False, True, True),
             (N_STREAMS, 16, 2, HOPS, False, False, True))
    for S, cin, cout, H, ld, ps, hyb in cases:
        taps = random_taps(ak, rng, S, cin, cout, ps, hyb, dev)
        kw = dict(low_delay=ld, per_stream=ps, hybrid=hyb)
        in_tail = uniform(rng, (S, cin, 15 * 128), dev)
        state = {True: in_tail, False: in_tail}

        def step(x, tail, kernel):
            fn = ak.render_full_ri if kernel else ak.render_full_ri_reference
            y, new_tail = fn(state[kernel], x, tail, taps, **kw)
            state[kernel] = torch.cat([state[kernel], x],
                                      dim=-1)[..., H * 128:].contiguous()
            return (y,), new_tail

        ola = uniform(rng, (S, cout, 9, 128), dev)
        err = chained_err(step, ola, ola,
                          lambda: uniform(rng, (S, cin, H * 128), dev),
                          "render_full_ri")
        print(f"phase 2: render_full_ri vs plain at (S, cin, cout, H, "
              f"low_delay, per_stream, hybrid) = {(S, cin, cout, H, ld, ps, hyb)}"
              f": max |err| = {err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"render_full_ri disagrees with plain: {err}")
        worst = max(worst, err)
        if S == N_STREAMS:
            x = uniform(rng, (S, cin, H * 128), dev)
            t = ab_times({
                "kernel": lambda: ak.render_full_ri(in_tail, x, ola, taps,
                                                    **kw),
                "plain": lambda: ak.render_full_ri_reference(
                    in_tail, x, ola, taps, **kw)}, 20, queued=True)
            b = render_full_bound(S, cin, cout, H, ps)
            report_times("render_full_ri", t, card,
                         "the flagship shape (with the dense DFT "
                         f"products: {EARLIER_RENDER_FULL_MS} ms)"
                         if cin == 16 else
                         f"{(S, cin, cout, H)}, per-stream taps ("
                         + {2: "the binauraliser", 5: "the panner 5.1",
                            11: "the panner 7.1.4"}[cout]
                         + f" slice; bound {b['bound_ms']:.4f} ms by "
                         f"{b['bound_by']})")
    return worst, t


def phase_analysis_front(ak, dev, rng, card):
    """analysis_front_ri vs its plain version; rows, tail hops, H, low
    delay: one short tile (H = 1), the least tail, four tiles (130 and 136
    frames), odd rows past the persistent grid.  The last two cases are
    timed: the decorrelator (16 streams x 4 channels), the array2sh slice
    (16 streams x 32 sensors), the ambi_dec slice (64 streams x 16
    channels), and at 32 hops HADES x 32 (64 rows) and the spreader x 32
    (32 rows).  Returns the max error and the times by (rows, H)."""
    worst = 0.0
    timed = {(DCR_STREAMS * DCR_CH, HOPS): "the decorrelator's shape",
             (A2S_STREAMS * A2S_SENSORS, HOPS):
                 "the array2sh slice's shape (and powermap / sldoa x 32)",
             (N_STREAMS * 16, HOPS):
                 "the ambi_dec slice's shape (and ambi_drc; with "
                 f"the dense C/S product: {EARLIER_FRONT_MS} ms)",
             (NB_INST * 2, NB_HOPS): "HADES x 32's shape (2 mics)",
             (NB_INST, NB_HOPS): "the spreader x 32's shape (1 source)"}
    times = {}
    cases = ((5, 15, 4, False), (3, 9, 2, True), (7, 15, 40, True),
             (3, 15, 1, False), (5, 9, 4, True), (7, 9, 130, False),
             (3, 15, 130, True), (1027, 15, HOPS, False),
             (DCR_STREAMS * DCR_CH, 15, 1, False),
             (DCR_STREAMS * DCR_CH, 15, HOPS, False),
             (A2S_STREAMS * A2S_SENSORS, 15, HOPS, False),
             (N_STREAMS * 16, 15, HOPS, False),
             (NB_INST * 2, 15, NB_HOPS, False), (NB_INST, 15, NB_HOPS, False))
    for rows, t_hops, H, ld in cases:
        def step(x, tail, kernel):
            fn = (ak.analysis_front_ri if kernel
                  else ak.analysis_front_ri_reference)
            out = fn(tail, x, low_delay=ld)
            return out, torch.cat([tail, x], dim=-1)[:, H * 128:].contiguous()

        tail = uniform(rng, (rows, t_hops * 128), dev, ANA_AMP)
        err = chained_err(
            step, tail, tail,
            lambda: uniform(rng, (rows, H * 128), dev, ANA_AMP),
            "analysis_front_ri")
        print(f"phase 2: analysis_front_ri vs plain at (rows, tail hops, H, "
              f"low_delay) = {(rows, t_hops, H, ld)}: max |err| = "
              f"{err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL,
              f"analysis_front_ri disagrees with plain: {err}")
        worst = max(worst, err)
        if (rows, H) not in timed:
            continue
        x = uniform(rng, (rows, H * 128), dev, ANA_AMP)
        t = ab_times({"kernel": lambda: ak.analysis_front_ri(tail, x),
                      "plain": lambda: ak.analysis_front_ri_reference(tail,
                                                                      x)},
                     20, queued=True)
        report_times("analysis_front_ri", t, card, timed[rows, H])
        re, im = ak.analysis_front_ri(tail, x)

        def pairs(out):
            spec = out[:, ::5].transpose(1, 2)
            return [("re", spec.real, re), ("im", spec.imag, im)]

        t["library"] = library_time(
            "analysis_front_ri", stft_call(tail, x), pairs, card,
            f"torch.stft(n_fft=1280)[:, ::5] at {rows} rows")
        times[rows, H] = t
    return worst, times


def phase_synthesis_back(ak, dev, rng, card):
    """synthesis_back_ri vs its plain version; rows, H, low delay, hybrid:
    one frame, H < 9, 17 steps of 8 frames (H = 130), odd rows.  Timed at
    H = 64: the decorrelator (16 streams x 4 channels: 64 one-row blocks),
    the array2sh slice (16 streams x 25 SH channels), ambi_drc (64 streams
    x 16) and the ambi_dec slice (64 streams x 22 loudspeakers); at 32
    hops HADES x 32 and the spreader x 32 (64 rows: 32 instances x 2
    ears).  Returns the max error and the times by (rows, H)."""
    worst = 0.0
    timed = {(DCR_STREAMS * DCR_CH, HOPS): "the decorrelator's shape",
             (A2S_STREAMS * A2S_NSH, HOPS): "the array2sh slice's shape",
             (DRC_STREAMS * 16, HOPS): "ambi_drc's shape",
             (N_STREAMS * 22, HOPS):
                 "the ambi_dec slice's shape (with the dense "
                 f"[P.A; P.B] product: {EARLIER_BACK_MS} ms)",
             (NB_INST * 2, NB_HOPS): "HADES x 32's and the spreader x 32's "
                                     "shape"}
    times = {}
    cases = ((5, 4, False, True), (3, 1, True, True), (6, 9, False, False),
             (4, 33, True, False), (3, 1, False, False), (5, 4, True, True),
             (7, 130, False, True), (2, 130, True, False),
             (1411, HOPS, False, True),
             (DCR_STREAMS * DCR_CH, 1, False, True),
             (DCR_STREAMS * DCR_CH, HOPS, False, True),
             (A2S_STREAMS * A2S_NSH, HOPS, False, True),
             (DRC_STREAMS * 16, HOPS, False, True),
             (N_STREAMS * 22, HOPS, False, True),
             (NB_INST * 2, NB_HOPS, False, True))
    for rows, H, ld, hyb in cases:
        K = 2 * (133 if hyb else 129)

        def step(spec, tail, kernel):
            fn = (ak.synthesis_back_ri if kernel
                  else ak.synthesis_back_ri_reference)
            y, new_tail = fn(spec, tail, low_delay=ld, hybrid=hyb)
            return (y,), new_tail

        tail = uniform(rng, (rows, 9, 128), dev)
        err = chained_err(step, tail, tail,
                          lambda: uniform(rng, (rows, H, K), dev, 10.0),
                          "synthesis_back_ri")
        print(f"phase 2: synthesis_back_ri vs plain at (rows, H, low_delay, "
              f"hybrid) = {(rows, H, ld, hyb)}: max |err| = {err:.3e} "
              f"(tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL,
              f"synthesis_back_ri disagrees with plain: {err}")
        worst = max(worst, err)
        if (rows, H) in timed:
            times[rows, H] = time_synthesis_back(ak, dev, rng, card, rows, H,
                                                 K, tail, timed[rows, H])
    return worst, times


def time_synthesis_back(ak, dev, rng, card, rows, H, K, tail, shape):
    """synthesis_back_ri (hybrid, normal delay) and its plain version timed
    at (rows, H, K), and ``F.conv_transpose1d`` as the library call."""
    spec = uniform(rng, (rows, H, K), dev, 10.0)
    t = ab_times({"kernel": lambda: ak.synthesis_back_ri(spec, tail),
                  "plain": lambda: ak.synthesis_back_ri_reference(spec, tail)},
                 20, queued=True)
    report_times("synthesis_back_ri", t, card, shape)
    y, new_tail = ak.synthesis_back_ri(spec, tail)
    # the basis of each packed bin over the 10 hops a frame reaches:
    # frame half k % 2 times the synthesis window's hop k
    c = ak._syn_consts(128, False, True, dev)
    ws = c["w_syn"].reshape(10, 128)
    W = torch.stack([c["AB"][:, (k % 2) * 128:(k % 2 + 1) * 128] * ws[k]
                     for k in range(10)], dim=1).reshape(K, 1, 1280)
    inp = spec.transpose(1, 2).contiguous()

    def conv():
        return torch.nn.functional.conv_transpose1d(inp, W, stride=128)

    def pairs(out):
        yf = out[:, 0]
        y_lib = yf[:, :H * 128].clone()
        y_lib[:, :9 * 128] += tail.reshape(rows, -1)
        return [("y", y_lib.reshape(rows, H, 128), y),
                ("new tail", yf[:, H * 128:].reshape(rows, 9, 128), new_tail)]

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        t["library"] = library_time(
            "synthesis_back_ri", conv, pairs, card,
            f"F.conv_transpose1d(stride=128) at {rows} rows, cuDNN TF32 off "
            "(the 9-hop tail add not timed)")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    return t


def phase_analysis_front_dg(ak, dev, rng, card):
    """analysis_front_dg_ri vs its plain version; rows, H, low delay, with
    the renderers' 15-hop tail.  The last case is the order-7 slice: 64
    streams x 64 channels."""
    worst = 0.0
    cases = ((5, 4, False), (3, 1, True), (7, 40, True), (3, 31, False),
             (2, 65, True), (2, 130, False), (N_STREAMS * 64, HOPS, False))
    for rows, H, ld in cases:
        def step(x, tail, kernel):
            fn = (ak.analysis_front_dg_ri if kernel
                  else ak.analysis_front_dg_ri_reference)
            out = fn(tail, x, low_delay=ld)
            return out, torch.cat([tail, x], dim=-1)[:, H * 128:].contiguous()

        tail = uniform(rng, (rows, 15 * 128), dev, ANA_AMP)
        err = chained_err(
            step, tail, tail,
            lambda: uniform(rng, (rows, H * 128), dev, ANA_AMP),
            "analysis_front_dg_ri")
        print(f"phase 2: analysis_front_dg_ri vs plain at (rows, H, "
              f"low_delay) = {(rows, H, ld)}: max |err| = {err:.3e} "
              f"(tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL,
              f"analysis_front_dg_ri disagrees with plain: {err}")
        worst = max(worst, err)
    x = uniform(rng, (rows, H * 128), dev, ANA_AMP)
    t = ab_times({"kernel": lambda: ak.analysis_front_dg_ri(tail, x),
                  "plain": lambda: ak.analysis_front_dg_ri_reference(tail,
                                                                     x)},
                 20, queued=True)
    report_times("analysis_front_dg_ri", t, card, "the order-7 slice's shape")
    d_re, d_im, _, _ = ak.analysis_front_dg_ri(tail, x)

    def pairs(out):
        d = out[:, ::5, 3:3 + H].transpose(1, 2)
        return [("d re", d.real, d_re), ("d im", d.imag, d_im)]

    t["library"] = library_time(
        "analysis_front_dg_ri", stft_call(tail, x), pairs, card,
        "torch.stft(n_fft=1280)[:, ::5] (d only; g not included)")
    return worst, t


def random_taps(ak, rng, S, cin, cout, per_stream, hybrid, dev):
    """decode_taps of random matrices, scaled by √(16/cin) above 16 inputs
    so that wide renders keep the flagship's output scale."""
    shape = ((S,) if per_stream else ()) + (133 if hybrid else 129, cout, cin)
    M = uniform(rng, (2,) + shape, dev, min(1.0, (16 / cin) ** 0.5))
    return ak.decode_taps(M[0], M[1], hybrid=hybrid).contiguous()


def phase_render_decode(ak, dev, rng, card, dg):
    """render_decode_synthesis_ri (``dg`` False: from the front's H+6-hop
    spectra) or render_decode_synthesis_dg_ri (from the (d, g) pair) vs its
    plain version; inputs are the plain front's output on half-scale noise.
    The last case is its main path's shape: 64 streams, cin 64, 2 ears
    (the order-7 slice for the (d, g) pair, the non-hybrid phase for the
    spectra)."""
    name = ("render_decode_synthesis_dg_ri" if dg
            else "render_decode_synthesis_ri")
    kern, plain = getattr(ak, name), getattr(ak, f"{name}_reference")
    front = (ak.analysis_front_dg_ri_reference if dg
             else ak.analysis_front_ri_reference)
    # S, cin, cout, H, low_delay, per_stream, hybrid
    cases = ((3, 5, 2, 4, False, False, True),
             (2, 25, 2, 1, True, True, True),
             (2, 17, 3, 9, False, True, False),
             (1, 64, 2, 40, True, False, False),
             # the most ears the dispatch sends (cin >= 17: cout <= 7)
             (2, 17, 7, 9, False, False, True),
             (2, 17, 7, 4, True, True, False),
             (1, 25, 5, 17, True, True, True),
             (1, 25, 5, 17, False, False, False),
             # S * cin odd at H = 1, 9, 130: rows of 129 floats that start
             # off a 16-byte boundary
             (3, 5, 2, 1, True, False, True),
             (1, 5, 3, 9, False, True, True),
             (1, 17, 2, 130, False, False, True),
             (1, 5, 2, 9, False, False, False),
             (1, 17, 3, 130, True, False, False),
             # 360 (stream, tile) pairs: more than stay resident at once
             (40, 5, 2, 130, False, False, True),
             (N_STREAMS, 64, 2, HOPS, False, False, dg))
    worst = 0.0
    for S, cin, cout, H, ld, ps, hyb in cases:
        if dg and not hyb:
            continue                       # the (d, g) pair is hybrid only
        taps = random_taps(ak, rng, S, cin, cout, ps, hyb, dev)
        kw = dict(low_delay=ld, per_stream=ps)
        if not dg:
            kw["hybrid"] = hyb

        def make_x():
            out = front(uniform(rng, (S * cin, 15 * 128), dev, ANA_AMP),
                        uniform(rng, (S * cin, H * 128), dev, ANA_AMP),
                        low_delay=ld)
            return [t.reshape(S, cin, -1, t.shape[-1]).contiguous()
                    for t in out]

        def step(spec, tail, kernel):
            y, new_tail = (kern if kernel else plain)(*spec, tail, taps, **kw)
            return (y,), new_tail

        ola = uniform(rng, (S, cout, 9, 128), dev)
        err = chained_err(step, ola, ola, make_x, name)
        print(f"phase 2: {name} vs plain at (S, cin, cout, H, low_delay, "
              f"per_stream, hybrid) = {(S, cin, cout, H, ld, ps, hyb)}: "
              f"max |err| = {err:.3e} (tol {KERNEL_TOL})")
        check(err <= KERNEL_TOL, f"{name} disagrees with plain: {err}")
        worst = max(worst, err)
    spec = make_x()
    (y1, t1), (y2, t2) = (kern(*spec, ola, taps, **kw) for _ in range(2))
    check(torch.equal(y1, y2) and torch.equal(t1, t2),
          f"{name}: two launches on the same inputs differ")
    print(f"phase 2: {name}: two launches at its main path's shape agree "
          "bit for bit")
    t = ab_times({"kernel": lambda: kern(*spec, ola, taps, **kw),
                  "plain": lambda: plain(*spec, ola, taps, **kw)}, 20,
                 queued=True)
    report_times(name, t, card, "(S, cin, cout, H) = "
                 f"{(N_STREAMS, 64, 2, HOPS)}")
    return worst, t


def phase_slice(name, phase, process, init_state, n_in, n_out, ak, dev, rng,
                card, expect, n_chunks=N_CHUNKS, queued_chunks=None,
                n_streams=N_STREAMS):
    """A main path: ``n_chunks`` chunks through ``process(state, x,
    fused)`` with every launch counter reset just before and read just
    after (``expect``: the
    launches each kernel must show), held against the plain path, then both
    paths timed, and the kernel path's device time with the host out of
    the way; fails if a chunk makes the host wait for the device (e.g. a
    host-to-device copy).  ``queued_chunks``: how many chunks that last
    measurement enqueues behind the spin kernel (default all): a path of
    more than ~120 launches a chunk would fill the launch queue of 1024
    entries with 8 chunks, and the host would then wait for the spin, not
    for a copy.  ``n_streams``: the streams a chunk holds.  Returns the
    launch counts."""
    T = HOPS * 128
    xs = [uniform(rng, (n_streams, n_in, T), dev) for _ in range(n_chunks)]

    def run(fused):
        st = init_state()
        ys = []
        for x in xs:
            y, st = process(st, x, fused)
            ys.append(y)
        return ys, st

    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    ys_k, st_k = run(True)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    print(f"phase {phase}: {name} main path ran {n_chunks} chunks of "
          f"{(n_streams, n_in, T)}; launches = {launches}")
    expect = {k: expect.get(k, 0) for k in ak.KERNELS}
    check(launches == expect, f"{name}: expected launches {expect}")
    ys_p, st_p = run(False)
    torch.cuda.synchronize()
    err = 0.0
    for yk, yp in zip(ys_k, ys_p):
        check(tuple(yk.shape) == (n_streams, n_out, T), f"y shape {yk.shape}")
        check(bool(torch.isfinite(yk).all()), "non-finite output")
        err = max(err, (yk - yp).abs().max().item())
    err = max(err, (st_k.ola_tail - st_p.ola_tail).abs().max().item())
    check(torch.equal(st_k.in_tail, st_p.in_tail), "in_tail differs")
    print(f"phase {phase}: {name} kernel path vs plain path over {n_chunks} "
          f"chunks: max |err| = {err:.3e} (tol {KERNEL_TOL})")
    check(err <= KERNEL_TOL, f"{name} disagrees with the plain path: {err}")

    state = {True: init_state(), False: init_state()}
    it = {True: 0, False: 0}

    def step(fused):
        _, state[fused] = process(state[fused], xs[it[fused] % n_chunks],
                                  fused)
        it[fused] += 1

    t = ab_times({"kernel": lambda: step(True), "plain": lambda: step(False)},
                 n_chunks, warmup=2)
    audio_s = n_streams * T / FS
    for path in ("kernel", "plain"):
        ms, runs = t[path]
        print(f"phase {phase}: {name} chunk, {path} path [{card}]: "
              f"{ms:.4f} ms per chunk of {n_streams} streams x {T} samples "
              f"= {audio_s / (ms / 1e3):.1f} audio-seconds per second "
              f"(runs {['%.4f' % r for r in runs]})")
    runs = [device_ms(lambda: step(True), queued_chunks or n_chunks)
            for _ in range(3)]
    dev_ms, host_ms = (float(np.median([r[i] for r in runs])) for i in (0, 1))
    ahead = all(r[2] for r in runs)
    print(f"phase {phase}: {name} kernel path [{card}]: device {dev_ms:.4f} "
          f"ms per chunk back to back, host enqueue {host_ms:.4f} ms per "
          f"chunk (medians of runs {[('%.4f' % r[0], '%.4f' % r[1]) for r in runs]}"
          f"), so the device idles {100 * (1 - dev_ms / t['kernel'][0]):.1f} "
          f"% of the {t['kernel'][0]:.4f} ms chunk; host enqueued ahead of "
          f"the device: {ahead}")
    check(ahead, f"{name}: a chunk made the host wait for the device")
    return launches


def phase_ambi_bin_c_parity(ambi_bin, ri, sh, geo, ak, dev, card):
    """Order 4 (cin = 25): the default dispatch takes the (d, g) pair; the
    one-pass route is run too.  The launch counters show which ran."""
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
    n_blocks = x.shape[-1] // 512
    routes = {
        "default": (lambda st, xb: ambi_bin.process_ri_batched(cfg, w, st,
                                                               xb),
                    ("analysis_front_dg_ri", "render_decode_synthesis_dg_ri")),
        "one-pass": (lambda st, xb: ri._render_one_pass(cfg.afstft, st, xb,
                                                        *w),
                     ("render_full_ri",))}
    for route, (process, kernels) in routes.items():
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        st = ambi_bin.init_state_batched(cfg, 1, dev)
        outs = []
        for f in range(n_blocks):
            y, st = process(st, x[..., f * 512:(f + 1) * 512].contiguous())
            outs.append(y[0])
        out = torch.cat(outs, dim=-1).cpu().numpy()
        ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
        err = float(np.abs(out - g["ambi_bin_out"]).max())
        print(f"phase 4: ambi_bin order 4 vs the C reference on the card, "
              f"{route} route [{card}]: max |err| = {err:.3e} (tol {C_TOL}); "
              f"launches = { {k: n for k, n in ran.items() if n} }")
        check(ran == {k: n_blocks if k in kernels else 0 for k in ak.KERNELS},
              f"C parity, {route} route: launches {ran}")
        check(np.isfinite(out).all() and err <= C_TOL,
              f"C parity, {route} route: {err}")


def phase_routes(ri, cases, dev, rng, card):
    """The one-pass route (_render_one_pass) vs the two-kernel route
    (_render_two_pass) on the same chunk and state, timed in turns with
    CUDA events behind a spin kernel (device time per call, as phase 2);
    ``cases``: [(label, cfg, weights)]."""
    for label, cfg, w in cases:
        bank = cfg.afstft
        x = uniform(rng, (N_STREAMS, cfg.nsh, HOPS * 128), dev)
        st = ri.init_state_batched(bank, N_STREAMS, cfg.nsh, 2, dev)
        fns = {"one-pass": lambda: ri._render_one_pass(bank, st, x, *w),
               "two-kernel": lambda: ri._render_two_pass(bank, st, x, *w)}
        diff = (fns["one-pass"]()[0] - fns["two-kernel"]()[0]).abs().max()
        for fn in fns.values():
            fn()
        runs = {name: [] for name in fns}
        for name in ("one-pass", "two-kernel", "two-kernel", "one-pass") * 3:
            runs[name].append(cuda_ms(fns[name], N_CHUNKS, queued=True))
        print(f"phase 7: routes at {label} (cin {cfg.nsh}) [{card}]: "
              + ", ".join(f"{name} {np.mean(r):.4f} ms per chunk (runs "
                          f"{['%.4f' % v for v in r]})"
                          for name, r in runs.items())
              + f"; max |one-pass − two-kernel| = {diff.item():.3e}")
        check(diff.item() <= 2 * KERNEL_TOL,
              f"routes disagree at {label}: {diff.item()}")


def phase_ambi_dec_c_parity(ambi_dec, ak, dev, card):
    """dec_e2e: order 3 → the golden 9-loudspeaker layout (cout·cin = 144,
    the analysis/synthesis kernels), H = 1 per block."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    cfg = ambi_dec.AmbiDecConfig(master_order=3, norm="n3d",
                                 dec_method=("allrad", "allrad"),
                                 re_weight=(False, True),
                                 transition_freq=800.0)
    w = ambi_dec.design_ri(cfg, np.asarray(g["dec_e2e_ls_dirs"], np.float64),
                           device=dev)
    x = torch.from_numpy(np.asarray(g["dec_e2e_in"], np.float32))[None].to(dev)
    st = ambi_dec.init_state_batched(cfg, 1, 9, dev)
    before = ak.analysis_front_ri.launches
    outs = []
    for f in range(x.shape[-1] // 128):
        y, st = ambi_dec.process_ri_batched(
            cfg, w, st, x[..., f * 128:(f + 1) * 128].contiguous())
        outs.append(y[0])
    out = torch.cat(outs, dim=-1).cpu().numpy()
    err = float(np.abs(out - g["dec_e2e_out"]).max())
    n = ak.analysis_front_ri.launches - before
    print(f"phase 6: ambi_dec dec_e2e (order 3 -> 9 LS, {n} blocks through "
          f"the kernels) vs the C reference on the card [{card}]: max |err| "
          f"= {err:.3e} (tol {C_TOL})")
    check(n == x.shape[-1] // 128, "C parity run bypassed the kernels")
    check(np.isfinite(out).all() and err <= C_TOL, f"C parity: {err}")


def design_binauraliser_from_sofa(binauraliser, hrir, sofa, cfg, dev):
    """The default HRIR set written to a SOFA file in a temporary directory
    with ``sofa_save``, read back with ``sofa_open`` (checked against the
    set) and designed from → the weights on ``dev``."""
    h, dirs, fs = hrir.default_hrirs()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "default_hrirs.sofa")
        sofa.sofa_save(path, np.asarray(h, np.float64), float(fs),
                       np.concatenate([dirs, np.ones((len(dirs), 1))], 1))
        c = sofa.sofa_open(path, usecase=sofa.USECASE_HRIR)
    check(c.n_receivers == 2 and np.array_equal(c.data_ir, h)
          and np.array_equal(c.source_dirs_deg(), dirs)
          and c.data_sampling_rate == fs,
          "the SOFA round trip changed the HRIR set")
    return binauraliser.design_ri(cfg, hrirs=c.data_ir,
                                  hrir_dirs_deg=c.source_dirs_deg(),
                                  hrir_fs=int(c.data_sampling_rate),
                                  device=dev), c


def phase_hrtf_taps(binauraliser, w, ak, dev, rng, card) -> dict:
    """hrtf_taps_ri vs its plain version (the torch chain it replaced, on
    the card) at small shapes and at its main path's (TAPS_STREAMS x
    TAPS_SOURCES, rotation), both interpolation modes, on the default
    HRIR set's weights ``w``; then timed there (kernel behind a spin,
    plain as it comes) against its byte bound.  A source whose rotated
    direction lies on a table step's rounding boundary may round to the
    next row on one side: such sources are counted (at most 2, or 0.05 %
    of a shape's), the rest held to 1e-6 of the largest tap."""
    err, flips = 0.0, 0
    for S, n, mode, rot in ((1, 1, "tri", False), (5, 17, "tri_ps", True),
                            (TAPS_STREAMS, TAPS_SOURCES, "tri", True),
                            (TAPS_STREAMS, TAPS_SOURCES, "tri_ps", True)):
        cfg = binauraliser.BinauraliserConfig(n_sources=n, interp_mode=mode,
                                              enable_rotation=rot)
        dirs = uniform(rng, (S, n, 2), dev) * torch.tensor([180.0, 90.0],
                                                           device=dev)
        ypr = uniform(rng, (S, 3), dev, amp=np.pi)
        k = ak.hrtf_taps_ri(cfg, w, dirs, ypr)
        p = ak.hrtf_taps_ri_reference(cfg, w, dirs, ypr)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(k).all()), "hrtf_taps_ri: taps not finite")
        scale = p.abs().max().item()
        pair = (k - p).abs().amax(dim=(2, 3, 4))
        off = pair > 1e-6 * scale
        n_off = int(off.sum().item())
        flips += n_off
        check(n_off <= max(2, 5e-4 * S * n),
              f"hrtf_taps_ri ({S}, {n}, {mode}): {n_off} sources off the "
              "plain version")
        e = pair[~off].max().item()
        err = max(err, e / scale)
        print(f"phase 2: hrtf_taps_ri ({S} streams, {n} sources, {mode}, "
              f"rotation {rot}) vs plain on the card: max |err| = {e:.3e} "
              f"({e / scale:.2e} of the largest tap), {n_off} sources on a "
              "row boundary")
    cfg = binauraliser.BinauraliserConfig(n_sources=TAPS_SOURCES,
                                          enable_rotation=True)
    dirs = uniform(rng, (TAPS_STREAMS, TAPS_SOURCES, 2), dev) * 90.0
    ypr = uniform(rng, (TAPS_STREAMS, 3), dev)
    t = ab_times({"kernel": lambda: ak.hrtf_taps_ri(cfg, w, dirs, ypr),
                  "plain": lambda: ak.hrtf_taps_ri_reference(cfg, w, dirs,
                                                             ypr)},
                 20, queued=True)
    pairs, n_dirs = TAPS_STREAMS * TAPS_SOURCES, w.hrtf_mag_by_dir.shape[0]
    # the controls and the (re, im) table read once, the taps written once
    b = bound(pairs * 2 + TAPS_STREAMS * 3 + 2 * n_dirs * 2 * 133,
              pairs * 2 * 4 * 129, 0.0)
    shape = f"({TAPS_STREAMS}, {TAPS_SOURCES}), tri, rotation"
    report_times("hrtf_taps_ri", t, card, shape)
    print(f"phase 2: hrtf_taps_ri at {shape} [{card}]: kernel "
          f"{t['kernel'][0]:.4f} ms, bound {b['bound_ms']:.4f} ms (bytes; "
          f"{100 * b['bound_ms'] / t['kernel'][0]:.1f} % of the kernel's "
          f"time), plain {t['plain'][0]:.4f} ms")
    return {"name": "hrtf_taps_ri", "route": "cuda",
            "source": "spatial_audio_framework_tpu_torch/csrc/"
                      "hrtf_taps_ri.cu",
            "replaces": "the torch chain rotate_dirs -> interp_hrtfs_ri -> "
                        "decode_taps (no TPU kernel)",
            "shape": shape, "max_rel_err": err,
            "sources_on_a_row_boundary": flips, "ms": t["kernel"][0],
            "plain_ms": t["plain"][0], **b, "library_ms": None}


def phase_wide_mix(ak, dev, rng, card) -> dict:
    """wide_mix_ri vs its plain version (the wide route's torch glue, on
    the card) in each matrix form (real or complex, shared or per stream)
    and bank, at small shapes and at its main path's (MIX_STREAMS x
    MIX_CIN -> MIX_COUT, H = HOPS, real, shared), within KERNEL_TOL of the
    largest output; then timed there (kernel behind a spin, plain as it
    comes) against its byte bound."""
    def inputs(S, cin, cout, H, complex_m, per_stream, nb):
        spec = [uniform(rng, (S * cin, H + 6, 129), dev, 14.0)
                for _ in range(2)]
        shape = ((S,) if per_stream else ()) + (nb, cout, cin)
        M = [uniform(rng, shape, dev, cin ** -0.5)
             for _ in range(2 if complex_m else 1)]
        return spec, M[0], M[1] if complex_m else None

    err = 0.0
    for S, cin, cout, H, complex_m, per_stream, hybrid in (
            (3, 16, 22, 5, False, False, True),
            (2, 16, 22, 9, True, False, True),
            (3, 65, 2, 8, True, True, True),
            (2, 20, 7, 1, False, True, False),
            (A2S_STREAMS, A2S_SENSORS, A2S_NSH, HOPS, True, False, True),
            (MIX_STREAMS, MIX_CIN, MIX_COUT, HOPS, False, False, True)):
        (sre, sim), Mre, Mim = inputs(S, cin, cout, H, complex_m, per_stream,
                                      133 if hybrid else 129)
        k = ak.wide_mix_ri(sre, sim, Mre, Mim, hybrid=hybrid)
        p = ak.wide_mix_ri_reference(sre, sim, Mre, Mim, hybrid=hybrid)
        torch.cuda.synchronize()
        check(k.shape == p.shape and bool(torch.isfinite(k).all()),
              "wide_mix_ri: output not finite or misshapen")
        e = ((k - p).abs().max() / p.abs().max()).item()
        err = max(err, e)
        print(f"phase 2: wide_mix_ri ({S} streams, {cin} -> {cout}, H {H}, "
              f"{'complex' if complex_m else 'real'}, "
              f"{'per stream' if per_stream else 'shared'}, "
              f"{'hybrid' if hybrid else 'non-hybrid'}) vs plain on the "
              f"card: max |err| = {e:.3e} of the largest output")
        check(e <= KERNEL_TOL, f"wide_mix_ri disagrees with the plain "
                               f"version: {e}")
        del k, p
    t = ab_times({"kernel": lambda: ak.wide_mix_ri(sre, sim, Mre, Mim),
                  "plain": lambda: ak.wide_mix_ri_reference(sre, sim, Mre,
                                                            Mim)},
                 10, queued=True)
    S, cin, cout, H = MIX_STREAMS, MIX_CIN, MIX_COUT, HOPS
    # the front's spectra read once, the packed rows written once, the
    # real matrix read once; 2 flop a real product, re and im
    b = bound(2 * S * cin * (H + 6) * 129 + 133 * cout * cin,
              S * cout * H * 2 * 133, S * cout * cin * H * 133 * 4)
    shape = f"({S}, {cin} -> {cout}, H {H}), real, shared"
    report_times("wide_mix_ri", t, card, shape)
    print(f"phase 2: wide_mix_ri at {shape} [{card}]: kernel "
          f"{t['kernel'][0]:.4f} ms, bound {b['bound_ms']:.4f} ms "
          f"({b['bound_by']}; {100 * b['bound_ms'] / t['kernel'][0]:.1f} % "
          f"of the kernel's time), plain {t['plain'][0]:.4f} ms")
    return {"name": "wide_mix_ri", "route": "cuda",
            "source": "spatial_audio_framework_tpu_torch/csrc/"
                      "wide_mix_ri.cu",
            "replaces": "the torch glue _hybrid_forward_ri_packed -> "
                        "_mix_bands -> dense copy (no TPU kernel)",
            "shape": shape, "max_rel_err": err, "ms": t["kernel"][0],
            "plain_ms": t["plain"][0], **b, "library_ms": None}


def phase_binauraliser_c_parity(binauraliser, w, ak, dev, card):
    """binaur (2 sources, 128-sample blocks) and brot (the same with the
    head rotated by yaw 40°, pitch −15°, roll 10°) on the default HRIR
    set's weights ``w``, one stream: per-stream taps on the one-pass
    kernel, one launch per block."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    dirs = torch.tensor([[[30.0, 0.0], [-45.0, 10.0]]], device=dev)
    rot = torch.from_numpy(
        np.deg2rad([[40.0, -15.0, 10.0]]).astype(np.float32)).to(dev)
    fsz = int(g["binaur_frame_size"][0])
    for key, ypr in (("binaur", None), ("brot", rot)):
        cfg = binauraliser.BinauraliserConfig(n_sources=2,
                                              enable_rotation=ypr is not None)
        x = torch.from_numpy(np.asarray(g[f"{key}_in"], np.float32))[None]
        x = x.to(dev)
        n_blocks = x.shape[-1] // fsz
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        st = binauraliser.init_state_batched(cfg, 1, dev)
        outs = []
        for f in range(n_blocks):
            y, st = binauraliser.process_ri_batched(
                cfg, w, st, x[..., f * fsz:(f + 1) * fsz].contiguous(), dirs,
                None, ypr)
            outs.append(y[0])
        out = torch.cat(outs, dim=-1).cpu().numpy()
        ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
        err = float(np.abs(out - g[f"{key}_out"]).max())
        print(f"phase 11: binauraliser {key} (2 sources, rotation "
              f"{ypr is not None}, {n_blocks} blocks of {fsz}) vs the C "
              f"reference on the card [{card}]: max |err| = {err:.3e} (tol "
              f"{C_TOL}); launches = { {k: n for k, n in ran.items() if n} }")
        check(ran == {k: n_blocks if k in ("render_full_ri", "hrtf_taps_ri")
                      else 0 for k in ak.KERNELS}, f"{key}: launches {ran}")
        check(np.isfinite(out).all() and err <= C_TOL, f"{key}: {err}")


def phase_hop64(ri, bank, ak, dev, rng):
    """One render_tf_matrix_ri(fused=True) call at hop 64, the binauraliser
    slice's size (64 streams x 4 sources, per-stream matrices, 8192
    samples): the kernels take hop 128 only, so the JAX package's dispatch
    runs the plain path.  It must launch nothing and equal fused=False."""
    S, cin, cout = N_STREAMS, 4, 2
    M = uniform(rng, (2, S, bank.n_bands, cout, cin), dev)
    x = uniform(rng, (S, cin, HOPS * 128), dev)
    st = ri.init_state_batched(bank, S, cin, cout, dev)
    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    y_k, st_k = ri.render_tf_matrix_ri(bank, st, x, M[0], M[1], fused=True)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    y_p, st_p = ri.render_tf_matrix_ri(bank, st, x, M[0], M[1], fused=False)
    same = (torch.equal(y_k, y_p) and torch.equal(st_k.in_tail, st_p.in_tail)
            and torch.equal(st_k.ola_tail, st_p.ola_tail))
    print(f"phase 12: render_tf_matrix_ri(fused=True) at hop {bank.hop}, "
          f"{(S, cin, cout)} per-stream, {x.shape[-1]} samples: launches = "
          f"{launches}; equal to fused=False: {same}")
    check(not any(launches.values()), "hop 64 launched a kernel")
    check(same and bool(torch.isfinite(y_k).all()),
          "hop 64 differs from the plain path")


def phase_fuma(ambi_bin, ak, dev, rng, card):
    """ambi_bin order 3, MagLS, FuMa channel order and normalisation: the
    conversion is not folded at design time, so every chunk applies it on
    the card, from a tensor cached per (order, convention, device).  After
    one chunk, 3 chunks enqueued behind a spin kernel must not make the host
    wait (a host-to-device copy per chunk would), and launch render_full_ri
    once each."""
    cfg = ambi_bin.AmbiBinConfig(order=3, method="magls", ch_ordering="fuma",
                                 norm="fuma")
    w = ambi_bin.design_ri(cfg, device=dev)
    xs = [uniform(rng, (N_STREAMS, cfg.nsh, HOPS * 128), dev)
          for _ in range(3)]
    state = {"st": ambi_bin.init_state_batched(cfg, N_STREAMS, dev), "i": 0}
    ys = []

    def step():
        y, state["st"] = ambi_bin.process_ri_batched(
            cfg, w, state["st"], xs[state["i"] % len(xs)])
        state["i"] += 1
        ys.append(y)

    step()
    before = ak.render_full_ri.launches
    dev_ms, host_ms, ahead = device_ms(step, len(xs))
    n = ak.render_full_ri.launches - before
    ok = all(bool(torch.isfinite(y).all()) for y in ys)
    print(f"phase 13: ambi_bin order 3, FuMa input, {len(xs)} chunks behind "
          f"a spin kernel [{card}]: device {dev_ms:.4f} ms, host enqueue "
          f"{host_ms:.4f} ms per chunk; render_full_ri launches {n}; host "
          f"enqueued ahead of the device: {ahead}")
    check(n == len(xs) and ok, "FuMa chunks: launches or output wrong")
    check(ahead, "FuMa: a chunk made the host wait for the device")


def phase_ambi_enc(ambi_enc, ak, dev, rng, card):
    """ambi_enc order 1, 64 sources (the JAX benchmark's cell): N_CHUNKS
    chunks of 64 frames of 128 samples through ``process``, the directions
    changing per chunk (so the first frame of a chunk crossfades between
    two encoding matrices), held against a float64 numpy encode of the same
    frames.  It has no filterbank: matrix products only, none of the six
    kernels.  Times: a chunk as it comes (CUDA events) and the host's
    enqueue time; the device time of a frame from 16 frames queued behind a
    spin kernel (a whole chunk's ~1500 launches overflow the launch
    queue)."""
    n_src, frame, n_frames = 64, 128, 64
    cfg = ambi_enc.AmbiEncConfig(order=1, n_sources=n_src, frame_size=frame)
    conv = ambi_enc.design(cfg, device=dev)
    dirs_np = (rng.uniform(-180.0, 180.0, (N_CHUNKS, n_src, 2))
               * [1.0, 0.45]).astype(np.float32)
    x_np = rng.uniform(-1.0, 1.0, (N_CHUNKS, n_src, n_frames * frame)
                       ).astype(np.float32)
    dirs, xs = torch.from_numpy(dirs_np).to(dev), torch.from_numpy(x_np).to(dev)

    def chunk(st, k):
        ys = []
        for f in range(n_frames):
            y, st = ambi_enc.process(
                cfg, conv, st, xs[k, :, f * frame:(f + 1) * frame], dirs[k])
            ys.append(y)
        return torch.cat(ys, dim=-1), st

    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    st = ambi_enc.init_state(cfg, dirs_np[0].astype(np.float64), device=dev)
    outs = []
    for k in range(N_CHUNKS):
        y, st = chunk(st, k)
        outs.append(y)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    out = torch.cat(outs, dim=-1).cpu().numpy()
    # float64 reference: frame f encodes frame f − 1 with the matrices of
    # frames f − 1 and f, faded arange(1, T+1)/T
    Ys = [ambi_enc.encoding_mtx(cfg, d.astype(np.float64)) for d in dirs_np]
    conv64 = conv.cpu().numpy().astype(np.float64)
    fade = np.arange(1, frame + 1) / frame
    x_all = np.concatenate(list(x_np.astype(np.float64)), axis=-1)
    ref = np.zeros((cfg.nsh, x_all.shape[-1]))
    for f in range(1, N_CHUNKS * n_frames):
        Y_new = Ys[f // n_frames]
        Y_old = Ys[max(f - 1, 0) // n_frames]
        xp = x_all[:, (f - 1) * frame:f * frame]
        ref[:, f * frame:(f + 1) * frame] = conv64 @ (
            (Y_new @ xp) * fade + (Y_old @ xp) * (1.0 - fade)) / np.sqrt(n_src)
    err = float(np.abs(out - ref).max())
    peak = float(np.abs(ref).max())
    print(f"phase 17: ambi_enc order 1, {n_src} sources, {N_CHUNKS} chunks "
          f"of {n_frames} frames of {frame} samples vs a float64 numpy "
          f"encode: max |err| = {err:.3e} (peak {peak:.3f}, tol "
          f"{ENC_TOL}); launches of the six kernels = {launches} (it has no "
          "filterbank: none expected)")
    check(not any(launches.values()), "ambi_enc launched a filterbank kernel")
    check(out.shape == ref.shape and np.isfinite(out).all()
          and err <= ENC_TOL * max(1.0, peak), f"ambi_enc vs float64: {err}")

    state = {"st": st, "k": 0}

    def step():
        _, state["st"] = chunk(state["st"], state["k"] % N_CHUNKS)
        state["k"] += 1

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ms = cuda_ms(step, 4)
    wall = (time.perf_counter() - t0) * 1e3 / 4

    def one_frame():
        _, state["st"] = ambi_enc.process(cfg, conv, state["st"],
                                          xs[0, :, :frame], dirs[0])

    frame_ms = cuda_ms(one_frame, 16, queued=True)
    audio_s = n_frames * frame / FS
    print(f"phase 17: ambi_enc chunk [{card}]: {ms:.4f} ms per chunk of "
          f"{n_frames} frames by CUDA events ({wall:.4f} ms on the host's "
          f"clock) = {audio_s / (ms / 1e3):.1f} audio-seconds per second; "
          f"device {frame_ms:.5f} ms per frame queued behind a spin = "
          f"{frame_ms * n_frames:.4f} ms per chunk, so the device idles "
          f"{100 * (1 - frame_ms * n_frames / ms):.1f} % of the chunk "
          "(launch bound)")


def golden_blocks(process, st, x, fsz, n_blocks):
    """x (1, n_in, T) on the card through ``process(st, block)`` in
    ``n_blocks`` blocks of ``fsz`` samples → the stream's output, numpy."""
    outs = []
    for f in range(n_blocks):
        y, st = process(st, x[..., f * fsz:(f + 1) * fsz].contiguous())
        outs.append(y[0])
    return torch.cat(outs, dim=-1).cpu().numpy()


def phase_new_models_c_parity(panner, ambi_enc, binauraliser_nf,
                              roombinauraliser, binw, ak, dev, card):
    """The compiled C reference's outputs for the four new models
    (tests/goldens/c_goldens.npz; configurations as tests/test_c_goldens.py),
    one stream through the batched entry points on the card in the goldens'
    own block sizes.  The renderers launch render_full_ri once per block;
    ambi_enc launches none of the six kernels."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    rot = t(np.deg2rad([[40.0, -15.0, 10.0]]))
    cases = []
    for key in ("pan", "pyr", "p2d"):
        ls = np.asarray(g["p2d_ls_dirs" if key == "p2d" else "pan_ls_dirs"],
                        np.float64)
        cfg = panner.PannerConfig(n_sources=2, n_loudspeakers=len(ls))
        w = panner.design(cfg, ls, device=dev)
        dirs = t(g["p2d_src_dirs" if key == "p2d" else "pan_src_dirs"])[None]
        ypr = t(np.radians(g["pyr_ypr_deg"]))[None] if key == "pyr" else None
        cases.append((key, 128, 32,
                      lambda st, xb, a=(cfg, w, dirs, ypr):
                      panner.process_ri_batched(a[0], a[1], st, xb, a[2],
                                                a[3]),
                      panner.init_state_batched(cfg, 1, len(ls), dev)))
    for key in ("bnf", "bnfr"):
        cfg = binauraliser_nf.BinauraliserNFConfig(
            n_sources=2, enable_rotation=key == "bnfr")
        if key == "bnfr":
            dirs = t([[[35.0, 12.0], [-60.0, -8.0]]])
            dists = t([[0.35, 0.8]])
        else:
            dirs, dists = t(g["bnf_src_dirs"])[None], t(g["bnf_dists"])[None]
        cases.append((key, 128, 48,
                      lambda st, xb, a=(cfg, dirs, dists,
                                        rot if key == "bnfr" else None):
                      binauraliser_nf.process_ri_batched(
                          a[0], binw, st, xb, a[1], a[2], None, a[3]),
                      binauraliser_nf.init_state_batched(cfg, 1, dev)))
    for key in ("rb", "rbr"):
        cfg = roombinauraliser.RoomBinauraliserConfig(
            n_sources=2, enable_rotation=key == "rbr",
            diff_eq_mode=roombinauraliser.DIFF_EQ_FABIAN_CTF)
        cfg, w = roombinauraliser.design_ri(cfg, device=dev)
        cases.append((key, 128, 48,
                      lambda st, xb, a=(cfg, w, rot if key == "rbr" else None):
                      roombinauraliser.process_ri_batched(a[0], a[1], st, xb,
                                                          None, a[2]),
                      roombinauraliser.init_state_batched(cfg, 1, dev)))
    for key, fsz, n_blocks, process, st in cases:
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        out = golden_blocks(process, st, t(g[f"{key}_in"])[None], fsz,
                            n_blocks)
        ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
        err = float(np.abs(out - g[f"{key}_out"]).max())
        print(f"phase 18: {key} ({n_blocks} blocks of {fsz}) vs the C "
              f"reference on the card [{card}]: max |err| = {err:.3e} (tol "
              f"{C_TOL}); launches = { {k: n for k, n in ran.items() if n} }")
        check(ran == {k: n_blocks if k == "render_full_ri" else 0
                      for k in ak.KERNELS}, f"{key}: launches {ran}")
        check(np.isfinite(out).all() and err <= C_TOL, f"{key}: {err}")
    # ambi_enc: order 3, N3D, 3 sources, 32 frames of 64 samples
    cfg = ambi_enc.AmbiEncConfig(order=3, norm="n3d", n_sources=3,
                                 enable_post_scaling=True, frame_size=64)
    conv = ambi_enc.design(cfg, device=dev)
    st = ambi_enc.init_state(cfg, np.asarray(g["enc_dirs"], np.float64),
                             device=dev)
    x, dirs = t(g["enc_in"]), t(g["enc_dirs"])
    outs = []
    for f in range(32):
        y, st = ambi_enc.process(cfg, conv, st, x[:, f * 64:(f + 1) * 64],
                                 dirs)
        outs.append(y)
    out = torch.cat(outs, dim=-1).cpu().numpy()
    err = float(np.abs(out - g["enc_out"]).max())
    print(f"phase 18: enc (32 frames of 64) vs the C reference on the card "
          f"[{card}]: max |err| = {err:.3e} (tol {C_TOL})")
    check(np.isfinite(out).all() and err <= C_TOL, f"enc: {err}")


def phase_design_checks(ambi_bin, hrir, ak, dev, card):
    """``resample_hrirs`` against the C's resampled HRIRs (host only), and
    ambi_bin order 3 with the SPR decoder (N3D) against the C reference:
    64 blocks of 128 samples, one stream, render_full_ri once per block."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    for tag, fs_in, fs_out, pad in (("48k_44k", 48000, 44100, False),
                                    ("44k_48k", 44100, 48000, False),
                                    ("48k_96k_pad", 48000, 96000, True),
                                    ("96k_48k", 96000, 48000, False),
                                    ("48k_16k", 48000, 16000, False)):
        ref = g[f"rsmp_{tag}_out"]
        out, n = hrir.resample_hrirs(g["rsmp_in"], fs_in, fs_out,
                                     pad_to_next_pow2=pad)
        err = float(np.abs(out - ref).max()) if out.shape == ref.shape \
            else float("inf")
        print(f"phase 19: resample_hrirs {fs_in} -> {fs_out} Hz (pad {pad}) "
              f"on the host vs the C reference: {out.shape}, max |err| = "
              f"{err:.3e} (tol {C_TOL})")
        check(n == ref.shape[-1] and err <= C_TOL, f"resample {tag}: {err}")
    cfg = ambi_bin.AmbiBinConfig(order=3, method="spr", norm="n3d")
    w = ambi_bin.design_ri(cfg, device=dev)
    x = torch.from_numpy(np.asarray(g["ab2_in"], np.float32))[None].to(dev)
    before = ak.render_full_ri.launches
    out = golden_blocks(
        lambda st, xb: ambi_bin.process_ri_batched(cfg, w, st, xb),
        ambi_bin.init_state_batched(cfg, 1, dev), x, 128, 64)
    err = float(np.abs(out - g["abspr_out"]).max())
    n = ak.render_full_ri.launches - before
    print(f"phase 19: ambi_bin order 3, SPR decoder ({n} blocks through "
          f"render_full_ri) vs the C reference on the card [{card}]: max "
          f"|err| = {err:.3e} (tol {C_TOL})")
    check(n == 64 and np.isfinite(out).all() and err <= C_TOL,
          f"abspr: {err}")


def phase_array2sh(array2sh, presets, ak, dev, rng, card):
    """array2sh: the Tikhonov design (Eigenmike32, order 4, N3D) against the
    compiled C's filters on the host, then the slice: 16 recordings of the
    32 sensors encoded to order 4 (nSH x Q = 800 channel pairs: the
    analysis front at 512 rows, the wide mix, the synthesis back at 400
    rows), as phase 3.  Returns the launch counts."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    em32 = np.degrees(presets.mic_preset("eigenmike32"))
    t0 = time.perf_counter()
    W = array2sh.design(
        array2sh.Array2SHConfig(order=4, r=0.042, R=0.042, norm="n3d",
                                filter_type=array2sh.FILTER_TIKHONOV),
        em32, device="cpu").W.numpy()
    ref = np.asarray(g["a2s_W_tikhonov"])
    err = float(np.abs(W[1:] - ref[1:]).max())
    lim = 2e-4 * max(1.0, float(np.abs(ref).max()))
    print(f"phase 20: array2sh Tikhonov filters {W.shape} on the host in "
          f"{time.perf_counter() - t0:.2f} s vs the C reference (band 0 "
          f"excluded): max |err| = {err:.3e} (limit {lim:.3e})")
    check(W.shape == ref.shape and err <= lim, f"a2s_W_tikhonov: {err}")
    cfg = array2sh.Array2SHConfig(order=4)
    w = array2sh.design_ri(cfg, em32, device=dev)
    return phase_slice(
        "array2sh Eigenmike32 -> order 4", 20,
        lambda st, x, fused: array2sh.process_ri_batched(cfg, w, st, x,
                                                         fused=fused),
        lambda: array2sh.init_state_batched(cfg, A2S_STREAMS, A2S_SENSORS,
                                            dev),
        A2S_SENSORS, A2S_NSH, ak, dev, rng, card,
        {"analysis_front_ri": N_CHUNKS, "wide_mix_ri": N_CHUNKS,
         "synthesis_back_ri": N_CHUNKS},
        n_streams=A2S_STREAMS)


def frames(process, st, x, fsz, n):
    """x (n_in, T) on the card through ``process(st, frame) -> (y, st)`` in
    ``n`` frames of ``fsz`` samples → (n_out, n·fsz) numpy.  After the
    first frame (which fills the caches of device constants) any operation
    that makes the host wait for the card raises."""
    y, st = process(st, x[:, :fsz])
    outs = [y]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for f in range(1, n):
            y, st = process(st, x[:, f * fsz:(f + 1) * fsz])
            outs.append(y)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return torch.cat(outs, dim=-1).cpu().numpy()


def c_parity(phase, key, out, ref, card, what=""):
    err = float(np.abs(out - ref).max()) if out.shape == ref.shape \
        else float("inf")
    print(f"phase {phase}: {key}{what} vs the C reference on the card "
          f"[{card}]: max |err| = {err:.3e} (tol {C_TOL})")
    check(np.isfinite(out).all() and err <= C_TOL, f"{key}: {err}")


def phase_ambi_dec_preview(ambi_dec, presets, ak, dev, rng, card):
    """ambi_dec's binaural preview: order 3 → the 22.x layout → 2 ears
    (TRI_PS HRTFs at the loudspeakers folded into the decoder on the host:
    a complex 16 → 2 matrix shared by the streams, the one-pass kernel), as
    phase 3; then parity with the compiled C (``adb``: its own 9
    loudspeakers) through the batched path in 128-sample blocks and through
    the single-stream complex ``process``.  Returns the slice's launches."""
    t0 = time.perf_counter()
    cfg = ambi_dec.AmbiDecConfig(master_order=3, binauralise_ls=True)
    ls = presets.loudspeaker_preset("22.x")
    w = ambi_dec.design_ri(cfg, ls, device=dev)
    print(f"phase 21: ambi_dec design with the binaural preview (order 3 -> "
          f"22.x -> 2 ears, weights {tuple(w.M_re.shape)} complex) on the "
          f"host in {time.perf_counter() - t0:.2f} s")
    launches = phase_slice(
        "ambi_dec binaural preview", 21,
        lambda st, x, fused: ambi_dec.process_ri_batched(cfg, w, st, x,
                                                         fused=fused),
        lambda: ambi_dec.init_state_batched(cfg, N_STREAMS, len(ls), dev),
        cfg.nsh, 2, ak, dev, rng, card, {"render_full_ri": N_CHUNKS})

    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    ls9 = np.asarray(g["ad16_ls_dirs"], np.float64)
    ccfg = ambi_dec.AmbiDecConfig(master_order=3, norm="n3d",
                                  dec_method=("allrad", "allrad"),
                                  re_weight=(False, True),
                                  transition_freq=800.0, binauralise_ls=True)
    x = torch.from_numpy(np.asarray(g["adb_in"], np.float32)).to(dev)
    wri = ambi_dec.design_ri(ccfg, ls9, device=dev)
    before = ak.render_full_ri.launches
    out = golden_blocks(
        lambda st, xb: ambi_dec.process_ri_batched(ccfg, wri, st, xb),
        ambi_dec.init_state_batched(ccfg, 1, 9, dev), x[None], 128, 32)
    n = ak.render_full_ri.launches - before
    c_parity(21, "adb", out, g["adb_out"], card,
             f" (batched path, {n} blocks through render_full_ri)")
    check(n == 32, "adb: the batched preview bypassed render_full_ri")
    wc = ambi_dec.design(ccfg, ls9, device=dev)
    out = frames(lambda st, xb: ambi_dec.process(ccfg, wc, st, xb),
                 ambi_dec.init_state(ccfg, 9, device=dev), x, 128, 32)
    c_parity(21, "adb", out, g["adb_out"], card, " (single-stream process)")
    return launches


def launches_per_call(fn, n: int):
    """torch.profiler over ``n`` calls of ``fn`` → (device launches per
    call: kernels, copies and fills; their device ms per call)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(ev), "the profiler saw no device activity")
    busy = sum(e.time_range.end - e.time_range.start for e in ev)
    return len(ev) / n, busy / n / 1e3


def phase_head_tracked(ambi_bin, sh, geo, cases, ak, dev, rng, card):
    """One listener with a head tracker: ambi_bin ``process_ri`` and
    ``process`` at orders 3 and 7 (``cases``: [(order, (M_re, M_im))], the
    slices' designs), blocks of 128 samples (the C's frame) and of 4096,
    with ``ypr`` living on the card and changing every block, so every
    block builds its SH rotation on the card.  Per case: no block may make
    the host wait (sync debug mode "error" around warm blocks, then blocks
    enqueued behind a spin kernel), the wall, host enqueue and device time
    per block, the rotation's share, and the launches per block.  The
    launches come from torch.profiler in a second pass over all cases, after
    every time was taken: once the profiler has run, each launch costs the
    host several times more.  ``process_ri`` must equal one stream of
    ``process_ri_batched`` with the same rotation folded into the weights.
    None of the six kernels may launch on the single-stream paths."""
    n_blocks, queued = 16, 4      # 4 blocks of ~200 launches fit the queue
    runs = []
    for order, (Mre, Mim) in cases:
        cfg = ambi_bin.AmbiBinConfig(order=order, method="magls",
                                     enable_rotation=True)
        weights = {"process_ri": (Mre, Mim),
                   "process": ambi_bin.AmbiBinWeights(torch.complex(Mre, Mim))}
        inits = {"process_ri": ambi_bin.init_state_ri,
                 "process": ambi_bin.init_state}
        yprs = uniform(rng, (n_blocks, 3), dev, np.pi)

        def rotation(cfg=cfg, yprs=yprs):
            return ambi_bin._rotation(cfg, yprs[0])

        rotation()
        rot_ms = cuda_ms(rotation, 8, queued=True)
        runs.append((f"SH rotation matrix, order {order}", rotation,
                     f"device {rot_ms:.4f} ms per block"))
        for T in (128, 4096):
            xs = uniform(rng, (n_blocks, cfg.nsh, T), dev)
            for entry in ("process_ri", "process"):
                proc, w = getattr(ambi_bin, entry), weights[entry]
                state = {"st": inits[entry](cfg, device=dev), "i": 0}
                ys = []

                def step(proc=proc, w=w, state=state, xs=xs, yprs=yprs,
                         cfg=cfg, ys=ys):
                    i = state["i"] % n_blocks
                    y, state["st"] = proc(cfg, w, state["st"], xs[i], yprs[i])
                    state["i"] += 1
                    ys.append(y)

                before = {k: getattr(ak, k).launches for k in ak.KERNELS}
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    for _ in range(4):
                        step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize()
                check(all(bool(torch.isfinite(y).all()) and y.shape == (2, T)
                          for y in ys), f"{entry}: output wrong")
                t0 = time.perf_counter()
                for _ in range(n_blocks):
                    step()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / n_blocks
                timed = [device_ms(step, queued) for _ in range(3)]
                dev_ms, host_ms = (float(np.median([r[i] for r in timed]))
                                   for i in (0, 1))
                ahead = all(r[2] for r in timed)
                ran = {k: getattr(ak, k).launches - before[k]
                       for k in ak.KERNELS}
                ys.clear()
                runs.append((
                    f"ambi_bin.{entry} order {order}, one listener, blocks "
                    f"of {T} samples, ypr on the card", step,
                    f"wall {wall:.4f} ms, host enqueue {host_ms:.4f} ms, "
                    f"device {dev_ms:.4f} ms per block ({queued} blocks "
                    f"queued), rotation {100 * rot_ms / dev_ms:.1f} % of the "
                    f"device time; {T / FS * 1e3:.2f} ms of audio per block "
                    f"= {T / FS / (wall / 1e3):.1f} audio-seconds per "
                    f"second; no host wait: {ahead}"))
                check(ahead, f"{entry}: a block made the host wait")
                check(not any(ran.values()),
                      f"{entry}: a single-stream block launched {ran}")
        # process_ri against the batched path with the rotation folded in
        ypr = yprs[0]
        rot = sh.get_sh_rot_mtx_real_torch(
            geo.yaw_pitch_roll2_rzyx_torch(ypr), order)
        folded = (torch.einsum("bes,st->bet", Mre, rot),
                  torch.einsum("bes,st->bet", Mim, rot))
        s1 = ambi_bin.init_state_ri(cfg, device=dev)
        sb = ambi_bin.init_state_batched(cfg, 1, dev)
        err = peak = 0.0
        for T in (4096, 128, 256):
            x = uniform(rng, (cfg.nsh, T), dev)
            y1, s1 = ambi_bin.process_ri(cfg, (Mre, Mim), s1, x, ypr)
            yb, sb = ambi_bin.process_ri_batched(cfg, folded, sb, x[None])
            err = max(err, (y1 - yb[0]).abs().max().item())
            peak = max(peak, yb.abs().max().item())
        print(f"phase 22: process_ri vs one stream of process_ri_batched with "
              f"the rotation folded in, order {order}: max |err| = {err:.3e} "
              f"(peak {peak:.3f}, tol {KERNEL_TOL} of max(1, peak))")
        check(err <= KERNEL_TOL * max(1.0, peak),
              f"process_ri disagrees with the batched path: {err}")
    for label, fn, line in runs:
        n_launch, busy_ms = launches_per_call(fn, 4)
        print(f"phase 22: {label} [{card}]: {line}; {n_launch:g} launches "
              f"per block, {busy_ms:.4f} ms of them busy (profiler)")
        check(n_launch * queued <= 1000,
              f"{label}: {queued} blocks overflow the launch queue")


def phase_ambi_bin_single_c_parity(ambi_bin, sh, ak, dev, card):
    """ambi_bin parity with the compiled C through the single-stream entry
    points on the card, the head rotation given as ``ypr``: order 4 at
    yaw = π (``process`` in 128-sample frames, ``process_ri`` in blocks of
    512), FuMa input with a general rotation (``abf``, both entry points),
    and the LS + diffuse-field-EQ and SPR decoders (``ab2``)."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)

    def run(cfg, entry, x, ypr, fsz, n):
        if entry == "process":
            w, st = ambi_bin.design(cfg, device=dev), ambi_bin.init_state(
                cfg, device=dev)
        else:
            w, st = (ambi_bin.design_ri(cfg, device=dev),
                     ambi_bin.init_state_ri(cfg, device=dev))
        proc = getattr(ambi_bin, entry)
        return frames(lambda s, xb: proc(cfg, w, s, xb, ypr), st, x, fsz, n)

    before = {k: getattr(ak, k).launches for k in ak.KERNELS}
    cfg = ambi_bin.AmbiBinConfig(order=4, method="magls", norm="n3d",
                                 enable_rotation=True)
    y_enc = sh.get_rsh(4, np.array([[-90.0, 0.0]], np.float32))[:, 0]
    x = t(y_enc[:, None] * g["ambi_bin_in_mono"][None, :])
    ypr = t([np.pi, 0.0, 0.0])
    for entry, fsz in (("process", 128), ("process_ri", 512)):
        out = run(cfg, entry, x, ypr, fsz, x.shape[-1] // fsz)
        c_parity(23, "ambi_bin order 4, yaw pi", out, g["ambi_bin_out"], card,
                 f" ({entry}, blocks of {fsz})")
    cfg = ambi_bin.AmbiBinConfig(order=1, method="magls", norm="fuma",
                                 ch_ordering="fuma", enable_rotation=True)
    ypr = t(np.radians([20.0, -10.0, 5.0]))
    for entry in ("process", "process_ri"):
        out = run(cfg, entry, t(g["abf_in"]), ypr, 128, 32)
        c_parity(23, "abf (FuMa input, general rotation)", out, g["abf_out"],
                 card, f" ({entry})")
    for method, key in (("lsdiffeq", "ablsd_out"), ("spr", "abspr_out")):
        cfg = ambi_bin.AmbiBinConfig(order=3, method=method, norm="n3d")
        out = run(cfg, "process", t(g["ab2_in"]), None, 128, 64)
        c_parity(23, f"ab2 ({method})", out, g[key], card, " (process)")
    ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
    check(not any(ran.values()), f"single-stream ambi_bin launched {ran}")


def phase_single_stream_c_parity(rotator, beamformer, binauraliser,
                                 binauraliser_nf, roombinauraliser, panner,
                                 binw, ak, dev, card):
    """Parity with the compiled C on the card for rotator (``rot``),
    beamformer (``bf`` max-EV, ``bf2`` cardioid and hypercardioid) and the
    single-stream complex ``process`` of binauraliser (``binaur``, ``brot``
    and ``btp``: TRI_PS), binauraliser_nf (``bnf``, ``bnfr``),
    roombinauraliser (``rb``, ``rbr``) and panner (``pan``, ``pyr``,
    ``p2d``), the goldens their batched paths meet in phases 11 and 18.
    ``binw``: the binauraliser's (re, im) design on the card.  None of the
    six kernels may launch."""
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, np.float32)).to(dev)
    before = {k: getattr(ak, k).launches for k in ak.KERNELS}
    rot = t(np.deg2rad([40.0, -15.0, 10.0]))

    cfg = rotator.RotatorConfig(order=3, norm="n3d", frame_size=64)
    w = rotator.design(cfg, device=dev)
    ypr = t(np.radians([30.0, -20.0, 10.0]))
    out = frames(lambda s, xb: rotator.process(cfg, w, s, xb, ypr),
                 rotator.init_state(cfg, device=dev), t(g["rot_in"]), 64, 32)
    c_parity(24, "rot", out, g["rot_out"], card)
    for btype, xkey, key in ((beamformer.BEAM_MAX_EV, "bf_in", "bf_out"),
                             (beamformer.BEAM_CARDIOID, "bf2_in", "bfc_out"),
                             (beamformer.BEAM_HYPERCARDIOID, "bf2_in",
                              "bfh_out")):
        cfg = beamformer.BeamformerConfig(order=3, n_beams=2, beam_type=btype,
                                          norm="n3d")
        W = beamformer.design(cfg, np.asarray(g["bf_dirs"], np.float64),
                              device=dev)
        out = frames(lambda s, xb: beamformer.process(cfg, W, s, xb),
                     beamformer.init_state(cfg, device=dev), t(g[xkey]), 128,
                     32)
        c_parity(24, f"{key[:-4]} ({btype})", out, g[key], card)

    fields = binauraliser.BinauraliserWeights._fields[1:]
    bw = binauraliser.BinauraliserWeights(
        torch.complex(binw.hrtf_re, binw.hrtf_im),
        *(getattr(binw, f) for f in fields))
    for key in ("binaur", "brot", "btp"):
        cfg = binauraliser.BinauraliserConfig(
            n_sources=2, enable_rotation=key == "brot",
            interp_mode=(binauraliser.INTERP_TRI_PS if key == "btp"
                         else binauraliser.INTERP_TRI))
        dirs = t([[20.0, -30.0], [-70.0, 35.0]] if key == "btp"
                 else [[30.0, 0.0], [-45.0, 10.0]])
        x = t(g[f"{key}_in"])
        out = frames(lambda s, xb: binauraliser.process(
                         cfg, bw, s, xb, dirs, None,
                         rot if key == "brot" else None),
                     binauraliser.init_state(cfg, device=dev), x, 128,
                     x.shape[-1] // 128)
        c_parity(24, key, out, g[f"{key}_out"], card, " (binauraliser.process)")
    for key in ("bnf", "bnfr"):
        cfg = binauraliser_nf.BinauraliserNFConfig(
            n_sources=2, enable_rotation=key == "bnfr")
        if key == "bnfr":
            dirs, dists = t([[35.0, 12.0], [-60.0, -8.0]]), t([0.35, 0.8])
        else:
            dirs, dists = t(g["bnf_src_dirs"]), t(g["bnf_dists"])
        out = frames(lambda s, xb: binauraliser_nf.process(
                         cfg, bw, s, xb, dirs, dists, None,
                         rot if key == "bnfr" else None),
                     binauraliser_nf.init_state(cfg, device=dev),
                     t(g[f"{key}_in"]), 128, 48)
        c_parity(24, key, out, g[f"{key}_out"], card,
                 " (binauraliser_nf.process)")
    rcfg, rw = roombinauraliser.design(
        roombinauraliser.RoomBinauraliserConfig(
            n_sources=2, diff_eq_mode=roombinauraliser.DIFF_EQ_FABIAN_CTF),
        device=dev)
    for key in ("rb", "rbr"):
        out = frames(lambda s, xb: roombinauraliser.process(
                         rcfg, rw, s, xb, None, rot if key == "rbr" else None),
                     roombinauraliser.init_state(rcfg, device=dev),
                     t(g[f"{key}_in"]), 128, 48)
        c_parity(24, key, out, g[f"{key}_out"], card,
                 " (roombinauraliser.process)")
    for key in ("pan", "pyr", "p2d"):
        lay = "p2d" if key == "p2d" else "pan"
        ls = np.asarray(g[f"{lay}_ls_dirs"], np.float64)
        cfg = panner.PannerConfig(n_sources=2, n_loudspeakers=len(ls))
        w = panner.design(cfg, ls, device=dev)
        dirs = t(g[f"{lay}_src_dirs"])
        ypr = t(np.radians(g["pyr_ypr_deg"])) if key == "pyr" else None
        out = frames(lambda s, xb: panner.process(cfg, w, s, xb, dirs, ypr),
                     panner.init_state(cfg, device=dev), t(g[f"{key}_in"]),
                     128, 32)
        c_parity(24, key, out, g[f"{key}_out"], card, " (panner.process)")
    ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
    check(not any(ran.values()), f"a single-stream path launched {ran}")


# -- the analysers and the decorrelator --------------------------------------

def tensors(o) -> list:
    """Every tensor of an output or a state (tuples, NamedTuples), in order."""
    if isinstance(o, torch.Tensor):
        return [o]
    if isinstance(o, (tuple, list)):
        return [t for v in o for t in tensors(v)]
    return []


def sh_scenes(rng, lead, order, T, dev, n_src=2) -> torch.Tensor:
    """Scenes for the map and DoA paths: per scene ``n_src`` plane waves
    at random directions (elevations within ±60°) in diffuse noise 20 dB
    down, N3D SH, (*lead, nSH, T) on the card.  The waveforms are drawn on
    the card from a seeded generator; the steering is host numpy."""
    from spatial_audio_framework_tpu_torch.modules import sh

    n = int(np.prod(lead))
    nsh = (order + 1) ** 2
    dirs = np.stack([rng.uniform(-180, 180, (n, n_src)),
                     rng.uniform(-60, 60, (n, n_src))], -1)
    Y = np.stack([sh.get_rsh(order, d) for d in dirs])       # (n, nSH, K)
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(1 << 31)))
    s = torch.randn((n, n_src, T), generator=gen, device=dev)
    noise = torch.randn((n, nsh, T), generator=gen, device=dev)
    x = torch.from_numpy(Y.astype(np.float32)).to(dev) @ s + 0.1 * noise
    return x.reshape(tuple(lead) + (nsh, T))


def rel_err(k: torch.Tensor, p: torch.Tensor) -> float:
    """max |k - p| over max(1, max |p|)."""
    return ((k - p).abs().max() / p.abs().max().clamp_min(1.0)).item()


def unit_vectors(azi: torch.Tensor, elev: torch.Tensor) -> torch.Tensor:
    return torch.stack([elev.cos() * azi.cos(), elev.cos() * azi.sin(),
                        elev.sin()], -1)


def sldoa_errors(ok, op, avg_energy) -> dict:
    """sldoa's outputs held kernel against plain: energies and alpha as
    they are; directions as unit vectors (an azimuth alone jumps by 2π
    across ±180°), weighted by the energy that carries them.  A per-slot
    direction is atan2 of an intensity Re(conj(W)·dipole) that cancels where
    the omni and a dipole are near orthogonal (the diffuse part of a scene),
    so a 1e-6 difference in the spectra can turn a weak slot's direction
    by any angle: the energy-weighted mean difference is what is held, the
    largest is printed."""
    du = (unit_vectors(ok.doa_rad[..., 0], ok.doa_rad[..., 1])
          - unit_vectors(op.doa_rad[..., 0], op.doa_rad[..., 1])
          ).norm(dim=-1)
    e = op.energy
    dd = (unit_vectors(ok.azi_deg.deg2rad(), ok.elev_deg.deg2rad())
          - unit_vectors(op.azi_deg.deg2rad(), op.elev_deg.deg2rad())
          ).norm(dim=-1)
    return {"energy": rel_err(ok.energy, op.energy),
            "doa (energy-weighted)": ((du * e).sum() / e.sum()).item(),
            "doa (largest)": (du.max().item(), None),
            "display (energy-weighted)": ((dd * avg_energy).sum()
                                          / avg_energy.sum()).item(),
            "alpha": rel_err(ok.alpha_scale, op.alpha_scale),
            "colour": rel_err(ok.colour_scale, op.colour_scale)}


class EighWatch:
    """``herm_ri.herm_eigh_embedded`` wrapped for a run under
    ``set_sync_debug_mode("error")``: ``torch.linalg.eigh`` reads its
    convergence flags back, the one host wait the map paths have, so the
    wrapper lets it through and times it (host clock, after the queue has
    drained)."""

    def __init__(self):
        from spatial_audio_framework_tpu_torch.ops import herm_ri

        self.mod, self.orig, self.ms = herm_ri, herm_ri.herm_eigh_embedded, []

    def __enter__(self):
        def eigh(C):
            torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(C)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.set_sync_debug_mode("error")
            return out

        self.mod.herm_eigh_embedded = eigh
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        self.mod.herm_eigh_embedded = self.orig
        return False


def phase_path(name, phase, process, init_state, xs, expect, compare, ak,
               card, chunks_per_call=1, queued_calls=None, streams=1,
               samples=HOPS * 128):
    """A main path of the analysers or the decorrelator: ``process(st, x,
    fused) -> (out, st)`` over the calls ``xs`` (each ``chunks_per_call``
    chunks of ``samples`` samples, by default 64 hops, for ``streams``
    streams or instances), with every
    launch counter reset just before and read just after (``expect``: the
    launches each kernel must show), held against ``fused=False``
    (``compare(out_k, st_k, out_p, st_p) -> {label: err or (err, tol)}``,
    each at most KERNEL_TOL or its tol; a tol of None is printed, not
    held); then the warm calls once more under
    ``set_sync_debug_mode("error")`` (no host wait; the map paths' eigh
    let through by EighWatch and timed); both paths timed; the device's
    time per chunk (``queued_calls`` calls enqueued behind a spin kernel,
    device time back to back; without it, the kernels' busy time under
    torch.profiler) beside the host's.  Returns the launch counts."""
    def run(fused):
        st, outs = init_state(), []
        for x in xs:
            out, st = process(st, x, fused)
            outs.append(out)
        return outs, st

    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    outs_k, st_k = run(True)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    n_chunks = len(xs) * chunks_per_call
    print(f"phase {phase}: {name} main path ran {n_chunks} chunks of "
          f"{streams} x {samples} samples in {len(xs)} calls; launches = "
          f"{launches}")
    check(launches == {k: expect.get(k, 0) for k in ak.KERNELS},
          f"{name}: expected launches {expect}")
    outs_p, st_p = run(False)
    torch.cuda.synchronize()
    errs, tols = {}, {}
    for ok_, op_ in zip(outs_k, outs_p):
        for a, b in zip(tensors(ok_), tensors(op_)):
            check(a.shape == b.shape and bool(torch.isfinite(a).all()),
                  f"{name}: kernel output not finite or misshapen")
        for label, e in compare(ok_, st_k, op_, st_p).items():
            e, tols[label] = e if isinstance(e, tuple) else (e, KERNEL_TOL)
            errs[label] = max(errs.get(label, 0.0), e)
    print(f"phase {phase}: {name} kernel path vs plain path, max |err| "
          "relative to max(1, |plain|): " + ", ".join(
              f"{k} {v:.3e}" + (f" (tol {tols[k]})" if tols[k] else
                                " (not held)") for k, v in errs.items()))
    check(all(v <= tols[k] for k, v in errs.items() if tols[k]),
          f"{name} disagrees with the plain path: {errs}")

    st = init_state()
    _, st = process(st, xs[0], True)
    with EighWatch() as watch:
        for x in xs[1:]:
            _, st = process(st, x, True)
    torch.cuda.synchronize()
    eigh = (f"; its {len(watch.ms)} eigh call(s) (the one host wait, let "
            f"through): {np.mean(watch.ms):.4f} ms each on the host clock"
            if watch.ms else "")
    print(f"phase {phase}: {name}: {len(xs) - 1} warm call(s) under "
          f"set_sync_debug_mode('error'): no host wait{eigh}")

    state = {True: init_state(), False: init_state()}
    it = {True: 0, False: 0}

    def step(fused):
        _, state[fused] = process(state[fused], xs[it[fused] % len(xs)],
                                  fused)
        it[fused] += 1

    t = ab_times({"kernel": lambda: step(True), "plain": lambda: step(False)},
                 len(xs), warmup=1)
    for path in ("kernel", "plain"):
        ms, runs = t[path]
        print(f"phase {phase}: {name} chunk, {path} path [{card}]: "
              f"{ms / chunks_per_call:.4f} ms per chunk of {streams} x "
              f"{samples} samples = "
              f"{streams * samples / FS / (ms / chunks_per_call / 1e3):.1f}"
              f" audio-seconds per second (runs per call "
              f"{['%.4f' % r for r in runs]})")
    wall = t["kernel"][0] / chunks_per_call
    if queued_calls:
        runs = [device_ms(lambda: step(True), queued_calls) for _ in range(3)]
        dev_ms, host_ms = (float(np.median([r[i] for r in runs])) / 
                           chunks_per_call for i in (0, 1))
        check(all(r[2] for r in runs),
              f"{name}: a chunk made the host wait for the device")
        how = "back to back behind a spin kernel"
    else:
        _, busy = launches_per_call(lambda: step(True), 2)
        dev_ms, host_ms = busy / chunks_per_call, wall
        how = ("kernels' busy time under torch.profiler; the host clock "
               "includes the eigh's wait")
    print(f"phase {phase}: {name} kernel path [{card}]: device "
          f"{dev_ms:.4f} ms per chunk ({how}), host {host_ms:.4f} ms per "
          f"chunk, so the device idles "
          f"{100 * (1 - dev_ms / wall):.1f} % of the {wall:.4f} ms chunk")
    return launches


def phase_analysers(ak, dev, rng, card) -> dict:
    """Phases 25-29: the decorrelator (4 channels x 16 streams), ambi_drc
    (order 3 x 64 streams), powermap (order 3, MUSIC, 812-point geosphere,
    5° display; 32 instances and 1, 8 chunks a call through
    ``analysis_chunks``), sldoa (order 3, 2562-point fit grid; 32
    instances and 1) and dirass (order 2 → 6, t-design 18, all three
    modes).  Returns the launch counts of the paths that run kernels."""
    from spatial_audio_framework_tpu_torch.models import (ambi_drc,
                                                          decorrelator,
                                                          dirass, powermap,
                                                          sldoa)

    T = HOPS * 128
    out = {}

    def audio_compare(names):
        def compare(yk, sk, yp, sp):
            errs = {"y": rel_err(yk, yp)}
            for label, a, b in zip(names, tensors(sk), tensors(sp)):
                errs[label] = rel_err(a, b)
            return errs
        return compare

    # 25: the decorrelator, the JAX benchmark's cell
    t0 = time.perf_counter()
    dcfg = decorrelator.DecorrelatorConfig(n_channels=DCR_CH)
    dw = decorrelator.design(dcfg, c_rand_offset=5016, device=dev)
    print(f"phase 25: decorrelator design ({DCR_CH} channels, lattice "
          f"orders 20/15/6/3, delays from the C's rand() stream) on the host "
          f"in {time.perf_counter() - t0:.2f} s")
    xs = [uniform(rng, (DCR_STREAMS, DCR_CH, T), dev) for _ in range(N_CHUNKS)]
    out["decorrelator"] = phase_path(
        f"decorrelator {DCR_CH} ch x {DCR_STREAMS} streams", 25,
        lambda st, x, f: decorrelator.process_ri_batched(dcfg, dw, st, x,
                                                         fused=f),
        lambda: decorrelator.init_state_batched(dcfg, dw, DCR_STREAMS, dev),
        xs, {"analysis_front_ri": N_CHUNKS, "synthesis_back_ri": N_CHUNKS},
        audio_compare(("in_tail", "ola_tail", "delay_buf", "iir_state",
                       "in_energy", "out_energy", "d1", "d2")),
        ak, card, queued_calls=2, streams=DCR_STREAMS)

    # 26: ambi_drc at the 1024-row shape
    rcfg = ambi_drc.AmbiDrcConfig(order=AN_ORDER, theshold_db=-20.0,
                                  ratio=4.0, knee_db=6.0)
    xs = [uniform(rng, (DRC_STREAMS, rcfg.nsh, T), dev)
          for _ in range(N_CHUNKS)]
    out["ambi_drc"] = phase_path(
        f"ambi_drc order {AN_ORDER} x {DRC_STREAMS} streams", 26,
        lambda st, x, f: ambi_drc.process_ri_batched(rcfg, st, x, fused=f),
        lambda: ambi_drc.init_state_batched(rcfg, DRC_STREAMS, dev),
        xs, {"analysis_front_ri": N_CHUNKS, "synthesis_back_ri": N_CHUNKS},
        audio_compare(("in_tail", "ola_tail", "yl_z1")), ak, card,
        queued_calls=2, streams=DRC_STREAMS)

    # 27: powermap, 32 instances and 1, 8 chunks a call
    t0 = time.perf_counter()
    pcfg = powermap.PowermapConfig(master_order=AN_ORDER, mode="music",
                                   norm="n3d")
    pw = powermap.design(pcfg, device=dev)
    print(f"phase 27: powermap design (order {AN_ORDER}, MUSIC, "
          f"{pw.Y_grid.shape[1]}-point geosphere, "
          f"{pw.interp_table.shape[0]}-point 5° display table) on the host "
          f"in {time.perf_counter() - t0:.2f} s")

    def map_compare(pk, sk, pp, sp):
        return {"Cx_re": rel_err(sk.Cx_re, sp.Cx_re),
                "Cx_im": rel_err(sk.Cx_im, sp.Cx_im),
                "map": (rel_err(pk, pp), MAP_TOL),
                "prev_pmap": (rel_err(sk.prev_pmap, sp.prev_pmap), MAP_TOL)}

    for n, expect in ((PM_INSTANCES, {"analysis_front_ri": 2 * N_CHUNKS}),
                      (1, {})):
        lead = (N_CHUNKS, n) if n > 1 else (N_CHUNKS,)
        xs = [sh_scenes(rng, lead, AN_ORDER, T, dev) for _ in range(2)]
        init = ((lambda: powermap.init_state_batched(pcfg, pw, n, dev))
                if n > 1 else (lambda: powermap.init_state(pcfg, pw, dev)))
        out[f"powermap {n}"] = phase_path(
            f"powermap order {AN_ORDER} MUSIC x {n}", 27,
            lambda st, x, f: powermap.analysis_chunks(pcfg, pw, st, x,
                                                      fused=f),
            init, xs, expect, map_compare, ak, card,
            chunks_per_call=N_CHUNKS, streams=n)

    # 28: sldoa, 32 instances and 1
    t0 = time.perf_counter()
    scfg = sldoa.SldoaConfig(master_order=AN_ORDER, norm="n3d")
    sw = sldoa.design(scfg, device=dev)
    print(f"phase 28: sldoa design (order {AN_ORDER}, "
          f"{scfg.max_sectors} sectors, 2562-point fit grid) on the host in "
          f"{time.perf_counter() - t0:.2f} s")

    def doa_compare(ok_, sk, op_, sp):
        errs = sldoa_errors(ok_, op_, sp.energy)
        errs["energy state"] = rel_err(sk.energy, sp.energy)
        return errs

    for n, expect in ((PM_INSTANCES, {"analysis_front_ri": N_CHUNKS}),
                      (1, {})):
        xs = [sh_scenes(rng, (n,), AN_ORDER, T, dev) for _ in range(N_CHUNKS)]
        if n == 1:
            xs = [x[0] for x in xs]
            proc = lambda st, x, f: sldoa.analysis(scfg, sw, st, x)  # noqa
            init = lambda: sldoa.init_state(scfg, dev)  # noqa: E731
        else:
            proc = lambda st, x, f: sldoa.analysis_batched(  # noqa: E731
                scfg, sw, st, x, fused=f)
            init = lambda: sldoa.init_state_batched(scfg, n, dev)  # noqa
        out[f"sldoa {n}"] = phase_path(
            f"sldoa order {AN_ORDER} x {n}", 28, proc, init, xs, expect,
            doa_compare, ak, card, queued_calls=1, streams=n)

    phase_dirass(dirass, ak, dev, rng, card)
    return out


def phase_dirass(dirass, ak, dev, rng, card):
    """Phase 29: dirass (order 2 → 6, t-design 18, 8192-sample blocks) in
    its three modes: none of the six kernels, as in the JAX package; the
    warm blocks under ``set_sync_debug_mode("error")``, the card's maps
    and states against the CPU's (DIRASS_TOL), wall, device and host ms
    per block."""
    T = HOPS * 128
    t0 = time.perf_counter()
    base = dirass.DirassConfig(input_order=2, upscale_order=6,
                               grid_tdesign=18, norm="n3d")
    w = dirass.design(base, device=dev)       # the same for every mode
    cw = w._replace(**{k: v.cpu() for k, v in w._asdict().items()
                       if isinstance(v, torch.Tensor)})
    print(f"phase 29: dirass design (order 2 -> 6, {w.W_beam.shape[0]}-point "
          f"t-design, 5° display table) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    for mode in ("off", "upscale", "nearest"):
        cfg = dataclasses.replace(base, mode=mode)
        xs = [uniform(rng, (cfg.nsh, T), dev) for _ in range(N_CHUNKS)]
        ref, ref_st = [], dirass.init_state(cfg, cw, device="cpu")
        for x in xs[:3]:
            p, ref_st = dirass.analysis(cfg, cw, ref_st, x.cpu())
            ref.append(p)
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        st = dirass.init_state(cfg, w, device=dev)
        got = []
        p, st = dirass.analysis(cfg, w, st, xs[0])
        got.append(p)
        with EighWatch():
            for i, x in enumerate(xs[1:], 1):
                p, st = dirass.analysis(cfg, w, st, x)
                got.append(p)
                if i == 2:
                    st3 = st
        torch.cuda.synchronize()
        ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
        check(not any(ran.values()), f"dirass {mode} launched {ran}")
        check(all(bool(torch.isfinite(p).all()) for p in got),
              f"dirass {mode}: non-finite map")
        errs = {"map": (torch.stack(got[:3]).cpu()
                        - torch.stack(ref)).abs().max().item()}
        for name in ("prev_energy", "prev_intensity"):
            a, b = getattr(st3, name).cpu(), getattr(ref_st, name)
            errs[name] = (a - b).abs().max().item() / max(
                b.abs().max().item(), 1e-30)
        held = [k for k in errs if mode != "nearest" or k != "map"]
        print(f"phase 29: dirass {mode}: {N_CHUNKS} blocks, none of the six "
              f"kernels, the warm blocks under set_sync_debug_mode('error'); "
              f"card vs CPU over 3 blocks, max |err| ("
              + ", ".join(f"{k} {v:.3e}" + ("" if k in held else
                                             " not held")
                          for k, v in errs.items())
              + f"; tol {DIRASS_TOL}, states relative to their largest)")
        check(all(errs[k] <= DIRASS_TOL for k in held),
              f"dirass {mode} on the card: {errs}")
        state = {"st": st, "i": 0}

        def step():
            _, state["st"] = dirass.analysis(cfg, w, state["st"],
                                             xs[state["i"] % N_CHUNKS])
            state["i"] += 1

        for _ in range(2):
            step()
        wall = [cuda_ms(step, N_CHUNKS) for _ in range(2)]
        runs = [device_ms(step, 1) for _ in range(3)]
        dev_ms, host_ms = (float(np.median([r[i] for r in runs]))
                           for i in (0, 1))
        check(all(r[2] for r in runs),
              f"dirass {mode}: a block made the host wait for the device")
        print(f"phase 29: dirass {mode} [{card}]: {np.mean(wall):.4f} ms per "
              f"block of {T} samples (runs {['%.4f' % r for r in wall]}), "
              f"device {dev_ms:.4f} ms back to back, host enqueue "
              f"{host_ms:.4f} ms, so the device idles "
              f"{100 * (1 - dev_ms / np.mean(wall)):.1f} %")


def phase_analyser_c_parity(ak, dev, card):
    """Phase 30: parity with the compiled C on the card, at the JAX tests'
    tolerances (tests/test_c_goldens.py): the DoA maps (``doa_*``) through
    the (re, im) map generators, the decorrelator (``dcr`` with the delays
    at rand() offset 5016, ``dkr`` with the ducker), ambi_drc (``drc``),
    every powermap mode (``pm``, ``pmp``, ``pmv``, ``pml``, ``pmc``,
    ``pmn``), sldoa (``sl_*``) and dirass (``dir``, ``dirn``, ``diro``,
    ``diru``); the single-stream blocks after the first under
    ``set_sync_debug_mode("error")`` (the maps' eigh let through), and the
    decorrelator, ambi_drc and sldoa through their batched kernels too."""
    from spatial_audio_framework_tpu_torch.models import (ambi_drc,
                                                          decorrelator,
                                                          dirass, powermap,
                                                          sldoa)
    from spatial_audio_framework_tpu_torch.modules import sh, sh_est, vbap
    from spatial_audio_framework_tpu_torch.ops import herm_ri
    from spatial_audio_framework_tpu_torch.utils import geometry as geo
    from spatial_audio_framework_tpu_torch.utils import presets

    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")

    def held(key, err, tol, what=""):
        print(f"phase 30: {key}{what} vs the C reference on the card "
              f"[{card}]: {err:.3e} (tol {tol})")
        check(np.isfinite(err) and err <= tol, f"{key}: {err}")

    def blocks(process, st, xs):
        """Each block of ``xs`` through ``process``; after the first, under
        set_sync_debug_mode("error") with the eigh let through."""
        out, st = process(st, xs[0])
        outs = [out]
        with EighWatch():
            for x in xs[1:]:
                out, st = process(st, x)
                outs.append(out)
        return outs

    # doa: the PWD and MUSIC maps on the card, peaks and ESPRIT on the host
    grid = presets.tdesign(21)
    Cx = np.asarray(g["doa_Cx"])
    dirs = np.stack([np.radians(grid[:, 0]),
                     np.pi / 2 - np.radians(grid[:, 1])], -1)
    Y = torch.from_numpy(sh.get_sh_real(3, dirs).astype(np.float32)).to(dev)
    C = herm_ri.split(Cx, dev)
    p = sh_est.generate_pwd_map_ri(C, Y).cpu().numpy()
    ref = np.asarray(g["doa_pwd_map"])
    held("doa_pwd_map", np.abs(p - ref).max() / max(1.0, ref.max()), C_TOL,
         " (relative to max(1, max))")
    check(set(sh_est.find_peaks_vonmises(p, grid, 2).tolist())
          == set(int(i) for i in g["doa_pwd_peaks"]), "doa_pwd_peaks")
    q = sh_est.generate_music_map_ri(C, Y, 2).cpu().numpy()
    ref = np.asarray(g["doa_music_map"])
    held("doa_music_map", np.abs(1 / q - 1 / ref).max()
         / max(1.0, (1 / ref).max()), C_TOL, " as 1/p")
    check(set(sh_est.find_peaks_vonmises(q, grid, 2).tolist())
          == set(int(i) for i in g["doa_music_peaks"]), "doa_music_peaks")
    _, V = np.linalg.eigh(Cx.astype(np.complex64))
    d = np.sort(sh_est.sph_esprit(V[:, ::-1][:, :2]), axis=0)
    held("doa_esprit_dirs_rad", float(np.abs(
        d - np.sort(np.asarray(g["doa_esprit_dirs_rad"]), axis=0)).max()),
        1e-3, " (ESPRIT on the host)")

    # the decorrelator and ambi_drc: 64 blocks of 128 samples, and one
    # 64-hop block through the batched kernels
    for key, cfg, off in (
            ("dcr", decorrelator.DecorrelatorConfig(n_channels=4), 5016),
            ("dkr", decorrelator.DecorrelatorConfig(
                n_channels=4, decor_amount=0.8, enable_transient_ducker=True,
                compensate_level=True), 0)):
        w = decorrelator.design(cfg, c_rand_offset=off, device=dev)
        x = torch.from_numpy(np.asarray(g[f"{key}_in"], np.float32)).to(dev)
        out = frames(lambda s, xb: decorrelator.process(cfg, w, s, xb),
                     decorrelator.init_state(cfg, w, device=dev), x, 128, 64)
        held(key, float(np.abs(out - g[f"{key}_out"]).max()), C_TOL,
             " (single-stream process)")
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        y, _ = decorrelator.process_ri_batched(
            cfg, w, decorrelator.init_state_batched(cfg, w, 1, dev), x[None])
        ran = {k: getattr(ak, k).launches - before[k] for k in ak.KERNELS}
        check(ran["analysis_front_ri"] == ran["synthesis_back_ri"] == 1,
              f"{key}: the batched path bypassed its kernels: {ran}")
        held(key, float((y[0].cpu() - torch.from_numpy(
            np.asarray(g[f"{key}_out"]))).abs().max()), C_TOL,
            " (batched, analysis_front_ri and synthesis_back_ri once)")
    rcfg = ambi_drc.AmbiDrcConfig(order=1, theshold_db=-30.0, ratio=8.0,
                                  knee_db=5.0, attack_ms=20.0,
                                  release_ms=200.0, in_gain_db=6.0,
                                  out_gain_db=3.0)
    x = torch.from_numpy(np.asarray(g["drc_in"], np.float32)).to(dev)
    out = frames(lambda s, xb: ambi_drc.process(rcfg, s, xb),
                 ambi_drc.init_state(rcfg, device=dev), x, 128, 64)
    held("drc", float(np.abs(out - g["drc_out"]).max()), C_TOL,
         " (single-stream process)")
    y, _ = ambi_drc.process_ri_batched(
        rcfg, ambi_drc.init_state_batched(rcfg, 1, dev), x[None])
    held("drc", float(np.abs(y[0].cpu().numpy() - g["drc_out"]).max()),
         C_TOL, " (batched kernels)")

    # powermap: the part-7 recipe (order-1 analysis per band) in each mode,
    # on one design (it does not depend on the mode)
    c_grid = np.asarray(g["pm_grid_dirs"], np.float64)
    base = powermap.PowermapConfig(master_order=3, n_sources=2, norm="n3d",
                                   cov_avg_coeff=0.5, pmap_avg_coeff=0.666,
                                   analysis_order_per_band=(1,) * 133)
    w0 = powermap.design(base, device=dev)
    for tag, mode in (("pm", "music"), ("pmp", "pwd"), ("pmv", "mvdr"),
                      ("pml", "music_log"), ("pmc", "cropac_lcmv"),
                      ("pmn", "minnorm")):
        cfg, w = dataclasses.replace(base, mode=mode), w0
        if tag == "pm":
            table = vbap.vbap_gain_table_to_interp_table(
                vbap.generate_vbap_gain_table_3d_srcs(c_grid,
                                                      w.grid_dirs_deg))
        else:
            iti = np.asarray(g[f"{tag}_pmap_iti"])
            table = np.zeros((iti.shape[0], w.interp_table.shape[1]))
            np.add.at(table, (np.arange(iti.shape[0])[:, None], iti),
                      np.asarray(g[f"{tag}_pmap_itw"], np.float32))
        w = w._replace(interp_table=torch.from_numpy(
            np.asarray(table, np.float32)).to(dev), interp_dirs_deg=c_grid)
        xs = torch.from_numpy(np.asarray(g[f"{tag}_in"], np.float32)).to(dev)
        maps = blocks(lambda s, xb: powermap.analysis(cfg, w, s, xb),
                      powermap.init_state(cfg, w, dev), xs)
        ours = maps[-1].cpu().numpy()
        ref = np.asarray(g[f"{tag}_pmap"])
        if tag == "pm":
            held("pm", float(np.abs(maps[0].cpu().numpy() - ref).max()),
                 C_TOL, " (block 1, where the C's map froze)")
            held("pm", float(np.abs(ours - ref).max()), 2e-2, " (block 8)")
        elif mode == "minnorm":
            r = np.corrcoef(np.log(ours + 1e-5), np.log(ref + 1e-5))[0, 1]
            print(f"phase 30: pmn vs the C reference on the card [{card}]: "
                  f"log-map correlation {r:.4f} (at least 0.8; MinNorm's "
                  "linear map is held statistically, as in the JAX test)")
            check(r >= 0.8, f"pmn: correlation {r}")
        else:
            held(tag, float(np.abs(ours - ref).max()),
                 5e-3 if mode == "cropac_lcmv" else 2e-3)

    # sldoa: 8 blocks, single-stream and through the batched front kernel
    scfg = sldoa.SldoaConfig(master_order=3, norm="n3d", min_freq=500.0,
                             max_freq=10000.0, avg_ms=0.5)
    sw = sldoa.design(scfg, device=dev)
    xs = torch.from_numpy(np.asarray(g["sl_in"], np.float32)).to(dev)
    freqs = scfg.afstft.centre_freqs(scfg.fs)
    sel = (freqs >= 500.0) & (freqs <= 10000.0)
    sel[0] = False
    for what, outs in (
            ("single-stream", blocks(
                lambda s, xb: sldoa.analysis(scfg, sw, s, xb),
                sldoa.init_state(scfg, dev), xs)),
            ("batched front kernel", [o for o in blocks(
                lambda s, xb: sldoa.analysis_batched(scfg, sw, s, xb[None]),
                sldoa.init_state_batched(scfg, 1, dev), xs)])):
        o = outs[-1]
        for name, mine, tol in (("sl_azi", o.azi_deg, 0.05),
                                ("sl_elev", o.elev_deg, 0.05),
                                ("sl_colour", o.colour_scale, 1e-6),
                                ("sl_alpha", o.alpha_scale, 1e-4)):
            ref = np.asarray(g[name]).reshape(133, 49)[:, :9]
            mine = mine.reshape(133, 9).cpu().numpy()
            held(name, float(np.abs(mine[sel] - ref[sel]).max()), tol,
                 f" ({what})")

    # dirass: order 2, t-design 18, 6 blocks in each mode
    c_grid = np.asarray(g["dir_grid_dirs"], np.float64)
    base = dirass.DirassConfig(input_order=2, upscale_order=6,
                               beam_type="maxre", grid_tdesign=18,
                               min_freq_hz=100.0, max_freq_hz=8000.0,
                               pmap_avg_coeff=0.25, norm="n3d")
    w0 = dirass.design(base, device=dev)
    for tag, mode in (("dir", "upscale"), ("dirn", "nearest"),
                      ("diro", "off"), ("diru", "upscale")):
        cfg, w = dataclasses.replace(base, mode=mode), w0
        if tag == "dir":
            table = vbap.vbap_gain_table_to_interp_table(
                vbap.generate_vbap_gain_table_3d_srcs(c_grid,
                                                      w.grid_dirs_deg))
        else:
            iti = np.asarray(g[f"{tag}_pmap_iti"])
            table = np.zeros((iti.shape[0], w.interp_table.shape[1]))
            np.add.at(table, (np.arange(iti.shape[0])[:, None], iti),
                      np.asarray(g[f"{tag}_pmap_itw"], np.float32))
        w = w._replace(
            interp_table=torch.from_numpy(np.asarray(table, np.float32)).to(
                dev), interp_dirs_deg=c_grid,
            interp_u=torch.from_numpy(np.asarray(
                geo.unit_sph2cart(c_grid, degrees=True), np.float32)).to(dev))
        xs = torch.from_numpy(np.asarray(g[f"{tag}_in"], np.float32)).to(dev)
        before = {k: getattr(ak, k).launches for k in ak.KERNELS}
        pmap = blocks(lambda s, xb: dirass.analysis(cfg, w, s, xb),
                      dirass.init_state(cfg, w, device=dev), xs)[-1]
        check(not any(getattr(ak, k).launches - before[k] for k in ak.KERNELS),
              "dirass launched a kernel")
        pmap, ref = pmap.cpu().numpy(), np.asarray(g[f"{tag}_pmap"])
        if tag == "dir":
            held("dir", float(np.abs(pmap - ref).max()), 5e-2,
                 f" (correlation {np.corrcoef(pmap, ref)[0, 1]:.4f}, at "
                 "least 0.995)")
            check(np.corrcoef(pmap, ref)[0, 1] >= 0.995, "dir: correlation")
        else:
            held(tag, float(np.abs(pmap - ref).max()),
                 1e-3 if mode == "off" else 1e-2)


def _on(x, device):
    return (tuple(_on(t, device) for t in x) if isinstance(x, tuple)
            else x.to(device))


def plain_path(name, phase, make, xs, ak, dev, card, audio_s, tol,
               held=lambda st: [], compare_calls=2, state_tol=None):
    """A path that runs none of the six kernels (as in the JAX package):
    ``make(device) -> (init_state(), process(st, x) -> (y, st))`` over the
    calls ``xs`` (on the card ``dev``).  Every launch counter reset just before the
    main run and read just after (all must stay 0); the card against the
    CPU on the same inputs over ``compare_calls`` calls (the output at most
    ``tol``, or printed when ``tol`` is None, and the ``held(state)`` leaves
    at most ``state_tol``, default ``tol``, relative to max(1, |CPU|));
    the warm calls under ``set_sync_debug_mode("error")``; then wall ms per
    call by CUDA events, host enqueue ms per call, and (last: the profiler
    slows the host afterwards) device busy ms and launches per call by
    torch.profiler.  ``audio_s``: audio seconds a call.  Returns the
    numbers."""
    init, process = make(dev)
    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    st, ys = init(), []
    for x in xs:
        y, st = process(st, x)
        ys.append(y)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    print(f"phase {phase}: {name} ran {len(xs)} calls; launches = "
          f"{launches}")
    check(not any(launches.values()), f"{name} launched {launches}")
    check(all(bool(torch.isfinite(y).all()) for y in ys),
          f"{name}: non-finite output")
    cinit, cproc = make("cpu")
    cst, st = cinit(), init()
    errs = {"y": 0.0}
    for x in xs[:compare_calls]:
        yc, cst = cproc(cst, _on(x, "cpu"))
        yk, st = process(st, x)
        errs["y"] = max(errs["y"], rel_err(yk.cpu(), yc))
    for i, (a, b) in enumerate(zip(held(st), held(cst))):
        errs[f"state {i}"] = rel_err(a.cpu(), b)
    state_tol = tol if state_tol is None else state_tol
    print(f"phase {phase}: {name} on the card vs on the CPU over "
          f"{compare_calls} calls, max |err| relative to max(1, |CPU|): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (tol {tol or 'none: printed'} on y, {state_tol} on the "
          "states)")
    check(all(v <= (tol if k == "y" else state_tol)
              for k, v in errs.items() if k != "y" or tol),
          f"{name}: {errs}")

    st = init()
    _, st = process(st, xs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for x in xs[1:]:
            _, st = process(st, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"phase {phase}: {name}: {len(xs) - 1} warm calls under "
          "set_sync_debug_mode('error'): no host wait")

    state = {"st": st, "i": 0}

    def step():
        _, state["st"] = process(state["st"], xs[state["i"] % len(xs)])
        state["i"] += 1

    step()
    wall = [cuda_ms(step, len(xs)) for _ in range(2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(len(xs)):
        step()
    host = (time.perf_counter() - t0) * 1e3 / len(xs)
    torch.cuda.synchronize()
    n_launch, busy = launches_per_call(step, 2)
    w = float(np.mean(wall))
    print(f"phase {phase}: {name} [{card}]: {w:.4f} ms per call (runs "
          f"{['%.4f' % r for r in wall]}) = {audio_s / (w / 1e3):.1f} "
          f"audio-seconds per second; host enqueue {host:.4f} ms per call; "
          f"device busy {busy:.4f} ms in {n_launch:.0f} launches per call "
          f"(torch.profiler), so the device idles "
          f"{100 * (1 - busy / w):.1f} %")
    return {"ms": w, "host_ms": host, "device_ms": busy,
            "launches_per_call": n_launch}


def phase_conv_room(ak, dev, rng, card) -> None:
    """Phases 31-32: tvconv (64 positions x 2 channels x 2048-tap IRs, hop
    128, chunks of 8192 samples: a moving listener with a new nearest
    position every chunk, a static listener, and 32 moving instances) and
    ambi_roomsim (order 2, 2 sources, 1 receiver, reflection order 2, the
    default room and walls; 1 instance and 32), the JAX benchmark's cells
    (bench.py:1103-1216).  None of the six kernels, as in the JAX package:
    each against the CPU, the warm chunks under the sync debug mode (TVConv
    selects its crossfade rows on the card), times."""
    from spatial_audio_framework_tpu_torch.models import (ambi_roomsim,
                                                          conv_examples)

    T = HOPS * 128
    t0 = time.perf_counter()
    irs = 0.1 * rng.standard_normal((64, 2, 2048)).astype(np.float32)
    irs[:, :, 0] += 1.0
    pos = rng.uniform(0, 5, (64, 3)).astype(np.float32)
    ex = conv_examples.TVConvExample()
    designs = {d: ex.design_ri(irs, pos, d) for d in ("cpu", dev)}
    print(f"phase 31: tvconv design (64 positions x 2 channels x 2048 taps, "
          f"{designs[dev][0].n_part} partitions of 128) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    for label, n in (("moving listener", None), ("static listener", None),
                     (f"{NB_INST} moving instances", NB_INST)):
        batch = () if n is None else (n,)
        xs = []
        for k in range(N_CHUNKS):
            x = uniform(rng, batch + (T,), dev)
            if n is not None:
                lp = torch.from_numpy(pos[(k * n + np.arange(n)) % 64])
            else:
                lp = torch.from_numpy(pos[3 if label[0] == "s" else k])
            xs.append((x, (lp + 0.01).to(dev)))

        def make(d, batch=batch):
            conv, H, p = designs[d if d == "cpu" else dev]

            def process(st, xp):
                return ex.process_ri(conv, H, st, xp[0], xp[1], p)
            return (lambda: ex.init_state_ri(conv, batch=batch, device=d),
                    process)

        plain_path(f"tvconv {label}", 31, make, xs, ak, dev, card,
                   (n or 1) * T / FS, KERNEL_TOL,
                   held=lambda st: [st.X_hist, st.ola, st.ola_last])
    time_tv_crossfade(designs[dev], rng, dev, card)

    t0 = time.perf_counter()
    cfg = ambi_roomsim.AmbiRoomSimConfig(sh_order=2, n_sources=2,
                                         refl_order=2)
    src = np.array([[2.0, 3.0, 1.5], [4.0, 2.0, 1.7]])
    rec = np.array([[3.0, 2.5, 1.6]])
    rw = {d: ambi_roomsim.design_ri(cfg, src, rec, device=d)
          for d in ("cpu", dev)}
    print(f"phase 32: ambi_roomsim design (order 2, 2 sources, reflection "
          f"order 2: RIRs of {rw[dev].conv.length_h} taps, "
          f"{rw[dev].conv.n_part} partitions) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    for n in (None, NB_INST):
        batch = () if n is None else (n,)
        xs = [uniform(rng, batch + (2, T), dev) for _ in range(N_CHUNKS)]

        def make(d, batch=batch):
            w = rw[d if d == "cpu" else dev]
            return (lambda: ambi_roomsim.init_state_ri(cfg, w, batch, d),
                    lambda st, x: ambi_roomsim.process_ri(cfg, w, st, x))

        plain_path(f"ambi_roomsim order 2 x {n or 1}", 32, make, xs, ak, dev,
                   card, (n or 1) * T / FS, KERNEL_TOL,
                   held=lambda st: list(st))
        time_mac(rw[dev], batch, rng, dev, card)


def time_tv_crossfade(design, rng, dev, card) -> None:
    """The cost of TVConv's crossfade rows, computed every block: device ms
    (calls queued behind a spin kernel) of the per-hop ``apply_block_ri``
    (its two crossfade streams are whole-block convolutions, selected per
    hop) against ``apply_block_ri_const`` (one whole-block convolution and
    three single-hop ones), one listener and 32, a moving index."""
    conv, H, _ = design
    T, nh = HOPS * 128, HOPS
    for n in (None, NB_INST):
        batch = () if n is None else (n,)
        st = conv.init_state_ri(0, batch, dev)
        x = uniform(rng, batch + (T,), dev)
        idx = torch.arange(nh, device=dev, dtype=torch.int32) % 64
        idx = idx.expand(batch + (nh,)).contiguous()
        idxc = idx[..., 0].contiguous()
        t = {"per hop": cuda_ms(lambda: conv.apply_block_ri(H, st, x, idx),
                                8, queued=True),
             "const": cuda_ms(lambda: conv.apply_block_ri_const(H, st, x,
                                                               idxc),
                              8, queued=True)}
        print(f"phase 31: tvconv x {n or 1} [{card}]: apply_block_ri "
              f"(per-hop index, crossfade rows of two more whole-block "
              f"convolutions every block) {t['per hop']:.4f} ms, "
              f"apply_block_ri_const {t['const']:.4f} ms of device per "
              f"chunk of {nh} hops")


def time_mac(w, batch, rng, dev, card) -> None:
    """The convolvers' one spectral core, ``matrix_conv._mac`` (one complex
    product batched over the bins), alone at ambi_roomsim's shape: device
    ms per chunk, queued behind a spin kernel."""
    from spatial_audio_framework_tpu_torch.ops import matrix_conv

    Hc = torch.complex(*w.Hf)
    P, n_out, n_in, nb = Hc.shape
    win = torch.complex(*(uniform(rng, batch + (HOPS, P, n_in, nb), dev)
                          for _ in range(2)))
    ms = cuda_ms(lambda: matrix_conv._mac(win, Hc), 20, queued=True)
    print(f"phase 32: the spectral core _mac at {batch + (HOPS, P, n_in)} "
          f"x {nb} bins -> {n_out} outputs [{card}]: {ms:.4f} ms of device "
          f"per chunk")


def phase_hades_spreader(ak, dev, rng, card) -> dict:
    """Phases 33-34: HADES (binaural BMVDR with covariance matching, the
    default HRIRs [::4] as the 2-mic array, blocks of 1024; one instance at
    64 blocks a call on the plain single-stream filterbank, 32 instances at
    4 blocks a call through ``process_chunk_batched``) and the spreader (OM
    mode, 1 source, frames of 512; 32 frames a chunk for one instance, 8
    frames for 32 instances through ``process_chunk``'s instance axis), the
    JAX benchmark's cells (bench.py:886-936, :1294-1358).  The batched
    paths launch ``analysis_front_ri`` and ``synthesis_back_ri`` once a
    call each, held against ``fused=False``; the single-instance paths
    launch none, held against the CPU.  Returns the batched paths'
    launches."""
    from spatial_audio_framework_tpu_torch.models import spreader
    from spatial_audio_framework_tpu_torch.modules import hades

    out = {}
    t0 = time.perf_counter()
    pipes = {}
    for d in ("cpu", dev):
        ana = hades.HadesAnalysis(device=d)
        pipes[d] = hades.HadesPipeline(ana, hades.HadesSynthesis(
            ana, beam_option=hades.HADES_BEAMFORMER_BMVDR))
    ana = pipes[dev].ana
    print(f"phase 33: HADES design ({ana.n_mics} mics, {ana.n_grid}-point "
          f"grid, BMVDR, triangular HRTFs) twice (card, CPU) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    bs = ana.blocksize
    xs = [uniform(rng, (64, 2, bs), dev) for _ in range(2)]

    def make_h(d):
        p = pipes[d if d == "cpu" else dev]
        return p.init_state, p.process_chunk

    plain_path("HADES x 1, 64 blocks a call", 33, make_h, xs, ak, dev, card,
               64 * bs / FS, None, held=lambda st: list(st[1]),
               state_tol=KERNEL_TOL)
    pipe = pipes[dev]

    def hades_compare(yk, sk, yp, sp):
        # the front's outputs (the tails, the SCMs) at KERNEL_TOL; what
        # follows the DoA's argmin printed (see CHAIN_TOL), with the number
        # of instances whose output moved more than CHAIN_TOL (the most of
        # any call)
        per = ((yk - yp).abs().amax(dim=(1, 2, 3))
               / yp.abs().amax(dim=(1, 2, 3)).clamp_min(1.0))
        errs = {"y": (rel_err(yk, yp), None),
                f"instances past {CHAIN_TOL}": (
                    float((per > CHAIN_TOL).sum()), None)}
        for label, a, b in zip(("in_tail", "ola_tail", "Cx_re", "Cx_im",
                                "M_re", "M_im", "syn in_tail", "syn ola_tail"),
                               tensors(sk), tensors(sp)):
            errs[label] = rel_err(a, b)
            if label.startswith("M_") or label == "syn ola_tail":
                errs[label] = (errs[label], None)
        return errs

    xs = [uniform(rng, (NB_INST, NB_HOPS * 128 // bs, 2, bs), dev)
          for _ in range(N_CHUNKS)]
    out["hades"] = phase_path(
        f"HADES binaural BMVDR x {NB_INST}", 33,
        lambda st, x, f: pipe.process_chunk_batched(st, x, fused=f),
        lambda: pipe.init_state_batched(NB_INST), xs,
        {"analysis_front_ri": N_CHUNKS, "synthesis_back_ri": N_CHUNKS},
        hades_compare, ak, card, streams=NB_INST, samples=NB_HOPS * 128)

    t0 = time.perf_counter()
    cfg = spreader.SpreaderConfig(n_sources=1, mode=spreader.MODE_OM)
    sw = {d: spreader.design(cfg, device=d) for d in ("cpu", dev)}
    print(f"phase 34: spreader design (OM, {sw[dev].H_re.shape[-1]}-point "
          f"HRIR grid, lattice decorrelator) twice (card, CPU) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    dirs = {d: torch.tensor([[40.0, 10.0]], device=d) for d in ("cpu", dev)}
    spread = {d: torch.tensor([60.0], device=d) for d in ("cpu", dev)}
    F = 512

    def make_s(d, n=None):
        dd = d if d == "cpu" else dev
        return ((lambda: spreader.init_state(cfg, sw[dd], n, device=d)),
                lambda st, x, f=True: spreader.process_chunk(
                    cfg, sw[dd], st, x, dirs[dd], spread[dd], fused=f))

    # OM's mixing matrices are free on the rank-one prototype's null space
    # (one source): the covariance averages and the output are held
    xs = [uniform(rng, (32, 1, F), dev) for _ in range(N_CHUNKS)]
    plain_path("spreader OM x 1, 32 frames a call", 34, make_s, xs, ak, dev,
               card, 32 * F / FS, CHAIN_TOL,
               held=lambda st: [st.Cproto_re, st.Cproto_im, st.Cy_re,
                                st.Cy_im], state_tol=KERNEL_TOL)

    def spr_compare(yk, sk, yp, sp):
        errs = {"y": (rel_err(yk, yp), CHAIN_TOL),
                "ola_tail": (rel_err(sk.bank.ola_tail, sp.bank.ola_tail),
                             CHAIN_TOL)}
        for label in ("Cproto_re", "Cproto_im", "Cy_re", "Cy_im"):
            errs[label] = rel_err(getattr(sk, label), getattr(sp, label))
        for label in ("prev_M_re", "prev_M_im", "prev_Mr"):
            errs[label] = (rel_err(getattr(sk, label), getattr(sp, label)),
                           None)
        return errs

    init_b, proc_b = make_s(dev, NB_INST)
    xs = [uniform(rng, (NB_INST, NB_HOPS * 128 // F, 1, F), dev)
          for _ in range(N_CHUNKS)]
    out["spreader"] = phase_path(
        f"spreader OM x {NB_INST}", 34, proc_b, init_b, xs,
        {"analysis_front_ri": N_CHUNKS, "synthesis_back_ri": N_CHUNKS},
        spr_compare, ak, card, streams=NB_INST, samples=NB_HOPS * 128)
    return out


def phase_conv_hades_c_parity(ak, dev, card) -> None:
    """Phase 35: parity with the compiled C on the card at the JAX tests'
    tolerances (tests/test_c_goldens.py): the convolvers (``mc_*`` both
    modes and the (re, im) form, ``mtc_*``, ``tvc_*`` both forms),
    ambi_roomsim (``ars``), CDF4SAP's generic path (``cdf_*``, real and
    complex, with and without energy), HADES through its two-stage path
    (``hds``, ``hdt``, ``hdr``, ``hdh``: diffuseness and DoA indices each
    block, DoA held equal) and the spreader in its three modes
    (``spr_*``)."""
    from spatial_audio_framework_tpu_torch.models import ambi_roomsim
    from spatial_audio_framework_tpu_torch.models import spreader as SPR
    from spatial_audio_framework_tpu_torch.modules import cdf4sap, hrir
    from spatial_audio_framework_tpu_torch.modules import hades as HD
    from spatial_audio_framework_tpu_torch.ops import matrix_conv as MC

    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")

    def held(key, out, ref, tol=C_TOL, what=""):
        out = out.cpu().numpy() if isinstance(out, torch.Tensor) else out
        ref = np.asarray(ref).reshape(out.shape) if np.size(ref) == np.size(
            out) else np.asarray(ref)
        err = (float(np.abs(out - ref).max()) if out.shape == ref.shape
               else float("inf"))
        print(f"phase 35: {key}{what} vs the C reference on the card "
              f"[{card}]: {err:.3e} (tol {tol})")
        check(np.isfinite(out).all() and err <= tol, f"{key}: {err}")

    def t(a, dtype=np.float32):
        return torch.from_numpy(np.asarray(a, dtype)).to(dev)

    x = t(g["mc_in"])
    for part in (False, True):
        mc = MC.MatrixConv(hop=128, length_h=1024, n_in=2, n_out=3,
                           partitioned=part)
        Hd, st, outs = mc.design(np.asarray(g["mc_H"]), dev), \
            mc.init_state(device=dev), []
        for b in range(8):
            y, st = mc.apply_block(Hd, st, x[:, b * 128:(b + 1) * 128])
            outs.append(y)
        key = "mc_out_part" if part else "mc_out_nonpart"
        held(key, torch.cat(outs, -1), g[key])
    y, _ = mc.apply_block_ri(mc.design_ri(np.asarray(g["mc_H"]), dev),
                             mc.init_state_ri(device=dev), x)
    held("mc_out_part", y, g["mc_out_part"], what=" ((re, im) form)")
    for part in (False, True):
        mu = MC.MultiConv(hop=128, length_h=300, n_ch=3, partitioned=part)
        y, _ = mu.apply_block(mu.design(np.asarray(g["mtc_H"]), dev),
                              mu.init_state(device=dev), t(g["mtc_in"]))
        key = "mtc_out_part" if part else "mtc_out_nonpart"
        held(key, y, g[key])
    tv = MC.TVConv(hop=128, length_h=512, n_out=2, n_irs=3)
    idx = t(g["tvc_idx"], np.int32)
    y, _ = tv.apply_block(tv.design(np.asarray(g["tvc_H"]), dev),
                          tv.init_state(0, device=dev), t(g["tvc_in"]), idx)
    held("tvc_out", y, g["tvc_out"])
    y, _ = tv.apply_block_ri(tv.design_ri(np.asarray(g["tvc_H"]), dev),
                             tv.init_state_ri(0, device=dev), t(g["tvc_in"]),
                             idx)
    held("tvc_out", y, g["tvc_out"], what=" ((re, im) form)")

    cfg = ambi_roomsim.AmbiRoomSimConfig(sh_order=2, n_sources=2,
                                         n_receivers=1, refl_order=2)
    w = ambi_roomsim.design_ri(cfg, np.array([[2.0, 3.0, 1.5],
                                              [4.0, 2.0, 1.7]]),
                               np.array([[3.0, 2.5, 1.6]]), device=dev)
    out = frames(lambda st, xb: ambi_roomsim.process_ri(cfg, w, st, xb),
                 ambi_roomsim.init_state_ri(cfg, w, device=dev),
                 t(g["ars_in"]), 128, 64)
    held("ars_out", out, g["ars_out"], what=" (warm frames under the sync "
         "debug mode)")

    for cplx in (False, True):
        s = "_c" if cplx else ""
        dt = np.complex64 if cplx else np.float32
        f = (cdf4sap.formulate_M_and_Cr_cmplx if cplx
             else cdf4sap.formulate_M_and_Cr)
        for energy in (False, True):
            M, Cr = f(*(torch.from_numpy(np.asarray(g[f"cdf_{k}{s}"]).astype(
                dt)).to(dev) for k in ("Cx", "Cy", "Q")), energy, 0.01)
            suff = s + ("_energy" if energy else "")
            held("cdf_M" + suff, M, g["cdf_M" + suff], 1e-3)
            held("cdf_Cr" + suff, Cr, g["cdf_Cr" + suff], 1e-3)

    hr, hd, hfs = hrir.default_hrirs()
    grid = np.asarray(g["hds_grid_dirs_deg"], np.float64)
    for pfx, kw, skw, n_blocks, tol in (
            ("hds", dict(hybrid=False, low_delay=True),
             dict(beam_option="bmvdr", interp_option="nearest"), 16, 5e-4),
            ("hdt", dict(hybrid=False, low_delay=True),
             dict(beam_option="none", interp_option="triangular",
                  enable_cm=False, hrirs=np.asarray(g["hdt_hrirs"],
                                                    np.float32),
                  hrir_dirs_deg=grid, hrir_fs=44100.0), 12, 1e-5),
            ("hdr", dict(hybrid=False, low_delay=True),
             dict(beam_option="filter_and_sum", interp_option="nearest"), 12,
             6e-4),
            ("hdh", dict(hybrid=True, low_delay=False),
             dict(beam_option="bmvdr", interp_option="nearest"), 8, 3e-4)):
        ana = HD.HadesAnalysis(
            fs=48000.0, hop=64,
            h_array=np.asarray(g[f"{pfx}_h_array"], np.float32),
            grid_dirs_deg=grid, blocksize=256, device=dev, **kw)
        skw = dict(dict(hrirs=hr, hrir_dirs_deg=hd, hrir_fs=hfs,
                        enable_cm=True), **skw)
        syn = HD.HadesSynthesis(ana, ref_indices=(1, 5), **skw)
        ed = HD.HadesRadialEditor(ana.grid_dirs_deg) if pfx == "hdr" else None
        ramp = -70.0 + 0.45 * np.arange(360)
        xin = np.asarray(g[f"{pfx}_in"], np.float32)
        outs, worst = [], 0.0
        for blk in range(n_blocks):
            params, sigs = ana.apply(t(xin[:, blk * 256:(blk + 1) * 256]))
            worst = max(worst, float(np.abs(
                params.diffuseness - g[f"{pfx}_diffuseness"][blk]).max()))
            check(np.array_equal(params.doa_idx, np.asarray(
                g[f"{pfx}_doa_idx"][blk]).astype(int)),
                f"{pfx}: DoA indices differ from the C at block {blk}")
            if ed is not None:
                params = ed.apply(params, ramp)
            outs.append(syn.apply(params, sigs))
        print(f"phase 35: {pfx}: DoA indices equal the C's in all "
              f"{n_blocks} x {ana.n_bands} band-blocks; diffuseness max "
              f"|err| {worst:.3e} (tol 1e-5)")
        check(worst <= 1e-5, f"{pfx} diffuseness: {worst}")
        key = "hds_out_bin" if pfx == "hds" else f"{pfx}_out"
        held(key, np.concatenate(outs, -1), g[key], tol)

    xs = t(g["spr_in"])
    for mode, key, off, tol in (("naive", "spr_out_naive", None, 2 * C_TOL),
                                ("om", "spr_out_om", 9272, 1e-3),
                                ("evd", "spr_out_evd", 16036, 1e-3)):
        cfg = SPR.SpreaderConfig(n_sources=1, mode=mode, cov_avg_coeff=0.5)
        w = SPR.design(cfg, c_rand_offset=off, device=dev)
        d = torch.tensor([[40.0, 10.0]], device=dev)
        sp = torch.tensor([60.0], device=dev)
        out = frames(lambda st, xb: SPR.process(cfg, w, st, xb, d, sp),
                     SPR.init_state(cfg, w, device=dev), xs[None], 512, 8)
        held(key, out, g[key], tol, " (warm frames under the sync debug "
             "mode)")



# the runtime's path: the flagship's 64 x 16 channels in frames of 1024
# samples (8 hops), fed by the host in blocks of 10 ms, for 2 s of audio
RT_FRAME, RT_BLOCK, RT_SECONDS = 1024, 480, 2.0
# the runtime against a direct loop of the same frames: the same launches on
# the same inputs (tests/test_runtime.py:113-145 holds the JAX runner at 1e-6)
RT_TOL = 1e-6


def phase_runtime(bcfg, bw, ak, dev, rng, card) -> dict:
    """Phase 36: StreamRunner over the flagship, synchronous and on the
    render thread; render_full_ri timed at the frame's shape.  Returns the
    launches of each mode's main run and the kernel's times at H = 8."""
    from spatial_audio_framework_tpu_torch.models import ambi_bin
    from spatial_audio_framework_tpu_torch.runtime import (StreamRunner,
                                                           native,
                                                           torch_frame_fn)

    check(native.native_available(),
          "the native runtime library did not build (g++): the ring "
          "buffers would be the pure-Python fallback")
    print(f"phase 36: native runtime {native.library_path().name} built "
          f"from {native.SRC.relative_to(ROOT)} by g++")
    nsh, S, F = bcfg.nsh, N_STREAMS, RT_FRAME
    n_in, n_out = S * nsh, S * 2
    T = int(RT_SECONDS * FS) // RT_BLOCK * RT_BLOCK
    n_frames = T // F
    x = (ANA_AMP * rng.uniform(-1.0, 1.0, (n_in, T))).astype(np.float32)

    def make():
        box = [ambi_bin.init_state_batched(bcfg, S, dev)]

        def fn(f):
            y, box[0] = ambi_bin.process_ri_batched(bcfg, bw, box[0],
                                                    f.reshape(S, nsh, F))
            return y.reshape(n_out, F)
        return fn

    # the direct loop: the same frames through the same call, no runtime
    direct = make()
    xd = torch.from_numpy(x[:, :n_frames * F]).to(dev)
    ref = torch.cat([direct(xd[:, k * F:(k + 1) * F])
                     for k in range(n_frames)], dim=1).cpu().numpy()
    runner = StreamRunner(torch_frame_fn(make(), n_in, F, dev), n_in, n_out,
                          F, fs=FS)
    runner.process_block(np.zeros((n_in, F), np.float32))   # warm: caches
    out = {}
    for mode in ("process_block", "render thread"):
        runner = StreamRunner(torch_frame_fn(make(), n_in, F, dev), n_in,
                              n_out, F, fs=FS, ring_frames=8)
        for k in ak.KERNELS:
            getattr(ak, k).launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if mode == "process_block":
            y = np.concatenate([runner.process_block(x[:, s:s + RT_BLOCK])
                                for s in range(0, T, RT_BLOCK)], axis=1)
        else:
            runner.start()
            fed, got, n_got = 0, [], 0
            deadline = time.monotonic() + 120.0
            try:
                while n_got < n_frames * F:
                    if fed < T:
                        fed += runner.push(x[:, fed:fed + RT_BLOCK])
                    chunk = runner.pull(RT_BLOCK)
                    if chunk.size:
                        got.append(chunk.copy())
                        n_got += chunk.shape[1]
                    else:
                        time.sleep(0.0002)
                    check(time.monotonic() < deadline,
                          "the render thread stalled")
            finally:
                runner.stop()
            y = np.concatenate(got, axis=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
        frames_run = runner.clock.frames
        print(f"phase 36: StreamRunner ({mode}) over the flagship main path: "
              f"{T} samples of {n_in} channels in blocks of {RT_BLOCK}, "
              f"{frames_run} frames of {F}; launches = {launches}")
        expect = {k: frames_run if k == "render_full_ri" else 0
                  for k in ak.KERNELS}
        check(frames_run == n_frames and launches == expect,
              f"runtime ({mode}): {frames_run} frames, expected launches "
              f"{expect}")
        if mode == "process_block":
            got_, want = y[:, F:n_frames * F], ref[:, :(n_frames - 1) * F]
            vs = "the direct loop delayed by one frame"
        else:     # the rings add no FIFO latency: frame k is samples k·F..
            got_, want = y[:, :n_frames * F], ref
            vs = "the direct loop"
        check(bool(np.isfinite(y).all()), f"runtime ({mode}): non-finite")
        err = float(np.abs(got_ - want).max())
        print(f"phase 36: StreamRunner ({mode}) vs {vs} of "
              f"process_ri_batched: max |err| = {err:.3e} (tol {RT_TOL})")
        check(err <= RT_TOL, f"runtime ({mode}) disagrees: {err}")
        ms = wall * 1e3 / frames_run
        print(f"phase 36: StreamRunner ({mode}) [{card}]: {ms:.4f} ms of "
              f"wall per frame of {F / FS * 1e3:.2f} ms of audio "
              f"({S} streams), frame clock rtf {runner.clock.rtf:.2f}, "
              f"audio-s/s {S * n_frames * F / FS / wall:.1f}; the "
              f"device-to-host read (pinned, its wait included) "
              f"{runner.read_s * 1e3 / frames_run:.4f} ms per frame = "
              f"{100 * runner.read_s / wall:.1f} % of the wall")
        out[mode] = {"launches": launches["render_full_ri"], "ms": ms,
                     "rtf": runner.clock.rtf,
                     "read_share": runner.read_s / wall}
    # the host's share, piece by piece (median ms of 20, host clock): the
    # FIFO framer's push of one block read in place (a run a channel), the
    # input ring's planar write of one block and its read, the output
    # ring's planar write of one frame's output and its read, and a
    # frame staged into pinned memory as process_block hands it on ((n_in,
    # F)) and as the render thread does (as it lies in the ring, (F, n_in))
    blk = x[:, :RT_BLOCK]
    framer = native.FifoFramer(n_in, F, n_out)
    ring, out_ring = (native.RingBuffer(4 * n_in * F),
                      native.RingBuffer(4 * n_out * F))
    pinned = torch.empty((n_in, F), dtype=torch.float32, pin_memory=True)
    pinned_t = torch.empty((F, n_in), dtype=torch.float32, pin_memory=True)
    frame = np.ascontiguousarray(x[:, :F])
    frame_t = np.ascontiguousarray(frame.T)
    y_frame = np.ascontiguousarray(x[:n_out, :F])

    def host_ms(fn):
        ts = []
        for _ in range(20):
            t0 = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(ts))

    def stage(host, f):
        host.numpy()[...] = f

    pieces = {
        "framer push (block)": lambda: framer.push(blk),
        "in ring planar write + read (block)": lambda: (
            ring.write_planar(blk), ring.read(n_in * RT_BLOCK)),
        "out ring planar write + read (frame)": lambda: (
            out_ring.write_planar(y_frame), out_ring.read(n_out * F)),
        "pinned staging (n_in, F)": lambda: stage(pinned, frame),
        "pinned staging as in the ring (F, n_in)": lambda: stage(
            pinned_t, frame_t)}
    print(f"phase 36: host pieces [{card}] (median ms, host clock): "
          + ", ".join(f"{k} {host_ms(v):.3f}" for k, v in pieces.items())
          + f"; a frame is {F / RT_BLOCK:.2f} blocks")
    # render_full_ri at the frame's shape (64, 16, 2, 8)
    H = F // 128
    taps = random_taps(ak, rng, S, nsh, 2, False, True, dev)
    in_tail = uniform(rng, (S, nsh, 15 * 128), dev)
    ola = uniform(rng, (S, 2, 9, 128), dev)
    xk = uniform(rng, (S, nsh, H * 128), dev)
    ky, _ = ak.render_full_ri(in_tail, xk, ola, taps)
    py, _ = ak.render_full_ri_reference(in_tail, xk, ola, taps)
    err = (ky - py).abs().max().item()
    check(err <= KERNEL_TOL, f"render_full_ri at H = {H}: {err}")
    t = ab_times({
        "kernel": lambda: ak.render_full_ri(in_tail, xk, ola, taps),
        "plain": lambda: ak.render_full_ri_reference(in_tail, xk, ola,
                                                     taps)}, 20, queued=True)
    b = render_full_bound(S, nsh, 2, H)
    report_times("render_full_ri", t, card,
                 f"{(S, nsh, 2, H)}, the runtime's frame (max |err| vs plain "
                 f"{err:.3e}; bound {b['bound_ms']:.4f} ms by "
                 f"{b['bound_by']})")
    out["times_h8"], out["bound_h8"] = t, b
    return out


def phase_render_signal(bcfg, bw, ak, dev, rng, card) -> int:
    """Phase 37: render_signal over the flagship, 8 blocks of 8192."""
    from spatial_audio_framework_tpu_torch.models import ambi_bin
    from spatial_audio_framework_tpu_torch.parallel.streaming import (
        render_signal)
    from spatial_audio_framework_tpu_torch.utils.profiling import (
        trace_annotation)

    T = HOPS * 128
    x = uniform(rng, (N_STREAMS, bcfg.nsh, N_CHUNKS * T), dev, ANA_AMP)

    def proc(st, b):
        return ambi_bin.process_ri_batched(bcfg, bw, st, b)

    def init():
        return ambi_bin.init_state_batched(bcfg, N_STREAMS, dev)

    render_signal(proc, init(), x[..., :2 * T], T)      # warm: caches
    st0 = init()
    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = render_signal(proc, st0, x, T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    print(f"phase 37: render_signal over the flagship main path, {N_CHUNKS} "
          f"blocks of {(N_STREAMS, bcfg.nsh, T)} under "
          f"set_sync_debug_mode('error'): no host wait; launches = "
          f"{launches}")
    check(launches == {k: N_CHUNKS if k == "render_full_ri" else 0
                       for k in ak.KERNELS}, "render_signal: launches")
    st, outs = init(), []
    for i in range(N_CHUNKS):
        o, st = proc(st, x[..., i * T:(i + 1) * T])
        outs.append(o)
    check(torch.equal(y, torch.cat(outs, dim=-1)),
          "render_signal differs from the hand loop")
    print("phase 37: render_signal equals the hand loop bit for bit")
    t = cuda_ms(lambda: render_signal(proc, init(), x, T), 3)
    print(f"phase 37: render_signal [{card}]: {t:.4f} ms for {N_CHUNKS} "
          f"blocks = {N_STREAMS * N_CHUNKS * T / FS / (t / 1e3):.1f} "
          "audio-seconds per second")
    name = "saf.render_signal.block"

    def annotated(st, b):
        with trace_annotation(name):
            return proc(st, b)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        render_signal(annotated, init(), x[..., :T], T)
        torch.cuda.synchronize()
    seen = [e for e in prof.events() if e.name == name]
    print(f"phase 37: trace_annotation {name!r}: {len(seen)} span(s) among "
          "torch.profiler's events")
    check(len(seen) >= 1, "the trace_annotation span is not in the profile")
    return launches["render_full_ri"]


def phase_mesh(bcfg, bw, ak, dev, rng, card) -> int:
    """Phase 38: run_sharded on the card's grid over the flagship."""
    from spatial_audio_framework_tpu_torch.models import ambi_bin
    from spatial_audio_framework_tpu_torch.parallel import mesh

    grid = mesh.make_mesh()
    print(f"phase 38: device grid {grid.shape} of "
          f"{[str(d) for d in grid.devices.ravel()]}")
    xs = [uniform(rng, (N_STREAMS, bcfg.nsh, HOPS * 128), dev, ANA_AMP)
          for _ in range(2)]

    def proc(w, st, b):
        return ambi_bin.process_ri_batched(bcfg, w, st, b)

    for k in ak.KERNELS:
        getattr(ak, k).launches = 0
    st, ys = ambi_bin.init_state_batched(bcfg, N_STREAMS, dev), []
    for x in xs:
        y, st = mesh.run_sharded(proc, bw, st, x, grid)
        ys.append(y)
    torch.cuda.synchronize()
    launches = {k: getattr(ak, k).launches for k in ak.KERNELS}
    n_dev = grid.devices.size
    print(f"phase 38: run_sharded over the flagship main path, 2 chunks; "
          f"launches = {launches}")
    check(launches == {k: 2 * n_dev if k == "render_full_ri" else 0
                       for k in ak.KERNELS}, "run_sharded: launches")
    rst = ambi_bin.init_state_batched(bcfg, N_STREAMS, dev)
    for x, y in zip(xs, ys):
        r, rst = proc(bw, rst, x)
        check(torch.equal(y.to(dev), r), "run_sharded differs from the "
              "unsharded render")
    check(torch.equal(st.gather().ola_tail.to(dev), rst.ola_tail),
          "run_sharded's state differs")
    print("phase 38: run_sharded equals the unsharded render bit for bit "
          "(outputs and gathered state)")
    return launches["render_full_ri"]


PITCH_CH, PITCH_BLOCK = 64, 8192


def phase_pitch_qmf_stft(ak, dev, rng, card) -> None:
    """Phases 39-40: the pitch shifter, QMF and STFT (none of the six
    kernels) through plain_path."""
    from spatial_audio_framework_tpu_torch.models import pitch_shifter as PS
    from spatial_audio_framework_tpu_torch.ops import qmf, stft

    n_blocks = int(np.ceil(RT_SECONDS * FS / PITCH_BLOCK))
    t = np.arange(n_blocks * PITCH_BLOCK) / FS
    f0 = rng.uniform(100.0, 2000.0, (PITCH_CH, 1))
    sig = (0.3 * np.sin(2 * np.pi * f0 * t) + 0.1 * np.sin(
        2 * np.pi * 2.5 * f0 * t + 1.0)).astype(np.float32)
    xd = torch.from_numpy(sig).to(dev)
    shifts = torch.from_numpy(rng.uniform(0.5, 2.0, n_blocks).astype(
        np.float32)).to(dev)
    xs = [(xd[:, i * PITCH_BLOCK:(i + 1) * PITCH_BLOCK], shifts[i])
          for i in range(n_blocks)]
    cfg = PS.PitchShifterConfig(n_ch=PITCH_CH)

    def make_pitch(device):
        mats = PS.design(cfg, device=device)
        return (lambda: PS.init_state(cfg, device=device),
                lambda st, xf: PS.process(cfg, st, xf[0], xf[1], mats))

    print(f"phase 39: pitch shifter {PITCH_CH} ch, fft {cfg.fft_size}, osamp "
          f"{cfg.osamp} ({cfg.fft_size // cfg.osamp}-sample hops), "
          f"{n_blocks} blocks of {PITCH_BLOCK} ({n_blocks * PITCH_BLOCK / FS:.2f}"
          " s), a new shift factor on the card every block")
    plain_path("pitch shifter", 39, make_pitch, xs, ak, dev, card,
               PITCH_CH * PITCH_BLOCK / FS, None)

    bank = qmf.QMF(hop=128, hybrid=True)
    qx = [uniform(rng, (PITCH_CH, PITCH_BLOCK), dev) for _ in range(4)]

    def make_qmf(device):
        def proc(st, x):
            spec, st = bank.analysis(st, x)
            return bank.synthesis(st, spec)
        return (lambda: bank.init_state(PITCH_CH, PITCH_CH, device=device),
                proc)

    plain_path("QMF round trip (hop 128, hybrid)", 40, make_qmf, qx, ak,
               dev, card, PITCH_CH * PITCH_BLOCK / FS, KERNEL_TOL,
               held=lambda st: [st.syn_tail, st.hyb_tail.real])
    init, proc = make_qmf(dev)
    st, ys = init(), []
    for x in qx:
        y, st = proc(st, x)
        ys.append(y)
    y = torch.cat(ys, -1).cpu().numpy()
    xin = torch.cat(qx, -1).cpu().numpy()
    d = bank.proc_delay
    err = float(np.abs(y[:, d:] - xin[:, :xin.shape[1] - d]).max())
    print(f"phase 40: QMF round trip on the card vs the input delayed by "
          f"{d}: max |err| = {err:.3e} (tol 0.01, tests/test_qmf.py)")
    check(err < 0.01, f"QMF round trip: {err}")
    st_ = stft.STFT(winsize=1024, hopsize=512, n_ch_in=PITCH_CH,
                    n_ch_out=PITCH_CH)

    def make_stft(device):
        def proc(st, x):
            spec, st = st_.forward(st, x)
            return st_.backward(st, spec)
        return lambda: st_.init_state(device=device), proc

    plain_path("STFT round trip (window 1024, hop 512)", 40, make_stft, qx,
               ak, dev, card, PITCH_CH * PITCH_BLOCK / FS, KERNEL_TOL,
               held=lambda st: [st.ola_tail])


def phase_last_c_parity(ak, dev, card) -> None:
    """Phase 41: pitch_out_*, qmf_*, the FuMa / ACN conversions on the
    card against the compiled C, at the JAX tests' tolerances."""
    from spatial_audio_framework_tpu_torch.modules import hoa
    from spatial_audio_framework_tpu_torch.ops.pitch import SmbPitchShift
    from spatial_audio_framework_tpu_torch.ops.qmf import QMF

    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    ps = SmbPitchShift(fs=FS, n_ch=1, fft_size=4096, osamp=4)
    x = torch.from_numpy(np.asarray(g["pitch_in"], np.float32))[None].to(dev)
    for key, shift in (("pitch_out_1p5", 1.5), ("pitch_out_0p5", 0.5),
                       ("pitch_out_2p0", 2.0)):
        y, _ = ps.apply(ps.init_state(dev), x,
                        torch.tensor(shift, device=dev))
        err = float(np.abs(y[0].cpu().numpy() - g[key]).max())
        print(f"phase 41: {key} vs the C reference on the card [{card}]: "
              f"max |err| = {err:.3e} (tol 1e-3, tests/test_c_goldens.py:416)")
        check(err <= 1e-3, f"{key}: {err}")
    bank = QMF(hop=128, hybrid=True)
    xq = torch.from_numpy(np.asarray(g["qmf_in"], np.float32)).to(dev)
    st = bank.init_state(4, 4, device=dev)
    specs, outs = [], []
    for f in range(8):
        spec, st = bank.analysis(st, xq[:, f * 512:(f + 1) * 512])
        specs.append(spec.cpu().numpy())
        y, st = bank.synthesis(st, spec)
        outs.append(y)
    err = float(np.abs(np.stack(specs) - g["qmf_spec"]).max())
    print(f"phase 41: qmf_spec vs the C reference on the card [{card}]: max "
          f"|err| = {err:.3e} (tol 1e-3, |spec| ~ O(10), "
          "tests/test_c_goldens.py:258)")
    check(err <= 1e-3, f"qmf_spec: {err}")
    c_parity(41, "qmf_out", torch.cat(outs, -1).cpu().numpy(),
             np.asarray(g["qmf_out"]), card)
    sig = torch.from_numpy(np.asarray(g["fuma_sig"], np.float32)).to(dev)
    for key, conv in (("fuma_to_acn", (hoa.HOA_CH_ORDER_FUMA,
                                       hoa.HOA_CH_ORDER_ACN)),
                      ("acn_to_fuma", (hoa.HOA_CH_ORDER_ACN,
                                       hoa.HOA_CH_ORDER_FUMA))):
        out = hoa.convert_hoa_channel_convention(sig, 2, *conv)
        err = float(np.abs(out.cpu().numpy() - g[key]).max())
        print(f"phase 41: {key} on the card: max |err| = {err:.3e} (exact)")
        check(err == 0.0, f"{key}: {err}")
    ones = torch.ones((4, 4), device=dev)
    for key, conv in (("fuma_norm_to_n3d", (hoa.HOA_NORM_FUMA,
                                            hoa.HOA_NORM_N3D)),
                      ("n3d_norm_to_fuma", (hoa.HOA_NORM_N3D,
                                            hoa.HOA_NORM_FUMA))):
        c_parity(41, key, hoa.convert_hoa_norm_convention(
            ones, 1, *conv).cpu().numpy(), np.asarray(g[key]), card)


def phase_wide(bcfg, bw, ak, dev, rng, card) -> dict:
    """Phase 42: the flagship at 256 streams, one chunk of 8192 samples,
    through ``process_ri_batched``: one ``render_full_ri`` launch for all
    the streams (the JAX package split them into groups there,
    bench.py:786-788), held against the plain path; then the kernel timed
    at the chunk's shape.  Returns the launches, times and bound."""
    from spatial_audio_framework_tpu_torch.models import ambi_bin

    S, nsh = WIDE_STREAMS, bcfg.nsh
    in_mb = S * (nsh * (15 + HOPS) + 2 * 9) * 128 * 4 / 1e6
    print(f"phase 42: the flagship at {S} streams: {in_mb:.1f} MB of input "
          f"a chunk with the carried tails")
    launches = phase_slice(
        f"ambi_bin flagship x {S}", 42,
        lambda st, x, fused: ambi_bin.process_ri_batched(bcfg, bw, st, x,
                                                         fused=fused),
        lambda: ambi_bin.init_state_batched(bcfg, S, dev), nsh, 2, ak, dev,
        rng, card, {"render_full_ri": 1}, n_chunks=1, n_streams=S)
    taps = random_taps(ak, rng, S, nsh, 2, False, True, dev)
    in_tail = uniform(rng, (S, nsh, 15 * 128), dev)
    ola = uniform(rng, (S, 2, 9, 128), dev)
    xk = uniform(rng, (S, nsh, HOPS * 128), dev)
    ky, kt = ak.render_full_ri(in_tail, xk, ola, taps)
    py, pt = ak.render_full_ri_reference(in_tail, xk, ola, taps)
    err = max((ky - py).abs().max().item(), (kt - pt).abs().max().item())
    check(err <= KERNEL_TOL, f"render_full_ri at {S} streams: {err}")
    t = ab_times({
        "kernel": lambda: ak.render_full_ri(in_tail, xk, ola, taps),
        "plain": lambda: ak.render_full_ri_reference(in_tail, xk, ola,
                                                     taps)}, 10, queued=True)
    b = render_full_bound(S, nsh, 2, HOPS)
    report_times("render_full_ri", t, card,
                 f"{(S, nsh, 2, HOPS)}, the flagship at {S} streams (max "
                 f"|err| vs plain {err:.3e}; bound {b['bound_ms']:.4f} ms by "
                 f"{b['bound_by']})")
    return {"launches": launches["render_full_ri"], "times": t, "bound": b}


def bound(in_floats: float, out_floats: float, flop: float) -> dict:
    """The least time of a kernel's work on the card (see HBM_BYTES_PER_S):
    the larger of its bytes over the HBM rate and its operations over the
    fp32 rate, and which of the two it is."""
    t_bytes = (in_floats + out_floats) * 4 / HBM_BYTES_PER_S * 1e3
    t_ops = flop / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def render_full_bound(S, cin, cout, H, per_stream=False) -> dict:
    """bound() of render_full_ri at one shape: 15 tail hops; the taps
    (per stream or shared), the overlap tail and the constants (windows,
    twiddles) counted as inputs."""
    T, NB, win, tw = 15, 129, 1280, 512
    ola = (H + 9) * 128           # output samples per row, y and tail
    rdft = FOLD_FLOP + FFT_FLOP   # fold and rDFT of a frame
    taps = (S if per_stream else 1) * cin * cout * 4 * NB
    return bound(
        S * cin * (T + H) * 128 + taps + S * cout * 9 * 128 + 2 * win + tw,
        S * cout * ola,
        S * cin * (H + 6) * rdft + S * cin * cout * H * (NB + 16) * 8
        + S * cout * H * FFT_FLOP + S * cout * ola * OLA_FLOP)


def front_bound(rows, H=HOPS) -> dict:
    """bound() of analysis_front_ri over ``rows`` rows of 15 tail hops and
    H new ones: H + 6 spectra a row."""
    T, NB = 15, 129
    return bound(rows * (T + H) * 128 + 1280 + 512,
                 2 * rows * (T + H - 9) * NB,
                 rows * (T + H - 9) * (FOLD_FLOP + FFT_FLOP))


def back_bound(rows, H=HOPS, K=266) -> dict:
    """bound() of synthesis_back_ri over ``rows`` rows of H packed spectra
    of K floats (hybrid: 2 x 133)."""
    ola = (H + 9) * 128           # output samples per row, y and tail
    return bound(rows * H * K + rows * 9 * 128 + 512 + 1280, rows * ola,
                 rows * H * FFT_FLOP + rows * ola * OLA_FLOP)


def kernel_bounds() -> dict:
    """bound() of each kernel at its main path's shape, the one phase 2
    times: 64 streams, H = 64, 15 tail hops; the constants each takes
    (windows, twiddles) counted as inputs."""
    S, H, T, NB = N_STREAMS, HOPS, 15, 129
    win, tw = 1280, 512
    ola = (H + 9) * 128           # output samples per row, y and tail
    rdft = FOLD_FLOP + FFT_FLOP   # fold and rDFT of a frame
    b = {"render_full_ri": render_full_bound(S, 16, 2, H)}   # the flagship
    cout = 2
    b["analysis_front_ri"] = front_bound(S * 16)    # the ambi_dec slice
    R = S * 64                    # analysis_front_dg_ri: order 7
    b["analysis_front_dg_ri"] = bound(
        R * (T + H) * 128 + win + tw, R * H * (NB + 16) * 2,
        R * (H + 6) * rdft + R * H * 16 * 2 * 4)
    b["synthesis_back_ri"] = back_bound(S * 22)     # the ambi_dec slice
    cin = 64                      # the renders from spectra and from (d, g)
    back = (cin * cout * 4 * NB + S * cout * 9 * 128 + tw + win,
            S * cout * ola,
            S * cout * H * FFT_FLOP + S * cout * ola * OLA_FLOP)
    b["render_decode_synthesis_ri"] = bound(
        S * cin * (H + 6) * NB * 2 + back[0], back[1],
        S * cin * cout * H * NB * 8 + back[2])
    b["render_decode_synthesis_dg_ri"] = bound(
        S * cin * H * (NB + 16) * 2 + back[0], back[1],
        S * cin * cout * H * (NB + 16) * 8 + back[2])
    return b


def shape_entry(shape, path, launches, t, b) -> dict:
    """A kernel's numbers at a shape other than its main path's, for the
    ``other_shapes`` list of its entry in the kernels line."""
    lib = t.get("library")
    return {"shape": shape, "path": path, "launches": launches,
            "ms": t["kernel"][0], "plain_ms": t["plain"][0], **b,
            "library_ms": lib[0] if lib else None}


def kernel_entry(name, replaces, launches, err, t, bounds, source=None,
                 other_shapes=()):
    lib = t.get("library")
    return {"other_shapes": list(other_shapes),
            "name": name, "route": "cuda",
            "source": "spatial_audio_framework_tpu_torch/csrc/"
                      f"{source or name}.cu",
            "replaces": f"spatial_audio_framework_tpu/ops/pallas_afstft.py:"
                        f"{replaces}",
            "launches": launches, "max_abs_err": err,
            "ms": t["kernel"][0], "plain_ms": t["plain"][0],
            **bounds[name], "library_ms": lib[0] if lib else None}


def profile_slice(label, process, init_state, n_in, dev, rng, card):
    """torch.profiler over N_CHUNKS chunks of a main path (after two
    warm-up chunks): device time per chunk of each kernel, in order, and
    the device's busy share of the profiled window."""
    xs = [uniform(rng, (N_STREAMS, n_in, HOPS * 128), dev)
          for _ in range(N_CHUNKS)]
    st = init_state()
    for x in xs[:2]:
        _, st = process(st, x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for x in xs:
            _, st = process(st, x)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    check(bool(kernels), f"profile of {label}: the profiler saw no kernel")
    per_name = {}
    for e in kernels:
        us = e.time_range.end - e.time_range.start
        n, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, t + us)
    busy = sum(t for _, t in per_name.values())
    window = (max(e.time_range.end for e in kernels)
              - min(e.time_range.start for e in kernels))
    print(f"profile: {label} [{card}]: {busy / N_CHUNKS / 1e3:.4f} ms of "
          f"kernels per chunk, busy {100 * busy / window:.1f} % of the "
          f"{window / N_CHUNKS / 1e3:.4f} ms per chunk from first to last "
          "kernel")
    for name, (n, t) in sorted(per_name.items(), key=lambda kv: -kv[1][1]):
        print(f"profile: {label}:   {t / N_CHUNKS / 1e3:.4f} ms per chunk "
              f"({100 * t / busy:.1f} %), {n / N_CHUNKS:g} per chunk: "
              f"{name[:90]}")


def profile(dev, rng, card) -> None:
    """--profile: the flagship, order-7, ambi_dec 22.x, non-hybrid 64 -> 2
    and 64-source binauraliser main paths under torch.profiler, nothing
    else."""
    from spatial_audio_framework_tpu_torch.models import (ambi_bin, ambi_dec,
                                                          binauraliser)
    from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
    from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
    from spatial_audio_framework_tpu_torch.utils import presets

    for order in (3, 7):
        cfg = ambi_bin.AmbiBinConfig(order=order, method="magls")
        w = ambi_bin.design_ri(cfg, device=dev)
        profile_slice(
            f"ambi_bin order {order}",
            lambda st, x: ambi_bin.process_ri_batched(cfg, w, st, x),
            lambda: ambi_bin.init_state_batched(cfg, N_STREAMS, dev),
            cfg.nsh, dev, rng, card)
    dcfg = ambi_dec.AmbiDecConfig(master_order=3)
    ls = presets.loudspeaker_preset("22.x")
    dw = ambi_dec.design_ri(dcfg, ls, device=dev)
    profile_slice(
        "ambi_dec 22.x",
        lambda st, x: ambi_dec.process_ri_batched(dcfg, dw, st, x),
        lambda: ambi_dec.init_state_batched(dcfg, N_STREAMS, len(ls), dev),
        dcfg.nsh, dev, rng, card)
    nh_bank = AfSTFT(hop=128, hybrid=False)
    nh_M = uniform(rng, (2, nh_bank.n_bands, 2, 64), dev, 0.5)
    profile_slice(
        "non-hybrid 64 -> 2",
        lambda st, x: ri.render_tf_matrix_ri(nh_bank, st, x, nh_M[0],
                                             nh_M[1]),
        lambda: ri.init_state_batched(nh_bank, N_STREAMS, 64, 2, dev),
        64, dev, rng, card)
    cfg = binauraliser.BinauraliserConfig(n_sources=64, enable_rotation=True)
    w = binauraliser.design_ri(cfg, device=dev)
    dirs = uniform(rng, (N_STREAMS, 64, 2), dev) * torch.tensor(
        [180.0, 81.0], device=dev)
    ypr = uniform(rng, (N_STREAMS, 3), dev)
    profile_slice(
        "binauraliser 64 sources",
        lambda st, x: binauraliser.process_ri_batched(cfg, w, st, x, dirs,
                                                      None, ypr),
        lambda: binauraliser.init_state_batched(cfg, N_STREAMS, dev),
        64, dev, rng, card)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hrtf-taps", action="store_true",
                    help="only build and run hrtf_taps_ri's phase (its "
                         "checks and its time against its byte bound)")
    ap.add_argument("--wide-mix", action="store_true",
                    help="only build and run wide_mix_ri's phase (after "
                         "hrtf_taps_ri's: its checks and its time against "
                         "its byte bound)")
    ap.add_argument("--profile", action="store_true",
                    help="only profile the ambi_bin order-3 and order-7, "
                         "ambi_dec 22.x, non-hybrid 64 -> 2 and 64-source "
                         "binauraliser main paths")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this smoke run measures the port on the card "
             "and has no CPU mode")
    from spatial_audio_framework_tpu_torch.models import (
        ambi_bin, ambi_dec, ambi_enc, array2sh, beamformer, binauraliser,
        binauraliser_nf, panner, roombinauraliser, rotator)
    from spatial_audio_framework_tpu_torch.modules import hrir, sh, sofa
    from spatial_audio_framework_tpu_torch.ops import _build
    from spatial_audio_framework_tpu_torch.ops import afstft_kernels as ak
    from spatial_audio_framework_tpu_torch.ops import afstft_ri as ri
    from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT
    from spatial_audio_framework_tpu_torch.utils import geometry as geo
    from spatial_audio_framework_tpu_torch.utils import presets

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    # the runtime's g++ build (phase 36) runs beside the nvcc builds
    from spatial_audio_framework_tpu_torch.runtime import native
    rt_build = threading.Thread(target=native.native_available)
    rt_build.start()
    seconds = _build.build()
    rt_build.join()
    print(f"phase 1: built {_build.library_path().name} from "
          f"{_build.SRC_DIR.relative_to(ROOT)} in {seconds:.2f} s")
    log = _build.library_path().with_suffix(".log")
    if log.is_file():
        for line in log.read_text().splitlines():
            if "entry function" in line:
                print(f"phase 1: nvcc: {line.split(chr(39))[1]}")
            elif (line.startswith("==") or "registers" in line
                  or "spill" in line):
                print(f"phase 1: nvcc: {line.strip()}")
    _build.load_library()

    rng = np.random.default_rng(args.seed)
    if args.profile:
        profile(dev, rng, card)
        return 0
    taps_entry = phase_hrtf_taps(
        binauraliser, binauraliser.design_ri(binauraliser.BinauraliserConfig(),
                                             device=dev), ak, dev, rng, card)
    if args.hrtf_taps:
        print(json.dumps({"kernels": [taps_entry]}))
        return 0
    mix_entry = phase_wide_mix(ak, dev, rng, card)
    if args.wide_mix:
        print(json.dumps({"kernels": [mix_entry]}))
        return 0
    errs, times = {}, {}
    errs["render_full_ri"], times["render_full_ri"] = phase_render_full(
        ak, dev, rng, card)
    errs["analysis_front_ri"], front_times = phase_analysis_front(
        ak, dev, rng, card)
    errs["synthesis_back_ri"], back_times = phase_synthesis_back(
        ak, dev, rng, card)
    rows_times = {"analysis_front_ri": front_times,
                  "synthesis_back_ri": back_times}
    times["analysis_front_ri"] = front_times[N_STREAMS * 16, HOPS]
    times["synthesis_back_ri"] = back_times[N_STREAMS * 22, HOPS]
    errs["analysis_front_dg_ri"], times["analysis_front_dg_ri"] = \
        phase_analysis_front_dg(ak, dev, rng, card)
    for dg in (False, True):
        name = ("render_decode_synthesis_dg_ri" if dg
                else "render_decode_synthesis_ri")
        errs[name], times[name] = phase_render_decode(ak, dev, rng, card, dg)

    t0 = time.perf_counter()
    bcfg = ambi_bin.AmbiBinConfig(order=3, method="magls")
    bw = ambi_bin.design_ri(bcfg, device=dev)
    print(f"phase 3: ambi_bin design (order 3, MagLS) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    flagship = phase_slice(
        "ambi_bin flagship", 3,
        lambda st, x, fused: ambi_bin.process_ri_batched(bcfg, bw, st, x,
                                                         fused=fused),
        lambda: ambi_bin.init_state_batched(bcfg, N_STREAMS, dev),
        bcfg.nsh, 2, ak, dev, rng, card,
        {"render_full_ri": N_CHUNKS})
    phase_ambi_bin_c_parity(ambi_bin, ri, sh, geo, ak, dev, card)

    t0 = time.perf_counter()
    dcfg = ambi_dec.AmbiDecConfig(master_order=3)
    ls = presets.loudspeaker_preset("22.x")
    dw = ambi_dec.design_ri(dcfg, ls, device=dev)
    print(f"phase 5: ambi_dec design (order 3 -> 22.x, dual-band AllRAD, "
          f"max-rE, energy-preserving) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    wide = phase_slice(
        "ambi_dec 22.x", 5,
        lambda st, x, fused: ambi_dec.process_ri_batched(dcfg, dw, st, x,
                                                         fused=fused),
        lambda: ambi_dec.init_state_batched(dcfg, N_STREAMS, len(ls), dev),
        dcfg.nsh, len(ls), ak, dev, rng, card,
        {"analysis_front_ri": N_CHUNKS, "wide_mix_ri": N_CHUNKS,
         "synthesis_back_ri": N_CHUNKS})
    phase_ambi_dec_c_parity(ambi_dec, ak, dev, card)

    t0 = time.perf_counter()
    o7cfg = ambi_bin.AmbiBinConfig(order=7, method="magls")
    o7w = ambi_bin.design_ri(o7cfg, device=dev)
    print(f"phase 7: ambi_bin design (order 7, MagLS) on the host in "
          f"{time.perf_counter() - t0:.2f} s")
    order7 = phase_slice(
        "ambi_bin order 7", 7,
        lambda st, x, fused: ambi_bin.process_ri_batched(o7cfg, o7w, st, x,
                                                         fused=fused),
        lambda: ambi_bin.init_state_batched(o7cfg, N_STREAMS, dev),
        o7cfg.nsh, 2, ak, dev, rng, card,
        {"analysis_front_dg_ri": N_CHUNKS,
         "render_decode_synthesis_dg_ri": N_CHUNKS})
    phase_routes(ri, [("order 3", bcfg, bw), ("order 7", o7cfg, o7w)], dev,
                 rng, card)

    nh_bank = AfSTFT(hop=128, hybrid=False)
    nh_M = uniform(rng, (2, nh_bank.n_bands, 2, 64), dev, 0.5)
    plain_bank = phase_slice(
        "non-hybrid 64 -> 2", 8,
        lambda st, x, fused: ri.render_tf_matrix_ri(nh_bank, st, x, nh_M[0],
                                                    nh_M[1], fused=fused),
        lambda: ri.init_state_batched(nh_bank, N_STREAMS, 64, 2, dev),
        64, 2, ak, dev, rng, card,
        {"analysis_front_ri": N_CHUNKS,
         "render_decode_synthesis_ri": N_CHUNKS})

    t0 = time.perf_counter()
    b4cfg = binauraliser.BinauraliserConfig(n_sources=4, enable_rotation=True)
    binw, sofa_c = design_binauraliser_from_sofa(binauraliser, hrir, sofa,
                                                 b4cfg, dev)
    print(f"phase 9: binauraliser design (TRI, diffuse-field EQ, 2°x5° VBAP "
          f"table) from a SOFA file of {sofa_c.n_sources} directions @ "
          f"{sofa_c.data_sampling_rate:g} Hz on the host in "
          f"{time.perf_counter() - t0:.2f} s")

    def head_tracked(n_src):
        """Per (stream, source) directions uniform in azimuth ±180° and
        elevation ±81°, per-stream yaw, pitch and roll uniform in ±1 rad
        (the JAX benchmark's binauraliser cell)."""
        dirs = rng.uniform(-180.0, 180.0, (N_STREAMS, n_src, 2))
        dirs = torch.from_numpy((dirs * [1.0, 0.45]).astype(np.float32))
        return dirs.to(dev), uniform(rng, (N_STREAMS, 3), dev)

    def binauraliser_slice(label, phase, cfg, expect):
        dirs, ypr = head_tracked(cfg.n_sources)
        return phase_slice(
            label, phase,
            lambda st, x, fused: binauraliser.process_ri_batched(
                cfg, binw, st, x, dirs, None, ypr, fused=fused),
            lambda: binauraliser.init_state_batched(cfg, N_STREAMS, dev),
            cfg.n_sources, 2, ak, dev, rng, card, expect)

    binauraliser_slice("binauraliser 4 sources", 9, b4cfg,
                       {"render_full_ri": N_CHUNKS, "hrtf_taps_ri": N_CHUNKS})
    binauraliser_slice(
        "binauraliser 64 sources", 10,
        binauraliser.BinauraliserConfig(n_sources=64, enable_rotation=True),
        {"analysis_front_dg_ri": N_CHUNKS,
         "render_decode_synthesis_dg_ri": N_CHUNKS, "hrtf_taps_ri": N_CHUNKS})
    phase_binauraliser_c_parity(binauraliser, binw, ak, dev, card)
    phase_hop64(ri, AfSTFT(hop=64, hybrid=True), ak, dev, rng)
    phase_fuma(ambi_bin, ak, dev, rng, card)

    # 4 sources per stream onto the JAX benchmark's two layouts
    layouts = {
        "5.1": [[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]],
        "7.1.4": [[30, 0], [-30, 0], [0, 0], [90, 0], [-90, 0], [135, 0],
                  [-135, 0], [45, 45], [-45, 45], [135, 45], [-135, 45]]}
    for label, ls in layouts.items():
        ls = np.asarray(ls, np.float64)
        t0 = time.perf_counter()
        pcfg = panner.PannerConfig(n_sources=4, n_loudspeakers=len(ls))
        pw = panner.design(pcfg, ls, device=dev)
        print(f"phase 14: panner design ({label}: {len(ls)} loudspeakers, "
              f"1° x 1° table of {tuple(pw.gtable.shape)}, DTT {pcfg.dtt}) "
              f"on the host in {time.perf_counter() - t0:.2f} s")
        pdirs, _ = head_tracked(4)
        phase_slice(
            f"panner {label}", 14,
            lambda st, x, fused: panner.process_ri_batched(
                pcfg, pw, st, x, pdirs, fused=fused),
            lambda: panner.init_state_batched(pcfg, N_STREAMS, len(ls), dev),
            4, len(ls), ak, dev, rng, card, {"render_full_ri": N_CHUNKS})

    nfcfg = binauraliser_nf.BinauraliserNFConfig(n_sources=4,
                                                 enable_rotation=True)
    nfdirs, nfypr = head_tracked(4)
    dists_np = rng.uniform(0.1, 4.0, (N_STREAMS, 4))
    dists = torch.from_numpy(dists_np.astype(np.float32)).to(dev)
    print(f"phase 15: binauraliser_nf distances: "
          f"{int((dists_np < nfcfg.nearfield_limit_m).sum())} below the "
          f"near-field limit {nfcfg.nearfield_limit_m} m, "
          f"{int((dists_np >= nfcfg.far_field_thresh_m).sum())} at or beyond "
          f"the far-field threshold {nfcfg.far_field_thresh_m:.3f} m, of "
          f"{dists_np.size}")
    check((dists_np < nfcfg.nearfield_limit_m).any()
          and (dists_np >= nfcfg.far_field_thresh_m).any(),
          "binauraliser_nf: the distances miss the clamp or the bypass")
    phase_slice(
        "binauraliser_nf 4 sources", 15,
        lambda st, x, fused: binauraliser_nf.process_ri_batched(
            nfcfg, binw, st, x, nfdirs, dists, None, nfypr, fused=fused),
        lambda: binauraliser_nf.init_state_batched(nfcfg, N_STREAMS, dev),
        4, 2, ak, dev, rng, card, {"render_full_ri": N_CHUNKS},
        queued_chunks=3)        # ~250 torch launches a chunk

    hrirs, hrir_dirs, hrir_fs = hrir.default_hrirs()
    for n_src, n_chunks, expect in (
            (16, N_CHUNKS, ("render_full_ri",)),
            (64, 2, ("analysis_front_dg_ri",
                     "render_decode_synthesis_dg_ri"))):
        t0 = time.perf_counter()
        shifts = rng.integers(1, len(hrirs), n_src)
        brirs = np.stack([np.roll(hrirs, int(k), axis=0) for k in shifts])
        rcfg, rw = roombinauraliser.design_ri(
            roombinauraliser.RoomBinauraliserConfig(n_sources=n_src), brirs,
            hrir_dirs, hrir_fs, device=dev)
        print(f"phase 16: roombinauraliser design ({n_src} BRIR sets of "
              f"{brirs.shape[1]} directions, TRI, BRIR-derived diffuse-field "
              f"EQ, 3-D table: {rcfg.vbap_3d}) on the host in "
              f"{time.perf_counter() - t0:.2f} s")
        del brirs
        rypr = uniform(rng, (N_STREAMS, 3), dev)
        phase_slice(
            f"roombinauraliser {n_src} sources", 16,
            lambda st, x, fused: roombinauraliser.process_ri_batched(
                rcfg, rw, st, x, None, rypr, fused=fused),
            lambda: roombinauraliser.init_state_batched(rcfg, N_STREAMS, dev),
            n_src, 2, ak, dev, rng, card, {k: n_chunks for k in expect},
            n_chunks=n_chunks)
        del rw

    phase_ambi_enc(ambi_enc, ak, dev, rng, card)
    phase_new_models_c_parity(panner, ambi_enc, binauraliser_nf,
                              roombinauraliser, binw, ak, dev, card)
    phase_design_checks(ambi_bin, hrir, ak, dev, card)

    a2s = phase_array2sh(array2sh, presets, ak, dev, rng, card)
    preview = phase_ambi_dec_preview(ambi_dec, presets, ak, dev, rng, card)
    phase_head_tracked(ambi_bin, sh, geo, [(3, bw), (7, o7w)], ak, dev, rng,
                       card)
    phase_ambi_bin_single_c_parity(ambi_bin, sh, ak, dev, card)
    phase_single_stream_c_parity(rotator, beamformer, binauraliser,
                                 binauraliser_nf, roombinauraliser, panner,
                                 binw, ak, dev, card)
    print(f"phases 1-24 took {time.perf_counter() - t_start:.1f} s")
    t0 = time.perf_counter()
    an = phase_analysers(ak, dev, rng, card)
    print(f"phases 25-29 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_analyser_c_parity(ak, dev, card)
    print(f"phase 30 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_conv_room(ak, dev, rng, card)
    hs = phase_hades_spreader(ak, dev, rng, card)
    print(f"phases 31-34 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_conv_hades_c_parity(ak, dev, card)
    print(f"phase 35 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    rt = phase_runtime(bcfg, bw, ak, dev, rng, card)
    rs_launches = phase_render_signal(bcfg, bw, ak, dev, rng, card)
    mesh_launches = phase_mesh(bcfg, bw, ak, dev, rng, card)
    print(f"phases 36-38 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_pitch_qmf_stft(ak, dev, rng, card)
    phase_last_c_parity(ak, dev, card)
    print(f"phases 39-41 took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    wide256 = phase_wide(bcfg, bw, ak, dev, rng, card)
    print(f"phase 42 took {time.perf_counter() - t0:.1f} s")

    bounds = kernel_bounds()
    # (kernel, rows, hops, path, its launches in that path's main run)
    shapes = (
        ("analysis_front_ri", A2S_STREAMS * A2S_SENSORS, HOPS,
         "array2sh Eigenmike32 -> order 4, 16 streams",
         a2s["analysis_front_ri"]),
        ("analysis_front_ri", DCR_STREAMS * DCR_CH, HOPS,
         f"decorrelator {DCR_CH} ch x {DCR_STREAMS} streams",
         an["decorrelator"]["analysis_front_ri"]),
        ("analysis_front_ri", PM_INSTANCES * 16, HOPS,
         f"powermap order {AN_ORDER} MUSIC x {PM_INSTANCES}",
         an[f"powermap {PM_INSTANCES}"]["analysis_front_ri"]),
        ("analysis_front_ri", PM_INSTANCES * 16, HOPS,
         f"sldoa order {AN_ORDER} x {PM_INSTANCES}",
         an[f"sldoa {PM_INSTANCES}"]["analysis_front_ri"]),
        ("analysis_front_ri", DRC_STREAMS * 16, HOPS,
         f"ambi_drc order {AN_ORDER} x {DRC_STREAMS} streams",
         an["ambi_drc"]["analysis_front_ri"]),
        ("synthesis_back_ri", A2S_STREAMS * A2S_NSH, HOPS,
         "array2sh Eigenmike32 -> order 4, 16 streams",
         a2s["synthesis_back_ri"]),
        ("synthesis_back_ri", DCR_STREAMS * DCR_CH, HOPS,
         f"decorrelator {DCR_CH} ch x {DCR_STREAMS} streams",
         an["decorrelator"]["synthesis_back_ri"]),
        ("synthesis_back_ri", DRC_STREAMS * 16, HOPS,
         f"ambi_drc order {AN_ORDER} x {DRC_STREAMS} streams",
         an["ambi_drc"]["synthesis_back_ri"]),
        ("analysis_front_ri", NB_INST * 2, NB_HOPS,
         f"HADES binaural BMVDR x {NB_INST}", hs["hades"]["analysis_front_ri"]),
        ("analysis_front_ri", NB_INST, NB_HOPS,
         f"spreader OM x {NB_INST}", hs["spreader"]["analysis_front_ri"]),
        ("synthesis_back_ri", NB_INST * 2, NB_HOPS,
         f"HADES binaural BMVDR x {NB_INST}", hs["hades"]["synthesis_back_ri"]),
        ("synthesis_back_ri", NB_INST * 2, NB_HOPS,
         f"spreader OM x {NB_INST}", hs["spreader"]["synthesis_back_ri"]))
    other = {"analysis_front_ri": [], "synthesis_back_ri": []}
    for name, rows, H, path, n in shapes:
        front = name == "analysis_front_ri"
        shape = f"({rows} rows, H {H}" + (")" if front else ", K 266)")
        b = front_bound(rows, H) if front else back_bound(rows, H)
        t = rows_times[name][rows, H]
        other[name].append(shape_entry(shape, path, n, t, b))
        print(f"phase 2: {name} at {shape}, the shape of {path} [{card}]: "
              f"kernel {t['kernel'][0]:.4f} ms, plain {t['plain'][0]:.4f} "
              f"ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}; "
              f"{100 * b['bound_ms'] / t['kernel'][0]:.0f} % of it), "
              f"library call {t['library'][0]:.4f} ms")
    # the preview's render is the flagship's shape (64, 16, 2, 64) with
    # shared complex taps: the flagship's times and bound hold for it
    other["render_full_ri"] = [shape_entry(
        f"({N_STREAMS}, 16, 2, {HOPS}), shared complex taps",
        "ambi_dec binaural preview, order 3 -> 22.x -> 2 ears",
        preview["render_full_ri"], times["render_full_ri"],
        bounds["render_full_ri"])]
    # the runtime's frames (H = 8), render_signal's blocks and the grid's
    # chunks (the flagship's shape)
    h8 = f"({N_STREAMS}, 16, 2, {RT_FRAME // 128})"
    for mode in ("process_block", "render thread"):
        other["render_full_ri"].append(shape_entry(
            h8, f"StreamRunner ({mode}) over the flagship, frames of "
            f"{RT_FRAME}, {RT_SECONDS:g} s", rt[mode]["launches"],
            rt["times_h8"], rt["bound_h8"]))
    other["render_full_ri"].append(shape_entry(
        f"({WIDE_STREAMS}, 16, 2, {HOPS})",
        f"the flagship at {WIDE_STREAMS} streams, one chunk",
        wide256["launches"], wide256["times"], wide256["bound"]))
    for path, n in (("render_signal over the flagship, 8 blocks",
                     rs_launches),
                    ("run_sharded on the card's grid, flagship, 2 chunks",
                     mesh_launches)):
        other["render_full_ri"].append(shape_entry(
            f"({N_STREAMS}, 16, 2, {HOPS})", path, n,
            times["render_full_ri"], bounds["render_full_ri"]))
    for name in times:
        lib = times[name].get("library")
        print(f"phase 2: {name} at its main path's shape [{card}]: kernel "
              f"{times[name]['kernel'][0]:.4f} ms, bound "
              f"{bounds[name]['bound_ms']:.4f} ms ({bounds[name]['bound_by']}"
              f"), library call "
              + ("none" if lib is None else f"{lib[0]:.4f} ms"))
    print(f"the whole run took {time.perf_counter() - t_start:.1f} s "
          f"[{card}]")
    print(json.dumps({"kernels": [
        kernel_entry("render_full_ri", 674, flagship["render_full_ri"],
                     errs["render_full_ri"], times["render_full_ri"], bounds,
                     other_shapes=other["render_full_ri"]),
        kernel_entry("analysis_front_ri", 82, wide["analysis_front_ri"],
                     errs["analysis_front_ri"], times["analysis_front_ri"],
                     bounds, other_shapes=other["analysis_front_ri"]),
        kernel_entry("synthesis_back_ri", 851, wide["synthesis_back_ri"],
                     errs["synthesis_back_ri"], times["synthesis_back_ri"],
                     bounds, other_shapes=other["synthesis_back_ri"]),
        kernel_entry("analysis_front_dg_ri", 173,
                     order7["analysis_front_dg_ri"],
                     errs["analysis_front_dg_ri"],
                     times["analysis_front_dg_ri"], bounds),
        kernel_entry("render_decode_synthesis_ri", 414,
                     plain_bank["render_decode_synthesis_ri"],
                     errs["render_decode_synthesis_ri"],
                     times["render_decode_synthesis_ri"], bounds),
        kernel_entry("render_decode_synthesis_dg_ri", 561,
                     order7["render_decode_synthesis_dg_ri"],
                     errs["render_decode_synthesis_dg_ri"],
                     times["render_decode_synthesis_dg_ri"], bounds,
                     source="render_decode_synthesis_ri"),
        taps_entry,
        mix_entry,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
