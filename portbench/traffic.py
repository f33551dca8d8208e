"""The one traffic generator: reads a mix (``portbench/traffic/<mix>.json``)
and makes, from the seed, the block ring and the per-block controls of a
cell, on the device, in a few large calls.

A mix's keys:

* ``streams``, ``block_samples``: the batch of one block (streams, or
  listeners, and samples at 48 kHz).
* ``inflight``: blocks the host keeps queued ahead of the device.
* ``ring_blocks``: distinct input blocks; block g reads ring[g % ring_blocks].
* ``signal``: ``{"kind": "sh_scenes", "plane_waves": n, "elev_max_deg": e,
  "diffuse": a}`` (per stream and ring block, n plane waves of white noise
  from random directions, SN3D, with white noise at amplitude a in every
  channel) or ``{"kind": "uniform"}`` (uniform noise in [-1, 1)).
* ``controls`` (renderers with moving sources only): ``ring_blocks`` of
  head poses and source directions; ``pose`` is ``{"kind": "walk",
  "deg_per_s": [yaw, pitch, roll], "max_deg": [pitch, roll]}`` or
  ``{"kind": "fixed", "max_deg": [pitch, roll]}``; ``dirs`` is
  ``{"deg_per_s": v, "elev_max_deg": e, "margin": m}``.  Each walk is
  closed over the control ring, so it has no jump where the ring wraps.
  Directions are drawn relative to the head and turned into the world by
  the pose, and no head-relative direction lies within ``margin`` (in
  table steps) of a rounding boundary of the interpolation table's row,
  where the lookup is discontinuous.
* ``warmup_blocks``, ``trace_blocks``, ``check_blocks``: blocks run in
  set-up, blocks traced in a ``--trace 1`` run, blocks of the window
  whose outputs are compared with the reference.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np
import torch

from portbench.reference import design as ref_design
from portbench.reference.render import cart2sph, rotation, sph2cart

ROOT = Path(__file__).resolve().parent
FS = 48000.0


def load(name: str) -> dict:
    path = ROOT / "traffic" / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one use (``stream``) of the seed."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def signal_ring(mix: dict, cin: int, seed: int, device) -> torch.Tensor:
    """(ring_blocks, streams, cin, block_samples) float32 on ``device``."""
    R, S, T = mix["ring_blocks"], mix["streams"], mix["block_samples"]
    sig = mix["signal"]
    gen = generator(seed, 1, device)
    if sig["kind"] == "uniform":
        x = torch.rand((R, S, cin, T), generator=gen, device=device)
        return x.mul_(2.0).sub_(1.0)
    if sig["kind"] != "sh_scenes":
        raise ValueError(f"unknown signal kind {sig['kind']!r}")
    order = int(round(math.sqrt(cin))) - 1
    n_pw = sig["plane_waves"]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    dirs = np.stack([rng.uniform(-180, 180, R * S * n_pw),
                     rng.uniform(-sig["elev_max_deg"], sig["elev_max_deg"],
                                 R * S * n_pw)], -1)
    Y = ref_design.real_sh(order, dirs)                  # (nSH, R·S·n_pw)
    ns = np.concatenate([[n] * (2 * n + 1) for n in range(order + 1)])
    Y = Y / np.sqrt(2.0 * ns + 1.0)[:, None]             # N3D → SN3D
    Y = torch.tensor(Y.T.reshape(R * S, n_pw, cin).transpose(0, 2, 1)
                     .astype(np.float32), device=device)  # (R·S, cin, n_pw)
    x = torch.empty((R, S, cin, T), device=device)
    for r in range(R):                                   # one block at a time
        s = torch.randn((S, n_pw, T), generator=gen, device=device)
        xr = torch.randn((S, cin, T), generator=gen, device=device)
        xr.mul_(sig["diffuse"]).baddbmm_(Y[r * S:(r + 1) * S], s)
        x[r] = xr
    return x


def _closed_walk(steps: torch.Tensor) -> torch.Tensor:
    """Cumulative sum over the first axis, less its drift, so the walk
    returns to its start after the last step."""
    n = steps.shape[0]
    w = torch.cumsum(steps, 0)
    frac = torch.arange(1, n + 1, dtype=w.dtype, device=w.device) / n
    return w - frac.reshape((n,) + (1,) * (w.ndim - 1)) * w[-1]


def _away_from_boundary(idx: torch.Tensor, margin: float) -> torch.Tensor:
    """Move a table index whose fraction lies within ``margin`` of 0.5 to
    0.5 ± margin, the nearer side."""
    base = torch.floor(idx)
    f = idx - base
    near = (f - 0.5).abs() < margin
    f = torch.where(near, torch.where(f < 0.5, 0.5 - margin, 0.5 + margin), f)
    return base + f


def controls(mix: dict, n_src: int, azi_res: float, elev_res: float,
             seed: int, device) -> dict:
    """Per-block controls of a renderer with moving sources:
    {"ypr": (Rc, S, 3) radians, "dirs": (Rc, S, n_src, 2) degrees, world
    directions}, float32 on ``device``, made in float64."""
    c = mix["controls"]
    Rc, S, T = c["ring_blocks"], mix["streams"], mix["block_samples"]
    dt = T / FS
    gen = generator(seed, 3, device)
    f64 = dict(dtype=torch.float64, device=device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, **f64) * 2.0 - 1.0

    pose = c["pose"]
    pmax = torch.tensor(pose["max_deg"], **f64)
    start = torch.cat([uniform(S, 1) * 180.0, uniform(S, 2) * pmax], -1)
    if pose["kind"] == "walk":
        rate = torch.tensor(pose["deg_per_s"], **f64)
        ypr = start + _closed_walk(uniform(Rc, S, 3) * rate * dt)
    elif pose["kind"] == "fixed":
        ypr = start.expand(Rc, S, 3).clone()
    else:
        raise ValueError(f"unknown pose kind {pose['kind']!r}")
    ypr[..., 1:] = torch.maximum(torch.minimum(ypr[..., 1:], pmax), -pmax)
    ypr = torch.deg2rad(ypr).float()

    d = c["dirs"]
    emax = d["elev_max_deg"]
    azi0 = uniform(S, n_src) * 180.0
    elev0 = torch.rad2deg(torch.asin(uniform(S, n_src)
                                     * math.sin(math.radians(emax))))
    step = d["deg_per_s"] * dt
    azi = azi0 + _closed_walk(uniform(Rc, S, n_src) * step)
    elev = (elev0 + _closed_walk(uniform(Rc, S, n_src) * step)).clamp(
        -emax, emax)
    m = d["margin"]
    ai = _away_from_boundary(torch.remainder(azi + 180.0, 360.0) / azi_res, m)
    ei = _away_from_boundary((elev + 90.0) / elev_res, m)
    rel = torch.stack([ai * azi_res - 180.0, ei * elev_res - 90.0], -1)
    # the program turns world directions into head-relative ones as
    # u @ R(ypr); the world direction is the head-relative one times Rᵀ
    R = rotation(ypr.double())                          # (Rc, S, 3, 3)
    u = torch.einsum("rsnj,rsij->rsni", sph2cart(rel), R)
    return {"ypr": ypr.contiguous(), "dirs": cart2sph(u).float().contiguous()}

