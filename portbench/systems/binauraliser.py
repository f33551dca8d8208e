"""SAF binauraliser on the port's batched entry: every listener renders its
own sources with head tracking, a new pose and new source directions
every block, state carried from block to block
(``models/binauraliser.process_ri_batched``, ``fused=True``)."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import traffic, work_bytes
from portbench.reference import design as ref_design
from portbench.reference.render import (Reference, cart2sph, history_blocks,
                                        interp_hrtfs, rotation, sph2cart)

# the settings the reference implements (SAF binauraliser_internal.c)
REFERENCE_SETTINGS = {"interp_mode": "tri", "enable_rotation": True,
                      "enable_hrir_diff_eq": True, "hop": 128}


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from spatial_audio_framework_tpu_torch.models import binauraliser

        st = config["settings"]
        for key, value in REFERENCE_SETTINGS.items():
            if st.get(key, value) != value:
                raise ValueError(f"{config['name']}: the reference renders "
                                 f"{key}={value!r}, not {st[key]!r}")
        self.model = binauraliser
        self.cfg = binauraliser.BinauraliserConfig(**st)
        self.device = device
        self.streams = mix["streams"]
        self.block_samples = mix["block_samples"]
        self.cin, self.cout = self.cfg.n_sources, 2
        self.hops_per_block = self.block_samples // self.cfg.hop
        self.fs = self.cfg.fs
        self.ring = traffic.signal_ring(mix, self.cin, seed, device)
        self.ctl = traffic.controls(mix, self.cin, self.cfg.azi_res,
                                    self.cfg.elev_res, seed, device)
        hrirs, dirs, fs = ref_design.load_hrirs()
        self.n_dirs = dirs.shape[0]
        self.w = binauraliser.design_ri(self.cfg, hrirs=hrirs,
                                        hrir_dirs_deg=dirs, hrir_fs=fs,
                                        device=device)
        self.state = binauraliser.init_state_batched(self.cfg, self.streams,
                                                     device=device)

    def step(self, g: int) -> torch.Tensor:
        x = self.ring[g % self.ring.shape[0]]
        c = g % self.ctl["ypr"].shape[0]
        y, self.state = self.model.process_ri_batched(
            self.cfg, self.w, self.state, x,
            src_dirs_deg=self.ctl["dirs"][c], ypr=self.ctl["ypr"][c],
            fused=True)
        return y

    def release(self) -> None:
        self.w = self.state = None

    def work_bytes(self) -> int:
        n_bands = self.cfg.hop + 5
        return work_bytes.block_bytes(
            self.streams, self.cin, self.cout, self.block_samples,
            work_bytes.hrtf_table_bytes(n_bands, self.n_dirs)
            + work_bytes.controls_bytes(self.streams, self.cin))

    def reference(self, g: int, precision: str = "fp32") -> torch.Tensor:
        """Block g's output, rendered by the plain reference from the
        inputs and controls of blocks g - m .. g, m = ``history_blocks``."""
        if getattr(self, "_tables", None) is None:
            H, comp, idx = ref_design.binauraliser_tables(
                self.fs, self.cfg.azi_res, self.cfg.elev_res)
            dev = self.device
            self._tables = (
                torch.tensor(H.real.astype(np.float32), device=dev),
                torch.tensor(H.imag.astype(np.float32), device=dev),
                torch.tensor(comp, device=dev),
                torch.tensor(idx, device=dev))
        Hre, Him, comp, idx = self._tables
        ref = Reference(self.device, precision)
        m = history_blocks(self.hops_per_block)
        R, Rc = self.ring.shape[0], self.ctl["ypr"].shape[0]
        T = self.block_samples
        chunk = max(1, 4096 // self.cin)
        out = []
        for s0 in range(0, self.streams, chunk):
            s1 = min(s0 + chunk, self.streams)
            x = torch.cat([self.ring[(g - m + i) % R, s0:s1]
                           for i in range(m + 1)], dim=-1)
            Ms = []
            for i in range(m + 1):
                c = (g - m + i) % Rc
                u = sph2cart(self.ctl["dirs"][c, s0:s1].double())
                rel = cart2sph(u @ rotation(self.ctl["ypr"][c, s0:s1]
                                            .double()))
                Ms.append(interp_hrtfs(Hre, Him, comp, idx, rel,
                                       self.cfg.azi_res, self.cfg.elev_res))
            Mre = torch.stack([M[0] for M in Ms], dim=1)  # (s, m+1, B, 2, n)
            Mim = torch.stack([M[1] for M in Ms], dim=1)
            y = ref.render(x, Mre, Mim, self.hops_per_block)[..., -T:]
            out.append(y / math.sqrt(self.cin))
        return torch.cat(out, dim=0)
