"""SAF ambi_bin on the port's batched entry: every stream decodes its own
scene to binaural with the configuration's decoder, state carried from
block to block (``models/ambi_bin.process_ri_batched``, ``fused=True``)."""
from __future__ import annotations

import numpy as np
import torch

from portbench import traffic, work_bytes
from portbench.reference import design as ref_design
from portbench.reference.render import Reference, history_blocks

# the settings the reference implements (SAF ambi_bin.c:63-78)
REFERENCE_SETTINGS = {"method": "magls", "hrir_preproc": "eq",
                      "ch_ordering": "acn", "norm": "sn3d",
                      "enable_max_re": True, "enable_diff_cov_matching": False,
                      "enable_rotation": False, "hop": 128}


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from spatial_audio_framework_tpu_torch.models import ambi_bin

        st = config["settings"]
        for key, value in REFERENCE_SETTINGS.items():
            if st.get(key, value) != value:
                raise ValueError(f"{config['name']}: the reference renders "
                                 f"{key}={value!r}, not {st[key]!r}")
        self.model = ambi_bin
        self.cfg = ambi_bin.AmbiBinConfig(**st)
        self.device = device
        self.streams = mix["streams"]
        self.block_samples = mix["block_samples"]
        self.cin, self.cout = self.cfg.nsh, 2
        self.hops_per_block = self.block_samples // self.cfg.hop
        self.fs = self.cfg.fs
        self.ring = traffic.signal_ring(mix, self.cin, seed, device)
        hrirs, dirs, fs = ref_design.load_hrirs()
        self.w = ambi_bin.design_ri(self.cfg, hrirs=hrirs, hrir_dirs_deg=dirs,
                                    hrir_fs=fs, device=device)
        self.state = ambi_bin.init_state_batched(self.cfg, self.streams,
                                                 device=device)

    def step(self, g: int) -> torch.Tensor:
        x = self.ring[g % self.ring.shape[0]]
        y, self.state = self.model.process_ri_batched(
            self.cfg, self.w, self.state, x, fused=True)
        return y

    def release(self) -> None:
        self.w = self.state = None

    def work_bytes(self) -> int:
        n_bands = self.cfg.hop + 5
        return work_bytes.block_bytes(
            self.streams, self.cin, self.cout, self.block_samples,
            work_bytes.decoder_bytes(n_bands, self.cout, self.cin))

    def reference(self, g: int, precision: str = "fp32") -> torch.Tensor:
        """Block g's output, rendered by the plain reference from the
        inputs of blocks g - m .. g, m = ``history_blocks``."""
        if getattr(self, "_dec", None) is None:
            dec = ref_design.ambi_bin_decoder(self.cfg.order, self.fs)
            self._dec = (torch.tensor(dec.real.astype(np.float32),
                                      device=self.device),
                         torch.tensor(dec.imag.astype(np.float32),
                                      device=self.device))
        ref = Reference(self.device, precision)
        m = history_blocks(self.hops_per_block)
        R = self.ring.shape[0]
        Mre, Mim = (d[None, None] for d in self._dec)   # (1, 1, B, 2, cin)
        T = self.block_samples
        chunk = max(1, 4096 // self.cin)
        out = []
        for s0 in range(0, self.streams, chunk):
            x = torch.cat([self.ring[(g - m + i) % R, s0:s0 + chunk]
                           for i in range(m + 1)], dim=-1)
            out.append(ref.render(x, Mre, Mim, self.hops_per_block)[..., -T:])
        return torch.cat(out, dim=0)
