"""SAF ambi_dec on the port's batched entry: every stream decodes its own
scene to the loudspeaker layout with the configuration's dual-band decoder,
state carried from block to block (``models/ambi_dec.process_ri_batched``,
``fused=True``).  At 16 inputs and 22 outputs (352 channel pairs) the
render takes the port's wide route."""
from __future__ import annotations

import torch

from portbench import traffic, work_bytes
from portbench.reference import ambi_dec as ref_ambi_dec
from portbench.reference.render import Reference, history_blocks


class System:
    def __init__(self, config: dict, mix: dict, seed: int, device):
        from spatial_audio_framework_tpu_torch.models import ambi_dec
        from spatial_audio_framework_tpu_torch.utils import presets

        st = config["settings"]
        for key, value in ref_ambi_dec.SETTINGS.items():
            if st.get(key, value) != value:
                raise ValueError(f"{config['name']}: the reference renders "
                                 f"{key}={value!r}, not {st[key]!r}")
        self.model = ambi_dec
        self.cfg = ambi_dec.AmbiDecConfig(
            master_order=st["order"], fs=st["fs"],
            dec_method=tuple(st["dec_method"]),
            re_weight=tuple(st["enable_max_re"]),
            diff_eq_mode=(ambi_dec.ENERGY_PRESERVING,) * 2,
            transition_freq=st["transition_freq"],
            ch_ordering=st["ch_ordering"], norm=st["norm"],
            binauralise_ls=False, hop=st["hop"])
        self.layout = st["layout"]
        self.device = device
        self.streams = mix["streams"]
        self.block_samples = mix["block_samples"]
        ls = presets.loudspeaker_preset(self.layout)
        self.cin, self.cout = self.cfg.nsh, ls.shape[0]
        self.hops_per_block = self.block_samples // self.cfg.hop
        self.fs = self.cfg.fs
        self.ring = traffic.signal_ring(mix, self.cin, seed, device)
        self.w = ambi_dec.design_ri(self.cfg, ls, device=device)
        self.state = ambi_dec.init_state_batched(self.cfg, self.streams,
                                                 self.cout, device=device)

    def step(self, g: int) -> torch.Tensor:
        x = self.ring[g % self.ring.shape[0]]
        y, self.state = self.model.process_ri_batched(
            self.cfg, self.w, self.state, x, fused=True)
        return y

    def release(self) -> None:
        self.w = self.state = None

    def work_bytes(self) -> int:
        # a real decoder shared by every stream, read once
        n_bands = self.cfg.hop + 5
        return work_bytes.block_bytes(
            self.streams, self.cin, self.cout, self.block_samples,
            work_bytes.F32 * n_bands * self.cout * self.cin)

    def reference(self, g: int, precision: str = "fp32") -> torch.Tensor:
        """Block g's output, rendered by the plain reference from the
        inputs of blocks g - m .. g, m = ``history_blocks``, with the
        reference's own decoder."""
        if getattr(self, "_dec", None) is None:
            dec = ref_ambi_dec.decoder(self.cfg.master_order, self.fs,
                                       self.cfg.transition_freq, self.layout)
            self._dec = torch.tensor(dec, device=self.device)
        ref = Reference(self.device, precision)
        m = history_blocks(self.hops_per_block)
        R = self.ring.shape[0]
        T = self.block_samples
        chunk = max(1, 4096 // self.cin)
        out = []
        for s0 in range(0, self.streams, chunk):
            x = torch.cat([self.ring[(g - m + i) % R, s0:s0 + chunk]
                           for i in range(m + 1)], dim=-1)
            out.append(ref_ambi_dec.render(ref, x, self._dec,
                                           self.hops_per_block)[..., -T:])
        return torch.cat(out, dim=0)
