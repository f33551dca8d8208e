"""The bytes a block's work needs, whatever implements it: each input read
once and each output and carried state written once, float32.  The
denominator of ``render_roofline`` (``metrics/render_roofline.py``).

Per block of S streams, cin inputs, cout outputs and T samples: the input
S·cin·T, the output S·cout·T, the 15-hop input tail read and written
(2·S·cin·15·128), the 9-hop overlap-add tail read and written
(2·S·cout·9·128), and the mixing data read once.
"""
from __future__ import annotations

F32 = 4
HOP = 128
IN_TAIL_HOPS = 15
OLA_TAIL_HOPS = 9


def block_bytes(streams: int, cin: int, cout: int, samples: int,
                mixing_bytes: int) -> int:
    S = streams
    return F32 * (S * cin * samples + S * cout * samples
                  + 2 * S * cin * IN_TAIL_HOPS * HOP
                  + 2 * S * cout * OLA_TAIL_HOPS * HOP) + mixing_bytes


def decoder_bytes(n_bands: int, cout: int, cin: int) -> int:
    """A per-band complex decoder shared by every stream (re, im)."""
    return F32 * n_bands * cout * cin * 2


def hrtf_table_bytes(n_bands: int, n_dirs: int) -> int:
    """The complex HRTF table over the HRIR grid, both ears (re, im)."""
    return F32 * n_bands * 2 * n_dirs * 2


def controls_bytes(streams: int, n_src: int) -> int:
    """A block's source directions (azimuth, elevation) and head poses
    (yaw, pitch, roll)."""
    return F32 * (streams * n_src * 2 + streams * 3)
