"""rotator — SH-domain rotation by yaw/pitch/roll (counterpart of
``spatial_audio_framework_tpu/models/rotator.py``; ``examples/src/rotator``).

The Ivanic rotation matrix of ``ypr`` (a tensor of three radians on the
device) is built on the device every frame
(``sh.get_sh_rot_mtx_real_torch``), so head-tracking angles stream without
the host waiting for the device; the previous rotation matrix is carried in
the state and crossfaded linearly over the frame (the reference's
interpolator, rotator.c).  No filterbank and none of the kernels: a few
``torch`` ops on the state's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from spatial_audio_framework_tpu_torch import default_device, f32_tensor
from spatial_audio_framework_tpu_torch.models import _common as C
from spatial_audio_framework_tpu_torch.modules import sh
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils import geometry as geo


@dataclass(frozen=True)
class RotatorConfig:
    order: int = 1
    ch_ordering: str = C.CH_ACN
    norm: str = C.NORM_SN3D
    use_roll_pitch_yaw: bool = False
    frame_size: int = 128

    @property
    def nsh(self) -> int:
        return (self.order + 1) ** 2

    def __post_init__(self):
        C.validate_config(self)


class RotatorState(NamedTuple):
    prev_M: torch.Tensor   # (nSH, nSH)
    prev_x: torch.Tensor   # (nSH, T) previous input frame


def design(cfg: RotatorConfig, device: torch.device | str | None = None):
    """(in_conv, out_conv) convention matrices folded around the rotation,
    on ``device`` (default: the card)."""
    conv_in = C.input_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    conv_out = C.output_conversion_mtx(cfg.order, cfg.ch_ordering, cfg.norm)
    return f32_tensor(conv_in, device), f32_tensor(conv_out, device)


def state_from_numpy(prev_M: np.ndarray, prev_x: np.ndarray,
                     device: torch.device | str | None = None) -> RotatorState:
    """A state (e.g. the JAX package's) from numpy arrays."""
    return RotatorState(prev_M=f32_tensor(prev_M, device),
                        prev_x=f32_tensor(prev_x, device))


def init_state(cfg: RotatorConfig,
               device: torch.device | str | None = None) -> RotatorState:
    device = default_device() if device is None else device
    return RotatorState(
        prev_M=torch.eye(cfg.nsh, dtype=torch.float32, device=device),
        prev_x=torch.zeros((cfg.nsh, cfg.frame_size), dtype=torch.float32,
                           device=device))


def process(cfg: RotatorConfig, weights, state: RotatorState, x: torch.Tensor,
            ypr: torch.Tensor):
    """x: (nSH, T); ypr: (yaw, pitch, roll) radians on x's device.
    One-frame latency with matrix crossfade, as in the reference."""
    conv_in, conv_out = weights
    T = x.shape[-1]
    R = geo.yaw_pitch_roll2_rzyx_torch(ypr,
                                       roll_pitch_yaw=cfg.use_roll_pitch_yaw)
    M = sh.get_sh_rot_mtx_real_torch(R.to(torch.float32), cfg.order)
    fade_in = (torch.arange(1, T + 1, dtype=x.dtype, device=x.device)
               / T)[None, :]
    with fp32_matmul():
        xin = conv_in @ state.prev_x
        out_new = M @ xin
        out_old = state.prev_M @ xin
        out = conv_out @ (out_new * fade_in + out_old * (1.0 - fade_in))
    return out, RotatorState(prev_M=M, prev_x=x)
