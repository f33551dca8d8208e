"""The SH rotation in the PyTorch port vs the JAX reference (CPU): the
rotation matrix on a tensor (``get_sh_rot_mtx_real_torch``) and on numpy,
the two Euler orders, and the numpy SH functions the beamformer needs.

Tolerances: 1e-5 absolute on the rotation matrices (their entries are
bounded by 1: float32 on both sides, only the order of a few products
differs), 1e-12 where both sides compute in float64."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.modules import sh as jsh
from spatial_audio_framework_tpu.utils import geometry as jgeo
from spatial_audio_framework_tpu_torch.modules import sh as tsh
from spatial_audio_framework_tpu_torch.utils import geometry as tgeo

ROT_TOL = 1e-5
GOLDENS = os.path.join(os.path.dirname(__file__), "goldens", "c_goldens.npz")

_HALF = np.pi / 2
# degenerate and seam angles, then random ones
_YPR = {
    "zero": (0.0, 0.0, 0.0),
    "yaw_pi": (np.pi, 0.0, 0.0),
    "yaw_minus_pi": (-np.pi, 0.0, 0.0),
    "pitch_up": (0.3, _HALF, -0.2),
    "pitch_down": (-1.0, -_HALF, 0.7),
    "roll_pi": (0.0, 0.0, np.pi),
    "all_pi": (np.pi, np.pi, -np.pi),
    **{f"random{i}": tuple(np.random.default_rng(40 + i).uniform(-np.pi, np.pi, 3))
       for i in range(3)},
}


def _jax_rot(ypr, order, rpy=False):
    y = jnp.asarray(np.asarray(ypr, np.float32))
    R = jgeo.yaw_pitch_roll2_rzyx(y[0], y[1], y[2], roll_pitch_yaw=rpy)
    return np.asarray(R), np.asarray(
        jsh.get_sh_rot_mtx_real(R.astype(jnp.float32), order))


@pytest.mark.parametrize("name", list(_YPR))
@pytest.mark.parametrize("order", range(1, 8))
def test_rot_mtx_torch_vs_jax(order, name):
    """float32 ypr → R → SH rotation, device ops only, vs the traced JAX
    recursion on the same float32 angles."""
    ypr = _YPR[name]
    _, ref = _jax_rot(ypr, order)
    R = tgeo.yaw_pitch_roll2_rzyx_torch(
        torch.tensor(np.asarray(ypr, np.float32)))
    got = tsh.get_sh_rot_mtx_real_torch(R, order)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= ROT_TOL
    # a rotation: orthogonal, band by band
    eye = got.numpy() @ got.numpy().T
    assert np.abs(eye - np.eye(ref.shape[0])).max() <= 1e-4


@pytest.mark.parametrize("name", ["yaw_pi", "pitch_up", "random0"])
@pytest.mark.parametrize("order", [1, 4, 7])
def test_rot_mtx_numpy_vs_jax_float32(order, name):
    """The numpy function at float32, as the port's design-time callers and
    the C-parity test use it."""
    R, ref = _jax_rot(_YPR[name], order)
    got = tsh.get_sh_rot_mtx_real(R.astype(np.float32), order)
    assert got.dtype == np.float32
    assert np.abs(got - ref).max() <= ROT_TOL


@pytest.mark.parametrize("fn", ["numpy", "torch"])
def test_rot_mtx_vs_c(fn):
    """Order 4 at yaw 30°, pitch −10°, roll 5° against the compiled C
    (tests/test_c_goldens.py::test_sh_rotation_matrix), limit 1e-4."""
    g = np.load(GOLDENS)
    ypr = np.deg2rad([30.0, -10.0, 5.0])
    if fn == "numpy":
        R = tgeo.yaw_pitch_roll2_rzyx(*ypr)
        M = tsh.get_sh_rot_mtx_real(R.astype(np.float32), 4)
    else:
        R = tgeo.yaw_pitch_roll2_rzyx_torch(torch.tensor(ypr, dtype=torch.float32))
        M = tsh.get_sh_rot_mtx_real_torch(R, 4).numpy()
    assert np.abs(np.asarray(R) - g["sh_R3"]).max() <= 1e-4
    assert np.abs(M - g["sh_rot_o4"]).max() <= 1e-4


@pytest.mark.parametrize("order", [1, 2, 5, 7])
def test_rot_mtx_torch_float64_equals_numpy(order):
    """Same sums in the same dtype: the tensor recursion reproduces the
    numpy one to rounding, so the tables (rows, coefficients, signs) are
    right at every (l, m, n)."""
    rng = np.random.default_rng(order)
    R = tgeo.yaw_pitch_roll2_rzyx(*rng.uniform(-3, 3, 3))
    ref = tsh.get_sh_rot_mtx_real(R, order)
    got = tsh.get_sh_rot_mtx_real_torch(torch.from_numpy(R), order).numpy()
    assert np.abs(got - ref).max() <= 1e-12


def test_rot_mtx_torch_batched():
    """Leading dims: (..., 3, 3) → (..., nSH, nSH), each its own rotation."""
    rng = np.random.default_rng(3)
    ypr = torch.from_numpy(rng.uniform(-3, 3, (2, 3, 3)))
    R = tgeo.yaw_pitch_roll2_rzyx_torch(ypr)
    M = tsh.get_sh_rot_mtx_real_torch(R, 3)
    assert M.shape == (2, 3, 16, 16)
    for i in range(2):
        for j in range(3):
            ref = tsh.get_sh_rot_mtx_real(R[i, j].numpy(), 3)
            assert np.abs(M[i, j].numpy() - ref).max() <= 1e-12


def test_rot_tables_are_cached(monkeypatch):
    """Once warm, a block's rotation makes no tensor from host data (a
    pageable host-to-device copy would make the host wait for the device)
    and reads nothing back."""
    R = tgeo.yaw_pitch_roll2_rzyx_torch(torch.tensor([0.1, 0.2, 0.3]))
    tsh.get_sh_rot_mtx_real_torch(R, 5)

    def refuse(*a, **k):
        raise AssertionError("tensor made from host data per block")

    monkeypatch.setattr(torch, "tensor", refuse)
    monkeypatch.setattr(torch, "from_numpy", refuse)
    monkeypatch.setattr(torch, "as_tensor", refuse)
    monkeypatch.setattr(torch.Tensor, "item", refuse)
    monkeypatch.setattr(torch.Tensor, "tolist", refuse)
    monkeypatch.setattr(torch.Tensor, "numpy", refuse)
    R = tgeo.yaw_pitch_roll2_rzyx_torch(torch.ones(3) * 0.5)
    M = tsh.get_sh_rot_mtx_real_torch(R, 5)
    assert M.shape == (36, 36)


@pytest.mark.parametrize("rpy", [False, True])
@pytest.mark.parametrize("name", list(_YPR))
def test_yaw_pitch_roll_torch_vs_jax(name, rpy):
    """Both Euler orders (the rotator's use_roll_pitch_yaw), float64."""
    ypr = np.asarray(_YPR[name], np.float64)
    ref = jgeo.yaw_pitch_roll2_rzyx(*ypr, roll_pitch_yaw=rpy)
    got = tgeo.yaw_pitch_roll2_rzyx_torch(torch.from_numpy(ypr),
                                          roll_pitch_yaw=rpy)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-12
    batched = tgeo.yaw_pitch_roll2_rzyx_torch(
        torch.from_numpy(np.stack([ypr, -ypr])), roll_pitch_yaw=rpy)
    assert torch.equal(batched[0], got)


@pytest.mark.parametrize("order", [1, 3, 7])
def test_complex_sh_and_beam_weights_vs_jax(order):
    """The numpy functions the beamformer stands on, float64 on both sides
    (the same code path in the JAX package's numpy branch)."""
    rng = np.random.default_rng(order)
    dirs = np.stack([rng.uniform(-np.pi, np.pi, 9), rng.uniform(0, np.pi, 9)],
                    -1)
    pairs = [
        (tsh.get_sh_complex(order, dirs), jsh.get_sh_complex(order, dirs)),
        (tsh.complex2real_sh_mtx(order), jsh.complex2real_sh_mtx(order)),
        (tsh.real2complex_sh_mtx(order), jsh.real2complex_sh_mtx(order)),
        (tsh.beam_weights_cardioid(order), jsh.beam_weights_cardioid(order)),
        (tsh.beam_weights_hypercardioid(order),
         jsh.beam_weights_hypercardioid(order)),
    ]
    Cc = rng.standard_normal(((order + 1) ** 2, 3)) \
        + 1j * rng.standard_normal(((order + 1) ** 2, 3))
    pairs.append((tsh.complex2real_coeffs(order, Cc),
                  jsh.complex2real_coeffs(order, Cc)))
    b = tsh.beam_weights_hypercardioid(order)
    pairs.append((tsh.rotate_axis_coeffs_complex(order, b, 0.7, -2.0),
                  jsh.rotate_axis_coeffs_complex(order, b, 0.7, -2.0)))
    pairs.append((tsh.rotate_axis_coeffs_real(order, b, 0.7, -2.0),
                  jsh.rotate_axis_coeffs_real(order, b, 0.7, -2.0)))
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype
        assert np.abs(got - ref).max() <= 1e-12
