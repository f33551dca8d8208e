"""The SMB pitch shifter in the port against the JAX package (CPU): the C
golden's input at the three shifts, several channels with the shift
changing every block and the JAX state handed across, the phase wrap at
exact odd multiples of π, and the scatters' indices."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.models import pitch_shifter as jps
from spatial_audio_framework_tpu.ops import pitch as jpitch
from spatial_audio_framework_tpu_torch.models import pitch_shifter as tps
from spatial_audio_framework_tpu_torch.ops import pitch as tpitch

# the C golden's budget is 1e-3 (tests/test_c_goldens.py:416, 431); port vs
# JAX measures 7.9e-5 at shift 0.5 (two bins collapse onto one: the
# magnitude sums in another order), below 1e-6 at 1.5 and 2.0
TOL = 1e-4


@pytest.fixture(scope="module")
def pitch_in():
    import os

    g = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                             "c_goldens.npz"))
    return np.asarray(g["pitch_in"], np.float32)


@pytest.mark.parametrize("shift", [0.5, 1.5, 2.0])
def test_golden_input_matches_jax(pitch_in, shift):
    jp = jpitch.SmbPitchShift(fs=48000.0, n_ch=1, fft_size=4096, osamp=4)
    tp = tpitch.SmbPitchShift(fs=48000.0, n_ch=1, fft_size=4096, osamp=4)
    yj, sj = jax.jit(lambda s, x: jp.apply(s, x, jnp.float32(shift)))(
        jp.init_state(), jnp.asarray(pitch_in)[None])
    yt, st = tp.apply(tp.init_state("cpu"), torch.from_numpy(pitch_in)[None],
                      torch.tensor(shift))
    err = np.abs(yt.numpy() - np.asarray(yj)).max()
    print(f"pitch shift {shift}: port vs JAX max |err| = {err:.3e} "
          f"(tol {TOL})")
    assert err <= TOL
    assert np.abs(yt.numpy()).max() > 0.1
    np.testing.assert_allclose(st.out_accum.numpy(), np.asarray(sj.out_accum),
                               atol=TOL)


def test_many_channels_changing_shift_and_state_handover():
    """4 channels, fft 1024 / osamp 8, a shift tensor new every block; the
    JAX state is handed to the port after the first block.  The inputs are
    sines, as the C golden's: see test_real_bins_take_the_c_sign for
    inputs with energy at the Nyquist bin."""
    cfg_j = jps.PitchShifterConfig(n_ch=4, fft_size=1024, osamp=8)
    cfg_t = tps.PitchShifterConfig(n_ch=4, fft_size=1024, osamp=8)
    t = np.arange(4 * 128 * 6) / 48000.0
    x = (np.array([[0.4], [0.3], [0.5], [0.2]])
         * np.sin(2 * np.pi * np.outer([220, 330, 440, 1000], t)
                  + np.arange(4)[:, None])).astype(np.float32)
    blocks = np.split(x, 4, axis=1)
    shifts = (1.25, 0.75, 1.9, 0.55)
    proc = jax.jit(lambda s, xx, f: jps.process(cfg_j, s, xx, f))
    sj = jps.init_state(cfg_j)
    st = tps.init_state(cfg_t, device="cpu")
    mats = tps.design(cfg_t, device="cpu")
    for i, (b, f) in enumerate(zip(blocks, shifts)):
        if i == 1:
            st = tps.state_from_numpy(cfg_t, [np.asarray(a) for a in sj],
                                      "cpu")
        yj, sj = proc(sj, jnp.asarray(b), jnp.float32(f))
        yt, st = tps.process(cfg_t, st, torch.from_numpy(b),
                             torch.tensor(f), mats)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=TOL,
                                   err_msg=f"block {i}, shift {f}")
    for name in ("in_fifo", "out_accum", "out_fifo"):
        np.testing.assert_allclose(getattr(st, name).numpy(),
                                   np.asarray(getattr(sj, name)), atol=TOL)
    # the phase states are held through the outputs of the blocks after
    # the handover: a bin far from every tone has a magnitude near 0 and a
    # phase that is rounding (it differs by up to π between the two)


def test_real_bins_take_the_c_sign():
    """The DC and Nyquist bins are real: the port's rFFT gives them a +0
    imaginary part, as the C's FFT does, so atan2 gives +π for a negative
    bin.  The JAX package's matmul DFT leaves ±1e-13 of rounding in the
    Nyquist bin's imaginary part (sin(πn) is not 0 in float32), so its
    phase there is ±π by chance; where the pitch shift moves the Nyquist
    bin into the spectrum (shift < 1) and the input has energy there
    (noise), the two outputs then move apart by 4.3e-2, while the JAX
    package moves by 4.5e-5 for a one-ulp change of its input and the two
    agree to 1.5e-4 on the same noise low-passed to no energy at Nyquist
    (scripts/pitch_precision.py): a difference of convention at one bin,
    not of rounding."""
    tp = tpitch.SmbPitchShift(fs=48000.0, n_ch=1, fft_size=64, osamp=4)
    x = -torch.ones(1, 64)
    x[0, 0::2] = -3.0          # negative DC and Nyquist
    spec = torch.fft.rfft(x * tp.design("cpu")["win"], dim=-1)
    assert not torch.signbit(spec.imag[0, [0, -1]]).any()
    ph = torch.atan2(spec.imag, spec.real)[0, [0, -1]]
    assert torch.equal(ph, torch.full((2,), float(np.float32(np.pi))))


def _jax_wrap(tmp):
    """The JAX module's wrap (ops/pitch.py, the qpd lines), verbatim."""
    qpd = (tmp / jnp.pi).astype(jnp.int32)
    qpd = qpd + jnp.where(qpd >= 0, qpd & 1, -(qpd & 1))
    return tmp - jnp.pi * qpd.astype(tmp.dtype)


def test_phase_wrap_at_odd_multiples_of_pi():
    k = np.arange(-7, 8, dtype=np.float32)
    tmp = np.concatenate([np.float32(np.pi) * k,
                          np.nextafter(np.float32(np.pi) * k, np.float32(0)),
                          np.float32(np.pi) * k + np.float32(1e-3),
                          np.linspace(-30, 30, 101, dtype=np.float32)])
    got = tpitch.wrap_phase(torch.from_numpy(tmp)).numpy()
    np.testing.assert_array_equal(got, np.asarray(_jax_wrap(jnp.asarray(tmp))))
    # the odd multiples themselves: truncation keeps ±π (round() would not)
    odd = np.float32(np.pi) * np.array([3, -3, 5], np.float32)
    w = tpitch.wrap_phase(torch.from_numpy(odd)).numpy()
    assert np.all(np.abs(np.abs(w) - np.pi) < 1e-5)


@pytest.mark.parametrize("shift", [0.5, 0.55, 1.0, 1.3, 1.5, 2.0, 0.999])
def test_scatter_indices_have_no_duplicates(shift):
    N = 1024
    half = N // 2 + 1
    k = torch.arange(half, dtype=torch.float32)
    ki = torch.arange(half, dtype=torch.int64)
    idx_mag, idx_freq = tpitch.scatter_indices(k, ki, torch.tensor(shift), N)
    assert idx_freq.unique().numel() == half          # no index repeats
    assert int(idx_mag.max()) <= half and int(idx_mag.min()) >= 0
    valid = idx_freq < half
    # each valid target is written once, by the last k of its run
    raw = np.floor(np.arange(half, dtype=np.float32) * np.float32(shift))
    for target in np.unique(raw[raw <= N // 2]).astype(int):
        last = np.nonzero(raw == target)[0].max()
        assert int(idx_freq[last]) == target
    assert int(valid.sum()) == len(np.unique(raw[raw <= N // 2]))


def test_pitch_shifter_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tps.PitchShifterConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tps.init_state(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tps.design(cfg)
