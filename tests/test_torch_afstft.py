"""afSTFT building blocks of the PyTorch port vs the JAX reference (CPU)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.modules import hrir as jhrir
from spatial_audio_framework_tpu.ops import afstft as jafstft
from spatial_audio_framework_tpu.ops import fft as jfft
from spatial_audio_framework_tpu.ops import pallas_afstft as jpa
from spatial_audio_framework_tpu_torch.ops import afstft as tafstft
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak
from spatial_audio_framework_tpu_torch.ops import fft as tfft


@pytest.mark.parametrize("hop", [128, 64])
@pytest.mark.parametrize("low_delay", [False, True])
def test_windows_exact(hop, low_delay):
    for a, b in zip(jafstft._windows(hop, low_delay),
                    tafstft._windows(hop, low_delay)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n", [256, 128])
def test_rdft_mats_exact(n):
    for a, b in zip(jfft._rdft_mats(n), tfft._rdft_mats(n)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hybrid", [True, False])
def test_centre_freqs_exact(hybrid):
    a = jafstft.AfSTFT(hop=128, hybrid=hybrid).centre_freqs(48000.0)
    b = tafstft.AfSTFT(hop=128, hybrid=hybrid).centre_freqs(48000.0)
    np.testing.assert_array_equal(a, b)
    assert tafstft.AfSTFT(hybrid=hybrid).n_bands == len(b)


@pytest.mark.parametrize("hybrid", [True, False])
def test_fir_to_filterbank_coeffs_vs_jax(hybrid):
    hrirs, _, _ = jhrir.default_hrirs()
    h = hrirs[::97][:8]                                  # a few directions
    a = jafstft.fir_to_filterbank_coeffs(h, 128, hybrid=hybrid)
    b = tafstft.fir_to_filterbank_coeffs(h, 128, hybrid=hybrid)
    assert a.shape == b.shape and b.dtype == np.complex64
    assert np.abs(a - b).max() <= 1e-5


@pytest.mark.parametrize("hybrid", [True, False])
def test_decode_taps_exact(hybrid):
    rng = np.random.default_rng(1)
    nb = 133 if hybrid else 129
    Mre = rng.standard_normal((nb, 2, 5)).astype(np.float32)
    Mim = rng.standard_normal((nb, 2, 5)).astype(np.float32)
    a = np.asarray(jpa.decode_taps(jnp.asarray(Mre), jnp.asarray(Mim),
                                   hybrid=hybrid))
    b = tak.decode_taps(torch.from_numpy(Mre), torch.from_numpy(Mim),
                        hybrid=hybrid).numpy()
    assert b.shape == (5, 2, 4, 129)
    np.testing.assert_array_equal(a, b)
