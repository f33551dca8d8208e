"""render_full_ri: the port's plain version vs the JAX Pallas kernel run in
interpret mode (CPU), and the wrapper's CPU/CUDA contract."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu.ops import pallas_afstft as jpa
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak

# |err| bound per JAX precision mode: "highest" is exact fp32 on both sides
# (only the summation order differs); "high" is the TPU kernel's bf16 f32x3
# split (pallas_afstft.py:51-64), ~4e-6 relative per product
TOL = {"highest": 1e-5, "high": 2e-4}


def _inputs(S, cin, cout, seed=0, per_stream=False, nb=133):
    rng = np.random.default_rng(seed)
    in_tail = rng.uniform(-1, 1, (S, cin, 15 * 128)).astype(np.float32)
    ola = rng.uniform(-1, 1, (S, cout, 9, 128)).astype(np.float32)
    mshape = ((S,) if per_stream else ()) + (nb, cout, cin)
    Mre = rng.standard_normal(mshape).astype(np.float32)
    Mim = rng.standard_normal(mshape).astype(np.float32)
    return rng, in_tail, ola, Mre, Mim


@pytest.mark.parametrize("mode", ["highest", "high"])
@pytest.mark.parametrize("S,cin,cout,H", [(2, 4, 2, 8), (3, 4, 2, 4),
                                          (1, 9, 2, 20)])
def test_render_full_reference_vs_jax(S, cin, cout, H, mode):
    """Two chained calls carrying both tails (H < 9 and H < 15 included)."""
    rng, in_tail, ola, Mre, Mim = _inputs(S, cin, cout)
    taps_j = jpa.decode_taps(jnp.asarray(Mre), jnp.asarray(Mim))
    taps_t = tak.decode_taps(torch.from_numpy(Mre), torch.from_numpy(Mim))
    jt, jo = jnp.asarray(in_tail), jnp.asarray(ola)
    tt, to = torch.from_numpy(in_tail), torch.from_numpy(ola)
    for _ in range(2):
        x = rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)
        jy, jo = jpa.render_full_ri(jt, jnp.asarray(x), jo, taps_j,
                                    interpret=True, mxu_mode=mode)
        ty, to = tak.render_full_ri_reference(tt, torch.from_numpy(x), to,
                                              taps_t)
        assert ty.shape == (S, cout, H * 128) and to.shape == (S, cout, 9, 128)
        assert np.abs(np.asarray(jy) - ty.numpy()).max() <= TOL[mode]
        assert np.abs(np.asarray(jo) - to.numpy()).max() <= TOL[mode]
        xx = np.concatenate([np.asarray(jt), x], axis=-1)[..., H * 128:]
        jt, tt = jnp.asarray(xx), torch.from_numpy(np.ascontiguousarray(xx))


@pytest.mark.parametrize("option", ["per_stream", "low_delay", "non_hybrid"])
def test_reference_options_vs_jax(option):
    """The plain version takes every option the kernel takes."""
    S, cin, cout, H = 2, 3, 2, 6
    kw = {"per_stream": option == "per_stream",
          "low_delay": option == "low_delay",
          "hybrid": option != "non_hybrid"}
    rng, in_tail, ola, Mre, Mim = _inputs(
        S, cin, cout, seed=2, per_stream=kw["per_stream"],
        nb=133 if kw["hybrid"] else 129)
    x = rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)
    taps_j = jpa.decode_taps(jnp.asarray(Mre), jnp.asarray(Mim),
                             hybrid=kw["hybrid"])
    taps_t = tak.decode_taps(torch.from_numpy(Mre), torch.from_numpy(Mim),
                             hybrid=kw["hybrid"])
    jy, jo = jpa.render_full_ri(jnp.asarray(in_tail), jnp.asarray(x),
                                jnp.asarray(ola), taps_j, interpret=True,
                                mxu_mode="highest", **kw)
    ty, to = tak.render_full_ri_reference(
        torch.from_numpy(in_tail), torch.from_numpy(x),
        torch.from_numpy(ola), taps_t, **kw)
    assert np.abs(np.asarray(jy) - ty.numpy()).max() <= 1e-5
    assert np.abs(np.asarray(jo) - to.numpy()).max() <= 1e-5


def test_cpu_wrapper_is_the_reference_and_not_counted():
    S, cin, cout, H = 2, 3, 2, 5
    rng, in_tail, ola, Mre, Mim = _inputs(S, cin, cout, seed=3)
    x = rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)
    args = (torch.from_numpy(in_tail), torch.from_numpy(x),
            torch.from_numpy(ola),
            tak.decode_taps(torch.from_numpy(Mre), torch.from_numpy(Mim)))
    before = tak.LAUNCHES["render_full_ri"]
    y1, t1 = tak.render_full_ri(*args)
    y2, t2 = tak.render_full_ri_reference(*args)
    assert torch.equal(y1, y2) and torch.equal(t1, t2)
    assert tak.LAUNCHES["render_full_ri"] == before


def test_kernel_constants_are_row_major():
    """The CUDA kernels index what they take (the windows and the FFT
    twiddle table) and the plain versions what they multiply by (the DFT
    matrices) as row-major arrays; _rdft_mats' A and B are Fortran-ordered
    numpy arrays, so a copy that kept their strides would hand A over
    transposed.  Each equals its float64 source rounded once."""
    from spatial_audio_framework_tpu_torch.ops.afstft import _windows
    from spatial_audio_framework_tpu_torch.ops.fft import (_fft256_twiddles,
                                                           _rdft_mats)

    cpu = torch.device("cpu")
    for low_delay in (False, True):
        k = tak.device_consts(128, low_delay, cpu)
        w_ana, w_syn = _windows(128, low_delay)
        C, S, A, B = _rdft_mats(256)
        expect = {"w_ana": w_ana, "w_syn": w_syn, "C": C, "S": S, "A": A,
                  "B": B}
        for name, ref in expect.items():
            assert k[name].is_contiguous(), name
            np.testing.assert_array_equal(k[name].numpy(),
                                          ref.astype(np.float32))
        assert all(t.is_contiguous() for t in k.values())
    tw = tak._fft_twiddles(cpu)
    ang = 2 * np.pi * np.arange(256) / 256
    assert tw.is_contiguous() and tw.shape == (256, 2)
    np.testing.assert_array_equal(tw.numpy(), _fft256_twiddles())
    np.testing.assert_array_equal(
        tw.numpy(), np.stack([np.cos(ang), -np.sin(ang)], 1).astype(np.float32))


_FLAGSHIP = dict(per_stream=False, hop=128, low_delay=False, hybrid=True,
                 cin=16, cout=2)


@pytest.mark.parametrize("change", [{"hop": 64}, {"cin": 65, "cout": 2}])
def test_kernel_support_check_raises(change):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak._check_kernel_supported(**{**_FLAGSHIP, **change})


@pytest.mark.parametrize("change", [
    {"cin": 16, "cout": 2}, {"cin": 25, "cout": 2}, {"cin": 64, "cout": 2},
    {"cin": 4, "cout": 3},
    # the options the kernel takes since the binauraliser slice
    {"per_stream": True}, {"low_delay": True}, {"hybrid": False}],
    ids=["16-2", "25-2", "64-2", "4-3", "per_stream", "low_delay",
         "non_hybrid"])
def test_kernel_support_check_accepts_the_slice(change):
    tak._check_kernel_supported(**{**_FLAGSHIP, **change})
