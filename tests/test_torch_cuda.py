"""The port's CUDA kernels on the card: each held against its plain
version, and the CUDA paths never take a plain version.

These tests need an NVIDIA GPU and nvcc and skip without them.  They import
neither jax nor the JAX package, so they also run on a machine without jax:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(tests/conftest.py configures jax).
"""
import contextlib

import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.models import ambi_bin, ambi_dec
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak
from spatial_audio_framework_tpu_torch.utils import presets

pytestmark = pytest.mark.cuda

# fp32 on both sides; only the order of the sums differs
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(S, cin, cout, seed=0, per_stream=False, hybrid=True):
    rng = np.random.default_rng(seed)
    in_tail = rng.uniform(-1, 1, (S, cin, 15 * 128)).astype(np.float32)
    ola = rng.uniform(-1, 1, (S, cout, 9, 128)).astype(np.float32)
    M = rng.uniform(-1, 1, (2,) + ((S,) if per_stream else ())
                    + (133 if hybrid else 129, cout, cin)).astype(np.float32)
    taps = tak.decode_taps(torch.from_numpy(M[0]), torch.from_numpy(M[1]),
                           hybrid=hybrid)
    return rng, in_tail, ola, taps.contiguous()


@pytest.mark.parametrize("S,cin,cout,H,options", [
    (3, 4, 2, 4, {}),      # odd S, H < 9
    (2, 4, 2, 40, {}),     # two hop tiles, the second partial
    (1, 25, 2, 4, {}),     # the order-4 C-golden width
    (2, 3, 1, 9, {}),      # one ear
    (1, 4, 3, 33, {}),     # an ear pass of 2 and one of 1
    (2, 4, 2, 6, {"low_delay": True}),
    (3, 4, 2, 1, {"per_stream": True}),           # the binauraliser's taps
    (2, 5, 2, 40, {"hybrid": False}),             # d at hop offset 6, no g
    (2, 3, 3, 9, {"low_delay": True, "per_stream": True, "hybrid": False}),
])
def test_kernel_matches_plain_version(cuda, S, cin, cout, H, options):
    rng, in_tail, ola, taps = _case(
        S, cin, cout, per_stream=options.get("per_stream", False),
        hybrid=options.get("hybrid", True))
    taps = taps.to(cuda)
    kt = rt = torch.from_numpy(in_tail).to(cuda)
    ko = ro = torch.from_numpy(ola).to(cuda)
    for _ in range(2):                       # chained: both tails carried
        x = torch.from_numpy(
            rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)).to(cuda)
        ky, ko = tak.render_full_ri(kt, x, ko, taps, **options)
        ry, ro = tak.render_full_ri_reference(rt, x, ro, taps, **options)
        torch.cuda.synchronize()
        assert (ky - ry).abs().max().item() <= TOL
        assert (ko - ro).abs().max().item() <= TOL
        kt = rt = torch.cat([kt, x], dim=-1)[..., H * 128:].contiguous()


def test_cuda_path_never_calls_plain_version(cuda, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took the plain version")

    monkeypatch.setattr(tak, "render_full_ri_reference", refuse)
    cfg = ambi_bin.AmbiBinConfig(order=1)
    rng = np.random.default_rng(1)
    w = ambi_bin.weights_from_numpy(rng.standard_normal((133, 2, 4)),
                                    rng.standard_normal((133, 2, 4)), cuda)
    st = ambi_bin.init_state_batched(cfg, 2, cuda)
    before = tak.render_full_ri.launches
    for _ in range(2):
        x = torch.from_numpy(
            rng.uniform(-1, 1, (2, 4, 512)).astype(np.float32)).to(cuda)
        y, st = ambi_bin.process_ri_batched(cfg, w, st, x)
    torch.cuda.synchronize()
    assert tak.render_full_ri.launches == before + 2
    assert bool(torch.isfinite(y).all())


def test_unsupported_option_raises_on_cuda(cuda):
    """The one-pass kernel takes every bank and taps form (above) but only
    hop 128 and at most 128 channel pairs."""
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.render_full_ri(z(2, 4, 15 * 64), z(2, 4, 4 * 64), z(2, 2, 9, 64),
                           z(4, 2, 4, 65))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.render_full_ri(z(1, 65, 15 * 128), z(1, 65, 512),
                           z(1, 2, 9, 128), z(65, 2, 4, 129))


def _u(rng, shape, device, amp=1.0):
    return torch.from_numpy(
        (amp * rng.uniform(-1, 1, shape)).astype(np.float32)).to(device)


@pytest.mark.parametrize("rows,t_hops,H,low_delay", [
    (5, 15, 4, False),     # rows not a multiple of 8, H < 9
    (3, 9, 2, False),      # the least tail, H < 9
    (7, 15, 40, True),     # low delay, two frame tiles (46 frames)
    (2, 15, 64, False),    # the slice's H: 70 frames, a partial tile
])
def test_analysis_front_matches_plain_version(cuda, rows, t_hops, H,
                                              low_delay):
    """Two chained calls carrying the input tail.  Half-scale noise keeps
    the spectra below |X| ~ 14, as in tests/test_torch_afstft_kernels.py."""
    rng = np.random.default_rng(rows)
    tail = _u(rng, (rows, t_hops * 128), cuda, amp=0.5)
    for _ in range(2):
        x = _u(rng, (rows, H * 128), cuda, amp=0.5)
        kre, kim = tak.analysis_front_ri(tail, x, low_delay=low_delay)
        rre, rim = tak.analysis_front_ri_reference(tail, x,
                                                   low_delay=low_delay)
        torch.cuda.synchronize()
        assert kre.shape == (rows, t_hops + H - 9, 129)
        assert (kre - rre).abs().max().item() <= TOL
        assert (kim - rim).abs().max().item() <= TOL
        tail = torch.cat([tail, x], dim=-1)[:, H * 128:].contiguous()


@pytest.mark.parametrize("rows,H,low_delay,hybrid", [
    (5, 4, False, True),   # rows not a multiple of 8, H < 9
    (3, 1, True, True),    # low delay, one hop
    (6, 9, False, False),  # non-hybrid (K = 258)
    (4, 33, True, False),  # low delay and non-hybrid
    (3, 64, False, True),  # the slice's H: 8 steps of 8 frames
])
def test_synthesis_back_matches_plain_version(cuda, rows, H, low_delay,
                                              hybrid):
    """Two chained calls carrying the overlap tail."""
    rng = np.random.default_rng(rows + H)
    K = 2 * (133 if hybrid else 129)
    kt = rt = _u(rng, (rows, 9, 128), cuda)
    for _ in range(2):
        spec = _u(rng, (rows, H, K), cuda, amp=10.0)
        ky, kt = tak.synthesis_back_ri(spec, kt, low_delay=low_delay,
                                       hybrid=hybrid)
        ry, rt = tak.synthesis_back_ri_reference(spec, rt,
                                                 low_delay=low_delay,
                                                 hybrid=hybrid)
        torch.cuda.synchronize()
        assert ky.shape == (rows, H, 128) and kt.shape == (rows, 9, 128)
        assert (ky - ry).abs().max().item() <= TOL
        assert (kt - rt).abs().max().item() <= TOL


@pytest.mark.parametrize("rows,t_hops,H,low_delay", [
    (3, 15, 1, False),     # 7 frames, one short tile
    (5, 9, 4, True),       # the least tail: 4 frames, low delay
    (7, 9, 130, False),    # 130 frames: four tiles of 33, 33, 33, 31
    (3, 15, 130, True),    # 136 frames: four tiles of 34
    (1027, 15, 64, False), # 70 frames, two tiles of 35; more tiles than
                           # the persistent grid has blocks, odd rows
])
def test_fft_front_matches_plain_version(cuda, rows, t_hops, H, low_delay):
    """The FFT-based front around its tiles of at most 40 frames (equal
    tiles of a row, none empty) and past its main path's rows."""
    rng = np.random.default_rng(rows + t_hops + H)
    tail = _u(rng, (rows, t_hops * 128), cuda, amp=0.5)
    x = _u(rng, (rows, H * 128), cuda, amp=0.5)
    kre, kim = tak.analysis_front_ri(tail, x, low_delay=low_delay)
    rre, rim = tak.analysis_front_ri_reference(tail, x, low_delay=low_delay)
    torch.cuda.synchronize()
    assert kre.shape == (rows, t_hops + H - 9, 129)
    assert (kre - rre).abs().max().item() <= TOL
    assert (kim - rim).abs().max().item() <= TOL


@pytest.mark.parametrize("rows,H,low_delay,hybrid", [
    (3, 1, False, False),  # one frame: the new tail is the old one moved
    (5, 4, True, True),    # H < 9, low delay
    (7, 130, False, True), # 17 steps of 8 frames, the last partial
    (2, 130, True, False),
    (1411, 64, False, True),  # past the ambi_dec slice's 1408 rows
])
def test_fft_back_matches_plain_version(cuda, rows, H, low_delay, hybrid):
    """The FFT-based back end around its 8-frame steps and 17-frame ring,
    two chained calls carrying the overlap tail."""
    rng = np.random.default_rng(rows + H)
    K = 2 * (133 if hybrid else 129)
    kt = rt = _u(rng, (rows, 9, 128), cuda)
    for _ in range(2):
        spec = _u(rng, (rows, H, K), cuda, amp=10.0)
        ky, kt = tak.synthesis_back_ri(spec, kt, low_delay=low_delay,
                                       hybrid=hybrid)
        ry, rt = tak.synthesis_back_ri_reference(spec, rt,
                                                 low_delay=low_delay,
                                                 hybrid=hybrid)
        torch.cuda.synchronize()
        assert (ky - ry).abs().max().item() <= TOL
        assert (kt - rt).abs().max().item() <= TOL


def test_interp_hrtfs_bad_directions_on_card(cuda, binauraliser_weights):
    """Directions past the VBAP table, negative rows and NaN directions
    neither assert on the card nor synchronise the host, and give what the
    same weights give on the CPU (NaN past the table, as the JAX
    package)."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    cfg = binauraliser.BinauraliserConfig(n_sources=6)
    dirs = torch.tensor([[10.0, 95.0], [10.0, -100.0], [float("nan"), 10.0],
                         [10.0, float("nan")], [10.0, 1e9], [30.0, 0.0]])
    w_cpu = type(binauraliser_weights)(*(t.cpu()
                                         for t in binauraliser_weights))
    dirs_cuda = dirs.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = binauraliser.interp_hrtfs_ri(cfg, binauraliser_weights,
                                           dirs_cuda)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = binauraliser.interp_hrtfs_ri(cfg, w_cpu, dirs)
    for g, r in zip(got, ref):
        g = g.cpu()
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert bool(torch.isnan(r[..., [0, 4]]).all())
        assert (g - r).nan_to_num().abs().max().item() <= 1e-6


def test_wide_render_takes_the_two_kernels(cuda, monkeypatch):
    """cout·cin > 128 (order 3 → 22.x) launches analysis_front_ri,
    wide_mix_ri and synthesis_back_ri once per block, never render_full_ri
    and never a plain version; the result matches the plain path."""
    cfg = ambi_dec.AmbiDecConfig(master_order=3)
    w = ambi_dec.design_ri(cfg, presets.loudspeaker_preset("22.x"),
                           device=cuda)
    rng = np.random.default_rng(7)
    xs = [_u(rng, (2, 16, 5 * 128), cuda) for _ in range(2)]
    st = ambi_dec.init_state_batched(cfg, 2, 22, cuda)
    ys_plain = []
    for x in xs:
        y, st = ambi_dec.process_ri_batched(cfg, w, st, x, fused=False)
        ys_plain.append(y)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for name in tak.KERNELS:
        monkeypatch.setattr(tak, f"{name}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    st = ambi_dec.init_state_batched(cfg, 2, 22, cuda)
    for x, yp in zip(xs, ys_plain):
        y, st = ambi_dec.process_ri_batched(cfg, w, st, x)
        torch.cuda.synchronize()
        assert (y - yp).abs().max().item() <= TOL
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 * (n in _WIDE_ROUTE) for n in tak.KERNELS}


def test_wide_render_at_the_benchmark_cells_rows(cuda, monkeypatch):
    """The wide route at the ``ambi_dec_o3_22x.batch1024`` cell's size:
    1024 streams, 16 → 22, H = 64 (16,384 front rows, 22,528 back rows),
    two blocks with state carried, within the configuration's limit
    (2e-5 of the largest sample) of the plain path on the card; each of
    its three kernels launched once a block, and the mix's plain version
    never."""
    cfg = ambi_dec.AmbiDecConfig(master_order=3)
    w = ambi_dec.design_ri(cfg, presets.loudspeaker_preset("22.x"),
                           device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(19)
    xs = [torch.rand((1024, 16, 64 * 128), generator=gen, device=cuda)
          .mul_(2.0).sub_(1.0) for _ in range(2)]
    st_k = st_p = ambi_dec.init_state_batched(cfg, 1024, 22, cuda)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took the mix's plain version")

    monkeypatch.setattr(tak, "wide_mix_ri_reference", refuse)
    before = {n: getattr(tak, n).launches for n in _WIDE_ROUTE}
    for x in xs:
        yk, st_k = ambi_dec.process_ri_batched(cfg, w, st_k, x)
        yp, st_p = ambi_dec.process_ri_batched(cfg, w, st_p, x, fused=False)
        torch.cuda.synchronize()
        err = ((yk - yp).abs().max() / yp.abs().max()).item()
        assert err <= 2e-5, err
        assert ((st_k.ola_tail - st_p.ola_tail).abs().max()
                / yp.abs().max()).item() <= 2e-5
        assert torch.equal(st_k.in_tail, st_p.in_tail)
        del yk, yp
    assert {n: getattr(tak, n).launches - before[n]
            for n in _WIDE_ROUTE} == dict.fromkeys(_WIDE_ROUTE, 2)


# -- wide_mix_ri: the wide route's hybrid stage and per-band mix ------------

_WIDE_ROUTE = ("analysis_front_ri", "wide_mix_ri", "synthesis_back_ri")


def _wide_inputs(rng, S, cin, cout, H, complex_m, per_stream, hybrid,
                 device):
    """Front-like spectra (S·cin, H+6, 129) at |X| ≤ 14 and a matrix
    scaled by 1/√cin, real or complex, shared or per stream."""
    spec = [_u(rng, (S * cin, H + 6, 129), device, amp=14.0)
            for _ in range(2)]
    shape = ((S,) if per_stream else ()) + (133 if hybrid else 129, cout,
                                            cin)
    M = [_u(rng, shape, device, amp=cin ** -0.5)
         for _ in range(2 if complex_m else 1)]
    return spec, M[0], M[1] if complex_m else None


@pytest.mark.parametrize("S,cin,cout,H,complex_m,per_stream,hybrid", [
    (3, 16, 22, 64, False, False, True),    # ambi_dec 22.x, odd S
    (2, 16, 22, 5, True, False, True),      # complex, H odd
    (5, 9, 17, 1, False, False, True),      # one hop: half an item
    (3, 65, 2, 5, True, True, True),        # the binauraliser past 64
    (2, 20, 7, 64, False, True, True),      # the panner, per stream, real
    (3, 32, 25, 5, True, False, True),      # array2sh: three e-groups
    (1, 64, 22, 5, True, True, True),       # many inputs: small band groups
    (3, 16, 22, 5, False, False, False),    # non-hybrid: 129 bands
    (2, 12, 13, 64, True, True, False),
    (7, 11, 13, 1, False, True, False),
    (2, 9, 17, 8, False, False, True),      # order 2: inputs past cin zero
    (3, 12, 13, 8, False, False, False),    # the real kernel, 129 bands
    (2, 16, 5, 4, False, False, True),      # one block of outputs a unit
])
def test_wide_mix_matches_plain_version(cuda, S, cin, cout, H, complex_m,
                                        per_stream, hybrid):
    """Within 2e-5 of the largest output of the plain version, which is
    the route's old torch glue, on the card."""
    rng = np.random.default_rng(S * cin + H)
    (sre, sim), Mre, Mim = _wide_inputs(rng, S, cin, cout, H, complex_m,
                                        per_stream, hybrid, cuda)
    before = tak.wide_mix_ri.launches
    got = tak.wide_mix_ri(sre, sim, Mre, Mim, hybrid=hybrid)
    ref = tak.wide_mix_ri_reference(sre, sim, Mre, Mim, hybrid=hybrid)
    torch.cuda.synchronize()
    assert tak.wide_mix_ri.launches == before + 1
    assert got.shape == ref.shape == (S * cout, H, 2 * (133 if hybrid
                                                        else 129))
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= 2e-5 * scale


def test_wide_mix_raises_on_what_it_does_not_take(cuda):
    """Wrong shapes, a dtype, a device or a hop other than 128 raise; the
    kernel never runs on them."""
    rng = np.random.default_rng(3)
    (sre, sim), Mre, Mim = _wide_inputs(rng, 2, 16, 22, 4, True, False,
                                        True, cuda)
    before = tak.wide_mix_ri.launches
    with pytest.raises(ValueError, match="rows"):
        tak.wide_mix_ri(sre[:-1], sim[:-1], Mre, Mim)       # S·cin rows
    with pytest.raises(ValueError, match="shape"):
        tak.wide_mix_ri(sre, sim, Mre[:129], Mim[:129])     # bands
    with pytest.raises(ValueError, match="shape"):
        tak.wide_mix_ri(sre, sim, Mre, Mim[:, :21])         # Mim's shape
    with pytest.raises(ValueError, match="shape"):
        tak.wide_mix_ri(sre, sim, Mre, Mim, hybrid=False)   # 129 bands
    with pytest.raises(TypeError, match="float32"):
        tak.wide_mix_ri(sre, sim.double(), Mre, Mim)
    with pytest.raises(ValueError, match="cpu"):
        tak.wide_mix_ri(sre, sim, Mre.cpu(), Mim)
    with pytest.raises(ValueError, match="contiguous"):
        tak.wide_mix_ri(sre, sim, Mre.transpose(1, 2).contiguous()
                        .transpose(1, 2), Mim)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.wide_mix_ri(sre[..., :65].contiguous(), sim[..., :65]
                        .contiguous(), Mre[:69], Mim[:69])
    assert tak.wide_mix_ri.launches == before


def test_new_kernels_raise_for_hop_other_than_128(cuda):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.analysis_front_ri(torch.zeros((2, 15 * 64), device=cuda),
                              torch.zeros((2, 4 * 64), device=cuda), hop=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.synthesis_back_ri(torch.zeros((2, 4, 138), device=cuda),
                              torch.zeros((2, 9, 64), device=cuda))


def _taps(rng, S, cin, cout, per_stream, hybrid, device):
    """decode_taps of random matrices, scaled by √(16/cin) above 16 inputs
    so wide renders keep the flagship's output scale."""
    shape = ((S,) if per_stream else ()) + (133 if hybrid else 129, cout, cin)
    M = min(1.0, (16 / cin) ** 0.5) * rng.uniform(-1, 1, (2,) + shape)
    M = torch.from_numpy(M.astype(np.float32))
    return tak.decode_taps(M[0], M[1], hybrid=hybrid).contiguous().to(device)


@pytest.mark.parametrize("rows,H,low_delay", [
    (5, 4, False),     # rows not a multiple of 8, H < 9
    (3, 1, True),      # low delay, one output hop
    (7, 40, True),     # two hop tiles, the second partial
    (2, 64, False),    # the order-7 slice's H
])
def test_analysis_front_dg_matches_plain_version(cuda, rows, H, low_delay):
    """Two chained calls carrying the 15-hop input tail; half-scale noise
    as for analysis_front_ri."""
    rng = np.random.default_rng(rows + H)
    tail = _u(rng, (rows, 15 * 128), cuda, amp=0.5)
    for _ in range(2):
        x = _u(rng, (rows, H * 128), cuda, amp=0.5)
        got = tak.analysis_front_dg_ri(tail, x, low_delay=low_delay)
        ref = tak.analysis_front_dg_ri_reference(tail, x, low_delay=low_delay)
        torch.cuda.synchronize()
        for k, r, n in zip(got, ref, (129, 129, 16, 16)):
            assert k.shape == (rows, H, n)
            assert (k - r).abs().max().item() <= TOL
        tail = torch.cat([tail, x], dim=-1)[:, H * 128:].contiguous()


@pytest.mark.parametrize("rows,H,low_delay", [
    (3, 31, False),        # odd H, one tile
    (2, 33, True),
    (2, 65, True),         # one hop into a second 64-hop tile
    (2, 130, False),       # three tiles, the last partial
    (4096, 64, False),     # the order-7 slice: 64 streams x 64 channels
])
def test_fft_front_dg_matches_plain_version(cuda, rows, H, low_delay):
    """The FFT-based front around its 64-hop tile and at its main path's
    rows (more tiles than the persistent grid has blocks)."""
    rng = np.random.default_rng(rows + H)
    tail = _u(rng, (rows, 15 * 128), cuda, amp=0.5)
    x = _u(rng, (rows, H * 128), cuda, amp=0.5)
    got = tak.analysis_front_dg_ri(tail, x, low_delay=low_delay)
    ref = tak.analysis_front_dg_ri_reference(tail, x, low_delay=low_delay)
    torch.cuda.synchronize()
    for k, r in zip(got, ref):
        assert (k - r).abs().max().item() <= TOL


@pytest.mark.parametrize("S,cin,cout,H,options", [
    (2, 1, 2, 31, {}),     # a cluster of one block
    (2, 3, 2, 33, {}),     # a cluster of three
    (2, 5, 2, 64, {}),     # cin the cluster of four does not divide
    (2, 16, 2, 64, {}),    # the flagship's width, four channels a block
    (1, 64, 2, 1, {}),     # cout * cin = 128, H = 1
    (2, 7, 1, 31, {}),     # one ear
    (1, 6, 3, 64, {"low_delay": True}),           # ear passes of 2 and 1
    (2, 5, 2, 33, {"per_stream": True}),
    (2, 5, 2, 31, {"hybrid": False}),
    (1, 127, 1, 4, {"hybrid": False, "low_delay": True}),
    (2, 4, 5, 33, {}),     # cout above 3: ear passes of 2, 2 and 1
    (2, 4, 5, 9, {"per_stream": True}),
    (2, 4, 11, 33, {}),    # six ear passes
    (1, 4, 11, 9, {"per_stream": True, "low_delay": True}),
])
def test_cluster_render_matches_plain_version(cuda, S, cin, cout, H,
                                              options):
    """The FFT-based one-pass render on its thread-block clusters: every
    cluster size, cin that the cluster size does not divide, each option;
    two chained calls carrying both tails."""
    rng = np.random.default_rng(S * cin + H)
    taps = _taps(rng, S, cin, cout, options.get("per_stream", False),
                 options.get("hybrid", True), cuda)
    kt = rt = _u(rng, (S, cin, 15 * 128), cuda)
    ko = ro = _u(rng, (S, cout, 9, 128), cuda)
    for _ in range(2):
        x = _u(rng, (S, cin, H * 128), cuda)
        ky, ko = tak.render_full_ri(kt, x, ko, taps, **options)
        ry, ro = tak.render_full_ri_reference(rt, x, ro, taps, **options)
        torch.cuda.synchronize()
        assert ky.shape == (S, cout, H * 128)
        assert (ky - ry).abs().max().item() <= TOL
        assert (ko - ro).abs().max().item() <= TOL
        kt = rt = torch.cat([kt, x], dim=-1)[..., H * 128:].contiguous()


def test_cluster_render_is_deterministic(cuda):
    """The cluster's blocks sum their spectra in rank order: two launches
    on the same inputs agree bit for bit."""
    rng = np.random.default_rng(5)
    taps = _taps(rng, 4, 16, 2, False, True, cuda)
    args = (_u(rng, (4, 16, 15 * 128), cuda), _u(rng, (4, 16, 64 * 128), cuda),
            _u(rng, (4, 2, 9, 128), cuda), taps)
    y1, t1 = tak.render_full_ri(*args)
    y2, t2 = tak.render_full_ri(*args)
    assert torch.equal(y1, y2) and torch.equal(t1, t2)


_RENDER_CASES = [  # S, cin, cout, H, low_delay, per_stream
    (3, 5, 2, 8, False, False),
    (2, 25, 2, 4, True, False),    # H < 9, low delay
    (2, 17, 3, 1, False, True),    # an ear pass of 2 and one of 1
    (1, 64, 2, 40, True, True),    # the order-7 width, partial hop tile
    (2, 17, 7, 9, False, False),   # the most ears the dispatch sends
    (1, 25, 5, 17, True, True),    # five ears, one hop into a second tile
    # S * cin odd at H = 1, 9, 130: rows of 129 floats that start off a
    # 16-byte boundary
    (3, 5, 2, 1, True, False),
    (1, 5, 3, 9, False, True),
    (1, 17, 2, 130, False, False),
    (40, 5, 2, 130, False, False), # 360 tiles: more than stay resident
]


@pytest.mark.parametrize("hybrid", [True, False])
@pytest.mark.parametrize("S,cin,cout,H,low_delay,per_stream", _RENDER_CASES)
def test_render_decode_synthesis_matches_plain_version(
        cuda, S, cin, cout, H, low_delay, per_stream, hybrid):
    """From the front's H+6-hop spectra, two chained calls carrying the
    overlap tail."""
    rng = np.random.default_rng(S * cin + H)
    taps = _taps(rng, S, cin, cout, per_stream, hybrid, cuda)
    kt = rt = _u(rng, (S, cout, 9, 128), cuda)
    for _ in range(2):
        sre, sim = (s.reshape(S, cin, H + 6, 129) for s in
                    tak.analysis_front_ri_reference(
                        _u(rng, (S * cin, 15 * 128), cuda, amp=0.5),
                        _u(rng, (S * cin, H * 128), cuda, amp=0.5)))
        sre, sim = sre.contiguous(), sim.contiguous()
        kw = dict(low_delay=low_delay, hybrid=hybrid, per_stream=per_stream)
        ky, kt = tak.render_decode_synthesis_ri(sre, sim, kt, taps, **kw)
        ry, rt = tak.render_decode_synthesis_ri_reference(sre, sim, rt, taps,
                                                          **kw)
        torch.cuda.synchronize()
        assert ky.shape == (S, cout, H * 128) and kt.shape == (S, cout, 9, 128)
        assert (ky - ry).abs().max().item() <= TOL
        assert (kt - rt).abs().max().item() <= TOL


@pytest.mark.parametrize("S,cin,cout,H,low_delay,per_stream", _RENDER_CASES)
def test_render_decode_synthesis_dg_matches_plain_version(
        cuda, S, cin, cout, H, low_delay, per_stream):
    """From the (d, g) pair, two chained calls carrying the overlap tail."""
    rng = np.random.default_rng(S * cin + H + 1)
    taps = _taps(rng, S, cin, cout, per_stream, True, cuda)
    kt = rt = _u(rng, (S, cout, 9, 128), cuda)
    for _ in range(2):
        dg = [t.reshape(S, cin, H, -1).contiguous() for t in
              tak.analysis_front_dg_ri_reference(
                  _u(rng, (S * cin, 15 * 128), cuda, amp=0.5),
                  _u(rng, (S * cin, H * 128), cuda, amp=0.5))]
        kw = dict(low_delay=low_delay, per_stream=per_stream)
        ky, kt = tak.render_decode_synthesis_dg_ri(*dg, kt, taps, **kw)
        ry, rt = tak.render_decode_synthesis_dg_ri_reference(*dg, rt, taps,
                                                             **kw)
        torch.cuda.synchronize()
        assert ky.shape == (S, cout, H * 128)
        assert (ky - ry).abs().max().item() <= TOL
        assert (kt - rt).abs().max().item() <= TOL


@pytest.mark.parametrize("form", ["dg", "hybrid", "plain"])
def test_render_decode_synthesis_is_deterministic(cuda, form):
    """Two launches on the same inputs agree bit for bit, at the order-7
    width and at an odd one."""
    for S, cin, cout, H in ((4, 64, 2, 64), (3, 17, 3, 9)):
        rng = np.random.default_rng(cin)
        taps = _taps(rng, S, cin, cout, False, form != "plain", cuda)
        front = (tak.analysis_front_dg_ri_reference if form == "dg"
                 else tak.analysis_front_ri_reference)
        spec = [t.reshape(S, cin, -1, t.shape[-1]).contiguous() for t in
                front(_u(rng, (S * cin, 15 * 128), cuda, amp=0.5),
                      _u(rng, (S * cin, H * 128), cuda, amp=0.5))]
        tail = _u(rng, (S, cout, 9, 128), cuda)
        if form == "dg":
            run = lambda: tak.render_decode_synthesis_dg_ri(  # noqa: E731
                *spec, tail, taps)
        else:
            run = lambda: tak.render_decode_synthesis_ri(  # noqa: E731
                *spec, tail, taps, hybrid=form == "hybrid")
        (y1, t1), (y2, t2) = run(), run()
        assert torch.equal(y1, y2) and torch.equal(t1, t2)


@pytest.mark.parametrize("hybrid", [True, False])
def test_two_pass_route_never_calls_plain_version(cuda, monkeypatch, hybrid):
    """cin = 25 > 16 at cout·cin = 50 takes the two-kernel route: the (d, g)
    pair for a hybrid bank, analysis_front_ri + render_decode_synthesis_ri
    otherwise, once per block each, never a plain version; the result
    matches the plain path."""
    from spatial_audio_framework_tpu_torch.ops import afstft_ri as tri
    from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT

    bank = AfSTFT(hybrid=hybrid)
    rng = np.random.default_rng(11)
    M = torch.from_numpy((0.8 * rng.uniform(-1, 1, (2, bank.n_bands, 2, 25))
                          ).astype(np.float32)).to(cuda)
    xs = [_u(rng, (2, 25, 5 * 128), cuda) for _ in range(2)]
    st = tri.init_state_batched(bank, 2, 25, 2, cuda)
    ys_plain = []
    for x in xs:
        y, st = tri.render_tf_matrix_ri(bank, st, x, M[0], M[1], fused=False)
        ys_plain.append(y)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    names = ("analysis_front_ri", "analysis_front_dg_ri",
             "render_decode_synthesis_ri", "render_decode_synthesis_dg_ri",
             "render_full_ri", "synthesis_back_ri")
    for name in names:
        monkeypatch.setattr(tak, f"{name}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in names}
    st = tri.init_state_batched(bank, 2, 25, 2, cuda)
    for x, yp in zip(xs, ys_plain):
        y, st = tri.render_tf_matrix_ri(bank, st, x, M[0], M[1])
        torch.cuda.synchronize()
        assert (y - yp).abs().max().item() <= TOL
    ran = {n: getattr(tak, n).launches - before[n] for n in names}
    pair = (("analysis_front_dg_ri", "render_decode_synthesis_dg_ri")
            if hybrid else ("analysis_front_ri", "render_decode_synthesis_ri"))
    assert ran == {n: 2 if n in pair else 0 for n in names}


def test_decode_kernels_raise_for_hop_other_than_128(cuda):
    z = lambda *shape: torch.zeros(shape, device=cuda)  # noqa: E731
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.analysis_front_dg_ri(z(2, 15 * 64), z(2, 4 * 64), hop=64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.render_decode_synthesis_ri(z(1, 2, 10, 65), z(1, 2, 10, 65),
                                       z(1, 2, 9, 64), z(2, 2, 4, 65))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.render_decode_synthesis_dg_ri(
            z(1, 2, 4, 65), z(1, 2, 4, 65), z(1, 2, 4, 16), z(1, 2, 4, 16),
            z(1, 2, 9, 64), z(2, 2, 4, 65))



def test_hop64_render_takes_the_plain_path(cuda):
    """At hop 64 render_tf_matrix_ri(fused=True) dispatches as the JAX
    package does: no kernel takes the hop, so it runs the plain path,
    launches nothing, raises nothing and equals fused=False."""
    from spatial_audio_framework_tpu_torch.ops import afstft_ri as tri
    from spatial_audio_framework_tpu_torch.ops.afstft import AfSTFT

    bank = AfSTFT(hop=64, hybrid=True)
    rng = np.random.default_rng(12)
    M = _u(rng, (2, 3, bank.n_bands, 2, 4), cuda)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    st_k = st_p = tri.init_state_batched(bank, 3, 4, 2, cuda)
    for _ in range(2):
        x = _u(rng, (3, 4, 6 * 64), cuda)
        yk, st_k = tri.render_tf_matrix_ri(bank, st_k, x, M[0], M[1])
        yp, st_p = tri.render_tf_matrix_ri(bank, st_p, x, M[0], M[1],
                                           fused=False)
        assert torch.equal(yk, yp) and torch.equal(st_k.ola_tail,
                                                   st_p.ola_tail)
    assert {n: getattr(tak, n).launches for n in tak.KERNELS} == before


@pytest.fixture(scope="module")
def binauraliser_weights():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from spatial_audio_framework_tpu_torch.models import binauraliser

    return binauraliser.design_ri(binauraliser.BinauraliserConfig(),
                                  device=torch.device("cuda"))


@pytest.mark.parametrize("n_src,pair", [
    (3, ("render_full_ri",)),                              # one pass
    (17, ("analysis_front_dg_ri", "render_decode_synthesis_dg_ri"))])
def test_binauraliser_routes_match_plain_path(cuda, binauraliser_weights,
                                              monkeypatch, n_src, pair):
    """Head-tracked sources with per-stream interpolated HRTFs: the taps
    from hrtf_taps_ri, then ≤ 16 sources take render_full_ri with
    per-stream taps, more the (d, g) pair, once per block each, never a
    plain version; the result matches the plain path."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    cfg = binauraliser.BinauraliserConfig(n_sources=n_src,
                                          enable_rotation=True)
    rng = np.random.default_rng(n_src)
    dirs = _u(rng, (2, n_src, 2), cuda) * torch.tensor([180.0, 90.0],
                                                      device=cuda)
    ypr = _u(rng, (2, 3), cuda)
    xs = [_u(rng, (2, n_src, h * 128), cuda) for h in (4, 9)]

    def run(fused):
        st, ys = binauraliser.init_state_batched(cfg, 2, cuda), []
        for x in xs:
            y, st = binauraliser.process_ri_batched(
                cfg, binauraliser_weights, st, x, dirs, None, ypr,
                fused=fused)
            ys.append(y)
        return ys, st

    ys_p, st_p = run(False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for name in tak.KERNELS:
        monkeypatch.setattr(tak, f"{name}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    ys_k, st_k = run(True)
    torch.cuda.synchronize()
    for yk, yp in zip(ys_k, ys_p):
        assert (yk - yp).abs().max().item() <= TOL
    assert (st_k.ola_tail - st_p.ola_tail).abs().max().item() <= TOL
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 if n in pair + ("hrtf_taps_ri",) else 0
                   for n in tak.KERNELS}


# -- hrtf_taps_ri: the binauraliser's taps from its directions --------------

# (azimuth, elevation): the poles, the ±180° seam, exact half-step rows and
# columns, azimuths outside [-180, 180]; then NaN, infinite, past-the-table
# and negative-row directions (tests/test_torch_hrtf_taps.py)
_TAP_EDGE_DIRS = [
    [180.0, 90.0], [-180.0, -90.0], [179.9, 0.0], [-179.9, 0.0],
    [-179.0, -87.5], [1.0, 2.5], [0.0, 89.9], [-541.0, -45.0],
    [720.5, 12.5], [30.0, 0.0]]
_TAP_BAD_DIRS = [
    [10.0, 95.0], [10.0, -100.0], [float("nan"), 10.0],
    [10.0, float("nan")], [10.0, 1e9], [float("inf"), 3.0],
    [float("-inf"), 3.0], [10.0, float("-inf")]]


def _taps_weights(rng, n_dirs, n_table, device):
    """Random binauraliser weights over an HRTF grid of ``n_dirs``
    directions and a VBAP table of ``n_table`` rows."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    return binauraliser.weights_from_numpy(
        rng.standard_normal((133, 2, n_dirs)),
        rng.standard_normal((133, 2, n_dirs)),
        rng.uniform(0, 1, (133, 2, n_dirs)),
        rng.uniform(-1e-3, 1e-3, n_dirs), rng.dirichlet(np.ones(3), n_table),
        rng.integers(0, n_dirs, (n_table, 3)), np.linspace(0, 24e3, 133),
        device)


def _on_cpu(w):
    return type(w)(*(t.cpu() for t in w))


def _near_a_row_boundary(cfg, dirs, ypr, margin=1e-4):
    """(S, nSrc): the plain version's table coordinates after rotation lie
    within ``margin`` of a step's rounding boundary, where another
    rounding of sin / atan2 may pick the next row."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    d = binauraliser.rotate_dirs(dirs, ypr)
    a = torch.remainder(d[..., 0] + 180.0, 360.0) / cfg.azi_res + 0.5
    e = (d[..., 1] + 90.0) / cfg.elev_res + 0.5
    return ((a - a.round()).abs() < margin) | ((e - e.round()).abs() < margin)


@pytest.mark.parametrize("S,n_src,mode,rotation,grid", [
    (1, 1, "tri", False, "default"),
    (3, 17, "tri_ps", True, "default"),
    (64, 64, "tri", True, "default"),
    (1024, 64, "tri", True, "default"),        # the track1024 cell's block
    (1024, 64, "tri_ps", False, "default"),
    (7, 5, "tri", True, "sofa"),               # another grid and table
    (33, 16, "tri_ps", True, "sofa"),
])
def test_hrtf_taps_kernel_matches_plain_version(cuda, binauraliser_weights,
                                                S, n_src, mode, rotation,
                                                grid):
    """The kernel vs its plain version (run on the CPU, the JAX package's
    arithmetic), within 1e-6 of the largest tap.  After a rotation a
    source within 1e-4 of a table step's rounding boundary (about 20
    roundings of sin / atan2) may take the next row on either side, and is
    not held: at most 2 sources or 0.5 % of them."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    rng = np.random.default_rng(S + n_src)
    res = {"default": (2, 5), "sofa": (3, 4)}[grid]
    cfg = binauraliser.BinauraliserConfig(
        n_sources=n_src, interp_mode=mode, enable_rotation=rotation,
        azi_res=res[0], elev_res=res[1])
    if grid == "default":
        w = binauraliser_weights
    else:      # 2,300 directions, as dense a SOFA set as the repo's tests use
        n_table = (int(360 / res[0] + 0.5) + 1) * (int(180 / res[1] + 0.5)
                                                   + 1)
        w = _taps_weights(rng, 2300, n_table, cuda)
    dirs = _u(rng, (S, n_src, 2), "cpu") * torch.tensor([180.0, 90.0])
    dirs[0, :min(n_src, len(_TAP_EDGE_DIRS))] = torch.tensor(
        _TAP_EDGE_DIRS[:n_src])
    ypr = _u(rng, (S, 3), "cpu") * np.pi
    got = tak.hrtf_taps_ri(cfg, w, dirs.to(cuda), ypr.to(cuda))
    ref = tak.hrtf_taps_ri(cfg, _on_cpu(w), dirs, ypr)
    got = got.cpu()
    assert got.shape == ref.shape == (S, n_src, 2, 4, 129)
    keep = torch.ones((S, n_src), dtype=torch.bool)
    if rotation:
        keep = ~_near_a_row_boundary(cfg, dirs, ypr)
        assert (~keep).sum().item() <= max(2, 0.005 * keep.numel())
    assert bool(torch.isfinite(got[keep]).all())
    err = (got[keep] - ref[keep]).abs().max().item()
    assert err <= 1e-6 * ref[keep].abs().max().item()


@pytest.mark.parametrize("mode", ["tri", "tri_ps"])
def test_hrtf_taps_bad_directions_on_card(cuda, binauraliser_weights, mode):
    """NaN, infinite, past-the-table and negative-row directions (and a NaN
    head pose) neither assert on the card nor synchronise the host, and
    give the plain version's taps: NaN exactly where it gives NaN."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    bad = torch.tensor([_TAP_BAD_DIRS + _TAP_EDGE_DIRS[:2]] * 2)
    n = bad.shape[1]
    ypr = torch.tensor([[0.3, -0.2, 0.1], [float("nan"), 0.2, -0.1]])
    for rotation in (False, True):
        cfg = binauraliser.BinauraliserConfig(
            n_sources=n, interp_mode=mode, enable_rotation=rotation)
        bad_c, ypr_c = bad.to(cuda), ypr.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = tak.hrtf_taps_ri(cfg, binauraliser_weights, bad_c, ypr_c)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got = got.cpu()
        ref = tak.hrtf_taps_ri(cfg, _on_cpu(binauraliser_weights), bad, ypr)
        assert torch.equal(got.isnan(), ref.isnan())
        assert (got - ref).nan_to_num().abs().max().item() <= 1e-6 * (
            ref.nan_to_num().abs().max().item())
        if rotation:     # the NaN pose: every source of stream 1 at row 0
            assert bool(torch.isfinite(got[1]).all())


@pytest.mark.parametrize("n_src", [3, 64])
def test_head_tracked_binauraliser_block_never_waits(cuda,
                                                     binauraliser_weights,
                                                     monkeypatch, n_src):
    """Once warm, a binauraliser block with new directions and a new pose
    on the card makes no tensor from host data and no host
    synchronisation, and launches hrtf_taps_ri once."""
    from spatial_audio_framework_tpu_torch.models import binauraliser

    cfg = binauraliser.BinauraliserConfig(n_sources=n_src,
                                          enable_rotation=True)
    rng = np.random.default_rng(n_src)
    dirs = [_u(rng, (4, n_src, 2), cuda) * 90.0 for _ in range(3)]
    yprs = [_u(rng, (4, 3), cuda) for _ in range(3)]
    xs = [_u(rng, (4, n_src, 512), cuda) for _ in range(3)]
    st = binauraliser.init_state_batched(cfg, 4, cuda)
    y, st = binauraliser.process_ri_batched(cfg, binauraliser_weights, st,
                                            xs[0], dirs[0], None, yprs[0])

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made from host data per block")

    before = tak.hrtf_taps_ri.launches
    torch.cuda.synchronize()
    with monkeypatch.context() as m:
        for name in ("from_numpy", "tensor", "as_tensor"):
            m.setattr(torch, name, refuse)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in (1, 2):
                y, st = binauraliser.process_ri_batched(
                    cfg, binauraliser_weights, st, xs[i], dirs[i], None,
                    yprs[i])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert tak.hrtf_taps_ri.launches == before + 2
    assert bool(torch.isfinite(y).all())


# -- panner, binauraliser_nf and roombinauraliser on the card ---------------

def _hrir_subset():
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    return h[::8], d[::8], fs


def _new_model_case(model, n_src, cuda, rng):
    """(process(state, x, fused), init_state, n_out) of a new model at a
    small size: 2 streams, coarse tables, designs from every 8th direction
    of the default HRIR set (one rolled set per source for the BRIRs)."""
    from spatial_audio_framework_tpu_torch.models import (binauraliser_nf,
                                                          panner,
                                                          roombinauraliser)

    dirs = _u(rng, (2, n_src, 2), cuda) * torch.tensor([180.0, 90.0],
                                                      device=cuda)
    ypr = _u(rng, (2, 3), cuda)
    if model.startswith("panner"):
        ls = np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0]]
                      + ([[45, 45], [-45, 45], [135, 45], [-135, 45]]
                         if model == "panner 3-D" else []), np.float64)
        cfg = panner.PannerConfig(n_sources=n_src, n_loudspeakers=len(ls),
                                  azi_res=5, elev_res=5)
        w = panner.design(cfg, ls, device=cuda)
        return (lambda st, x, fused: panner.process_ri_batched(
                    cfg, w, st, x, dirs, ypr, fused=fused),
                lambda: panner.init_state_batched(cfg, 2, len(ls), cuda),
                len(ls))
    h, d, fs = _hrir_subset()
    if model == "binauraliser_nf":
        cfg = binauraliser_nf.BinauraliserNFConfig(n_sources=n_src,
                                                   enable_rotation=True)
        w = binauraliser_nf.design_ri(cfg, h, d, fs, device=cuda)
        dists = (_u(rng, (2, n_src), cuda) + 1.0) * 2.0 + 0.05   # 0.05-4.05 m
        return (lambda st, x, fused: binauraliser_nf.process_ri_batched(
                    cfg, w, st, x, dirs, dists, None, ypr, fused=fused),
                lambda: binauraliser_nf.init_state_batched(cfg, 2, cuda), 2)
    cfg = roombinauraliser.RoomBinauraliserConfig(n_sources=n_src)
    sets = np.stack([np.roll(h, 3 * s, 0) for s in range(n_src)])
    cfg, w = roombinauraliser.design_ri(cfg, sets, d, fs, device=cuda)
    gains = _u(rng, (2, n_src), cuda) + 1.5
    return (lambda st, x, fused: roombinauraliser.process_ri_batched(
                cfg, w, st, x, gains, ypr, fused=fused),
            lambda: roombinauraliser.init_state_batched(cfg, 2, cuda), 2)


@pytest.mark.parametrize("model,n_src,pair", [
    ("panner 2-D", 4, ("render_full_ri",)),            # cout 5
    ("panner 3-D", 4, ("render_full_ri",)),            # cout 9
    ("binauraliser_nf", 3, ("render_full_ri",)),
    ("binauraliser_nf", 17, ("analysis_front_dg_ri",
                             "render_decode_synthesis_dg_ri")),
    ("roombinauraliser", 3, ("render_full_ri",)),
    ("roombinauraliser", 17, ("analysis_front_dg_ri",
                              "render_decode_synthesis_dg_ri"))])
def test_new_model_routes_match_plain_path(cuda, monkeypatch, model, n_src,
                                           pair):
    """Each new model's kernel route against ``fused=False`` on the card:
    ≤ 16 sources take render_full_ri with per-stream taps, more the (d, g)
    pair, once per block each, never a plain version."""
    rng = np.random.default_rng(n_src)
    process, init_state, n_out = _new_model_case(model, n_src, cuda, rng)
    xs = [_u(rng, (2, n_src, h * 128), cuda) for h in (4, 9)]

    def run(fused):
        st, ys = init_state(), []
        for x in xs:
            y, st = process(st, x, fused)
            ys.append(y)
        return ys, st

    ys_p, st_p = run(False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for name in tak.KERNELS:
        monkeypatch.setattr(tak, f"{name}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    ys_k, st_k = run(True)
    torch.cuda.synchronize()
    for yk, yp in zip(ys_k, ys_p):
        assert yk.shape == (2, n_out, yk.shape[-1])
        assert bool(torch.isfinite(yk).all())
        assert (yk - yp).abs().max().item() <= TOL
    assert (st_k.ola_tail - st_p.ola_tail).abs().max().item() <= TOL
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 if n in pair else 0 for n in tak.KERNELS}


def test_binauraliser_nf_warm_chunk_builds_nothing_from_host_data(
        cuda, monkeypatch):
    """After one warm chunk (the afSTFT constants and the DVF table are
    then cached on the card), a binauraliser_nf chunk makes no tensor from
    host data and never synchronises the host."""
    rng = np.random.default_rng(3)
    process, init_state, _ = _new_model_case("binauraliser_nf", 3, cuda, rng)
    x = _u(rng, (2, 3, 8 * 128), cuda)
    y_warm, st = process(init_state(), x, True)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made from host data per chunk")

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, refuse)
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = process(st, x, True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and y.shape == y_warm.shape


def test_new_models_bad_directions_on_card(cuda):
    """panner and roombinauraliser at NaN, infinite and out-of-table
    directions: no device-side assert, no host synchronisation, and the
    CPU's result (NaN where the table ends)."""
    from spatial_audio_framework_tpu_torch.models import (panner,
                                                          roombinauraliser)

    bad = torch.tensor([[10.0, 95.0], [10.0, -100.0], [float("nan"), 10.0],
                        [10.0, float("nan")], [10.0, 1e9],
                        [float("inf"), 3.0], [10.0, float("-inf")],
                        [30.0, 0.0]])
    ls = np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0],
                   [45, 45], [-45, 45], [135, 45], [-135, 45]], np.float64)
    pcfg = panner.PannerConfig(n_sources=len(bad), n_loudspeakers=9,
                               azi_res=5, elev_res=5)
    pw = panner.design(pcfg, ls, device="cpu")
    h, d, fs = _hrir_subset()
    rcfg, rw = roombinauraliser.design_ri(
        roombinauraliser.RoomBinauraliserConfig(n_sources=2),
        np.stack([h, np.roll(h, 5, 0)]), d, fs, device="cpu")
    pw_c = type(pw)(*(t.to(cuda) for t in pw))
    rw_c = type(rw)(*(t.to(cuda) for t in rw))
    bad_c = bad.to(cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        g = panner._table_lookup(pcfg, pw_c.gtable, bad_c)
        H = roombinauraliser.interp_hrtfs_ri(rcfg, rw_c, bad_c)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    g_ref = panner._table_lookup(pcfg, pw.gtable, bad)
    H_ref = roombinauraliser.interp_hrtfs_ri(rcfg, rw, bad)
    for got, ref in ((g, g_ref), (H[0], H_ref[0]), (H[1], H_ref[1])):
        got = got.cpu()
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert bool(torch.isnan(ref[[0, 4, 6]]).all())
        assert bool(torch.isfinite(ref[[1, 2, 3, 5, 7]]).all())
        assert (got - ref).nan_to_num().abs().max().item() <= 1e-6


# -- array2sh, ambi_dec's binaural preview and the head-tracked listener ------

@pytest.mark.parametrize("rows,H", [(16 * 32, 64), (16 * 32, 1), (33, 9)])
def test_analysis_front_at_the_array2sh_rows(cuda, rows, H):
    """analysis_front_ri over 16 recordings x 32 sensors (512 rows)."""
    rng = np.random.default_rng(rows + H)
    tail = _u(rng, (rows, 15 * 128), cuda) * 0.5
    x = _u(rng, (rows, H * 128), cuda) * 0.5
    for k, p in zip(tak.analysis_front_ri(tail, x),
                    tak.analysis_front_ri_reference(tail, x)):
        assert k.shape == (rows, H + 6, 129)
        assert (k - p).abs().max().item() <= TOL


@pytest.mark.parametrize("rows,H", [(16 * 25, 64), (16 * 25, 1), (25, 9)])
def test_synthesis_back_at_the_array2sh_rows(cuda, rows, H):
    """synthesis_back_ri over 16 recordings x 25 SH channels (400 rows)."""
    rng = np.random.default_rng(rows + H)
    spec = _u(rng, (rows, H, 266), cuda) * 10.0
    tail = _u(rng, (rows, 9, 128), cuda)
    for k, p in zip(tak.synthesis_back_ri(spec, tail),
                    tak.synthesis_back_ri_reference(spec, tail)):
        assert (k - p).abs().max().item() <= TOL


def test_array2sh_route_matches_plain_path(cuda, monkeypatch):
    """Eigenmike32 → order 4, 3 streams (800 channel pairs, the wide
    route): the front, the mix and the back once a chunk, never a plain
    version, equal to ``fused=False``."""
    from spatial_audio_framework_tpu_torch.models import array2sh

    cfg = array2sh.Array2SHConfig(order=4)
    w = array2sh.design_ri(
        cfg, np.degrees(presets.mic_preset("eigenmike32")), device=cuda)
    rng = np.random.default_rng(2)
    xs = [_u(rng, (3, 32, h * 128), cuda) for h in (9, 4)]

    def run(fused):
        st, ys = array2sh.init_state_batched(cfg, 3, 32, cuda), []
        for x in xs:
            y, st = array2sh.process_ri_batched(cfg, w, st, x, fused=fused)
            ys.append(y)
        return ys, st

    ys_p, st_p = run(False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for name in tak.KERNELS:
        monkeypatch.setattr(tak, f"{name}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    ys_k, st_k = run(True)
    torch.cuda.synchronize()
    for yk, yp in zip(ys_k, ys_p):
        assert yk.shape == (3, 25, yk.shape[-1])
        assert (yk - yp).abs().max().item() <= TOL * max(
            1.0, yp.abs().max().item())
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 * (n in _WIDE_ROUTE) for n in tak.KERNELS}


def test_ambi_dec_binaural_preview_takes_the_one_pass_kernel(cuda):
    """binauralise_ls: a complex 16 → 2 decode from ambi_dec, one
    render_full_ri launch a chunk, equal to ``fused=False``."""
    h, d, fs = _hrir_subset()
    cfg = ambi_dec.AmbiDecConfig(master_order=3, binauralise_ls=True)
    ls = presets.loudspeaker_preset("22.x")
    w = ambi_dec.design_ri(cfg, ls, None, h, d, fs, device=cuda)
    assert w.M_im is not None and w.M_re.shape == (133, 2, 16)
    rng = np.random.default_rng(4)
    x = _u(rng, (2, 16, 9 * 128), cuda)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    yk, _ = ambi_dec.process_ri_batched(
        cfg, w, ambi_dec.init_state_batched(cfg, 2, 22, cuda), x)
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    yp, _ = ambi_dec.process_ri_batched(
        cfg, w, ambi_dec.init_state_batched(cfg, 2, 22, cuda), x,
        fused=False)
    assert ran == {n: int(n == "render_full_ri") for n in tak.KERNELS}
    assert yk.shape == (2, 2, 9 * 128)
    assert (yk - yp).abs().max().item() <= TOL


@pytest.mark.parametrize("entry", ["process_ri", "process"])
@pytest.mark.parametrize("order", [1, 3, 7])
def test_head_tracked_block_never_waits_for_the_device(cuda, monkeypatch,
                                                       entry, order):
    """Once warm, a block of the single-stream ambi_bin with a new ``ypr``
    on the card builds its SH rotation there: no tensor from host data, no
    host synchronisation, none of the six kernels, and the CPU's output."""
    cfg = ambi_bin.AmbiBinConfig(order=order, enable_rotation=True,
                                 ch_ordering="fuma" if order == 1 else "acn",
                                 norm="fuma" if order == 1 else "sn3d")
    rng = np.random.default_rng(order)
    M = rng.standard_normal((2, 133, 2, cfg.nsh)).astype(np.float32)
    xs = rng.uniform(-1, 1, (3, cfg.nsh, 256)).astype(np.float32)
    yprs = rng.uniform(-np.pi, np.pi, (3, 3)).astype(np.float32)

    def run(device, guard):
        if entry == "process_ri":
            w = ambi_bin.weights_from_numpy(M[0], M[1], device)
            st = ambi_bin.init_state_ri(cfg, device=device)
        else:
            w = ambi_bin.weights_complex_from_numpy(M[0], M[1], device)
            st = ambi_bin.init_state(cfg, device=device)
        x_d = torch.from_numpy(xs).to(device)
        ypr_d = torch.from_numpy(yprs).to(device)
        proc, ys = getattr(ambi_bin, entry), []
        y, st = proc(cfg, w, st, x_d[0], ypr_d[0])
        ys.append(y)
        with guard():
            for i in (1, 2):
                y, st = proc(cfg, w, st, x_d[i], ypr_d[i])
                ys.append(y)
        return torch.cat(ys, dim=-1).cpu()

    import contextlib

    @contextlib.contextmanager
    def no_host_data():
        def refuse(*args, **kwargs):
            raise AssertionError("a tensor was made from host data per block")

        torch.cuda.synchronize()
        with monkeypatch.context() as m:
            for name in ("from_numpy", "tensor", "as_tensor"):
                m.setattr(torch, name, refuse)
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")

    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    got = run(cuda, no_host_data)
    assert {n: getattr(tak, n).launches for n in tak.KERNELS} == before
    ref = run("cpu", contextlib.nullcontext)
    assert bool(torch.isfinite(got).all())
    assert (got - ref).abs().max().item() <= TOL * max(
        1.0, ref.abs().max().item())


def test_single_stream_lookups_bad_directions_on_card(cuda):
    """The complex interp_hrtfs of binauraliser (TRI and TRI_PS) and
    roombinauraliser, and the single-stream panner gains, at NaN, infinite
    and out-of-table directions: no device-side assert, no host
    synchronisation, and the CPU's result (NaN where the table ends)."""
    from spatial_audio_framework_tpu_torch.models import (binauraliser,
                                                          panner,
                                                          roombinauraliser)

    bad = torch.tensor([[10.0, 95.0], [10.0, -100.0], [float("nan"), 10.0],
                        [10.0, float("nan")], [10.0, 1e9],
                        [float("inf"), 3.0], [10.0, float("-inf")],
                        [180.0, 0.0], [-180.0, 0.0], [30.0, 0.0]])
    h, d, fs = _hrir_subset()
    cases = []
    for mode in (binauraliser.INTERP_TRI, binauraliser.INTERP_TRI_PS):
        cfg = binauraliser.BinauraliserConfig(n_sources=len(bad),
                                              interp_mode=mode, azi_res=10,
                                              elev_res=15)
        w = binauraliser.design(cfg, h, d, fs, device="cpu")
        cases.append((lambda w, x, cfg=cfg: torch.view_as_real(
            binauraliser.interp_hrtfs(cfg, w, x)), w, bad))
    rcfg, rw = roombinauraliser.design(
        roombinauraliser.RoomBinauraliserConfig(n_sources=2),
        np.stack([h, np.roll(h, 5, 0)]), d, fs, device="cpu")
    for row in bad:
        cases.append((lambda w, x: torch.view_as_real(
            roombinauraliser.interp_hrtfs(rcfg, w, x)), rw, row))
    ls = np.array([[30, 0], [-30, 0], [0, 0], [110, 0], [-110, 0],
                   [45, 45], [-45, 45], [135, 45], [-135, 45]], np.float64)
    pcfg = panner.PannerConfig(n_sources=len(bad), n_loudspeakers=9,
                               azi_res=5, elev_res=5)
    pw = panner.design(pcfg, ls, device="cpu")
    cases.append((lambda w, x: panner._band_gains(pcfg, w, x, None), pw, bad))
    saw_nan = saw_finite = False
    for fn, w, x in cases:
        w_c = type(w)(*(t.to(cuda) for t in w))
        x_c = x.to(cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(w_c, x_c)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        got, ref = got.cpu(), fn(w, x)
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert (got - ref).nan_to_num().abs().max().item() <= 1e-5
        saw_nan |= bool(torch.isnan(ref).any())
        saw_finite |= bool(torch.isfinite(ref).any())
    assert saw_nan and saw_finite


# -- the analysers and the decorrelator --------------------------------------

@pytest.mark.parametrize("rows,H", [(16 * 4, 64), (16 * 4, 1), (64 * 16, 64)])
def test_analysis_front_at_the_analyser_rows(cuda, rows, H):
    """analysis_front_ri over the decorrelator's 16 streams x 4 channels
    (64 rows, under one wave of the card) and ambi_drc's 64 x 16."""
    rng = np.random.default_rng(rows + H)
    tail = _u(rng, (rows, 15 * 128), cuda) * 0.5
    x = _u(rng, (rows, H * 128), cuda) * 0.5
    for k, p in zip(tak.analysis_front_ri(tail, x),
                    tak.analysis_front_ri_reference(tail, x)):
        assert k.shape == (rows, H + 6, 129)
        assert (k - p).abs().max().item() <= TOL


@pytest.mark.parametrize("rows,H", [(16 * 4, 64), (16 * 4, 1), (64 * 16, 64)])
def test_synthesis_back_at_the_analyser_rows(cuda, rows, H):
    """synthesis_back_ri over 64 one-row blocks (the decorrelator) and
    1024 rows (ambi_drc)."""
    rng = np.random.default_rng(rows + H)
    spec = _u(rng, (rows, H, 266), cuda) * 10.0
    tail = _u(rng, (rows, 9, 128), cuda)
    for k, p in zip(tak.synthesis_back_ri(spec, tail),
                    tak.synthesis_back_ri_reference(spec, tail)):
        assert (k - p).abs().max().item() <= TOL


def _analyser_case(name, cuda):
    """(process(st, x, fused) -> (out tensors, st), init_state(), x shape,
    kernels a chunk) of one batched analyser or decorrelator path at a
    small width."""
    from spatial_audio_framework_tpu_torch.models import (ambi_drc,
                                                          decorrelator,
                                                          powermap, sldoa)

    if name == "decorrelator":
        cfg = decorrelator.DecorrelatorConfig(n_channels=4)
        w = decorrelator.design(cfg, c_rand_offset=0, device=cuda)
        return ((lambda st, x, f: _flat(*decorrelator.process_ri_batched(
                    cfg, w, st, x, fused=f))),
                lambda: decorrelator.init_state_batched(cfg, w, 3, cuda),
                (3, 4), ("analysis_front_ri", "synthesis_back_ri"))
    if name == "ambi_drc":
        cfg = ambi_drc.AmbiDrcConfig(order=3, theshold_db=-20.0)
        return ((lambda st, x, f: _flat(*ambi_drc.process_ri_batched(
                    cfg, st, x, fused=f))),
                lambda: ambi_drc.init_state_batched(cfg, 3, cuda),
                (3, 16), ("analysis_front_ri", "synthesis_back_ri"))
    if name == "powermap":
        cfg = powermap.PowermapConfig(master_order=3, mode="music",
                                      norm="n3d", n_sources=2,
                                      analysis_grid="tdesign")
        w = powermap.design(cfg, device=cuda)
        return ((lambda st, x, f: _flat(*powermap.analysis_batched(
                    cfg, w, st, x, fused=f))),
                lambda: powermap.init_state_batched(cfg, w, 3, cuda),
                (3, 16), ("analysis_front_ri",))
    cfg = sldoa.SldoaConfig(master_order=3, norm="n3d", fit_grid_level=6)
    w = sldoa.design(cfg, device=cuda)
    return ((lambda st, x, f: _flat(*sldoa.analysis_batched(
                cfg, w, st, x, fused=f))),
            lambda: sldoa.init_state_batched(cfg, 3, cuda),
            (3, 16), ("analysis_front_ri",))


def _flat(out, st):
    """Every tensor of an output and a state, in order, and the state."""
    def leaves(o):
        if isinstance(o, torch.Tensor):
            return [o]
        return [t for v in o for t in leaves(v)] if isinstance(
            o, tuple) else []
    return leaves(out) + leaves(st), st


@pytest.mark.parametrize("name", ["decorrelator", "ambi_drc", "powermap",
                                  "sldoa"])
def test_analyser_route_matches_plain_path(cuda, monkeypatch, name):
    """Each batched path over chunks of 9 and 4 hops: its kernels once a
    chunk, never a plain version, and ``fused=False``'s outputs and
    states (angles as unit vectors: an azimuth jumps by 2π across ±180°)."""
    process, init_state, lead, kernels = _analyser_case(name, cuda)
    rng = np.random.default_rng(5)
    xs = [_u(rng, lead + (h * 128,), cuda) for h in (9, 4)]

    def run(fused):
        st, outs = init_state(), []
        for x in xs:
            leaves, st = process(st, x, fused)
            outs += leaves
        return outs

    plain = run(False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for k in tak.KERNELS:
        monkeypatch.setattr(tak, f"{k}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    fused = run(True)
    torch.cuda.synchronize()
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 * (n in kernels) for n in tak.KERNELS}
    for k, p in zip(fused, plain):
        assert k.shape == p.shape and bool(torch.isfinite(k).all())
        if name == "sldoa" and k.shape[-1:] == (2,) and k.ndim == 5:
            k, p = _unit(k), _unit(p)
            assert (k - p).abs().max().item() <= 2e-3
            continue
        scale = max(1.0, p.abs().max().item())
        assert (k - p).abs().max().item() <= 1e-4 * scale


def _unit(azi_elev):
    a, e = azi_elev[..., 0], azi_elev[..., 1]
    return torch.stack([e.cos() * a.cos(), e.cos() * a.sin(), e.sin()], -1)


@pytest.mark.parametrize("name", ["decorrelator", "ambi_drc", "sldoa"])
def test_analyser_chunk_loop_never_waits_for_the_device(cuda, monkeypatch,
                                                        name):
    """Once warm, a chunk makes no tensor from host data and never makes
    the host wait for the card (the lattice's block matrices, the delay
    starts and the smoother constants are device tensors made once)."""
    process, init_state, lead, _ = _analyser_case(name, cuda)
    rng = np.random.default_rng(6)
    xs = [_u(rng, lead + (8 * 128,), cuda) for _ in range(3)]
    st = init_state()
    _, st = process(st, xs[0], True)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made from host data per chunk")

    with monkeypatch.context() as m:
        for fn in ("from_numpy", "tensor", "as_tensor"):
            m.setattr(torch, fn, refuse)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for x in xs[1:]:
                _, st = process(st, x, True)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


def test_powermap_silent_scene_gives_a_zero_map_on_card(cuda):
    """The trace guard on the card: no energy, a zero map and state (the
    eigh of a zero covariance is still taken, and masked)."""
    from spatial_audio_framework_tpu_torch.models import powermap

    cfg = powermap.PowermapConfig(master_order=3, mode="music", norm="n3d",
                                  analysis_grid="tdesign")
    w = powermap.design(cfg, device=cuda)
    st = powermap.init_state_batched(cfg, w, 2, cuda)
    xs = torch.zeros((3, 2, 16, 4 * 128), device=cuda)
    p, st = powermap.analysis_chunks(cfg, w, st, xs)
    assert p.shape == (3, 2, w.interp_table.shape[0])
    assert p.abs().max().item() == 0.0 and st.prev_pmap.abs().max().item() == 0


@pytest.mark.parametrize("mode", ["off", "upscale", "nearest"])
def test_dirass_on_card_matches_the_cpu(cuda, mode):
    """dirass launches none of the six kernels; its maps and states on the
    card equal the CPU's to 1e-4: float32 sums in another order (5.5e-6
    seen on the [0, 1] maps; the 100 Hz high-pass's scan composes its
    pole-matrix powers in float64 on the host, so it does not amplify
    rounding).  The nearest mode's map is not held: a sector whose
    direction moves can land in the next display cell; its state
    (energies, intensities) is."""
    from spatial_audio_framework_tpu_torch.models import dirass

    cfg = dirass.DirassConfig(input_order=2, upscale_order=6, mode=mode,
                              grid_tdesign=18, norm="n3d")
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((3, 9, 8192)).astype(np.float32)

    def run(device):
        w = dirass.design(cfg, device=device)
        st, out = dirass.init_state(cfg, w, device=device), []
        for x in xs:
            p, st = dirass.analysis(cfg, w, st, torch.from_numpy(x).to(device))
            out.append(p.cpu())
        return torch.stack(out), [t.cpu() for t in st[2:]]

    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    got, got_st = run(cuda)
    assert {n: getattr(tak, n).launches for n in tak.KERNELS} == before
    ref, ref_st = run("cpu")
    assert bool(torch.isfinite(got).all())
    if mode != "nearest":
        assert (got - ref).abs().max().item() <= 1e-4
    for a, b in zip(got_st, ref_st):
        assert (a - b).abs().max().item() <= 1e-4 * max(
            b.abs().max().item(), 1e-30)


# -- convolution, room simulation, HADES and the spreader --------------------

@pytest.mark.parametrize("rows,H", [(64, 32), (32, 32), (4, 4)])
def test_front_back_at_the_hades_spreader_rows(cuda, rows, H):
    """analysis_front_ri at HADES x 32 (64 rows: 32 instances x 2 mics) and
    the spreader x 32 (32 rows), 32 hops a call; synthesis_back_ri at 64
    rows (32 instances x 2 ears) for both."""
    rng = np.random.default_rng(rows + H)
    tail = _u(rng, (rows, 15 * 128), cuda) * 0.5
    x = _u(rng, (rows, H * 128), cuda) * 0.5
    for k, p in zip(tak.analysis_front_ri(tail, x),
                    tak.analysis_front_ri_reference(tail, x)):
        assert k.shape == (rows, H + 6, 129)
        assert (k - p).abs().max().item() <= TOL
    spec = _u(rng, (rows, H, 266), cuda) * 10.0
    otail = _u(rng, (rows, 9, 128), cuda)
    for k, p in zip(tak.synthesis_back_ri(spec, otail),
                    tak.synthesis_back_ri_reference(spec, otail)):
        assert (k - p).abs().max().item() <= TOL


# the spreader's output (its solve / CDF4SAP chain), kernel path vs plain:
# the C's own output moves 5.3e-4 for a one-ulp input change
# (tests/test_c_goldens.py), and two plain orders of the same front differ
# by 6.7e-5 on the CPU (scripts/chain_precision.py).  HADES's output is not
# held: its DoA is an argmin over the grid whose near ties flip with
# rounding (4.3e-3 between two plain orders, one band of one block); the
# covariances the front feeds agree to TOL on both.
CHAIN_TOL = 5e-4


def _batched_case(name, cuda):
    """(process(st, x, fused) -> (y, st), init_state(), x shape,
    held(st) -> [(state leaf, tol)], the output's tol or None) of HADES or
    the spreader, 3 instances."""
    from spatial_audio_framework_tpu_torch.modules import hrir

    h, d, fs = hrir.default_hrirs()
    if name == "hades":
        from spatial_audio_framework_tpu_torch.modules import hades

        ana = hades.HadesAnalysis(h_array=h[::16], grid_dirs_deg=d[::16],
                                  blocksize=512, device=cuda)
        pipe = hades.HadesPipeline(ana, hades.HadesSynthesis(
            ana, beam_option="bmvdr"))
        return (lambda st, x, f: pipe.process_chunk_batched(st, x, fused=f),
                lambda: pipe.init_state_batched(3), (3, 4, 2, 512),
                lambda st: [(c, TOL) for c in st[1]], None)
    from spatial_audio_framework_tpu_torch.models import spreader

    cfg = spreader.SpreaderConfig(mode="om")
    w = spreader.design(cfg, h[::8], d[::8], fs, device=cuda)
    dirs = torch.tensor([[40.0, 10.0]], device=cuda)
    spread = torch.tensor([60.0], device=cuda)
    # the covariance averages; OM's mixing matrices are free on the rank-one
    # prototype's null space, so only what they produce is held
    return (lambda st, x, f: spreader.process_chunk(cfg, w, st, x, dirs,
                                                    spread, fused=f),
            lambda: spreader.init_state(cfg, w, n_instances=3, device=cuda),
            (3, 4, 1, 512), lambda st: [(st.bank.ola_tail, CHAIN_TOL),
                                        (st.Cproto_re, TOL), (st.Cy_re, TOL)],
            CHAIN_TOL)


@pytest.mark.parametrize("name", ["hades", "spreader"])
def test_batched_hades_spreader_route_matches_plain_path(cuda, monkeypatch,
                                                         name):
    """The instance-batched paths: one analysis_front_ri and one
    synthesis_back_ri launch a call, never a plain version, and
    ``fused=False``'s states and output, relative to max(1, scale): the
    covariances at TOL, the spreader's output at CHAIN_TOL."""
    process, init_state, shape, held, y_tol = _batched_case(name, cuda)
    rng = np.random.default_rng(11)
    xs = [_u(rng, shape, cuda) for _ in range(2)]

    def run(fused):
        st, outs = init_state(), []
        for x in xs:
            y, st = process(st, x, fused)
            outs += held(st) + ([(y, y_tol)] if y_tol else [])
        return outs

    plain = run(False)

    def refuse(*args, **kwargs):
        raise AssertionError("the CUDA path took a plain version")

    for k in tak.KERNELS:
        monkeypatch.setattr(tak, f"{k}_reference", refuse)
    before = {n: getattr(tak, n).launches for n in tak.KERNELS}
    fused = run(True)
    torch.cuda.synchronize()
    ran = {n: getattr(tak, n).launches - before[n] for n in tak.KERNELS}
    assert ran == {n: 2 * (n in ("analysis_front_ri", "synthesis_back_ri"))
                   for n in tak.KERNELS}
    for (k, tol), (p, _) in zip(fused, plain):
        assert k.shape == p.shape and bool(torch.isfinite(k).all())
        scale = max(1.0, p.abs().max().item())
        assert (k - p).abs().max().item() <= tol * scale


def _conv_case(name, cuda):
    """(step(i) for chunk i, launched kernels expected none) of the plain
    paths: tvconv with a moving and a static listener and 4 moving
    instances, ambi_roomsim, and the kernel paths of HADES and the spreader
    x 3 (which must not wait either)."""
    from spatial_audio_framework_tpu_torch.models import (ambi_roomsim,
                                                          conv_examples)

    rng = np.random.default_rng(12)
    if name.startswith("tvconv"):
        ex = conv_examples.TVConvExample()
        irs = 0.1 * rng.standard_normal((8, 2, 512)).astype(np.float32)
        conv, H, pos = ex.design_ri(irs, rng.uniform(0, 5, (8, 3)), cuda)
        batch = (4,) if name == "tvconv x4" else ()
        state = {"st": ex.init_state_ri(conv, batch=batch, device=cuda)}
        lps = pos[torch.arange(6, device=cuda) % 8]
        if batch:
            lps = torch.stack([pos[(torch.arange(4, device=cuda) + i) % 8]
                               for i in range(6)])
        xs = _u(rng, (6,) + batch + (8 * 128,), cuda)

        def step(i):
            lp = lps[i] if name != "tvconv static" else lps[0]
            _, state["st"] = ex.process_ri(conv, H, state["st"], xs[i], lp,
                                           pos)
        return step
    if name == "roomsim":
        cfg = ambi_roomsim.AmbiRoomSimConfig(sh_order=2, n_sources=2,
                                             refl_order=1)
        w = ambi_roomsim.design_ri(cfg, np.array([[2.0, 3, 1.5], [4, 2, 1.7]]),
                                   np.array([[3.0, 2.5, 1.6]]), device=cuda)
        state = {"st": ambi_roomsim.init_state_ri(cfg, w, (3,), cuda)}
        xs = _u(rng, (6, 3, 2, 8 * 128), cuda)

        def step(i):
            _, state["st"] = ambi_roomsim.process_ri(cfg, w, state["st"],
                                                     xs[i])
        return step
    process, init_state, shape = _batched_case(name, cuda)[:3]
    state = {"st": init_state()}
    xs = _u(rng, (6,) + shape, cuda)

    def step(i):
        _, state["st"] = process(state["st"], xs[i], True)
    return step


@pytest.mark.parametrize("name", ["tvconv moving", "tvconv static",
                                  "tvconv x4", "roomsim", "hades",
                                  "spreader"])
def test_conv_hades_spreader_chunks_never_wait(cuda, monkeypatch, name):
    """Once warm, a chunk makes no tensor from host data and never makes
    the host wait: TVConv computes its crossfade rows every chunk and
    selects them on the card (no branch on a device predicate), and picks
    filters and positions by index_select and argmin on the card."""
    step = _conv_case(name, cuda)
    step(0)
    torch.cuda.synchronize()

    def refuse(*args, **kwargs):
        raise AssertionError("a tensor was made from host data per chunk")

    with monkeypatch.context() as m:
        for fn in ("from_numpy", "tensor", "as_tensor"):
            m.setattr(torch, fn, refuse)
        torch.cuda.set_sync_debug_mode("error")
        try:
            for i in range(1, 6):
                step(i)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# the real-time runtime, render_signal, the device grid, the pitch shifter,
# QMF and STFT on the card
# ---------------------------------------------------------------------------

def _ambi_bin_frame(cuda, S, order, seed=0):
    cfg = ambi_bin.AmbiBinConfig(order=order)
    rng = np.random.default_rng(seed)
    M = (0.3 * rng.standard_normal((2, 133, 2, cfg.nsh))).astype(np.float32)
    return cfg, ambi_bin.weights_from_numpy(M[0], M[1], cuda)


@pytest.mark.parametrize("order,frame_size", [(1, 128), (3, 1024)])
def test_stream_runner_launches_render_full_ri_once_per_frame(cuda, order,
                                                              frame_size):
    """StreamRunner on the native ring buffers over the batched render:
    one render_full_ri launch per frame, the output equal to a direct loop
    of the same frames delayed by one frame."""
    from spatial_audio_framework_tpu_torch.runtime import (StreamRunner,
                                                           native_available,
                                                           torch_frame_fn)

    assert native_available()
    S = 4
    cfg, w = _ambi_bin_frame(cuda, S, order)
    nsh = cfg.nsh

    def make():
        box = [ambi_bin.init_state_batched(cfg, S, device=cuda)]

        def fn(f):
            y, box[0] = ambi_bin.process_ri_batched(cfg, w, box[0],
                                                    f.reshape(S, nsh, -1))
            return y.reshape(S * 2, -1)
        return fn

    n_frames = 6
    x = np.random.default_rng(1).uniform(
        -1, 1, (S * nsh, n_frames * frame_size)).astype(np.float32)
    runner = StreamRunner(torch_frame_fn(make(), S * nsh, frame_size, cuda),
                          S * nsh, S * 2, frame_size)
    tak.render_full_ri.launches = 0
    y = np.concatenate([runner.process_block(x[:, s:s + 480])
                        for s in range(0, x.shape[1], 480)], axis=1)
    done = x.shape[1] // frame_size
    assert tak.render_full_ri.launches == done == runner.clock.frames
    assert runner.read_s > 0.0
    direct = make()
    ref = np.concatenate([direct(torch.from_numpy(
        x[:, k * frame_size:(k + 1) * frame_size]).to(cuda)).cpu().numpy()
        for k in range(done)], axis=1)
    valid = min(y.shape[1], done * frame_size)
    assert np.abs(y[:, frame_size:valid]
                  - ref[:, :valid - frame_size]).max() <= 1e-6


def test_torch_frame_fn_stages_either_layout_to_the_same_tensor(cuda):
    """A frame as the render thread hands it on (the transpose of a
    contiguous (F, n) array: staged as it lies, transposed on the card) and
    the same frame as a contiguous (n, F) array reach the function as the
    same tensor, without a host wait."""
    from spatial_audio_framework_tpu_torch.runtime import torch_frame_fn

    n, F = 64 * 16, 1024
    seen = []
    run = torch_frame_fn(lambda t: seen.append(t.clone()) or t, n, F, cuda)
    lies = np.random.default_rng(5).uniform(-1, 1, (F, n)).astype(np.float32)
    for f in (lies.T, np.ascontiguousarray(lies.T), lies.T):
        run(f)
        torch.cuda.synchronize()   # as the runner's read of each output
    torch.cuda.set_sync_debug_mode("error")
    try:
        run(lies.T)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    want = torch.from_numpy(np.ascontiguousarray(lies.T)).to(cuda)
    assert all(t.shape == (n, F) and t.is_contiguous()
               and torch.equal(t, want) for t in seen)


def test_render_signal_never_waits_and_equals_a_hand_loop(cuda):
    from spatial_audio_framework_tpu_torch.parallel.streaming import (
        render_signal)

    S = 8
    cfg, w = _ambi_bin_frame(cuda, S, 3)
    x = torch.from_numpy(np.random.default_rng(2).uniform(
        -1, 1, (S, 16, 4 * 1024)).astype(np.float32)).to(cuda)

    def proc(st, b):
        return ambi_bin.process_ri_batched(cfg, w, st, b)

    render_signal(proc, ambi_bin.init_state_batched(cfg, S, device=cuda),
                  x[..., :2048], 1024)                       # warm
    st0 = ambi_bin.init_state_batched(cfg, S, device=cuda)
    tak.render_full_ri.launches = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, _ = render_signal(proc, st0, x, 1024)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert tak.render_full_ri.launches == 4
    st, outs = ambi_bin.init_state_batched(cfg, S, device=cuda), []
    for b in range(4):
        o, st = proc(st, x[..., b * 1024:(b + 1) * 1024])
        outs.append(o)
    assert torch.equal(y, torch.cat(outs, dim=-1))


def test_run_sharded_on_the_cards_grid(cuda):
    from spatial_audio_framework_tpu_torch.parallel import mesh

    S = 8
    cfg, w = _ambi_bin_frame(cuda, S, 3)
    x = torch.from_numpy(np.random.default_rng(3).uniform(
        -1, 1, (S, 16, 1024)).astype(np.float32)).to(cuda)
    grid = mesh.make_mesh(1)
    assert grid.devices[0, 0].type == "cuda"

    def proc(w_, st, b):
        return ambi_bin.process_ri_batched(cfg, w_, st, b)

    y, st = mesh.run_sharded(proc, w, ambi_bin.init_state_batched(
        cfg, S, device=cuda), x, grid)
    ref, rst = proc(w, ambi_bin.init_state_batched(cfg, S, device=cuda), x)
    assert torch.equal(y, ref)
    assert torch.equal(st.gather().ola_tail, rst.ola_tail)


def test_pitch_shifter_on_the_card_never_waits(cuda):
    from spatial_audio_framework_tpu_torch.models import pitch_shifter as ps

    cfg = ps.PitchShifterConfig(n_ch=4, fft_size=1024, osamp=8)
    t = np.arange(4 * 1024) / 48000.0
    x = (0.4 * np.sin(2 * np.pi * np.outer([220, 330, 440, 1000], t))
         ).astype(np.float32)
    shifts = (1.25, 0.75, 1.9, 0.55)

    def run(device, guard):
        st = ps.init_state(cfg, device=device)
        mats = ps.design(cfg, device=device)
        xd = torch.from_numpy(x).to(device)
        fs = torch.tensor(shifts, device=device)
        outs = []
        for i in range(4):
            ctx = guard() if i else _nullctx()
            with ctx:
                y, st = ps.process(cfg, st, xd[:, i * 1024:(i + 1) * 1024],
                                   fs[i], mats)
            outs.append(y)
        return torch.cat(outs, -1).cpu()

    got = run(cuda, _sync_error)
    ref = run("cpu", _nullctx)
    assert (got - ref).abs().max().item() <= 1e-3


def test_qmf_and_stft_on_the_card_match_the_cpu(cuda):
    from spatial_audio_framework_tpu_torch.ops import qmf, stft

    x = np.random.default_rng(4).uniform(-1, 1, (8, 4096)).astype(np.float32)
    for bank in (qmf.QMF(128, True), qmf.QMF(128, False)):
        outs = {}
        for dev in (cuda, "cpu"):
            st = bank.init_state(8, 8, device=dev)
            spec, st = bank.analysis(st, torch.from_numpy(x).to(dev))
            y, _ = bank.synthesis(st, spec)
            outs[str(dev)] = (spec.cpu(), y.cpu())
        (sc, yc), (sp, yp) = outs.values()
        assert (sc - sp).abs().max().item() <= 1e-4
        assert (yc - yp).abs().max().item() <= 1e-5
    st_ = stft.STFT(256, 128, 8, 8)
    outs = []
    for dev in (cuda, "cpu"):
        s = st_.init_state(device=dev)
        spec, s = st_.forward(s, torch.from_numpy(x).to(dev))
        y, _ = st_.backward(s, spec)
        outs.append(y.cpu())
    assert (outs[0] - outs[1]).abs().max().item() <= 1e-5


def test_probe_device_fences_the_card(cuda):
    from spatial_audio_framework_tpu_torch.runtime import probe_device

    assert 0.0 < probe_device(timeout_s=120.0, reps=3) < 10.0


@contextlib.contextmanager
def _nullctx():
    yield


@contextlib.contextmanager
def _sync_error():
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")
