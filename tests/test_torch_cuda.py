"""The port's CUDA kernel on the card: held against its plain version, and
the CUDA path never takes the plain version.

These tests need an NVIDIA GPU and nvcc and skip without them.  They import
neither jax nor the JAX package, so they also run on a machine without jax:
``python -m pytest --noconftest -q tests/test_torch_cuda.py``
(tests/conftest.py configures jax).
"""
import numpy as np
import pytest
import torch

from spatial_audio_framework_tpu_torch.models import ambi_bin
from spatial_audio_framework_tpu_torch.ops import afstft_kernels as tak

pytestmark = pytest.mark.cuda

# fp32 on both sides; only the order of the sums differs
TOL = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _case(S, cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    in_tail = rng.uniform(-1, 1, (S, cin, 15 * 128)).astype(np.float32)
    ola = rng.uniform(-1, 1, (S, cout, 9, 128)).astype(np.float32)
    M = rng.uniform(-1, 1, (2, 133, cout, cin)).astype(np.float32)
    taps = tak.decode_taps(torch.from_numpy(M[0]), torch.from_numpy(M[1]))
    return rng, in_tail, ola, taps.contiguous()


@pytest.mark.parametrize("S,cin,cout,H", [
    (3, 4, 2, 4),      # odd S, H < 9
    (2, 4, 2, 40),     # two hop tiles, the second partial
    (1, 25, 2, 4),     # the order-4 C-golden width
    (2, 3, 1, 9),      # one ear
    (1, 4, 3, 33),     # an ear pass of 2 and one of 1
])
def test_kernel_matches_plain_version(cuda, S, cin, cout, H):
    rng, in_tail, ola, taps = _case(S, cin, cout)
    taps = taps.to(cuda)
    kt = rt = torch.from_numpy(in_tail).to(cuda)
    ko = ro = torch.from_numpy(ola).to(cuda)
    for _ in range(2):                       # chained: both tails carried
        x = torch.from_numpy(
            rng.uniform(-1, 1, (S, cin, H * 128)).astype(np.float32)).to(cuda)
        ky, ko = tak.render_full_ri(kt, x, ko, taps)
        ry, ro = tak.render_full_ri_reference(rt, x, ro, taps)
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
    _, in_tail, ola, taps = _case(2, 4, 2)
    t = [torch.from_numpy(a).to(cuda) for a in (in_tail, ola)]
    x = torch.zeros((2, 4, 512), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tak.render_full_ri(t[0], x, t[1], taps.to(cuda), low_delay=True)
