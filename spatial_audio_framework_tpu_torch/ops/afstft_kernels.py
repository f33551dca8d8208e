"""The TF-matrix renderer's kernel and its plain version (counterpart of
``spatial_audio_framework_tpu/ops/pallas_afstft.py``).

For a per-band mixing (decode) matrix M over the 133 HYBRID bands, the chain
hybrid-forward → per-band M → hybrid-inverse collapses into a 7-tap FIR along
the hop axis applied in the 129 UNIFORM bands:

    y_u[h] = A_u · spec_u[h+3]  +  B_u · (j·(c1·(spec_u[h+6] − spec_u[h])
                                           + c2·(spec_u[h+4] − spec_u[h+2])))

with A_u = ½(M_lo + M_hi), B_u = s_u (M_lo − M_hi) for the four split
uniform bands u ∈ {1..4} (s = [−1, 1, −1, 1]; afSTFT_internal.c:523-641),
A_u = M for all other bands and B_u = 0.  :func:`decode_taps` builds the
(A, B) taps; :func:`render_full_ri` runs analysis ⊗ decode ⊗ synthesis of a
block in one pass.

:func:`render_full_ri` launches the hand-written CUDA kernel
(``csrc/render_full_ri.cu``) for CUDA tensors and uses its plain PyTorch
version :func:`render_full_ri_reference` for CPU tensors only.  Options the
kernel does not take raise NotImplementedError on CUDA
(:func:`_check_kernel_supported`); nothing falls back to the plain version.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from spatial_audio_framework_tpu_torch.ops import _build
from spatial_audio_framework_tpu_torch.ops.afstft import (_COEFF1, _COEFF2,
                                                          _TOTAL_HOPS,
                                                          device_consts)
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul

_G_BANDS = 16   # lanes carried for the hybrid-FIR context g (the B taps are
                # nonzero only in uniform bands 1..4)
_NT = _TOTAL_HOPS - 1   # overlap-add tail hops
_KERNEL_HOP = 128       # the kernel's fixed hop
_KERNEL_MAX_CH_PRODUCT = 128


def decode_taps(Mre: torch.Tensor, Mim: torch.Tensor,
                hybrid: bool = True) -> torch.Tensor:
    """(..., n_bands, Cout, Cin) hybrid-band decode matrices → uniform-band
    taps tensor (..., Cin, Cout, 4, 129) packing [A_re, A_im, B_re, B_im]."""
    if not hybrid:
        A_re, A_im = Mre, Mim
        B_re, B_im = torch.zeros_like(Mre), torch.zeros_like(Mim)
    else:
        # s = [-1, 1, -1, 1], made on the device: a host-to-device copy
        # here would stall every block until the device drains
        s = torch.ones((4, 1, 1), dtype=Mre.dtype, device=Mre.device)
        s[0::2] = -1.0

        def collapse(M):
            lo = M[..., 1:9:2, :, :]
            hi = M[..., 2:10:2, :, :]
            A = torch.cat([M[..., :1, :, :], 0.5 * (lo + hi), M[..., 9:, :, :]],
                          dim=-3)
            B = torch.cat([torch.zeros_like(M[..., :1, :, :]), s * (lo - hi),
                           torch.zeros_like(M[..., 9:, :, :])], dim=-3)
            return A, B

        A_re, B_re = collapse(Mre)
        A_im, B_im = collapse(Mim)

    def r(T):  # (..., nb, Cout, Cin) → (..., Cin, Cout, nb)
        return T.movedim((-3, -2, -1), (-1, -2, -3))

    return torch.stack([r(A_re), r(A_im), r(B_re), r(B_im)], dim=-2)


def _check_kernel_supported(*, per_stream: bool, hop: int, low_delay: bool,
                            hybrid: bool, cin: int, cout: int) -> None:
    """Raise NotImplementedError for what the CUDA kernel does not take.
    These options are not on the ported slice; each names its ROADMAP.md
    item.  (The plain version takes all of them, on the CPU.)"""
    item = "ROADMAP.md, Queue 2, 'render_full_ri: the remaining options'"
    if per_stream:
        raise NotImplementedError(f"per-stream decode taps: {item}")
    if hop != _KERNEL_HOP:
        raise NotImplementedError(f"hop {hop} != 128: {item}")
    if low_delay:
        raise NotImplementedError(f"low-delay afSTFT banks: {item}")
    if not hybrid:
        raise NotImplementedError(f"non-hybrid afSTFT banks: {item}")
    if cout * cin > _KERNEL_MAX_CH_PRODUCT:
        raise NotImplementedError(
            f"cout*cin = {cout * cin} > 128 takes the einsum path, whose "
            "kernels analysis_front_ri and synthesis_back_ri are not ported: "
            "ROADMAP.md, Queue 2, items 1 and 4")


@functools.lru_cache(maxsize=None)
def _kernel_consts(device: torch.device) -> dict[str, torch.Tensor]:
    """The windows and DFT matrices the kernel takes, on ``device``, all
    row-major; A and B get a zero 130th row so the kernel reads bands in
    pairs."""
    k = device_consts(_KERNEL_HOP, False, device)
    pad = torch.zeros((1, 2 * _KERNEL_HOP), dtype=torch.float32, device=device)
    return {**k, "A": torch.cat([k["A"], pad]), "B": torch.cat([k["B"], pad])}


def render_full_ri(in_tail: torch.Tensor, x: torch.Tensor,
                   ola_tail: torch.Tensor, taps: torch.Tensor,
                   low_delay: bool = False, hybrid: bool = True,
                   per_stream: bool = False):
    """One-pass TF-matrix renderer.

    in_tail: (S, cin, 15·hop) carried input history; x: (S, cin, H·hop);
    ola_tail: (S, cout, 9, hop); taps from :func:`decode_taps`, shared
    (cin, cout, 4, hop+1) or per-stream (S, cin, cout, 4, hop+1).
    Returns (y (S, cout, H·hop), new_ola_tail (S, cout, 9, hop)).

    CPU tensors take :func:`render_full_ri_reference`.  CUDA tensors launch
    the kernel (counted in ``render_full_ri.launches``) or raise.
    """
    if x.device.type == "cpu":
        return render_full_ri_reference(in_tail, x, ola_tail, taps,
                                        low_delay=low_delay, hybrid=hybrid,
                                        per_stream=per_stream)
    if x.device.type != "cuda":
        raise ValueError(f"render_full_ri: unsupported device {x.device}")
    hop = ola_tail.shape[-1]
    S, cin = x.shape[:2]
    cout = taps.shape[-3]
    _check_kernel_supported(per_stream=per_stream, hop=hop,
                            low_delay=low_delay, hybrid=hybrid, cin=cin,
                            cout=cout)
    H = x.shape[2] // hop
    expect = {"in_tail": (in_tail, (S, cin, 15 * hop)),
              "x": (x, (S, cin, H * hop)),
              "ola_tail": (ola_tail, (S, cout, _NT, hop)),
              "taps": (taps, (cin, cout, 4, hop + 1))}
    for name, (t, shape) in expect.items():
        if t.device != x.device:
            raise ValueError(f"render_full_ri: {name} on {t.device}, "
                             f"x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"render_full_ri: {name} is {t.dtype}, "
                            "expected float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"render_full_ri: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"render_full_ri: {name} must be contiguous "
                             "and 16-byte aligned")
    if S < 1 or H < 1:
        raise ValueError(f"render_full_ri: needs S >= 1 and H >= 1 hops "
                         f"(got S={S}, x length {x.shape[2]})")
    lib = _build.load_library()
    k = _kernel_consts(x.device)
    frames = torch.empty((S, cout, H, 2 * hop), dtype=torch.float32,
                         device=x.device)
    y = torch.empty((S, cout, H * hop), dtype=torch.float32, device=x.device)
    new_tail = torch.empty((S, cout, _NT, hop), dtype=torch.float32,
                           device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.saf_render_full_ri(
            in_tail.data_ptr(), x.data_ptr(), ola_tail.data_ptr(),
            taps.data_ptr(), k["w_ana"].data_ptr(), k["w_syn"].data_ptr(),
            k["C"].data_ptr(), k["S"].data_ptr(), k["A"].data_ptr(),
            k["B"].data_ptr(), frames.data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), S, cin, cout, H, stream)
    _build.check(lib, code, "render_full_ri")
    render_full_ri.launches += 1
    return y, new_tail


render_full_ri.launches = 0


def render_full_ri_reference(in_tail: torch.Tensor, x: torch.Tensor,
                             ola_tail: torch.Tensor, taps: torch.Tensor,
                             low_delay: bool = False, hybrid: bool = True,
                             per_stream: bool = False):
    """Plain PyTorch version of :func:`render_full_ri` (same contract, any
    option, any device).  The steps and their order follow the TPU kernel
    ``_render_full_kernel``; matmuls run in full fp32 (TF32 off)."""
    hop = ola_tail.shape[-1]
    S, cin = x.shape[:2]
    H = x.shape[2] // hop
    t_hops = in_tail.shape[2] // hop
    cout = taps.shape[-3]
    nb = hop + 1
    dev = x.device
    k = device_consts(hop, low_delay, dev)
    wa = k["w_ana"].reshape(_TOTAL_HOPS, hop)
    ws = k["w_syn"].reshape(_TOTAL_HOPS, hop)
    C, Smat, A, Bm = k["C"], k["S"], k["A"], k["B"]
    if low_delay:
        A, Bm = A * k["sign"][:, None], Bm * k["sign"][:, None]

    # 1. fold the H+6 frames (two parity accumulators)
    He = H + 6
    xx = torch.cat([in_tail, x], dim=2).reshape(S, cin, t_hops + H, hop)
    acc0 = torch.zeros((S, cin, He, hop), dtype=torch.float32, device=dev)
    acc1 = torch.zeros_like(acc0)
    for m in range(_TOTAL_HOPS // 2):
        acc0 = acc0 + xx[:, :, 2 * m:2 * m + He] * wa[2 * m]
        acc1 = acc1 + xx[:, :, 2 * m + 1:2 * m + 1 + He] * wa[2 * m + 1]
    # 2. rDFT
    with fp32_matmul():
        sre = acc0 @ C[:hop] + acc1 @ C[hop:]
        sim = acc0 @ Smat[:hop] + acc1 @ Smat[hop:]
    # 3. direct taps and hybrid context (16 bands)
    d_off = 3 if hybrid else 6
    dre = sre[:, :, None, d_off:d_off + H]          # (S, cin, 1, H, nb)
    dim_ = sim[:, :, None, d_off:d_off + H]
    if hybrid:
        sg_re, sg_im = sre[..., :_G_BANDS], sim[..., :_G_BANDS]
        gre = (_COEFF1 * (sg_re[:, :, 6:6 + H] - sg_re[:, :, 0:H])
               + _COEFF2 * (sg_re[:, :, 4:4 + H] - sg_re[:, :, 2:2 + H]))
        gim = (_COEFF1 * (sg_im[:, :, 6:6 + H] - sg_im[:, :, 0:H])
               + _COEFF2 * (sg_im[:, :, 4:4 + H] - sg_im[:, :, 2:2 + H]))
    else:
        gre = torch.zeros((S, cin, H, _G_BANDS), dtype=torch.float32,
                          device=dev)
        gim = torch.zeros_like(gre)
    w_re, w_im = -gim[:, :, None], gre[:, :, None]  # j · g
    # 4. decode per ear, summed over cin
    T = taps if per_stream else taps[None]          # (S|1, cin, cout, 4, nb)

    def tap(q, n):
        return T[:, :, :, q, None, :n]              # (S|1, cin, cout, 1, n)

    are, aim = tap(0, nb), tap(1, nb)
    bre, bim = tap(2, _G_BANDS), tap(3, _G_BANDS)
    t_re = (are * dre - aim * dim_).sum(dim=1)      # (S, cout, H, nb)
    t_im = (are * dim_ + aim * dre).sum(dim=1)
    c_re = (bre * w_re - bim * w_im).sum(dim=1)     # (S, cout, H, 16)
    c_im = (bre * w_im + bim * w_re).sum(dim=1)
    out_re = t_re + F.pad(c_re, (0, nb - _G_BANDS))
    out_im = t_im + F.pad(c_im, (0, nb - _G_BANDS))
    # 5. irDFT
    with fp32_matmul():
        fr = out_re @ A + out_im @ Bm                # (S, cout, H, 2·hop)
    # 6. synthesis window, overlap-add, tail merge
    f0, f1 = fr[..., :hop], fr[..., hop:]
    acc = torch.zeros((S, cout, H + _NT, hop), dtype=torch.float32,
                      device=dev)
    for k in range(_TOTAL_HOPS):
        acc[:, :, k:k + H] += (f0 if k % 2 == 0 else f1) * ws[k]
    acc[:, :, :_NT] += ola_tail
    y = acc[:, :, :H].reshape(S, cout, H * hop)
    return y, acc[:, :, H:].contiguous()
