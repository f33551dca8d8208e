"""The afSTFT kernels and their plain versions (counterpart of
``spatial_audio_framework_tpu/ops/pallas_afstft.py``).

* :func:`analysis_front_ri` — framing ⊗ analysis window ⊗ fold ⊗ rDFT of a
  block for many rows (``csrc/analysis_front_ri.cu``);
* :func:`synthesis_back_ri` — [re | im] spectra @ [P·A; P·B] (hybrid
  inverse and low-delay sign folded into the irDFT), synthesis window,
  overlap-add and tail merge (``csrc/synthesis_back_ri.cu``);
* :func:`render_full_ri` — the one-pass TF-matrix renderer
  (``csrc/render_full_ri.cu``), described below.

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

Each entry point launches its hand-written CUDA kernel for CUDA tensors
(counted in ``<entry>.launches``) and uses its plain PyTorch version
``<entry>_reference`` for CPU tensors only.  Options a kernel does not take
raise NotImplementedError on CUDA, naming their ROADMAP.md item; nothing
falls back to the plain version.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from spatial_audio_framework_tpu_torch import f32_tensor
from spatial_audio_framework_tpu_torch.ops import _build
from spatial_audio_framework_tpu_torch.ops.afstft import (_COEFF1, _COEFF2,
                                                          _TOTAL_HOPS,
                                                          _windows,
                                                          device_consts)
from spatial_audio_framework_tpu_torch.ops.fft import _rdft_mats
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
            f"cout*cin = {cout * cin} > 128: the one-pass kernel holds at "
            "most 128 channel pairs; render_tf_matrix_ri serves such "
            "renders with analysis_front_ri → einsum → synthesis_back_ri "
            f"(a wider one-pass kernel: {item})")


def _check_hop(what: str, hop: int) -> None:
    if hop != _KERNEL_HOP:
        raise NotImplementedError(
            f"{what}: hop {hop} != 128 (ROADMAP.md, Queue 2, 'the kernels "
            "at hop != 128')")


def _check_inputs(what: str, x: torch.Tensor, expect: dict) -> None:
    """Raise unless every tensor of ``expect`` ({name: (tensor, shape)})
    is float32 on x's device with that shape, contiguous and 16-byte
    aligned, as the CUDA kernels read them."""
    for name, (t, shape) in expect.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             "16-byte aligned")


def _launch(what: str, fn: str, device: torch.device, *args) -> None:
    """Call the C entry point ``fn`` with ``args`` and the current CUDA
    stream of ``device``; raise on a CUDA error."""
    lib = _build.load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = getattr(lib, fn)(*args, stream)
    _build.check(lib, code, what)


def _fold_rdft(xx: torch.Tensor, k: dict, n: int):
    """Fold n frames of xx (..., n + 9, hop) with the analysis window in
    two parity accumulators, then rDFT them as two half-K products, in the
    TPU kernels' op order (``_fold`` + ``_kernel``) → (re, im), each
    (..., n, hop + 1)."""
    hop = xx.shape[-1]
    wa = k["w_ana"].reshape(_TOTAL_HOPS, hop)
    acc0 = torch.zeros(xx.shape[:-2] + (n, hop), dtype=torch.float32,
                       device=xx.device)
    acc1 = torch.zeros_like(acc0)
    for m in range(_TOTAL_HOPS // 2):
        acc0 = acc0 + xx[..., 2 * m:2 * m + n, :] * wa[2 * m]
        acc1 = acc1 + xx[..., 2 * m + 1:2 * m + 1 + n, :] * wa[2 * m + 1]
    C, Smat = k["C"], k["S"]
    with fp32_matmul():
        return (acc0 @ C[:hop] + acc1 @ C[hop:],
                acc0 @ Smat[:hop] + acc1 @ Smat[hop:])


def _overlap_add(fr: torch.Tensor, w_syn: torch.Tensor,
                 ola_tail: torch.Tensor):
    """Synthesis window, overlap-add over 10 hops and tail merge of frames
    fr (..., H, 2·hop) with the carried tail (..., 9, hop) → (y (..., H,
    hop), new tail (..., 9, hop)); correct for H < 9."""
    hop = fr.shape[-1] // 2
    H = fr.shape[-2]
    ws = w_syn.reshape(_TOTAL_HOPS, hop)
    f0, f1 = fr[..., :hop], fr[..., hop:]
    acc = torch.zeros(fr.shape[:-2] + (H + _NT, hop), dtype=torch.float32,
                      device=fr.device)
    for k in range(_TOTAL_HOPS):
        acc[..., k:k + H, :] += (f0 if k % 2 == 0 else f1) * ws[k]
    acc[..., :_NT, :] += ola_tail
    return acc[..., :H, :], acc[..., H:, :].contiguous()


# ---------------------------------------------------------------------------
# analysis front: framing ⊗ window ⊗ fold ⊗ rDFT
# ---------------------------------------------------------------------------

def analysis_front_ri(tail: torch.Tensor, x: torch.Tensor,
                      low_delay: bool = False, hop: int = _KERNEL_HOP):
    """Fused framing + window + fold + rDFT.

    tail: (B, T_tail) carried input history, whole hops, at least 9;
    x: (B, H·hop) the new block.  Returns (re, im), each
    (B, H + T_tail/hop − 9, hop+1): one spectral hop per input hop beyond
    the 9-hop window warm-up.

    CPU tensors take :func:`analysis_front_ri_reference`.  CUDA tensors
    launch the kernel (counted in ``analysis_front_ri.launches``) or raise;
    the kernel takes hop 128 only.
    """
    if x.device.type == "cpu":
        return analysis_front_ri_reference(tail, x, low_delay=low_delay,
                                           hop=hop)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_front_ri: unsupported device {x.device}")
    _check_hop("analysis_front_ri", hop)
    B = x.shape[0]
    t_hops, H = tail.shape[-1] // hop, x.shape[-1] // hop
    if (tail.ndim != 2 or x.ndim != 2 or tail.shape[-1] % hop
            or x.shape[-1] % hop or t_hops < _NT or H < 1 or B < 1):
        raise ValueError(
            f"analysis_front_ri: needs tail (B, >= 9 whole hops) and x "
            f"(B, >= 1 whole hop); got {tuple(tail.shape)}, "
            f"{tuple(x.shape)}")
    _check_inputs("analysis_front_ri", x, {
        "tail": (tail, (B, t_hops * hop)), "x": (x, (B, H * hop))})
    k = device_consts(hop, low_delay, x.device)
    n_out = t_hops + H - _NT
    re = torch.empty((B, n_out, hop + 1), dtype=torch.float32,
                     device=x.device)
    im = torch.empty_like(re)
    _launch("analysis_front_ri", "saf_analysis_front_ri", x.device,
            tail.data_ptr(), x.data_ptr(), k["w_ana"].data_ptr(),
            k["C"].data_ptr(), k["S"].data_ptr(), re.data_ptr(),
            im.data_ptr(), B, t_hops, H)
    analysis_front_ri.launches += 1
    return re, im


analysis_front_ri.launches = 0


def analysis_front_ri_reference(tail: torch.Tensor, x: torch.Tensor,
                                low_delay: bool = False,
                                hop: int = _KERNEL_HOP):
    """Plain PyTorch version of :func:`analysis_front_ri` (same contract,
    any hop, any device), in the TPU kernel ``_kernel``'s op order."""
    B = x.shape[0]
    n_hops = (tail.shape[1] + x.shape[1]) // hop
    xx = torch.cat([tail, x], dim=1).reshape(B, n_hops, hop)
    return _fold_rdft(xx, device_consts(hop, low_delay, x.device),
                      n_hops - _NT)


# ---------------------------------------------------------------------------
# synthesis back end: hybrid inverse ⊗ irDFT ⊗ window ⊗ overlap-add
# ---------------------------------------------------------------------------

def _hybrid_inverse_mtx(n_bands_hyb: int, hop: int) -> np.ndarray:
    """(n_bands_hyb, hop+1) 0/1 matrix summing hybrid band pairs back to
    uniform bands (afSTFT_internal.c:644-673), folded into the irDFT."""
    nb_uni = hop + 1
    if n_bands_hyb == nb_uni:       # non-hybrid
        return np.eye(nb_uni, dtype=np.float32)
    P = np.zeros((n_bands_hyb, nb_uni), np.float32)
    P[0, 0] = 1.0
    for p in range(4):              # bands 1..8 are pairs of uniform 1..4
        P[1 + 2 * p, 1 + p] = 1.0
        P[2 + 2 * p, 1 + p] = 1.0
    for b in range(5, nb_uni):      # bands 9.. map 1:1 to uniform 5..
        P[4 + b, b] = 1.0
    return P


@functools.lru_cache(maxsize=None)
def _syn_consts(hop: int, low_delay: bool, hybrid: bool,
                device: torch.device) -> dict[str, torch.Tensor]:
    """The synthesis kernel's constants on ``device``, row-major:
    ``AB`` = [P·A; P·B] (2·n_bands, 2·hop), with the low-delay odd-bin
    sign folded into A and B (pallas_afstft.py:899-906), and ``w_syn``."""
    _, w_syn = _windows(hop, low_delay)
    _, _, A, Bm = _rdft_mats(2 * hop)
    P = _hybrid_inverse_mtx(hop + (5 if hybrid else 1), hop)
    if low_delay:
        sign = np.where(np.arange(hop + 1) % 2, -1.0, 1.0)[:, None]
        A, Bm = A * sign, Bm * sign
    AB = np.concatenate([P @ A, P @ Bm], axis=0).astype(np.float32)
    return {"AB": f32_tensor(AB, device), "w_syn": f32_tensor(w_syn, device)}


def synthesis_back_ri(spec: torch.Tensor, tail: torch.Tensor,
                      low_delay: bool = False, hybrid: bool = True):
    """Fused hybrid inverse + irDFT + window + overlap-add.

    spec: (B, H, 2·n_bands) packed [re | im] spectra (n_bands = hop+5
    hybrid, hop+1 not); tail: (B, 9, hop) the previous block's overlap
    carry.  Returns (y (B, H, hop), new_tail (B, 9, hop)).

    CPU tensors take :func:`synthesis_back_ri_reference`.  CUDA tensors
    launch the kernel (counted in ``synthesis_back_ri.launches``) or raise;
    the kernel takes hop 128 only, with any bank (hybrid or not, normal or
    low delay).
    """
    if spec.device.type == "cpu":
        return synthesis_back_ri_reference(spec, tail, low_delay=low_delay,
                                           hybrid=hybrid)
    if spec.device.type != "cuda":
        raise ValueError(
            f"synthesis_back_ri: unsupported device {spec.device}")
    hop = tail.shape[-1]
    _check_hop("synthesis_back_ri", hop)
    B, H = spec.shape[:2]
    K = 2 * (hop + (5 if hybrid else 1))
    if spec.ndim != 3 or B < 1 or H < 1:
        raise ValueError(f"synthesis_back_ri: needs spec (B >= 1, H >= 1, "
                         f"{K}); got {tuple(spec.shape)}")
    _check_inputs("synthesis_back_ri", spec, {
        "spec": (spec, (B, H, K)), "tail": (tail, (B, _NT, hop))})
    c = _syn_consts(hop, low_delay, hybrid, spec.device)
    frames = torch.empty((B, H, 2 * hop), dtype=torch.float32,
                         device=spec.device)
    y = torch.empty((B, H, hop), dtype=torch.float32, device=spec.device)
    new_tail = torch.empty((B, _NT, hop), dtype=torch.float32,
                           device=spec.device)
    _launch("synthesis_back_ri", "saf_synthesis_back_ri", spec.device,
            spec.data_ptr(), tail.data_ptr(), c["AB"].data_ptr(),
            c["w_syn"].data_ptr(), frames.data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), B, H, K)
    synthesis_back_ri.launches += 1
    return y, new_tail


synthesis_back_ri.launches = 0


def synthesis_back_ri_reference(spec: torch.Tensor, tail: torch.Tensor,
                                low_delay: bool = False,
                                hybrid: bool = True):
    """Plain PyTorch version of :func:`synthesis_back_ri` (same contract,
    any hop, any device), in the TPU kernel ``_syn_kernel``'s op order."""
    c = _syn_consts(tail.shape[-1], low_delay, hybrid, spec.device)
    with fp32_matmul():
        fr = spec @ c["AB"]                          # (B, H, 2·hop)
    return _overlap_add(fr, c["w_syn"], tail)


# ---------------------------------------------------------------------------
# one-pass TF-matrix renderer
# ---------------------------------------------------------------------------


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
    _check_inputs("render_full_ri", x, {
        "in_tail": (in_tail, (S, cin, 15 * hop)),
        "x": (x, (S, cin, H * hop)),
        "ola_tail": (ola_tail, (S, cout, _NT, hop)),
        "taps": (taps, (cin, cout, 4, hop + 1))})
    if S < 1 or H < 1:
        raise ValueError(f"render_full_ri: needs S >= 1 and H >= 1 hops "
                         f"(got S={S}, x length {x.shape[2]})")
    k = _kernel_consts(x.device)
    frames = torch.empty((S, cout, H, 2 * hop), dtype=torch.float32,
                         device=x.device)
    y = torch.empty((S, cout, H * hop), dtype=torch.float32, device=x.device)
    new_tail = torch.empty((S, cout, _NT, hop), dtype=torch.float32,
                           device=x.device)
    _launch("render_full_ri", "saf_render_full_ri", x.device,
            in_tail.data_ptr(), x.data_ptr(), ola_tail.data_ptr(),
            taps.data_ptr(), k["w_ana"].data_ptr(), k["w_syn"].data_ptr(),
            k["C"].data_ptr(), k["S"].data_ptr(), k["A"].data_ptr(),
            k["B"].data_ptr(), frames.data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), S, cin, cout, H)
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
    A, Bm = k["A"], k["B"]
    if low_delay:
        A, Bm = A * k["sign"][:, None], Bm * k["sign"][:, None]

    # 1-2. fold the H+6 frames (two parity accumulators), rDFT
    xx = torch.cat([in_tail, x], dim=2).reshape(S, cin, t_hops + H, hop)
    sre, sim = _fold_rdft(xx, k, H + 6)
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
    y, new_tail = _overlap_add(fr, k["w_syn"], ola_tail)
    return y.reshape(S, cout, H * hop), new_tail
