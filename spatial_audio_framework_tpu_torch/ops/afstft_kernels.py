"""The afSTFT kernels and their plain versions (counterpart of
``spatial_audio_framework_tpu/ops/pallas_afstft.py``).

* :func:`analysis_front_ri` — framing ⊗ analysis window ⊗ fold ⊗ rDFT of a
  block for many rows (``csrc/analysis_front_ri.cu``);
* :func:`analysis_front_dg_ri` — the same front, emitting the direct taps
  d and the hybrid-FIR context g that the renderer decodes
  (``csrc/analysis_front_dg_ri.cu``);
* :func:`render_decode_synthesis_ri` / :func:`render_decode_synthesis_dg_ri`
  — decode with A/B taps summed over the input channels, irDFT, synthesis
  window, overlap-add and tail merge, from the H+6-hop spectra or from the
  (d, g) pair (``csrc/render_decode_synthesis_ri.cu``);
* :func:`render_full_ri` — the one-pass TF-matrix renderer
  (``csrc/render_full_ri.cu``), analysis ⊗ decode ⊗ synthesis in one call;
* :func:`synthesis_back_ri` — hybrid inverse, low-delay sign and irDFT of
  [re | im] spectra, synthesis window, overlap-add and tail merge
  (``csrc/synthesis_back_ri.cu``);
* :func:`hrtf_taps_ri` — the binauraliser's per-stream decode taps from a
  block's source directions and head poses: rotation, HRTF-table
  interpolation and :func:`decode_taps` in one call
  (``csrc/hrtf_taps_ri.cu``).

For a per-band mixing (decode) matrix M over the 133 HYBRID bands, the chain
hybrid-forward → per-band M → hybrid-inverse collapses into a 7-tap FIR along
the hop axis applied in the 129 UNIFORM bands:

    y_u[h] = A_u · spec_u[h+3]  +  B_u · (j·(c1·(spec_u[h+6] − spec_u[h])
                                           + c2·(spec_u[h+4] − spec_u[h+2])))

with A_u = ½(M_lo + M_hi), B_u = s_u (M_lo − M_hi) for the four split
uniform bands u ∈ {1..4} (s = [−1, 1, −1, 1]; afSTFT_internal.c:523-641),
A_u = M for all other bands and B_u = 0.  :func:`decode_taps` builds the
(A, B) taps; d = spec[h+3] and g = c1·(…) + c2·(…) on bands 0..15 are what
the decode reads.  Non-hybrid banks decode d = spec[h+6] with A alone.

Every kernel takes its rDFT and irDFT as FFTs (``rdft256`` / ``irdft256``
in ``csrc/afstft_common.cuh``, twiddles from :func:`_fft_twiddles`); only
the plain versions multiply by the dense DFT matrices of
:func:`~spatial_audio_framework_tpu_torch.ops.afstft.device_consts`.

Each entry point launches its hand-written CUDA kernel for CUDA tensors
(counted in ``<entry>.launches``) and uses its plain PyTorch version
``<entry>_reference`` for CPU tensors only.  The kernels take every option
of their TPU counterparts (shared or per-stream taps, hybrid or not, normal
or low delay) at hop 128; other hops, and one-pass renders wider than 128
channel pairs, raise NotImplementedError on CUDA, naming their ROADMAP.md
item or the route that serves them.  Nothing falls back to the plain
version.  The plain versions share one decode:
:func:`render_full_ri_reference` is the front's plain version followed by
:func:`render_decode_synthesis_ri_reference`, which derives (d, g) and runs
:func:`render_decode_synthesis_dg_ri_reference`.
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
from spatial_audio_framework_tpu_torch.ops.fft import (_fft256_twiddles,
                                                       _rdft_mats)
from spatial_audio_framework_tpu_torch.ops.precision import fp32_matmul
from spatial_audio_framework_tpu_torch.utils.profiling import spanned

_G_BANDS = 16   # lanes carried for the hybrid-FIR context g (the B taps are
                # nonzero only in uniform bands 1..4)
_NT = _TOTAL_HOPS - 1   # overlap-add tail hops
_TAIL_HOPS = _NT + 6    # the renderers' input tail: 9 framing + 6 hybrid hops
_KERNEL_HOP = 128       # the kernel's fixed hop
_KERNEL_MAX_CH_PRODUCT = 128
# the entry points that launch a CUDA kernel, each counted in
# ``<entry>.launches`` and spanned as ``kernels.<entry>``
KERNELS = ("render_full_ri", "analysis_front_dg_ri",
           "render_decode_synthesis_dg_ri", "analysis_front_ri",
           "render_decode_synthesis_ri", "synthesis_back_ri", "hrtf_taps_ri")


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



@spanned("kernels.hrtf_taps_ri")
def hrtf_taps_ri(cfg, w, dirs_deg: torch.Tensor,
                 ypr: torch.Tensor | None = None) -> torch.Tensor:
    """The binauraliser's per-stream decode taps of a block:
    ``decode_taps(*interp_hrtfs_ri(cfg, w, rotate_dirs(dirs_deg, ypr)))``
    (``models/binauraliser``), the rotation only when
    ``cfg.enable_rotation`` and ``ypr`` is given.

    cfg: a ``BinauraliserConfig`` at hop 128; w: its
    ``BinauraliserWeightsRI``; dirs_deg (S, nSrc, 2) degrees; ypr (S, 3)
    radians or None.  → taps (S, nSrc, 2, 4, 129), the per-stream taps of
    :func:`render_full_ri` and :func:`render_decode_synthesis_dg_ri`.

    CPU tensors take :func:`hrtf_taps_ri_reference`.  CUDA tensors launch
    the kernel (counted in ``hrtf_taps_ri.launches``), which reads the
    weights' direction-major tables ``w.hrtf_ri_by_dir`` and
    ``w.hrtf_mag_by_dir``, or raise."""
    if dirs_deg.device.type == "cpu":
        return hrtf_taps_ri_reference(cfg, w, dirs_deg, ypr)
    if dirs_deg.device.type != "cuda":
        raise ValueError(f"hrtf_taps_ri: unsupported device {dirs_deg.device}")
    what = "hrtf_taps_ri"
    _check_hop(what, cfg.hop)
    if w.hrtf_ri_by_dir is None or w.hrtf_mag_by_dir is None:
        raise ValueError(f"{what}: the weights carry no direction-major "
                         "tables; make them with binauraliser."
                         "weights_from_numpy or design_ri")
    if dirs_deg.ndim != 3 or dirs_deg.shape[-1] != 2:
        raise ValueError(f"{what}: dirs_deg must be (S, nSrc, 2), got "
                         f"{tuple(dirs_deg.shape)}")
    S, n_src = dirs_deg.shape[:2]
    n_dirs, n_table = w.hrtf_mag_by_dir.shape[0], w.table_w.shape[0]
    nb = _KERNEL_HOP + 5
    rotate = cfg.enable_rotation and ypr is not None
    _check_inputs(what, dirs_deg, {
        "hrtf_ri_by_dir": (w.hrtf_ri_by_dir, (n_dirs, 2, nb, 2)),
        "hrtf_mag_by_dir": (w.hrtf_mag_by_dir, (n_dirs, 2, nb)),
        "table_w": (w.table_w, (n_table, 3)), "itds": (w.itds, (n_dirs,)),
        "freqs": (w.freqs, (nb,))})
    # the controls are read a float at a time: a block's slice of a longer
    # control buffer need not start on a 16-byte boundary
    controls = {"dirs_deg": (dirs_deg, (S, n_src, 2))}
    if rotate:
        controls["ypr"] = (ypr, (S, 3))
    _check_inputs(what, dirs_deg, controls, align=4)
    idx = w.table_idx
    if (idx.device != dirs_deg.device or idx.dtype != torch.int64
            or tuple(idx.shape) != (n_table, 3) or not idx.is_contiguous()):
        raise ValueError(f"{what}: table_idx must be a contiguous int64 "
                         f"({n_table}, 3) tensor on {dirs_deg.device}")
    taps = torch.empty((S, n_src, 2, 4, _KERNEL_HOP + 1),
                       dtype=torch.float32, device=dirs_deg.device)
    n_azi = int(360.0 / cfg.azi_res + 0.5) + 1
    _launch(what, "saf_hrtf_taps_ri", dirs_deg.device, dirs_deg.data_ptr(),
            ypr.data_ptr() if rotate else None, w.hrtf_ri_by_dir.data_ptr(),
            w.hrtf_mag_by_dir.data_ptr(), w.table_w.data_ptr(),
            idx.data_ptr(), w.itds.data_ptr(), w.freqs.data_ptr(),
            taps.data_ptr(), S, n_src, n_dirs, n_table,
            n_azi, float(cfg.azi_res), float(cfg.elev_res),
            int(cfg.interp_mode == "tri_ps"))
    hrtf_taps_ri.launches += 1
    return taps


hrtf_taps_ri.launches = 0


def hrtf_taps_ri_reference(cfg, w, dirs_deg: torch.Tensor,
                           ypr: torch.Tensor | None = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`hrtf_taps_ri` (same contract, any
    hop, any device): the binauraliser's own chain, unchanged and in its op
    order, without the chain's spans (it runs inside this entry's)."""
    # ops sits below models in the import graph, so the chain is imported
    # here, at the call
    from spatial_audio_framework_tpu_torch.models import binauraliser as B

    if cfg.enable_rotation and ypr is not None:
        dirs_deg = B.rotate_dirs.__wrapped__(dirs_deg, ypr)
    return decode_taps(*B.interp_hrtfs_ri.__wrapped__(cfg, w, dirs_deg),
                       hybrid=True)


def _check_kernel_supported(*, per_stream: bool, hop: int, low_delay: bool,
                            hybrid: bool, cin: int, cout: int) -> None:
    """Raise NotImplementedError for what the one-pass CUDA kernel does not
    take: a hop other than 128, or more than 128 channel pairs.  Every
    bank (hybrid or not, normal or low delay) and shared or per-stream taps
    pass, as in the TPU kernel.  (The plain version takes any hop and
    width, on the CPU.)"""
    del per_stream, low_delay, hybrid    # the kernel takes every value
    _check_hop("render_full_ri", hop)
    if cout * cin > _KERNEL_MAX_CH_PRODUCT:
        raise NotImplementedError(
            f"cout*cin = {cout * cin} > 128: the one-pass kernel holds at "
            "most 128 channel pairs; render_tf_matrix_ri serves such "
            "renders with analysis_front_ri → einsum → synthesis_back_ri, "
            "as the JAX package's dispatch does (ROADMAP.md, Queue 2, "
            "'render_full_ri: the remaining options')")


def _check_hop(what: str, hop: int) -> None:
    if hop != _KERNEL_HOP:
        raise NotImplementedError(
            f"{what}: hop {hop} != 128 (ROADMAP.md, Queue 2, 'the kernels "
            "at hop != 128')")


def _check_inputs(what: str, x: torch.Tensor, expect: dict,
                  align: int = 16) -> None:
    """Raise unless every tensor of ``expect`` ({name: (tensor, shape)})
    is float32 on x's device with that shape, contiguous and ``align``-byte
    aligned, as the CUDA kernels read them."""
    for name, (t, shape) in expect.items():
        if t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, x on {x.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} is {t.dtype}, expected float32")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if not t.is_contiguous() or t.data_ptr() % align:
            raise ValueError(f"{what}: {name} must be contiguous and "
                             f"{align}-byte aligned")


@functools.lru_cache(maxsize=None)
def _fft_twiddles(device: torch.device) -> torch.Tensor:
    """The FFT-based kernels' twiddle table W₂₅₆ᵏ ((256, 2) float32,
    :func:`~spatial_audio_framework_tpu_torch.ops.fft._fft256_twiddles`) on
    ``device``, made once per device."""
    return f32_tensor(_fft256_twiddles(), device)


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

def _check_rows(what: str, tail: torch.Tensor, x: torch.Tensor, hop: int,
                lost_hops: int) -> tuple[int, int, int]:
    """Validate an analysis front's (tail, x) rows for its kernel →
    (rows, tail hops, x hops); the front emits t_hops + x_hops − lost_hops
    hops, which must be at least one."""
    _check_hop(what, hop)
    B = x.shape[0]
    t_hops, x_hops = tail.shape[-1] // hop, x.shape[-1] // hop
    if (tail.ndim != 2 or x.ndim != 2 or tail.shape[-1] % hop
            or x.shape[-1] % hop or t_hops < _NT or x_hops < 1 or B < 1
            or t_hops + x_hops <= lost_hops):
        raise ValueError(
            f"{what}: needs tail (B, >= 9 whole hops) and x (B, >= 1 whole "
            f"hop), {lost_hops + 1} hops in all; got {tuple(tail.shape)}, "
            f"{tuple(x.shape)}")
    _check_inputs(what, x, {"tail": (tail, (B, t_hops * hop)),
                            "x": (x, (B, x_hops * hop))})
    return B, t_hops, x_hops


@spanned("kernels.analysis_front_ri")
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
    B, t_hops, H = _check_rows("analysis_front_ri", tail, x, hop, _NT)
    k = device_consts(hop, low_delay, x.device)
    n_out = t_hops + H - _NT
    re = torch.empty((B, n_out, hop + 1), dtype=torch.float32,
                     device=x.device)
    im = torch.empty_like(re)
    _launch("analysis_front_ri", "saf_analysis_front_ri", x.device,
            tail.data_ptr(), x.data_ptr(), k["w_ana"].data_ptr(),
            _fft_twiddles(x.device).data_ptr(), re.data_ptr(),
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


def _d_g(sre: torch.Tensor, sim: torch.Tensor, hybrid: bool):
    """The decode's inputs from H+6 spectral hops (..., H+6, hop+1): direct
    taps d = s[h+3] and hybrid context g = c1·(s[h+6] − s[h]) + c2·(s[h+4]
    − s[h+2]) on bands 0..15, in the TPU kernel ``_kernel_dg``'s op order;
    non-hybrid banks decode d = s[h+6] with g = 0.  → (d_re, d_im, g_re,
    g_im): (..., H, hop+1) and (..., H, 16)."""
    H = sre.shape[-2] - 6
    if not hybrid:
        g = sre.new_zeros(sre.shape[:-2] + (H, _G_BANDS))
        return sre[..., 6:, :], sim[..., 6:, :], g, g

    def g(s):
        s = s[..., :_G_BANDS]
        return (_COEFF1 * (s[..., 6:6 + H, :] - s[..., 0:H, :])
                + _COEFF2 * (s[..., 4:4 + H, :] - s[..., 2:2 + H, :]))

    return sre[..., 3:3 + H, :], sim[..., 3:3 + H, :], g(sre), g(sim)


@spanned("kernels.analysis_front_dg_ri")
def analysis_front_dg_ri(tail: torch.Tensor, x: torch.Tensor,
                         low_delay: bool = False, hop: int = _KERNEL_HOP):
    """Fused framing + window + fold + rDFT emitting the renderer's (d, g)
    pair (for hybrid banks).

    tail: (B, T_tail) carried input history, whole hops, at least 9 (the
    renderers carry 15); x: (B, X·hop) the new block.  With H = T_tail/hop
    + X − 15 output hops, returns (d_re, d_im, g_re, g_im): the direct taps
    d = s[h+3], each (B, H, hop+1), and the hybrid context g on bands 0..15,
    each (B, H, 16), where s are :func:`analysis_front_ri`'s spectra.

    CPU tensors take :func:`analysis_front_dg_ri_reference`.  CUDA tensors
    launch the kernel (counted in ``analysis_front_dg_ri.launches``) or
    raise; the kernel takes hop 128 only.
    """
    if x.device.type == "cpu":
        return analysis_front_dg_ri_reference(tail, x, low_delay=low_delay,
                                              hop=hop)
    if x.device.type != "cuda":
        raise ValueError(
            f"analysis_front_dg_ri: unsupported device {x.device}")
    B, t_hops, x_hops = _check_rows("analysis_front_dg_ri", tail, x, hop,
                                    _TAIL_HOPS)
    k = device_consts(hop, low_delay, x.device)
    H = t_hops + x_hops - _TAIL_HOPS
    out = [torch.empty((B, H, n), dtype=torch.float32, device=x.device)
           for n in (hop + 1, hop + 1, _G_BANDS, _G_BANDS)]
    _launch("analysis_front_dg_ri", "saf_analysis_front_dg_ri", x.device,
            tail.data_ptr(), x.data_ptr(), k["w_ana"].data_ptr(),
            _fft_twiddles(x.device).data_ptr(),
            *(t.data_ptr() for t in out), B, t_hops, x_hops)
    analysis_front_dg_ri.launches += 1
    return tuple(out)


analysis_front_dg_ri.launches = 0


def analysis_front_dg_ri_reference(tail: torch.Tensor, x: torch.Tensor,
                                   low_delay: bool = False,
                                   hop: int = _KERNEL_HOP):
    """Plain PyTorch version of :func:`analysis_front_dg_ri` (same
    contract, any hop, any device), in the TPU kernel ``_kernel_dg``'s op
    order: the front's spectra, then (d, g)."""
    sre, sim = analysis_front_ri_reference(tail, x, low_delay=low_delay,
                                           hop=hop)
    return _d_g(sre, sim, hybrid=True)


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
    """The plain synthesis back end's constants on ``device``, row-major:
    ``AB`` = [P·A; P·B] (2·n_bands, 2·hop), with the low-delay odd-bin
    sign folded into A and B (pallas_afstft.py:899-906), and ``w_syn``.
    (The kernel takes the window and the FFT twiddles instead.)"""
    _, w_syn = _windows(hop, low_delay)
    _, _, A, Bm = _rdft_mats(2 * hop)
    P = _hybrid_inverse_mtx(hop + (5 if hybrid else 1), hop)
    if low_delay:
        sign = np.where(np.arange(hop + 1) % 2, -1.0, 1.0)[:, None]
        A, Bm = A * sign, Bm * sign
    AB = np.concatenate([P @ A, P @ Bm], axis=0).astype(np.float32)
    return {"AB": f32_tensor(AB, device), "w_syn": f32_tensor(w_syn, device)}


@spanned("kernels.synthesis_back_ri")
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
    w_syn = device_consts(hop, low_delay, spec.device)["w_syn"]
    y = torch.empty((B, H, hop), dtype=torch.float32, device=spec.device)
    new_tail = torch.empty((B, _NT, hop), dtype=torch.float32,
                           device=spec.device)
    _launch("synthesis_back_ri", "saf_synthesis_back_ri", spec.device,
            spec.data_ptr(), tail.data_ptr(), w_syn.data_ptr(),
            _fft_twiddles(spec.device).data_ptr(), y.data_ptr(),
            new_tail.data_ptr(), B, H, int(hybrid), int(low_delay))
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
# decode ⊗ irDFT ⊗ window ⊗ overlap-add: the two-kernel renderer's back half
# ---------------------------------------------------------------------------


def _launch_decode_synthesis(what: str, fn: str, inputs: dict,
                             tail: torch.Tensor, taps: torch.Tensor,
                             low_delay: bool, per_stream: bool, S: int,
                             cin: int, cout: int, H: int, *flags: bool):
    """Check and launch a decode + synthesis kernel: ``inputs`` ({name:
    (tensor, shape)}) are its spectral inputs in the C entry point's order,
    ``flags`` its trailing int arguments.  → (y (S, cout, H·hop),
    new_tail (S, cout, 9, hop))."""
    hop = tail.shape[-1]
    _check_hop(what, hop)
    if min(S, cin, cout, H) < 1:
        raise ValueError(f"{what}: needs S, cin, cout, H >= 1; got "
                         f"{(S, cin, cout, H)}")
    x0 = next(iter(inputs.values()))[0]
    taps_shape = ((S,) if per_stream else ()) + (cin, cout, 4, hop + 1)
    _check_inputs(what, x0, {**inputs, "tail": (tail, (S, cout, _NT, hop)),
                             "taps": (taps, taps_shape)})
    w_syn = device_consts(hop, low_delay, x0.device)["w_syn"]
    frames = torch.empty((S, cout, H, 2 * hop), dtype=torch.float32,
                         device=x0.device)
    y = torch.empty((S, cout, H * hop), dtype=torch.float32, device=x0.device)
    new_tail = torch.empty((S, cout, _NT, hop), dtype=torch.float32,
                           device=x0.device)
    _launch(what, fn, x0.device, *(t.data_ptr() for t, _ in inputs.values()),
            taps.data_ptr(), _fft_twiddles(x0.device).data_ptr(),
            w_syn.data_ptr(), tail.data_ptr(), frames.data_ptr(),
            y.data_ptr(), new_tail.data_ptr(), S, cin, cout, H,
            *(int(f) for f in flags), int(low_delay))
    return y, new_tail


@spanned("kernels.render_decode_synthesis_ri")
def render_decode_synthesis_ri(sre: torch.Tensor, sim: torch.Tensor,
                               tail: torch.Tensor, taps: torch.Tensor,
                               low_delay: bool = False, hybrid: bool = True,
                               per_stream: bool = False):
    """Fused decode ⊗ irDFT ⊗ window ⊗ overlap-add from spectra.

    sre/sim: (S, cin, H+6, hop+1) uniform-band spectra from
    :func:`analysis_front_ri` (6 leading context hops); tail: (S, cout, 9,
    hop) the overlap carry; taps from :func:`decode_taps`, shared (cin,
    cout, 4, hop+1) or per-stream (S, cin, cout, 4, hop+1).  Hybrid banks
    decode d = s[h+3] with the hybrid context g (B taps on bands 0..15),
    non-hybrid banks d = s[h+6] with A alone.  Returns (y (S, cout, H·hop),
    new_tail (S, cout, 9, hop)).

    CPU tensors take :func:`render_decode_synthesis_ri_reference`.  CUDA
    tensors launch the kernel (counted in
    ``render_decode_synthesis_ri.launches``) or raise; the kernel takes
    hop 128 only, with any bank and shared or per-stream taps.
    """
    if sre.device.type == "cpu":
        return render_decode_synthesis_ri_reference(
            sre, sim, tail, taps, low_delay=low_delay, hybrid=hybrid,
            per_stream=per_stream)
    if sre.device.type != "cuda":
        raise ValueError(
            f"render_decode_synthesis_ri: unsupported device {sre.device}")
    S, cin, Hp6, _ = sre.shape
    cout = taps.shape[-3]
    y, new_tail = _launch_decode_synthesis(
        "render_decode_synthesis_ri", "saf_render_decode_synthesis_ri",
        {"sre": (sre, (S, cin, Hp6, tail.shape[-1] + 1)),
         "sim": (sim, (S, cin, Hp6, tail.shape[-1] + 1))},
        tail, taps, low_delay, per_stream, S, cin, cout, Hp6 - 6, hybrid,
        per_stream)
    render_decode_synthesis_ri.launches += 1
    return y, new_tail


render_decode_synthesis_ri.launches = 0


def render_decode_synthesis_ri_reference(sre: torch.Tensor, sim: torch.Tensor,
                                         tail: torch.Tensor,
                                         taps: torch.Tensor,
                                         low_delay: bool = False,
                                         hybrid: bool = True,
                                         per_stream: bool = False):
    """Plain PyTorch version of :func:`render_decode_synthesis_ri` (same
    contract, any hop, any device): (d, g) from the spectra, then
    :func:`render_decode_synthesis_dg_ri_reference`.  It sums the decode
    over cin in one reduction where the TPU kernel ``_render_kernel``
    accumulates channel by channel (~1 ulp·√cin apart)."""
    return render_decode_synthesis_dg_ri_reference(
        *_d_g(sre, sim, hybrid), tail, taps, low_delay=low_delay,
        per_stream=per_stream)


@spanned("kernels.render_decode_synthesis_dg_ri")
def render_decode_synthesis_dg_ri(dre: torch.Tensor, dim_: torch.Tensor,
                                  gre: torch.Tensor, gim: torch.Tensor,
                                  tail: torch.Tensor, taps: torch.Tensor,
                                  low_delay: bool = False,
                                  per_stream: bool = False):
    """Fused decode ⊗ irDFT ⊗ window ⊗ overlap-add from the (d, g) pair of
    :func:`analysis_front_dg_ri`: d (S, cin, H, hop+1), g (S, cin, H, 16);
    tail and taps as in :func:`render_decode_synthesis_ri`; hybrid banks.
    Returns (y (S, cout, H·hop), new_tail (S, cout, 9, hop)).

    CPU tensors take :func:`render_decode_synthesis_dg_ri_reference`.  CUDA
    tensors launch the kernel (counted in
    ``render_decode_synthesis_dg_ri.launches``) or raise; the kernel takes
    hop 128 only, normal or low-delay banks, shared or per-stream taps.
    """
    if dre.device.type == "cpu":
        return render_decode_synthesis_dg_ri_reference(
            dre, dim_, gre, gim, tail, taps, low_delay=low_delay,
            per_stream=per_stream)
    if dre.device.type != "cuda":
        raise ValueError(
            f"render_decode_synthesis_dg_ri: unsupported device {dre.device}")
    S, cin, H, _ = dre.shape
    cout = taps.shape[-3]
    d_shape = (S, cin, H, tail.shape[-1] + 1)
    g_shape = (S, cin, H, _G_BANDS)
    y, new_tail = _launch_decode_synthesis(
        "render_decode_synthesis_dg_ri", "saf_render_decode_synthesis_dg_ri",
        {"dre": (dre, d_shape), "dim": (dim_, d_shape),
         "gre": (gre, g_shape), "gim": (gim, g_shape)},
        tail, taps, low_delay, per_stream, S, cin, cout, H, per_stream)
    render_decode_synthesis_dg_ri.launches += 1
    return y, new_tail


render_decode_synthesis_dg_ri.launches = 0


def render_decode_synthesis_dg_ri_reference(dre: torch.Tensor,
                                            dim_: torch.Tensor,
                                            gre: torch.Tensor,
                                            gim: torch.Tensor,
                                            tail: torch.Tensor,
                                            taps: torch.Tensor,
                                            low_delay: bool = False,
                                            per_stream: bool = False):
    """Plain PyTorch version of :func:`render_decode_synthesis_dg_ri` (same
    contract, any hop, any device), in the TPU kernel
    ``_render_dg_kernel``'s op order: the decode summed over cin in one
    reduction per ear, the irDFT in full fp32 (TF32 off), then synthesis
    window, overlap-add and tail merge."""
    hop = tail.shape[-1]
    S, _, H, nb = dre.shape
    cout = taps.shape[-3]
    k = device_consts(hop, low_delay, dre.device)
    A, Bm = k["A"], k["B"]
    if low_delay:
        A, Bm = A * k["sign"][:, None], Bm * k["sign"][:, None]
    dre, dim_ = dre[:, :, None], dim_[:, :, None]   # (S, cin, 1, H, nb)
    w_re, w_im = -gim[:, :, None], gre[:, :, None]  # j · g
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
    with fp32_matmul():
        fr = out_re @ A + out_im @ Bm                # (S, cout, H, 2·hop)
    y, new_tail = _overlap_add(fr, k["w_syn"], tail)
    return y.reshape(S, cout, H * hop), new_tail


# ---------------------------------------------------------------------------
# one-pass TF-matrix renderer
# ---------------------------------------------------------------------------


@spanned("kernels.render_full_ri")
def render_full_ri(in_tail: torch.Tensor, x: torch.Tensor,
                   ola_tail: torch.Tensor, taps: torch.Tensor,
                   low_delay: bool = False, hybrid: bool = True,
                   per_stream: bool = False):
    """One-pass TF-matrix renderer.

    in_tail: (S, cin, 15·hop) carried input history; x: (S, cin, H·hop);
    ola_tail: (S, cout, 9, hop); taps from :func:`decode_taps`, shared
    (cin, cout, 4, hop+1) or per-stream (S, cin, cout, 4, hop+1).  Hybrid
    banks decode d = s[h+3] with the hybrid context, non-hybrid banks
    d = s[h+6] with A alone.
    Returns (y (S, cout, H·hop), new_ola_tail (S, cout, 9, hop)).

    CPU tensors take :func:`render_full_ri_reference`.  CUDA tensors launch
    the kernel (counted in ``render_full_ri.launches``) or raise; the
    kernel takes hop 128 and cout·cin ≤ 128, with any bank and shared or
    per-stream taps.
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
        "taps": (taps, ((S,) if per_stream else ()) + (cin, cout, 4,
                                                       hop + 1))})
    if S < 1 or H < 1:
        raise ValueError(f"render_full_ri: needs S >= 1 and H >= 1 hops "
                         f"(got S={S}, x length {x.shape[2]})")
    k = device_consts(hop, low_delay, x.device)
    frames = torch.empty((S, cout, H, 2 * hop), dtype=torch.float32,
                         device=x.device)
    y = torch.empty((S, cout, H * hop), dtype=torch.float32, device=x.device)
    new_tail = torch.empty((S, cout, _NT, hop), dtype=torch.float32,
                           device=x.device)
    _launch("render_full_ri", "saf_render_full_ri", x.device,
            in_tail.data_ptr(), x.data_ptr(), ola_tail.data_ptr(),
            taps.data_ptr(), k["w_ana"].data_ptr(), k["w_syn"].data_ptr(),
            _fft_twiddles(x.device).data_ptr(), frames.data_ptr(),
            y.data_ptr(), new_tail.data_ptr(), S, cin, cout, H, int(hybrid),
            int(per_stream), int(low_delay))
    render_full_ri.launches += 1
    return y, new_tail


render_full_ri.launches = 0


def render_full_ri_reference(in_tail: torch.Tensor, x: torch.Tensor,
                             ola_tail: torch.Tensor, taps: torch.Tensor,
                             low_delay: bool = False, hybrid: bool = True,
                             per_stream: bool = False):
    """Plain PyTorch version of :func:`render_full_ri` (same contract, any
    option, any device), in the TPU kernel ``_render_full_kernel``'s op
    order: the two-kernel pipeline's plain versions composed, i.e. the
    front's H+6 spectral hops, (d, g) (for hybrid banks exactly
    :func:`analysis_front_dg_ri_reference`), and
    :func:`render_decode_synthesis_dg_ri_reference`."""
    S, cin = x.shape[:2]
    sre, sim = analysis_front_ri_reference(
        in_tail.reshape(S * cin, -1), x.reshape(S * cin, -1),
        low_delay=low_delay, hop=ola_tail.shape[-1])
    return render_decode_synthesis_ri_reference(
        sre.reshape(S, cin, *sre.shape[1:]),
        sim.reshape(S, cin, *sim.shape[1:]), ola_tail, taps,
        low_delay=low_delay, hybrid=hybrid, per_stream=per_stream)
