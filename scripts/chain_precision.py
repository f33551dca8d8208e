#!/usr/bin/env python3
"""How sensitive HADES's and the spreader's solve / CDF4SAP chains are to
float32 rounding, on the CPU, through the port alone (no JAX):

1. the HADES golden ``hds`` (6 mics, BMVDR, covariance matching) against
   the compiled C with CDF4SAP's generic path in float64 (as the port runs
   it) and in float32;
2. the condition number of the 2-mic design's diffuse covariance per band
   (default HRIRs [::16], hop 128): a band above ~1e5 whitens to a noise
   eigenvector float32 cannot resolve, so its DoA is rounding;
3. HADES x 32 (4 blocks of 1024) and the spreader x 32 (8 frames of 512,
   OM) with the filterbank's front and back in two plain orders (the
   kernels' plain versions, ``fused=True`` on CPU tensors, against the
   batched plain filterbank, ``fused=False``): the outputs' and states'
   max |difference| relative to max(1, |plain|), which is what the card's
   kernel-vs-plain comparison can expect at best.

Usage (from the repository root): ``python scripts/chain_precision.py``
(about a minute).
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from spatial_audio_framework_tpu_torch.models import spreader  # noqa: E402
from spatial_audio_framework_tpu_torch.modules import cdf4sap  # noqa: E402
from spatial_audio_framework_tpu_torch.modules import hades, hrir  # noqa: E402


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1.0))


def hds_error(g, float32: bool) -> float:
    """The hds recipe of tests/test_torch_c_goldens.py, max |err| vs C."""
    generic = cdf4sap.formulate_M_and_Cr

    def f32(Cx, Cy, Q, use_energy=False, reg=1e-2):
        # the generic path's recipe in float32 throughout: cast the
        # float64 working copies down before every step by running it on
        # float32 tensors with float32 SVDs
        dt = Cx.dtype
        M, Cr = _generic_f32(Cx.float(), Cy.float(), Q.float(), use_energy,
                             reg)
        return M.to(dt), Cr.to(dt)

    if float32:
        cdf4sap.formulate_M_and_Cr = f32
    try:
        h, d, fs = hrir.default_hrirs()
        ana = hades.HadesAnalysis(
            fs=48000.0, hop=64, h_array=np.asarray(g["hds_h_array"],
                                                   np.float32),
            grid_dirs_deg=np.asarray(g["hds_grid_dirs_deg"], np.float64),
            blocksize=256, hybrid=False, low_delay=True, device="cpu")
        syn = hades.HadesSynthesis(ana, h, d, beam_option="bmvdr",
                                   ref_indices=(1, 5), hrir_fs=fs,
                                   interp_option="nearest")
        x = np.asarray(g["hds_in"], np.float32)
        outs = []
        for blk in range(16):
            params, sigs = ana.apply(x[:, blk * 256:(blk + 1) * 256])
            outs.append(syn.apply(params, sigs))
        ref = np.asarray(g["hds_out_bin"]).reshape(2, -1)
        return float(np.abs(np.concatenate(outs, -1) - ref).max())
    finally:
        cdf4sap.formulate_M_and_Cr = generic


def _generic_f32(Cx, Cy, Q, use_energy, reg):
    """cdf4sap.formulate_M_and_Cr's recipe, every step in float32."""
    def Hm(a):
        return a.transpose(-1, -2)

    U_cy, s_cy, _ = torch.linalg.svd(Cy)
    Ky = U_cy * torch.sqrt(s_cy.clamp_min(2.23e-20))[..., None, :]
    U_cx, s_cx, _ = torch.linalg.svd(Cx)
    s_sqrt = torch.sqrt(s_cx.clamp_min(2.23e-20))
    Kx = U_cx * s_sqrt[..., None, :]
    limit = s_sqrt.amax(-1, keepdim=True) * reg + 2.23e-13
    Kx_reg_inv = (1.0 / torch.maximum(s_sqrt, limit))[..., :, None] * Hm(U_cx)
    g_diag = torch.diagonal(Q @ Cx @ Hm(Q), dim1=-2, dim2=-1)
    g_lim = g_diag.amax(-1, keepdim=True) * 0.001 + 2.23e-13
    cy_diag = torch.diagonal(Cy, dim1=-2, dim2=-1)
    g_hat = torch.sqrt(cy_diag.clamp_min(2.23e-13)
                       / torch.maximum(g_diag, g_lim))
    U, _, Vh = torch.linalg.svd(Hm(Kx) @ Hm(Q) @ (g_hat[..., :, None] * Ky))
    P = Hm(Vh) @ torch.eye(Cy.shape[-1], Cx.shape[-1]) @ Hm(U)
    M = Ky @ P @ Kx_reg_inv
    Cy_tilde = M @ Cx @ Hm(M)
    Cr = Cy - Cy_tilde
    if use_energy:
        gg = torch.sqrt(cy_diag.clamp_min(2.23e-20)
                        / (torch.diagonal(Cy_tilde, dim1=-2, dim2=-1)
                           + 2.23e-7))
        M, Cr = gg[..., :, None] * M, torch.zeros_like(Cr)
    return M, Cr


def two_orders(name: str) -> dict:
    """x 32 instances, two calls: fused=True (the kernels' plain versions
    on CPU tensors) against fused=False (the batched plain filterbank)."""
    rng = np.random.default_rng(0)
    h, d, fs = hrir.default_hrirs()
    if name == "hades":
        ana = hades.HadesAnalysis(device="cpu")
        pipe = hades.HadesPipeline(ana, hades.HadesSynthesis(
            ana, beam_option="bmvdr"))
        init = lambda: pipe.init_state_batched(32)  # noqa: E731
        proc = pipe.process_chunk_batched
        shape = (32, 4, 2, 1024)
        leaves = lambda st: {"Cx_re": st[1][0], "M_re": st[2][0],  # noqa
                             "ola_tail": st[3].ola_tail}
    else:
        cfg = spreader.SpreaderConfig(mode="om")
        w = spreader.design(cfg, device="cpu")
        dirs, spread = torch.tensor([[40.0, 10.0]]), torch.tensor([60.0])
        init = lambda: spreader.init_state(cfg, w, 32, device="cpu")  # noqa
        proc = lambda st, x, fused: spreader.process_chunk(  # noqa: E731
            cfg, w, st, x, dirs, spread, fused=fused)
        shape = (32, 8, 1, 512)
        leaves = lambda st: {"Cproto_re": st.Cproto_re,  # noqa: E731
                             "prev_M_re": st.prev_M_re,
                             "ola_tail": st.bank.ola_tail}
    xs = [torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
          for _ in range(2)]
    out = {}
    st = {True: init(), False: init()}
    for x in xs:
        y = {}
        for fused in (True, False):
            y[fused], st[fused] = proc(st[fused], x, fused=fused)
        out["y"] = max(out.get("y", 0.0), rel(y[True], y[False]))
    for k, v in leaves(st[True]).items():
        out[k] = rel(v, leaves(st[False])[k])
    return out


def main() -> int:
    g = np.load(ROOT / "tests" / "goldens" / "c_goldens.npz")
    print(f"hds vs C, CDF4SAP's generic path in float64: "
          f"{hds_error(g, False):.3e}; in float32: {hds_error(g, True):.3e} "
          f"(budget 5e-4)")
    h, d, _ = hrir.default_hrirs()
    ana = hades.HadesAnalysis(hop=128, h_array=h[::16], grid_dirs_deg=d[::16],
                              device="cpu")
    cond = np.linalg.cond(ana.DCM)
    print(f"2-mic design (default HRIRs [::16]): diffuse covariance "
          f"condition by band: band 0 {cond[0]:.3e}, the rest at most "
          f"{cond[1:].max():.3e}; bands above 1e5: "
          f"{np.nonzero(cond > 1e5)[0].tolist()}")
    for name in ("hades", "spreader"):
        errs = two_orders(name)
        print(f"{name} x 32, front and back in two plain orders, max |diff| "
              "relative to max(1, |plain|): "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
