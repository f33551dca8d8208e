"""BRIR processing (counterpart of
``spatial_audio_framework_tpu/modules/brir.py``; the fork's ``saf_brir``
module, framework/modules/saf_brir/saf_brir.h).

The fork's saf_brir is an API-identical clone of saf_hrir (estimateITDs,
HRIRs2HRTFs_afSTFT, diffuseFieldEqualiseHRTFs, interpHRTFs,
binauralDiffuseCoherence, resampleHRIRs) specialised in name only for
binaural *room* impulse responses; here it re-exports the same
implementations from :mod:`spatial_audio_framework_tpu_torch.modules.hrir`.
"""
from spatial_audio_framework_tpu_torch.modules.hrir import (  # noqa: F401
    binaural_diffuse_coherence,
    default_hrirs,
    diffuse_field_equalise_hrtfs,
    estimate_itds,
    hrirs_to_hrtfs,
    hrirs_to_hrtfs_afstft,
    interp_hrtfs,
    resample_hrirs,
)

__all__ = [
    "binaural_diffuse_coherence", "default_hrirs",
    "diffuse_field_equalise_hrtfs", "estimate_itds", "hrirs_to_hrtfs",
    "hrirs_to_hrtfs_afstft", "interp_hrtfs", "resample_hrirs",
]
