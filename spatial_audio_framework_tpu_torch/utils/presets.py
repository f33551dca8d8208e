"""Loudspeaker-layout / sensor-array / spherical-grid preset tables
(counterpart of ``spatial_audio_framework_tpu/utils/presets.py``).

The tables of ``saf_utility_loudspeaker_presets.h`` and
``saf_utility_sensorarray_presets.h`` — t-designs, sphere coverings,
geodesic spheres, standard and measured loudspeaker layouts, commercial
microphone-array geometries — read from the data file shared with the JAX
package (``data/presets.npz``, by path).
"""
from __future__ import annotations

import functools

import numpy as np

from spatial_audio_framework_tpu_torch import data_path


@functools.lru_cache(maxsize=None)
def _tables() -> dict:
    with np.load(data_path("presets.npz")) as z:
        return {k: z[k].copy() for k in z.keys()}


def get_table(name: str) -> np.ndarray:
    """Raw table access by reference symbol name (without leading __)."""
    return _tables()[name]


def tdesign(degree: int) -> np.ndarray:
    """Spherical t-design directions (deg): degrees 1..21, 30, 40, ..., 100,
    124 (saf_utility_loudspeaker_presets.h __Tdesign_degree_N_dirs_deg)."""
    t = _tables()
    key = f"Tdesign_degree_{degree}_dirs_deg"
    if key not in t:
        raise KeyError(f"no t-design of degree {degree}")
    return t[key]


def tdesign_n_points(degree: int) -> int:
    """Number of points for degrees 1..21 (__Tdesign_nPoints_per_degree)."""
    return int(_tables()["Tdesign_nPoints_per_degree"][degree - 1])


def sphere_covering(n_points: int) -> np.ndarray:
    """Minimal sphere covering with n_points in 4..64 (deg)."""
    return _tables()[f"SphCovering_{n_points}_dirs_deg"]


def geosphere(level: int, icosahedral: bool = True) -> np.ndarray:
    """Geodesic sphere directions (deg), levels 0..16."""
    kind = "ico" if icosahedral else "oct"
    return _tables()[f"geosphere_{kind}_{level}_0_dirs_deg"]


# Mapping of reference LOUDSPEAKER_ARRAY_PRESETS (_common.h:97-129) to tables.
_LS_PRESETS = {
    "mono": "mono_dirs_deg",
    "stereo": "stereo_dirs_deg",
    "5.x": "5pX_dirs_deg",
    "7.x": "7pX_dirs_deg",
    "8.x": "8pX_dirs_deg",
    "9.x": "9pX_dirs_deg",
    "10.x": "10pX_dirs_deg",
    "11.x": "11pX_dirs_deg",
    "11.x_7_4": "11pX_7_4_dirs_deg",
    "13.x": "13pX_dirs_deg",
    "22.x": "22pX_dirs_deg",
    "9+10+3.2": "9_10_3p2_dirs_deg",
    "aalto_mcc": "Aalto_MCC_dirs_deg",
    "aalto_mcc_subset": "Aalto_MCCsubset_dirs_deg",
    "aalto_apaja": "Aalto_Apaja_dirs_deg",
    "aalto_lr": "Aalto_LR_dirs_deg",
    "dtu_avil": "DTU_AVIL_dirs_deg",
    "zylia_lab": "Zylia_Lab_dirs_deg",
}


def loudspeaker_preset(name: str) -> np.ndarray:
    """Loudspeaker layout directions (azi, elev) in degrees."""
    return _tables()[_LS_PRESETS[name.lower()]]


def loudspeaker_preset_names() -> list[str]:
    return list(_LS_PRESETS)


# Microphone-array presets (saf_utility_sensorarray_presets.h; MIC_PRESETS
# _common.h:88-94), sensor directions in radians.
_MIC_PRESETS = {
    "zylia": "Zylia1D_coords_rad",
    "eigenmike32": "Eigenmike32_coords_rad",
    "eigenmike64": "Eigenmike64_coords_rad",
    "dtu_mic": "DTU_mic_coords_rad",
    "aalto_hydrophone": "Aalto_Hydrophone_coords_rad",
    "sennheiser_ambeo": "Sennheiser_Ambeo_coords_rad",
    "core_sound_tetramic": "Core_Sound_TetraMic_coords_rad",
    "sound_field_sps200": "Sound_field_SPS200_coords_rad",
    "zoom_h3vr": "Zoom_H3VR_coords_rad",
}

# SH-order usable frequency ranges per array (e.g. __Zylia_freqRange).
_MIC_FREQ_RANGES = {
    "zylia": "Zylia_freqRange",
    "eigenmike32": "Eigenmike32_freqRange",
    "dtu_mic": "DTU_mic_freqRange",
}


def mic_preset(name: str) -> np.ndarray:
    """Sensor directions in radians, shape (nSensors, 2)."""
    return _tables()[_MIC_PRESETS[name.lower()]]


def mic_preset_freq_range(name: str) -> np.ndarray:
    return _tables()[_MIC_FREQ_RANGES[name.lower()]]


def mic_preset_names() -> list[str]:
    return list(_MIC_PRESETS)


def default_ls_coords64() -> np.ndarray:
    return _tables()["default_LScoords64_rad"]


def default_sensor_coords64() -> np.ndarray:
    return _tables()["default_SENSORcoords64_rad"]
