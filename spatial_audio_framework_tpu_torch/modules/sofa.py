"""SOFA (Spatially Oriented Format for Acoustics) reader/writer
(counterpart of ``spatial_audio_framework_tpu/modules/sofa.py`` and of
``saf_sofa_reader``, including the fork's ``saf_sofa_open_universal``
BRIR/MIMO-SRIR use-cases, saf_sofa_reader.h:79-86,291-294).  Host numpy.

SOFA files are HDF5 (netCDF-4); parsing uses the pure-Python HDF5 reader in
``utils.hdf5`` (the reference likewise vendors its own HDF5 parser via
libmysofa).  The container mirrors ``saf_sofa_container``
(saf_sofa_reader.h:102-240) including the MultiSpeakerBRIR /
SingleRoomMIMOSRIR fields added by the fork.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from spatial_audio_framework_tpu_torch.utils import hdf5 as _h5
from spatial_audio_framework_tpu_torch.utils.geometry import cart2sph

# SAF_SOFA_READER_USECASE (fork, saf_sofa_reader.h:79-86)
USECASE_DEFAULT = "default"
USECASE_HRIR = "hrir"
USECASE_BRIR = "brir"

# SAF_SOFA_ERROR_CODES (saf_sofa_reader.h:242-258)
SAF_SOFA_OK = 0
SAF_SOFA_ERROR_INVALID_FILE_OR_FILE_PATH = 1
SAF_SOFA_ERROR_DIMENSIONS_UNEXPECTED = 2
SAF_SOFA_ERROR_FORMAT_UNEXPECTED = 3
SAF_SOFA_ERROR_NETCDF_IN_USE = 4
SAF_SOFA_ERROR_INVALID_READER_OPTION = 5


class SofaError(RuntimeError):
    def __init__(self, code: int, msg: str):
        super().__init__(msg)
        self.code = code


@dataclass
class SofaContainer:
    """Mirror of saf_sofa_container (saf_sofa_reader.h:102-240)."""
    n_sources: int = -1
    n_receivers: int = -1
    data_length_ir: int = -1
    data_ir: Optional[np.ndarray] = None            # (M, R, N)
    data_sampling_rate: float = -1.0
    data_delay: Optional[np.ndarray] = None
    source_position: Optional[np.ndarray] = None    # (M, 3)
    receiver_position: Optional[np.ndarray] = None  # (R, 3)
    n_listeners: int = -1
    n_emitters: int = -1
    listener_position: Optional[np.ndarray] = None
    listener_up: Optional[np.ndarray] = None
    listener_view: Optional[np.ndarray] = None
    emitter_position: Optional[np.ndarray] = None
    emitter_up: Optional[np.ndarray] = None
    emitter_view: Optional[np.ndarray] = None
    room_temperature: Optional[np.ndarray] = None
    room_volume: Optional[np.ndarray] = None
    room_corner_a: Optional[np.ndarray] = None
    room_corner_b: Optional[np.ndarray] = None
    receiver_view: Optional[np.ndarray] = None
    receiver_up: Optional[np.ndarray] = None
    source_view: Optional[np.ndarray] = None
    source_up: Optional[np.ndarray] = None
    var_attrs: Dict[str, str] = field(default_factory=dict)
    global_attrs: Dict[str, str] = field(default_factory=dict)

    @property
    def source_position_type(self) -> Optional[str]:
        return self.var_attrs.get("SourcePosition:Type")

    def source_dirs_deg(self) -> np.ndarray:
        """Source positions as (azi, elev) degrees (the layout ambi_bin etc.
        consume, ambi_bin.c:228-230)."""
        if self.source_position is None:
            raise SofaError(SAF_SOFA_ERROR_DIMENSIONS_UNEXPECTED,
                            "SOFA file has no SourcePosition dataset")
        sp = np.asarray(self.source_position)
        if (self.source_position_type or "spherical").startswith("cart"):
            sph = np.asarray(cart2sph(sp, degrees=True))
            return sph[:, :2]
        return sp[:, :2]


_DATASET_MAP = {
    "Data.IR": "data_ir",
    "Data.Delay": "data_delay",
    "SourcePosition": "source_position",
    "ReceiverPosition": "receiver_position",
    "ListenerPosition": "listener_position",
    "ListenerUp": "listener_up",
    "ListenerView": "listener_view",
    "EmitterPosition": "emitter_position",
    "EmitterUp": "emitter_up",
    "EmitterView": "emitter_view",
    "RoomTemperature": "room_temperature",
    "RoomVolume": "room_volume",
    "RoomCornerA": "room_corner_a",
    "RoomCornerB": "room_corner_b",
    "ReceiverView": "receiver_view",
    "ReceiverUp": "receiver_up",
    "SourceView": "source_view",
    "SourceUp": "source_up",
}


def sofa_open(path: str, usecase: str = USECASE_DEFAULT) -> SofaContainer:
    """Load a SOFA file (saf_sofa_open / the fork's saf_sofa_open_universal).

    usecase 'hrir' enforces 2 receivers; 'brir' additionally expects
    MultiSpeakerBRIR/SingleRoomMIMOSRIR conventions (the fork requires the
    NetCDF reader for this — here one code path handles both)."""
    try:
        root = _h5.read_hdf5(path)
    except (OSError, ValueError) as e:
        raise SofaError(SAF_SOFA_ERROR_INVALID_FILE_OR_FILE_PATH, str(e))
    c = SofaContainer()
    c.global_attrs = {k: v for k, v in root.attrs.items()
                      if isinstance(v, str)}
    if c.global_attrs.get("Conventions", "SOFA") not in ("SOFA",):
        raise SofaError(SAF_SOFA_ERROR_FORMAT_UNEXPECTED, "not a SOFA file")
    for name, ds in root.datasets.items():
        if name == "Data.SamplingRate":
            c.data_sampling_rate = float(np.ravel(ds.data)[0])
            continue
        attr = _DATASET_MAP.get(name)
        if attr is not None:
            setattr(c, attr, np.asarray(ds.data, np.float32))
        for ak, av in ds.attrs.items():
            if isinstance(av, str):
                c.var_attrs[f"{name}:{ak}"] = av
    if c.data_ir is not None:
        if c.data_ir.ndim == 2:
            c.data_ir = c.data_ir[:, None, :]
        c.n_sources = c.data_ir.shape[0]
        c.n_receivers = c.data_ir.shape[1]
        c.data_length_ir = c.data_ir.shape[-1]
    else:
        raise SofaError(SAF_SOFA_ERROR_DIMENSIONS_UNEXPECTED, "no Data.IR")
    if c.listener_position is not None:
        c.n_listeners = np.atleast_2d(c.listener_position).shape[0]
    if c.emitter_position is not None:
        c.n_emitters = np.atleast_2d(c.emitter_position).shape[0]
    if usecase == USECASE_HRIR and c.n_receivers != 2:
        raise SofaError(SAF_SOFA_ERROR_DIMENSIONS_UNEXPECTED,
                        "HRIR use-case requires exactly 2 receivers")
    if usecase == USECASE_BRIR:
        conv = c.global_attrs.get("SOFAConventions", "")
        if conv not in ("MultiSpeakerBRIR", "SingleRoomMIMOSRIR", "GeneralFIR",
                        "GeneralFIR-E"):
            raise SofaError(SAF_SOFA_ERROR_INVALID_READER_OPTION,
                            f"convention '{conv}' not valid for BRIR use-case")
    return c


def sofa_save(path: str, data_ir: np.ndarray, fs: float,
              source_position: np.ndarray,
              receiver_position: Optional[np.ndarray] = None,
              conventions: str = "SimpleFreeFieldHRIR",
              position_type: str = "spherical",
              extra_global_attrs: Optional[dict] = None):
    """Write a minimal valid SOFA file (fixture/export helper).

    data_ir: (M, R, N); source_position: (M, 3) in (azi, elev, r) degrees when
    position_type='spherical'."""
    w = _h5.HDF5Writer()
    w.add_root_attr("Conventions", "SOFA")
    w.add_root_attr("SOFAConventions", conventions)
    w.add_root_attr("Version", "2.1")
    w.add_root_attr("DataType", "FIR")
    for k, v in (extra_global_attrs or {}).items():
        w.add_root_attr(k, v)
    units = "degree, degree, metre" if position_type == "spherical" else "metre"
    w.add_dataset("Data.IR", np.asarray(data_ir, np.float64))
    w.add_dataset("Data.SamplingRate", np.asarray([fs], np.float64),
                  attrs={"Units": "hertz"})
    w.add_dataset("SourcePosition", np.asarray(source_position, np.float64),
                  attrs={"Type": position_type, "Units": units})
    if receiver_position is None:
        receiver_position = np.zeros((data_ir.shape[1], 3))
    w.add_dataset("ReceiverPosition", np.asarray(receiver_position, np.float64),
                  attrs={"Type": "cartesian", "Units": "metre"})
    w.add_dataset("ListenerPosition", np.zeros((1, 3)),
                  attrs={"Type": "cartesian", "Units": "metre"})
    w.add_dataset("ListenerUp", np.array([[0.0, 0.0, 1.0]]))
    w.add_dataset("ListenerView", np.array([[1.0, 0.0, 0.0]]))
    w.save(path)
