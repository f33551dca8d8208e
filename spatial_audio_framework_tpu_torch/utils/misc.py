"""Miscellaneous helpers (counterpart of
``spatial_audio_framework_tpu/utils/misc.py``, ``saf_utility_misc``).
Only what the ported models use so far."""
from __future__ import annotations

import warnings


def saf_print_warning(msg: str) -> None:
    """Debug warning print (saf_utilities.h:120-142 ``saf_print_warning``)."""
    warnings.warn(f"SAF WARNING: {msg}", stacklevel=2)
