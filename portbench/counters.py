"""The program's own counters (``utils/profiling.counters()`` of the port:
kept only while a profiler records, so over the traced blocks alone) as a
per-layer metric's value a block.  A program without them gives None."""
from __future__ import annotations


def per_block(ctx, name: str, scale: float):
    """Counter ``name`` over the traced blocks, times ``scale``; None if
    the program keeps no counters or no block was traced."""
    from spatial_audio_framework_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or not ctx.blocks:
        return None
    return counters().get(name, 0) / ctx.blocks * scale
