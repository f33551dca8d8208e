"""ops.spectra_bytes: MB a block of spectra written between the wide
route's two kernels (``analysis_front_ri`` → hybrid stage → per-band mix →
``synthesis_back_ri``): the program's counter ``ops.spectra_bytes``, over
the traced blocks.  A program that keeps no such counter gives None."""
from portbench.counters import per_block


def read(ctx):
    from spatial_audio_framework_tpu_torch.utils import profiling

    counters = getattr(profiling, "counters", None)
    if counters is None or "ops.spectra_bytes" not in counters():
        return None
    return per_block(ctx, "ops.spectra_bytes", 1e-6)
