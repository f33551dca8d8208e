"""render_roofline: the least time a block's work needs, its bytes
(``portbench/work_bytes.py``) over the card's memory bandwidth
(``portbench/peaks.json``), as a share in % of the device's busy time a
block (the union of every operation the traced blocks launched).  The
work is bytes-bound: its operations over the fp32 peak take less."""


def read(ctx):
    if not ctx.ops or not ctx.blocks or ctx.peak is None or ctx.busy_s <= 0:
        return None
    least_s = ctx.work_bytes / ctx.peak["hbm_bytes_per_s"]
    return 100.0 * least_s / (ctx.busy_s / ctx.blocks)
