"""ops.launches: device operations (kernels, copies, fills) launched a
block, from the profiler's device trace of the traced blocks."""


def read(ctx):
    if not ctx.ops or not ctx.blocks:
        return None
    return len(ctx.ops) / ctx.blocks
