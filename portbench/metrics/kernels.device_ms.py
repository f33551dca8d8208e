"""kernels.device_ms: device milliseconds a block in every operation that
is not PyTorch's or a vendor library's (``portbench/kernel_classes.py``):
the program's own kernels, whatever their names."""


def read(ctx):
    if not ctx.ops or not ctx.blocks:
        return None
    t = sum(e - s for name, s, e in ctx.ops if not ctx.is_library(name))
    return t / ctx.blocks / 1e3
