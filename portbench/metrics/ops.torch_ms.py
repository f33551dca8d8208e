"""ops.torch_ms: device milliseconds a block in operations that are
PyTorch's or a vendor library's (``portbench/kernel_classes.py``)."""


def read(ctx):
    if not ctx.ops or not ctx.blocks:
        return None
    t = sum(e - s for name, s, e in ctx.ops if ctx.is_library(name))
    return t / ctx.blocks / 1e3
