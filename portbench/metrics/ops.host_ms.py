"""ops.host_ms: host milliseconds a block inside the program's ``ops.*``
spans (the routes, the decode taps, the input tail, the HRTF glue) and
outside the ``kernels.*`` spans nested in them: the program's counter
``ops.host_ns``, over the traced blocks."""
from portbench.counters import per_block


def read(ctx):
    return per_block(ctx, "ops.host_ns", 1e-6)
