"""kernels.host_ms: host milliseconds a block inside the program's
``kernels.*`` spans, each kernel wrapper from entry to return (checks,
output allocation, the launch): the program's counter
``kernels.host_ns``, over the traced blocks."""
from portbench.counters import per_block


def read(ctx):
    return per_block(ctx, "kernels.host_ns", 1e-6)
