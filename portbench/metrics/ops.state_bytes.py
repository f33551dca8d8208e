"""ops.state_bytes: MB a block written by the copies the ops layer makes to
carry state (the 15-hop input tail) or to lay inputs out densely for a
kernel: the program's counter ``ops.state_bytes``, over the traced
blocks."""
from portbench.counters import per_block


def read(ctx):
    return per_block(ctx, "ops.state_bytes", 1e-6)
