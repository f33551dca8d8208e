"""models.enqueue_ms: host milliseconds a block inside the calls into the
program's entry (the benchmark's ``models.process`` span around each
``process_ri_batched``), over the traced blocks."""


def read(ctx):
    spans = [e - s for name, s, e in ctx.spans if name == "models.process"]
    if not spans or not ctx.blocks:
        return None
    return sum(spans) / ctx.blocks / 1e3
