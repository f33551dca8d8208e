"""device.idle_pct: the share in % of the traced window (the first
``models.process`` span's start to the last device operation's end) in
which no device operation ran."""


def read(ctx):
    if not ctx.ops or ctx.window_s <= 0:
        return None
    return 100.0 * (ctx.window_s - ctx.busy_s) / ctx.window_s
