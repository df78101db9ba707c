"""``device_idle_share.fit``: 1 - (union of kernel and copy intervals /
the traced window) over one profiled steady EM iteration, in percent."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "fit" or tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
