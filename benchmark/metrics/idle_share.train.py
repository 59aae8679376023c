"""The share of a traced train window in which no operation ran on the
card: 1 - (union of device activity) / the window."""


def read(ctx):
    if "steps" not in ctx:
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
