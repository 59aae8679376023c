"""The share of a traced render window in which no operation ran on the
card; its gaps are the bucket loop's and render_path's host work."""


def read(ctx):
    if "buckets" not in ctx:
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
