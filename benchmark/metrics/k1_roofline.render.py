"""K1's share of its bound in a traced render window: the frozen
bound of both passes of every 4096-ray bucket (counts.k1_bound_s) over
the device time of K1's kernels, found by name (no autograd range
holds them on the no-grad render path)."""


def read(ctx):
    t = ctx.get("owner_s", {}).get("K1")
    if "buckets" not in ctx or not t:
        return None
    return 100.0 * ctx["k1_bound_s"] / t
