"""K2's share of its bound in a traced train window: the frozen bound of
the backward work of every step (counts.k2_bound_s) over the device time
of the kernels K2 launched (the backward of FusedApply)."""


def read(ctx):
    t = ctx.get("owner_s", {}).get("K2")
    if "k2_bound_s" not in ctx or not t:
        return None
    return 100.0 * ctx["k2_bound_s"] / t
