"""K1's share of its bound in a traced train window: the frozen
bound of both passes of every step (counts.k1_bound_s) over the device
time of the kernels K1 launched (the forward of FusedApply)."""


def read(ctx):
    t = ctx.get("owner_s", {}).get("K1")
    if "steps" not in ctx or not t:
        return None
    return 100.0 * ctx["k1_bound_s"] / t
