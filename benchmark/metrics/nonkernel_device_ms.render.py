"""Device milliseconds a 4096-ray bucket of every operation outside K1:
the ray batch (ray grid, near / far, sampling, compositing, importance
merge) and the copies of a request."""


def read(ctx):
    if "buckets" not in ctx or not ctx["buckets"]:
        return None
    s = sum(v for k, v in ctx["owner_s"].items() if k != "K1")
    return 1e3 * s / ctx["buckets"]
