"""Device milliseconds a train step of every operation that is neither
K1 nor K2: the ray batch (near / far, sampling, compositing), FK, the
losses, autograd's own kernels, both Adams and the uploads."""


def read(ctx):
    if "steps" not in ctx or not ctx["steps"]:
        return None
    return 1e3 * ctx["owner_s"].get(None, 0.0) / ctx["steps"]
