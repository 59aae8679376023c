"""The whole train step's share of the card's bf16 peak, by the host's
clock: model FLOPs (the MLP's products over every point the kernels
evaluate, times 3 for forward and backward, no recompute) of all steps of
the run's untraced window, over the window's time x 989 TFLOP/s. It is
`train_rays_per_s` rescaled by the frozen FLOPs a ray, so it bounds every
kernel's roofline share from above. (The profiler slows the host; the
traced dispatches would read low.)"""
from benchmark.counts import PEAK_BF16_FLOPS


def read(ctx):
    if "steps" not in ctx or "window_model_flop_per_s" not in ctx:
        return None
    return 100.0 * ctx["window_model_flop_per_s"] / PEAK_BF16_FLOPS
