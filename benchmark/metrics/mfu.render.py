"""The requests' share of the card's bf16 peak, by the host's clock:
model FLOPs (the MLP's forward products over every point of the box
rays) of all requests of the run's untraced window, over the window's
time x 989 TFLOP/s. It is `render_box_rays_per_s` rescaled by the frozen
FLOPs a box ray. (The profiler slows the host; the traced requests would
read low.)"""
from benchmark.counts import PEAK_BF16_FLOPS


def read(ctx):
    if "buckets" not in ctx or "window_model_flop_per_s" not in ctx:
        return None
    return 100.0 * ctx["window_model_flop_per_s"] / PEAK_BF16_FLOPS
