"""Least times ("bounds") of the fused render kernels on one H100, from
operation and byte counts.

    python -m anerf_torch.kernels.roofline

prints the bound of every kernel in PERF.md's table at the flagship
shapes (8 x 256 MLP, multires 7 / 4, framecodes; S = 64 coarse + S = 80
fine). A bound is the larger of the operations over the peak rate of
their type and the bytes over the HBM rate, each input read once and each
output written once. chip_smoke.py takes the counts from here and applies
them to its own run's inputs.
"""
from __future__ import annotations

from ..models.nerf import NeRFConfig

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, non-tensor (data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3


def _mma_layers(ncfg: NeRFConfig):
    """(K, N) of every MMA layer, unpadded: trunk, feature, view."""
    W = ncfg.width
    layers = [(ncfg.dnet_input, W)]
    for i in range(1, ncfg.depth):
        layers.append(((ncfg.dnet_input + W) if (i - 1) in ncfg.skips
                       else W, W))
    return layers + [(W, W), (ncfg.vnet_input, W // 2)]


def mlp_macs_per_point(ncfg: NeRFConfig) -> int:
    """Multiply-adds of the MLP forward per point (K1's tensor-core work,
    and K2's recompute): the MMA layers and the rgb / alpha heads."""
    W = ncfg.width
    return sum(k * n for k, n in _mma_layers(ncfg)) + (W // 2) * 3 + W


def bwd_f32_macs_per_point(ncfg: NeRFConfig) -> int:
    """f32 multiply-adds of K2's cotangent products per point: dX = dY W
    and dW = X^T dY for every MMA layer (layer 0's input gradient
    included: the pose path needs it), the bias sums, and the heads' dW
    and input cotangents."""
    W = ncfg.width
    macs = sum(2 * k * n + n for k, n in _mma_layers(ncfg))
    return macs + 2 * (W // 2) * 3 + 2 * W + 4


def bound_ms(times_s) -> tuple:
    """(bound in ms, 'operations' or 'bytes') from {kind: seconds}, the
    seconds each kind of work takes at its peak; the key 'bytes' names
    the memory time."""
    kind = max(times_s, key=times_s.get)
    return times_s[kind] * 1e3, 'bytes' if kind == 'bytes' else 'operations'


def flagship_bounds(n_rays_fwd: int = 4096, n_rays_bwd: int = 2048):
    """{kernel id: (bound ms, bound_by, what it covers)} at the flagship
    shapes: K1, K3 and K4 on one render bucket of `n_rays_fwd` rays, K2
    on one train step of `n_rays_bwd` rays; both nets, S = 64 + 80."""
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    W = ncfg.width
    n_w = sum(k * n for k, n in _mma_layers(ncfg))          # per net
    n_f32 = (W * (ncfg.depth + 1) + W // 2                  # biases
             + 3 * (W // 2) + W + 4 + 24)                   # heads, cut
    w_bytes = 2 * (2 * n_w + 4 * n_f32)                     # both nets
    ray_bytes = 4 * (3 * 72 + 160)                          # m_all + aux
    view_in = ncfg.vnet_input - W
    P = n_rays_fwd * (64 + 80)
    fwd_ops = 2.0 * mlp_macs_per_point(ncfg) * P / PEAK_BF16_FLOPS
    per_point = {
        'K1': 12 + 16,                          # pts in, raw out
        'K3': 4 * 512 + 16,                     # segment-packed f32 in
        'K4': 2 * (ncfg.dnet_input + view_in) + 16,   # embedded bf16 in
    }
    out = {}
    for kid, b in per_point.items():
        n_bytes = P * b + w_bytes + (2 * n_rays_fwd * ray_bytes
                                     if kid == 'K1' else 0)
        ms, by = bound_ms({'ops': fwd_ops, 'bytes': n_bytes / PEAK_HBM_BYTES})
        out[kid] = (ms, by, f'{n_rays_fwd}-ray bucket')
    Pb = n_rays_bwd * (64 + 80)
    n_grad = 2 * 4 * sum((k + 1) * n for k, n in _mma_layers(ncfg))
    n_bytes = (Pb * (12 + 16 + 12) + 2 * 2 * n_rays_bwd * ray_bytes
               + w_bytes + n_grad)
    out['K2'] = bound_ms({
        'fp32': 2.0 * bwd_f32_macs_per_point(ncfg) * Pb / PEAK_FP32_FLOPS,
        'bf16': 2.0 * mlp_macs_per_point(ncfg) * Pb / PEAK_BF16_FLOPS,
        'bytes': n_bytes / PEAK_HBM_BYTES}) + (
        f'{n_rays_bwd}-ray train step',)
    return out


def main() -> None:
    for kid, (ms, by, what) in sorted(flagship_bounds().items()):
        print(f'{kid}: bound {ms:.4f} ms per {what} ({by})')


if __name__ == '__main__':
    main()
