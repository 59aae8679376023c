"""Frozen work counts of the A-NeRF network and the least time ("bound")
of its kernels on one NVIDIA H100 SXM.

The counts depend on the network and the inputs alone, never on how a
kernel is built: K2's cotangent products are counted once, at the bf16
peak, whatever split or precision implements them, and the forward that
K2 recomputes is not counted. So no design can read above 100% of its
bound. A bound is the larger of the operations at their type's peak and
the HBM bytes at 3.35 TB/s, each input read once and each output written
once. fp32 work outside the tensor cores is counted in FLOP at 67
TFLOP/s (an FMA is 2 FLOP; a special-function instruction 16); the
transcendental costs are estimates of what each call compiles to.
"""
from __future__ import annotations

import dataclasses

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, non-tensor (data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3

N_JOINTS, C72 = 24, 72
SINCOSF_FLOP = 40               # accurate sincosf: reduction + polynomials
WINDOW_FLOP = 40                # 1 / (1 + expf(.)): ex2, rcp, ~8 FMA
SQRT_DIV_FLOP = 40              # sqrtf and a divide


@dataclasses.dataclass(frozen=True)
class Net:
    """One A-NeRF MLP: trunk `depth` x `width` with a skip after each layer
    in `skips`, PE bands `nfk` (joint distances) and `nfv` (view
    directions), `fc` framecode columns."""
    width: int = 256
    depth: int = 8
    skips: tuple = (4,)
    nfk: int = 7
    nfv: int = 4
    fc: int = 16

    @property
    def dnet_input(self) -> int:
        return N_JOINTS * (1 + 2 * self.nfk) + C72

    @property
    def vnet_input(self) -> int:
        return C72 * (1 + 2 * self.nfv) + self.fc + self.width


def net_of(cfg: dict) -> Net:
    """The Net of a configuration file's `train_config`."""
    t = cfg['train_config']
    return Net(width=t['netwidth'], depth=t['netdepth'], nfk=t['multires'],
               nfv=t['multires_views'],
               fc=t['framecode_size'] if t['opt_framecode'] else 0)


def mma_layers(n: Net):
    """(K, N) of every matrix product of the forward: trunk, feature,
    view."""
    W = n.width
    layers = [(n.dnet_input, W)]
    for i in range(1, n.depth):
        layers.append(((n.dnet_input + W) if (i - 1) in n.skips else W, W))
    return layers + [(W, W), (n.vnet_input, W // 2)]


def mlp_macs_per_point(n: Net) -> int:
    """Multiply-adds of the MLP forward per point: the products and the
    rgb / alpha heads."""
    W = n.width
    return sum(k * m for k, m in mma_layers(n)) + (W // 2) * 3 + W


def bwd_macs_per_point(n: Net) -> int:
    """Multiply-adds of the MLP backward per point: dX = dY W^T and
    dW = X^T dY of every product (layer 0's dX too: the pose path needs
    it), the bias sums, the heads' dW and input cotangents."""
    W = n.width
    macs = sum(2 * k * m + m for k, m in mma_layers(n))
    return macs + 2 * (W // 2) * 3 + 2 * W + 4


def transform_flop_per_point() -> int:
    """Per joint: 3 rotated coordinates, a sum of squares, sqrt and
    divide, 3 unit-direction multiplies."""
    return N_JOINTS * (3 * 6 + 6 + SQRT_DIV_FLOP + 3)


def pe_flop_per_point(n: Net) -> int:
    """The cutoff PE per point: per joint a window and per band a sin /
    cos pair with its window products; per view channel the same."""
    band = SINCOSF_FLOP + 4
    return (N_JOINTS * (WINDOW_FLOP + 1 + n.nfk * band)
            + C72 * (1 + n.nfv * band))


def pe_bwd_flop_per_point(n: Net) -> int:
    """The PE's and the transform's backward per point, without the
    forward geometry: per kp band a sin / cos pair and 4 FMA, per view
    band 4 FMA, the window derivative, the normalize and sqrt cotangents,
    dpts and the per-ray sums."""
    return (N_JOINTS * (WINDOW_FLOP + 4 + n.nfk * (SINCOSF_FLOP + 8) + 6)
            + C72 * (2 + n.nfv * 8)
            + N_JOINTS * 26 + 2 * 2 * 3 * C72 + 2 * C72)


def ray_bytes(n: Net) -> int:
    """One ray's per-ray operands (3 x 72 rotation columns, 72 + 72 + fc
    translations, view directions and framecode) in f32."""
    return 4 * (3 * C72 + 2 * C72 + max(n.fc, 16))


def net_bytes(n: Net) -> int:
    """One network's weights: bf16 products, f32 biases and heads, the
    cutoff distances."""
    W = n.width
    n_f32 = W * (n.depth + 1) + W // 2 + 3 * (W // 2) + W + 4 + N_JOINTS
    return 2 * sum(k * m for k, m in mma_layers(n)) + 4 * n_f32


def grad_bytes(n: Net) -> int:
    """One network's f32 weight gradients."""
    W = n.width
    return 4 * (sum((k + 1) * m for k, m in mma_layers(n))
                + (W // 2 + 1) * 3 + W + 1)


def _bound(times: dict) -> float:
    return max(times.values())


def k1_bound_s(n: Net, n_rays: int, S: int) -> float:
    """K1 on n_rays rays of S points: points in (12 B), raw out (16 B),
    per-ray operands and weights in; MLP products at the bf16 peak, the
    transform and PE at the fp32 peak."""
    P = n_rays * S
    return _bound({
        'bf16': 2.0 * mlp_macs_per_point(n) * P / PEAK_BF16_FLOPS,
        'fp32': (transform_flop_per_point() + pe_flop_per_point(n)) * P
        / PEAK_FP32_FLOPS,
        'bytes': (28 * P + n_rays * ray_bytes(n) + net_bytes(n))
        / PEAK_HBM_BYTES})


def k2_bound_s(n: Net, n_rays: int, S: int) -> float:
    """K2 (the backward of K1) on n_rays rays of S points: its products
    once at the bf16 peak, the PE and transform backward at the fp32 peak;
    points, cotangents (16 B), per-ray operands and weights in, the
    weight gradients, dpts (12 B) and the per-ray cotangents out. The
    forward it recomputes is not counted."""
    P = n_rays * S
    return _bound({
        'bf16': 2.0 * bwd_macs_per_point(n) * P / PEAK_BF16_FLOPS,
        'fp32': pe_bwd_flop_per_point(n) * P / PEAK_FP32_FLOPS,
        'bytes': ((12 + 16 + 12) * P + 2 * n_rays * ray_bytes(n)
                  + net_bytes(n) + grad_bytes(n)) / PEAK_HBM_BYTES})


def passes(cfg: dict):
    """[(S, net)] of one ray's MLP calls: the coarse pass at N_samples and
    the fine one, on the coarse ++ importance samples with two networks,
    on the importance samples alone with one ('single_net')."""
    t = cfg['train_config']
    s, i = t['N_samples'], t['N_importance']
    if not i:
        return [(s, 'coarse')]
    if t.get('single_net'):
        return [(s, 'coarse'), (i, 'coarse')]
    return [(s, 'coarse'), (s + i, 'fine')]


def points_per_ray(cfg: dict) -> int:
    return sum(S for S, _ in passes(cfg))


def model_flop_per_ray(cfg: dict, train: bool) -> float:
    """Model FLOPs of one ray: the MLP's products over the points the
    kernels evaluate, times 3 in training (the backward is twice the
    forward; no recompute)."""
    f = 2.0 * mlp_macs_per_point(net_of(cfg)) * points_per_ray(cfg)
    return 3.0 * f if train else f
