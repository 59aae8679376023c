"""Least times ("bounds") of the fused render kernels on one H100, from
operation and byte counts.

    python -m anerf_torch.kernels.roofline

prints the bound of every kernel in PERF.md's table at the flagship
shapes (8 x 256 MLP, multires 7 / 4, framecodes; S = 64 coarse + S = 80
fine; K1 and both flavours of K2 also at the culled shapes, S = 8 + 24),
then K1, K3, K4 and K2 at the other shapes the fused kernels take
(`config_bounds`: any width, depth, skips, input and framecode width),
and of every stage of K1-d and K2-d at the kernel_bench tool's 2048
rays; then, beside K1's operations bound, the bytes of weights K1-v1
and K1 read from L2 per launch (not part of any bound: L2 traffic is
what the two designs differ in), and beside K2's the bytes its
layer-by-layer design moves through HBM in a train step and its old
fp32-FMA bound (history). A bound is the larger of the operations
over the peak rate of their type and the bytes over the HBM rate, each
input read once and each output written once. chip_smoke.py takes the
counts from here and applies them to its own run's inputs.

K2's cotangent products are counted at the rate of the least arithmetic
that keeps f32 accuracy: one operand of each is exactly bf16 and the f32
cotangent splits exactly into SPLIT_PASSES bf16 terms, so they are that
many bf16 products at the bf16 peak (K2-v1 ran them as f32 FMAs). K2's
bf16 flavour (bwd_f32=False) rounds the cotangent to bf16: one pass.
fp32 work outside the tensor cores is counted in FLOP at the 67 TFLOP/s
peak (an FMA is 2 FLOP). An instruction of the special function unit
(MUFU: ex2, rcp, rsqrt, sin, cos) counts 16 FLOP: an SM executes 16 of
them a clock against 128 FMAs. The transcendental costs below are
estimates of the instructions each call compiles to at these arguments;
bf16 conversions, integer index arithmetic and shared-memory traffic are
not counted.
"""
from __future__ import annotations

from ..models.nerf import NeRFConfig

PEAK_BF16_FLOPS = 989e12        # H100 SXM dense bf16 (data sheet)
PEAK_FP32_FLOPS = 67e12         # H100 SXM fp32, non-tensor (data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM HBM3

#: accurate sincosf for |x| < 105615 (the PE's angles stay below 2^7 x
#: a distance of a few units): a three-part Cody-Waite reduction (3 FMA),
#: two minimax polynomials (about 7 FMA each), a quadrant select
SINCOSF_FLOP = 40
#: __sincosf: MUFU.SIN and MUFU.COS after one range-scaling multiply
FAST_SINCOSF_FLOP = 34
#: the pe_notrig stand-in x / 2 - 0.124 x^2, 1 - 0.437 x^2
STANDIN_SINCOS_FLOP = 6
#: the window 1 / (1 + expf(tau (v - cut))): expf (MUFU.EX2 and about 4
#: FMA) and a correctly rounded divide (MUFU.RCP and about 4 FMA)
WINDOW_FLOP = 40
#: sqrtf(v^2) and 1 / v of the geometry, the same way
SQRT_DIV_FLOP = 40
N_JOINTS, C72, FC = 24, 72, 16


def ray_bytes(fc: int = FC) -> int:
    """Bytes of one ray's K1 operands: m_all (3 x 72) and aux (144 + fc)
    f32."""
    return 4 * (3 * C72 + 2 * C72 + fc)
#: points per CTA of K1-v1 and K1, and CTAs per cluster of K1 (its
#: weight copies are multicast to the cluster): csrc/fused_render_common.cuh
#: TM, csrc/fused_render_sm90.cu CL
K1_TM = 64
K1_CLUSTER = 2
#: K1's weight image pads each input segment to a multiple of this
SLICE_K = 64


def _mma_layers(ncfg: NeRFConfig):
    """(K, N) of every MMA layer, unpadded: trunk, feature, view."""
    W = ncfg.width
    layers = [(ncfg.dnet_input, W)]
    for i in range(1, ncfg.depth):
        layers.append(((ncfg.dnet_input + W) if (i - 1) in ncfg.skips
                       else W, W))
    return layers + [(W, W), (ncfg.vnet_input, W // 2)]


def weight_elems(ncfg: NeRFConfig, pad: int) -> int:
    """bf16 elements of one network's MMA weight blocks with each input
    segment (the density input, the trunk width, the view input) padded
    to a multiple of `pad`: 16 for the fragment-order 'w' that K1-v1
    reads, SLICE_K for K1's image."""
    W = ncfg.width
    up = lambda n: -(-n // pad) * pad
    k0, kv = up(ncfg.dnet_input), up(ncfg.vnet_input - W)
    blocks = [(k0, W)]
    for i in range(1, ncfg.depth):
        blocks.append(((k0 + W) if (i - 1) in ncfg.skips else W, W))
    blocks += [(W, W), (W + kv, W // 2)]
    return sum(k * n for k, n in blocks)


def l2_weight_bytes(ncfg: NeRFConfig, n_points: int, pad: int,
                    tm: int = K1_TM, cluster: int = 1) -> int:
    """Bytes of weights one launch reads from L2 on n_points points when
    each cluster of `cluster` CTAs of `tm` points reads every weight
    once (K1-v1: tm 64, no cluster; K1: tm 64, K1_CLUSTER, whole
    clusters)."""
    n_clusters = -(-(-(-n_points // tm)) // cluster)
    return n_clusters * 2 * weight_elems(ncfg, pad)


def mlp_macs_per_point(ncfg: NeRFConfig) -> int:
    """Multiply-adds of the MLP forward per point (K1's tensor-core work,
    and K2's recompute): the MMA layers and the rgb / alpha heads."""
    W = ncfg.width
    return sum(k * n for k, n in _mma_layers(ncfg)) + (W // 2) * 3 + W


#: bf16 terms of an f32 cotangent (hi + mid + lo): K2's passes per product
SPLIT_PASSES = 3


def bwd_f32_macs_per_point(ncfg: NeRFConfig) -> int:
    """f32 multiply-adds of K2's cotangent products per point: dX = dY W
    and dW = X^T dY for every MMA layer (layer 0's input gradient
    included: the pose path needs it), the bias sums, and the heads' dW
    and input cotangents."""
    W = ncfg.width
    macs = sum(2 * k * n + n for k, n in _mma_layers(ncfg))
    return macs + 2 * (W // 2) * 3 + 2 * W + 4


def transform_flop_per_point() -> int:
    """K1's geometry per point: per joint 3 rotated coordinates (a
    multiply, 2 FMA, an add), the sum of squares (3 FMA), sqrt and
    divide, 3 unit-direction multiplies."""
    return N_JOINTS * (3 * 6 + 6 + SQRT_DIV_FLOP + 3)


def pe_flop_per_point(nfk: int, nfv: int,
                      sincos_flop: int = SINCOSF_FLOP) -> int:
    """The cutoff PE per point after the geometry: per joint the window
    and the windowed v, per kp band an angle, a sin / cos pair, two
    window products and the next frequency; per view channel the same
    over nfv bands (the view bands are computed per point, as K1 does)."""
    band = sincos_flop + 4
    return (N_JOINTS * (WINDOW_FLOP + 1 + nfk * band)
            + C72 * (1 + nfv * band))


def pe_bwd_flop_per_point(nfk: int, nfv: int) -> int:
    """K2's cutoff-PE backward per point (pe_transform_bwd_kernel up to
    the window derivative): the geometry and window again, per kp band a
    sin / cos pair and 4 FMA, per view band 4 FMA (the view bands' sin /
    cos are per ray), the window derivative."""
    return (transform_flop_per_point()
            + N_JOINTS * (WINDOW_FLOP + 4 + nfk * (SINCOSF_FLOP + 8) + 6)
            + C72 * (2 + nfv * 8))


def transform_bwd_flop_per_point() -> int:
    """K2's transform backward per point: per joint the normalize and
    sqrt cotangents (about 13 FMA), then dpts (3 x 72 FMA) and the point's
    share of the per-ray sums of dm_all (3 x 72 FMA) and daux (2 x 72
    adds)."""
    return N_JOINTS * 26 + 2 * 2 * 3 * C72 + 2 * C72


def bound_ms(times_s) -> tuple:
    """(bound in ms, 'operations' or 'bytes') from {kind: seconds}, the
    seconds each kind of work takes at its peak; the key 'bytes' names
    the memory time."""
    kind = max(times_s, key=times_s.get)
    return times_s[kind] * 1e3, 'bytes' if kind == 'bytes' else 'operations'


def act_bytes_per_point(ncfg: NeRFConfig, k0p: int, kvp: int) -> int:
    """K2's saved bf16 MLP inputs and activations per point (its recompute
    pads the two inputs to 64 columns)."""
    W = ncfg.width
    up = lambda n: -(-n // SLICE_K) * SLICE_K
    return 2 * (up(k0p) + up(kvp) + (ncfg.depth + 1) * W + W // 2)


def k1d_stage_seconds(stage: str, ncfg: NeRFConfig, nfk: int, nfv: int,
                      n_points: int, n_rays: int, w_bytes: int) -> dict:
    """{kind: seconds at its peak} of one K1-d launch at `stage` on
    n_points points of n_rays rays (w_bytes: the packed operands): it
    reads the points and the per-ray operands (and, at 'full', the
    weights) and writes 4 floats a point."""
    fp32 = transform_flop_per_point()
    if stage != 'transform':
        trig = {'pe_notrig': STANDIN_SINCOS_FLOP,
                'pe_fasttrig': FAST_SINCOSF_FLOP}.get(stage, SINCOSF_FLOP)
        fp32 += pe_flop_per_point(nfk, nfv, trig)
    n_bytes = (12 + 16) * n_points + ray_bytes() * n_rays
    out = {'fp32': fp32 * n_points / PEAK_FP32_FLOPS}
    if stage == 'full':
        n_bytes += w_bytes
        out['bf16'] = 2.0 * mlp_macs_per_point(ncfg) * n_points \
            / PEAK_BF16_FLOPS
    out['bytes'] = n_bytes / PEAK_HBM_BYTES
    return out


def k2d_stage_seconds(stage: str, ncfg: NeRFConfig, nfk: int, nfv: int,
                      k0p: int, kvp: int, n_points: int, n_rays: int,
                      w_bytes: int, dw_bytes: int,
                      passes: int = SPLIT_PASSES, fc: int = FC) -> dict:
    """{kind: seconds at its peak} of K2's sequence stopped after `stage`
    on n_points points of n_rays rays. It reads the points, the per-ray
    operands, the weights and (after the recompute) the cotangent; it
    writes the stage's outputs: raw and the saved activations
    (recompute); dW and the MLP inputs' f32 cotangents (mlp); dW and a
    3-float digest a point (pe); dW, dpts and the per-ray dm_all and
    daux (full). The cotangent products count as `passes` bf16 products
    each (SPLIT_PASSES for the f32 flavour, 1 for the bf16 flavour);
    'full' is K2's bound. fc: framecode columns of an aux row."""
    P = n_points
    fp32 = (transform_flop_per_point() + pe_flop_per_point(nfk, nfv)) * P
    n_in = (12 + (16 if stage != 'recompute' else 0)) * P \
        + ray_bytes(fc) * n_rays + w_bytes
    n_out = {'recompute': (16 + act_bytes_per_point(ncfg, k0p, kvp)) * P,
             'mlp': dw_bytes + 4 * (k0p + kvp) * P,
             'pe': dw_bytes + 12 * P,
             'full': dw_bytes + 12 * P + ray_bytes(fc) * n_rays}[stage]
    bf16 = 2.0 * mlp_macs_per_point(ncfg) * P
    if stage != 'recompute':
        bf16 += passes * 2.0 * bwd_f32_macs_per_point(ncfg) * P
    if stage in ('pe', 'full'):
        fp32 += pe_bwd_flop_per_point(nfk, nfv) * P
    if stage == 'full':
        fp32 += transform_bwd_flop_per_point() * P
    return {'fp32': fp32 / PEAK_FP32_FLOPS,
            'bf16': bf16 / PEAK_BF16_FLOPS,
            'bytes': (n_in + n_out) / PEAK_HBM_BYTES}


def k2_fp32_ms(ncfg: NeRFConfig, n_points: int) -> float:
    """History: K2's cotangent products as f32 FMAs at the 67 TFLOP/s
    fp32 peak (K2-v1's design, and K2's bound until the split products),
    ms on n_points points."""
    return 2.0 * bwd_f32_macs_per_point(ncfg) * n_points / PEAK_FP32_FLOPS \
        * 1e3


def k2_launch_bytes(ncfg: NeRFConfig, nfk: int, nfv: int, n_points: int,
                    cot_bytes: int = 4, chunk: int = 2048,
                    fc: int = FC) -> list:
    """[(launch, HBM bytes)] of K2's layer-by-layer sequence on n_points
    points of one net, in launch order (fused_render.bwd_plan's labels,
    the recompute as one), every tensor read from HBM as often as the
    design reads it (none from L2):
      * 'recompute': the points read, the saved activations (2 F a point,
        `act_rows`) and raw written;
      * 'heads': g, hv and the last trunk activation read, dhv written,
        the heads' dW partials written once per chunk;
      * each MMA layer ('view', 'feature', 'layer d-1' .. 'layer 0'): its
        cotangent dY read twice (the dW and dX roles), its input
        activations (dW's B) and, where its input is a ReLU output, the
        masks read; its input's cotangent written (an MLP input's columns
        always f32: the PE backward reads them; 'layer 0' also reads dx0,
        which the skip layer wrote first); its dW partials written once
        per chunk;
      * 'chunk sum': every partial read once;
      * 'PE': the points, dx0 and dxv read, dpts written.
    cot_bytes is the size of a stored MMA-layer cotangent entry: 4 (f32,
    the f32 flavour), 2 (bf16 tiles, the bf16 flavour). chunk: points a
    dW partial covers (fused_render.bwd_plan). fc: framecode columns."""
    W, WV = ncfg.width, ncfg.width // 2
    k0 = N_JOINTS * (1 + 2 * nfk) + C72
    kv = C72 * (1 + 2 * nfv) + fc
    up = lambda n, m: -(-n // m) * m
    k0p, kvp = up(k0, 16), up(kv, 16)
    F = up(k0, 64) + up(kv, 64) + (ncfg.depth + 1) * W + WV
    c, P, n_chunk = cot_bytes, n_points, -(-n_points // chunk)
    layers = [(k0p, W)] + [((k0p + W) if (i - 1) in ncfg.skips else W, W)
                           for i in range(1, ncfg.depth)]
    layers += [(W, W), (W + kvp, WV)]
    names = [f'layer {i}' for i in range(ncfg.depth)] + ['feature', 'view']
    heads_grad = (WV + 1) * 3 + W + 1
    out = [('recompute', (12 + 2 * F + 16) * P),
           ('heads', (16 + 2 * (WV + W) + c * WV) * P
            + 4 * heads_grad * n_chunk)]
    per_layer = {}
    for i, (k, n) in enumerate(layers):
        x_in = k0p if i == 0 else (k0p if k > W and i <= ncfg.depth
                                   else 0)
        x_in = kvp if i == len(layers) - 1 else x_in
        per = 2 * c * n + 2 * k + c * (k - x_in) + 4 * x_in
        if 0 < i <= ncfg.depth:                        # masked input h
            per += 2 * W
        if i == 0:                                     # dx0 accumulate
            per += 4 * k0p
        per_layer[names[i]] = per * P + 4 * (k + 1) * n * n_chunk
    out += [(name, per_layer[name]) for name in reversed(names)]
    n_grad = sum((k + 1) * n for k, n in layers) + heads_grad
    return out + [('chunk sum', 4 * n_grad * n_chunk),
                  ('PE', (12 + 4 * (k0p + kvp) + 12) * P)]


def k2_design_bytes(ncfg: NeRFConfig, nfk: int, nfv: int, n_points: int,
                    chunk: int = 2048, cot_bytes: int = 4,
                    fc: int = FC) -> int:
    """HBM bytes K2's layer-by-layer sequence moves on n_points points of
    one net: the sum of `k2_launch_bytes`' launches. cot_bytes is the size
    of a stored MMA-layer cotangent entry: 4, the f32 flavour's design
    (f32 cotangents through HBM); 2, the bf16 flavour's (bf16 cotangent
    tiles; dx0 and dxv, which the f32 PE backward reads, stay f32).
    chunk: points a dW partial covers. fc: framecode columns."""
    return sum(b for _, b in k2_launch_bytes(ncfg, nfk, nfv, n_points,
                                             cot_bytes, chunk, fc))


def layered_launch_bytes(ncfg: NeRFConfig, k0: int, kv: int,
                         n_points: int, save: bool = False,
                         embedded: bool = False) -> list:
    """[(launch, HBM bytes)] of one call of the layered route
    (csrc/fused_render_layered_sm90.cu) on n_points points of one net, in
    launch order (tools/kernel_bench.py: layered_labels' names), every
    tensor read from HBM once for each time the design reads it (a
    layer's second output block finds its A rows in L2):
      * 'phase A' (not K4's, with `embedded`: its inputs come embedded):
        K1's points (12 B) and the 24 cutoff distances read, the bf16
        x0 | xv rows written, each padded to 64 columns (into X, or with
        `save`, K2's recompute, into its act layout);
      * each MMA layer ('layer i', 'feature', 'view'): its bf16 input
        segments read (K4's x0 and xv at their k0 and kv columns) and its
        output written, where the activations live (X, or act with
        `save`), with `save` also the last trunk layer's and hv's rows
        into X for the heads; its bf16 weights (unpadded) and f32 bias;
      * 'heads': hv and the last trunk layer's rows read, the raw output
        (16 B) written; the f32 head weights and b_out.
    k0, kv: the MLP inputs' widths."""
    W, d, WV = ncfg.width, ncfg.depth, ncfg.width // 2
    up = lambda n: -(-n // SLICE_K) * SLICE_K
    x0, xv = up(k0), up(kv)
    a0, av = (k0, kv) if embedded else (x0, xv)   # what the layers read
    ins = [a0] + [(a0 + W) if (i - 1) in ncfg.skips else W
                  for i in range(1, d)] + [W, W + av]
    extra = [0] * (d - 1) + [W, 0, WV] if save else [0] * (d + 2)
    out = [] if embedded else [
        ('phase A', (12 + 2 * (x0 + xv)) * n_points + 4 * 24)]
    names = [f'layer {i}' for i in range(d)] + ['feature', 'view']
    for name, k, (kw, n), x in zip(names, ins, _mma_layers(ncfg), extra):
        out.append((name, 2 * (k + n + x) * n_points + 2 * kw * n + 4 * n))
    out.append(('heads', (2 * (WV + W) + 16) * n_points
                + 4 * (3 * WV + W + 4)))
    return out


def layered_design_bytes(ncfg: NeRFConfig, k0: int, kv: int,
                         n_points: int, save: bool = False,
                         embedded: bool = False) -> int:
    """HBM bytes of one call of the layered route on n_points points of
    one net: the sum of `layered_launch_bytes`' launches (K1's points;
    with `save` the activations written once, into K2's act layout, and
    the heads' inputs into X as well; K4, `embedded`, reads its inputs in
    place and no cutoff distances)."""
    return sum(b for _, b in layered_launch_bytes(ncfg, k0, kv, n_points,
                                                  save, embedded))


def k2_seconds(ncfg: NeRFConfig, nfk: int, nfv: int, n_points_by_net,
               n_rays: int, w_bytes: int, dw_bytes: int,
               bwd_f32: bool = True, fc: int = FC) -> dict:
    """{kind: seconds at its peak} of K2 in the flavour `bwd_f32` on one
    train step: one launch per net on that net's points
    (n_points_by_net), n_rays rays, w_bytes of both nets' packed
    operands, dw_bytes of one net's dW. The sum of
    `k2d_stage_seconds('full', ...)` over the nets."""
    k0p, kvp = input_pads(nfk, nfv, fc)
    passes = SPLIT_PASSES if bwd_f32 else 1
    out: dict = {}
    for P in n_points_by_net:
        for kind, t in k2d_stage_seconds('full', ncfg, nfk, nfv, k0p, kvp, P,
                                         n_rays, w_bytes // 2, dw_bytes,
                                         passes, fc).items():
            out[kind] = out.get(kind, 0.0) + t
    return out


def input_pads(nfk: int, nfv: int, fc: int = FC) -> tuple:
    """(k0p, kvp): the MLP inputs' widths padded to 16."""
    up = lambda n: -(-n // 16) * 16
    return (up(N_JOINTS * (1 + 2 * nfk) + C72), up(C72 * (1 + 2 * nfv) + fc))


def net_bytes(ncfg: NeRFConfig) -> int:
    """Bytes of one network's packed operands as a bound counts them: the
    MMA weights in bf16, unpadded, and the f32 biases, heads and cutoff
    distances."""
    W = ncfg.width
    n_f32 = (W * (ncfg.depth + 1) + W // 2                  # biases
             + 3 * (W // 2) + W + 4 + 24)                   # heads, cut
    return 2 * sum(k * n for k, n in _mma_layers(ncfg)) + 4 * n_f32


def config_bounds(ncfg: NeRFConfig, nfk: int, nfv: int, n_rays_fwd: int,
                  S_fwd, n_rays_bwd: int, S_bwd) -> dict:
    """{kernel id: (bound ms, bound_by, what it covers)} of K1, K3, K4 on
    one render bucket of n_rays_fwd rays (both nets, the sample counts
    S_fwd) and of K2 in both flavours on one train step of n_rays_bwd
    rays (S_bwd), at any config the fused kernels take: any width, depth
    and skips, nfk / nfv bands and framecode width (the config's, or FC
    zero columns without framecodes)."""
    fc = ncfg.framecode_ch if ncfg.use_framecode else FC
    w_net = net_bytes(ncfg)
    w_bytes = 2 * w_net                                     # both nets
    P = n_rays_fwd * sum(S_fwd)
    fwd_ops = {'bf16': 2.0 * mlp_macs_per_point(ncfg) * P / PEAK_BF16_FLOPS,
               'fp32': (transform_flop_per_point()
                        + pe_flop_per_point(nfk, nfv)) * P / PEAK_FP32_FLOPS}
    raw_row = -(-(N_JOINTS + 2 * C72 + fc) // 4) * 4        # K3's row
    per_point = {
        'K1': 12 + 16,                                  # pts in, raw out
        'K3': 4 * raw_row + 16,                         # f32 rows in
        'K4': 2 * (ncfg.vnet_input - ncfg.width + ncfg.dnet_input) + 16,
    }
    what = f'{n_rays_fwd}-ray bucket, S = ' + ' + '.join(map(str, S_fwd))
    out = {}
    for kid, b in per_point.items():
        n_bytes = P * b + w_bytes + (2 * n_rays_fwd * ray_bytes(fc)
                                     if kid == 'K1' else 0)
        times = dict(fwd_ops, bytes=n_bytes / PEAK_HBM_BYTES)
        if kid == 'K4':
            del times['fp32']                           # no PE
        out[kid] = bound_ms(times) + (what,)
    n_grad = 4 * sum((k + 1) * n for k, n in _mma_layers(ncfg))
    what = f'{n_rays_bwd}-ray train step, S = ' + ' + '.join(map(str, S_bwd))
    for kid, f32 in (('K2', True), ('K2 bf16', False)):
        out[kid] = bound_ms(k2_seconds(
            ncfg, nfk, nfv, tuple(n_rays_bwd * S for S in S_bwd),
            n_rays_bwd, w_bytes, n_grad, f32, fc)) + (what,)
    return out


#: the shapes beyond the flagship's that the fused kernels take, as
#: chip_smoke.py's shapes phase runs them (the surreal config's settings
#: with these overrides): {name: (NeRFConfig overrides, nfk, nfv)}
SHAPES = {
    'wide-net': (dict(width=512), 7, 4),
    'wide-input': (dict(input_ch=24 * 21, input_ch_views=72 * 13,
                        framecode_ch=32), 10, 6),
    'two-stage': (dict(input_ch=24 * 21), 10, 4),
    'plain-trunk-5': (dict(depth=5), 7, 4),
    'plain-trunk-40': (dict(depth=40), 7, 4),
}


def shape_config(name: str) -> tuple:
    """(NeRFConfig, nfk, nfv) of a SHAPES entry: the flagship's network
    (8 x 256, skip 4, multires 7 / 4, 16-wide framecodes) with the entry's
    overrides."""
    kw, nfk, nfv = SHAPES[name]
    base = dict(input_ch=24 * (1 + 2 * 7), input_ch_bones=72,
                input_ch_views=72 * (1 + 2 * 4), use_framecode=True,
                framecode_ch=16, n_framecodes=4)
    return NeRFConfig(**{**base, **kw}), nfk, nfv


def flagship_bounds(n_rays_fwd: int = 4096, n_rays_bwd: int = 2048,
                    n_rays_stages: int = 2048):
    """{kernel id: (bound ms, bound_by, what it covers)} at the flagship
    shapes: K1, K3 and K4 on one render bucket of `n_rays_fwd` rays, K2
    (both flavours) on one train step of `n_rays_bwd` rays; both nets,
    S = 64 + 80 (`config_bounds`), and K1 and K2 again at the culled
    shapes S = 8 + 24 (cull_ratio 0.125); each K1-d and K2-d stage on
    `n_rays_stages` rays, S = 64 + 80 (the coarse net's weights)."""
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    nfk, nfv = 7, 4
    k0p, kvp = input_pads(nfk, nfv)
    w_net = net_bytes(ncfg)
    out = config_bounds(ncfg, nfk, nfv, n_rays_fwd, (64, 80), n_rays_bwd,
                        (64, 80))
    culled = config_bounds(ncfg, nfk, nfv, n_rays_fwd, (8, 24), n_rays_bwd,
                           (8, 24))
    for kid in ('K1', 'K2', 'K2 bf16'):
        out[f'{kid} culled'] = culled[kid]
    dw_bytes = 4 * sum((k + 1) * n for k, n in _mma_layers(ncfg))
    R = n_rays_stages
    what = f'{R} rays, S = 64 + 80'
    for stage in ('transform', 'pe', 'pe_notrig', 'pe_fasttrig', 'full'):
        ms = [bound_ms(k1d_stage_seconds(stage, ncfg, nfk, nfv, R * S, R,
                                         w_net)) for S in (64, 80)]
        out[f'K1-d {stage}'] = (ms[0][0] + ms[1][0], ms[0][1], what)
    for stage in ('recompute', 'mlp', 'pe', 'full'):
        ms = [bound_ms(k2d_stage_seconds(stage, ncfg, nfk, nfv, k0p, kvp,
                                         R * S, R, w_net, dw_bytes))
              for S in (64, 80)]
        out[f'K2-d {stage}'] = (ms[0][0] + ms[1][0], ms[0][1], what)
    return out


def l2_weight_lines(n_rays: int = 4096):
    """K1-v1's and K1's weight bytes read from L2 on one render bucket of
    n_rays rays (S = 64 + 80), with the MLP's FLOP per byte."""
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    flop = 2.0 * mlp_macs_per_point(ncfg) * n_rays * (64 + 80)
    lines = []
    for name, pad, cluster in (('K1-v1', 16, 1), ('K1', SLICE_K, K1_CLUSTER)):
        b = sum(l2_weight_bytes(ncfg, n_rays * S, pad, K1_TM, cluster)
                for S in (64, 80))
        lines.append(f'{name}: {b / 1e9:.3f} GB of weights from L2 per '
                     f'{n_rays}-ray bucket (TM {K1_TM}, cluster {cluster}), '
                     f'{flop / b:.1f} FLOP per L2 byte')
    return lines


def k2_lines(n_rays: int = 2048):
    """Beside K2's bound: the fp32-FMA bound it had before the split
    products (history) and each flavour's design HBM traffic per train
    step of n_rays rays, at S = 64 + 80 and at the culled S = 8 + 24: the
    f32 flavour's f32 cotangents in 2048-point chunks, the bf16 flavour's
    bf16 cotangent tiles in its plan's chunks (fused_render.bf16_grid)."""
    from .fused_render import bf16_grid
    ncfg = NeRFConfig(use_framecode=True, framecode_ch=16)
    P = n_rays * (64 + 80)
    lines = [f'K2 history: its products as f32 FMAs, '
             f'{k2_fp32_ms(ncfg, P):.4f} ms at 67 TFLOP/s per {n_rays}-ray '
             f'train step (K2-v1\'s design)']
    for shapes in ((64, 80), (8, 24)):
        for f32, what in ((True, 'f32 flavour, f32 cotangents'),
                          (False, 'bf16 flavour, bf16 cotangent tiles')):
            b = sum(k2_design_bytes(
                ncfg, 7, 4, n_rays * S,
                2048 if f32 else bf16_grid(n_rays * S, ncfg.width)[0],
                4 if f32 else 2) for S in shapes)
            lines.append(
                f'K2 design traffic, S = {shapes[0]} + {shapes[1]} '
                f'({what}): {b / 1e9:.3f} GB through HBM per {n_rays}-ray '
                f'train step, {b / PEAK_HBM_BYTES * 1e3:.4f} ms at 3.35 TB/s '
                f'(the layer-by-layer sequence, no L2 reuse)')
    return lines


def main() -> None:
    for kid, (ms, by, what) in flagship_bounds().items():
        print(f'{kid}: bound {ms:.4f} ms per {what} ({by})')
    for line in l2_weight_lines() + k2_lines():
        print(line)
    for name in SHAPES:
        ncfg, nfk, nfv = shape_config(name)
        for kid, (ms, by, what) in config_bounds(
                ncfg, nfk, nfv, 4096, (64, 80), 2048, (64, 80)).items():
            print(f'{name} {kid}: bound {ms:.4f} ms per {what} ({by})')


if __name__ == '__main__':
    main()
