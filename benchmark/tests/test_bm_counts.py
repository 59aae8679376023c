"""The frozen work counts: MACs a point, passes, model FLOPs and the
kernels' bounds, against numbers worked out by hand."""
import pytest

from benchmark import counts, harness

PEAK = 989e12


def cfg(name):
    return harness.load_json(harness.HERE / 'configs' / f'{name}.json')


def test_macs_per_point():
    assert counts.mlp_macs_per_point(counts.net_of(cfg('surreal'))) == 863872
    assert counts.mlp_macs_per_point(
        counts.net_of(cfg('surreal_single'))) == 790144


def test_passes_and_model_flop():
    assert counts.passes(cfg('surreal')) == [(64, 'coarse'), (80, 'fine')]
    assert counts.passes(cfg('surreal_single')) == [(96, 'coarse'),
                                                    (48, 'coarse')]
    # 144 points a ray in both; x3 in training
    assert counts.model_flop_per_ray(cfg('surreal'), True) == \
        3 * 2 * 863872 * 144
    assert counts.model_flop_per_ray(cfg('surreal_single'), False) == \
        2 * 790144 * 144


@pytest.mark.parametrize('name, view_k, bwd', [
    # trunk (432, 256), six (256, 256), the skip layer (688, 256), the
    # feature layer (256, 256) and the view layer (k, 128): sum of
    # 2 k n + n, plus the heads' 2 * 128 * 3 + 2 * 256 + 4
    ('surreal', 920, 221440 + 7 * 131328 + 352512 + 235648 + 1284),
    ('surreal_single', 344, 221440 + 7 * 131328 + 352512 + 88192 + 1284),
])
def test_backward_macs(name, view_k, bwd):
    n = counts.net_of(cfg(name))
    assert counts.mma_layers(n)[-1] == (view_k, 128)
    assert counts.bwd_macs_per_point(n) == bwd


@pytest.mark.parametrize('name, rays, S', [
    ('surreal', 2048, 64), ('surreal', 2048, 80),
    ('surreal_single', 4096, 96), ('surreal_single', 4096, 48)])
def test_bounds_by_hand(name, rays, S):
    """Both kernels are bound by their bf16 products at these shapes: K1
    by 2 x MACs x points, K2 by 2 x backward MACs x points, each once."""
    n = counts.net_of(cfg(name))
    P = rays * S
    k1 = 2 * counts.mlp_macs_per_point(n) * P / PEAK
    k2 = 2 * counts.bwd_macs_per_point(n) * P / PEAK
    assert counts.k1_bound_s(n, rays, S) == pytest.approx(k1, rel=1e-12)
    assert counts.k2_bound_s(n, rays, S) == pytest.approx(k2, rel=1e-12)
    # the other terms lie below
    fp32 = (counts.transform_flop_per_point()
            + counts.pe_flop_per_point(n)) * P / counts.PEAK_FP32_FLOPS
    byt = (28 * P + rays * counts.ray_bytes(n) + counts.net_bytes(n)) \
        / counts.PEAK_HBM_BYTES
    assert fp32 < k1 and byt < k1


def test_flagship_step_bounds():
    """A 2048-ray step of the flagship: K1 0.5152 ms (the forward of both
    nets), K2 1.0319 ms (the backward once, no recompute), well under the
    split-pass counting of kernels/roofline.py (3.6108 ms)."""
    n = counts.net_of(cfg('surreal'))
    k1 = sum(counts.k1_bound_s(n, 2048, S) for S, _ in
             counts.passes(cfg('surreal')))
    k2 = sum(counts.k2_bound_s(n, 2048, S) for S, _ in
             counts.passes(cfg('surreal')))
    assert k1 * 1e3 == pytest.approx(0.5152, abs=1e-4)
    assert k2 * 1e3 == pytest.approx(1.0319, abs=1e-4)
