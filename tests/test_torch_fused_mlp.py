"""anerf_torch K4 (kernels/fused_mlp.py) against anerf_tpu, on the CPU.

On a CPU tensor the wrapper runs the kernel's plain PyTorch version, so
these tests hold the plain version (and the operand packing the CUDA
kernel reads) against the JAX Pallas kernel fused_mlp_apply, run in
interpret mode as tests/test_fused_mlp.py runs it, on the same weights
(carried by convert.params_from_numpy) and the same inputs from a numpy
seed. The CUDA kernel is held against the plain version on the card by
chip_smoke.py and tests/test_torch_kernels_gpu.py.

Tolerance 5e-3 abs/rel: both round the same operands and activations to
bf16 and keep each product in f32 before the bias (the TPU kernel's
_mlp_chain), so they differ only by f32 summation order, which flips an
occasional bf16 rounding of an activation.
"""
import numpy as np
import pytest
import torch

import jax

from anerf_tpu.kernels import fused_mlp as jfm
from anerf_tpu.models.nerf import NeRFConfig as JaxNeRFConfig
from anerf_tpu.models.nerf import init_nerf_params

from anerf_torch.convert import params_from_numpy
from anerf_torch.kernels import fused_mlp as tfm
from anerf_torch.models.nerf import NeRFConfig

LIKE = dict(atol=5e-3, rtol=5e-3)
P = 1500            # not a multiple of the kernels' tiles

FLAGSHIP = dict(depth=8, width=256, input_ch=360, input_ch_bones=72,
                input_ch_views=648, skips=(4,), use_viewdirs=True,
                framecode_ch=16, n_framecodes=4)
SMALL = dict(depth=4, width=256, input_ch=24, input_ch_bones=0,
             input_ch_views=72, skips=(2,), use_viewdirs=True)
CASES = {'flagship_no_framecode': (dict(FLAGSHIP, use_framecode=False), 512),
         'flagship_framecode': (dict(FLAGSHIP, use_framecode=True), 512),
         'small': (SMALL, 256)}


def _setup(name, seed=0):
    kw, tile = CASES[name]
    jcfg, tcfg = JaxNeRFConfig(**kw), NeRFConfig(**kw)
    jparams = init_nerf_params(jax.random.PRNGKey(seed), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), 'cpu')
    rng = np.random.default_rng(seed)
    x_pts = rng.normal(size=(P, jcfg.dnet_input)).astype(np.float32)
    x_view = rng.normal(size=(P, tfm.view_in(tcfg))).astype(np.float32)
    return jcfg, tcfg, jparams, tparams, x_pts, x_view, tile


@pytest.mark.parametrize('name', list(CASES))
def test_plain_k4_matches_pallas(name):
    jcfg, tcfg, jparams, tparams, x_pts, x_view, tile = _setup(name)
    assert jfm.supports_config(jcfg) and tfm.supports_config(tcfg)
    want = jfm.fused_mlp_apply(jcfg, jfm.pack_params(jparams, jcfg),
                               jax.numpy.asarray(x_pts),
                               jax.numpy.asarray(x_view), tile)
    packed = tfm.pack_params(tparams, tcfg)
    got = tfm.fused_mlp_apply_ref(tcfg, packed, torch.as_tensor(x_pts),
                                  torch.as_tensor(x_view))
    assert got.shape == (P, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LIKE)


def test_k4_wrapper_takes_plain_route_on_cpu():
    _, tcfg, _, tparams, x_pts, x_view, _ = _setup('small', seed=1)
    packed = tfm.pack_params(tparams, tcfg)
    before = tfm.LAUNCHES
    xp, xv = torch.as_tensor(x_pts[:64]), torch.as_tensor(x_view[:64])
    got = tfm.fused_mlp_apply(tcfg, packed, xp, xv)
    assert tfm.LAUNCHES == before == 0
    assert torch.equal(got, tfm.fused_mlp_apply_ref(tcfg, packed, xp, xv))


def test_k4_packing_pads_inputs_to_16():
    """The small config's widths 24 and 72 pad to 32 and 80; the padding
    rows of layer 0, of the skip layer and of the view layer hold no
    weight."""
    from anerf_torch.kernels import fused_render as fr
    _, tcfg, _, tparams, _, _, _ = _setup('small')
    packed = tfm.pack_params(tparams, tcfg)
    assert (packed['k0p'], packed['kvp']) == (32, 80)
    shapes = fr.mlp_shapes(tcfg, 32, 80)
    assert shapes == [(256, 32), (256, 256), (256, 256), (256, 32 + 256),
                      (256, 256), (128, 256 + 80)]
    blocks, off = [], 0
    for n, k in shapes:
        blocks.append(fr.from_fragment_order(packed['w'][off:off + n * k],
                                             n, k))
        off += n * k
    assert off == packed['w'].numel()
    for i, cols in ((0, slice(24, 32)), (3, slice(24, 32)),
                    (5, slice(256 + 72, 256 + 80))):
        assert not blocks[i][:, cols].any()
    want = tparams['pts_linears'][3]['w'][24:].t().to(torch.bfloat16)
    assert torch.equal(blocks[3][:, 32:], want)


def test_supports_config_is_the_jax_gate_at_width_256():
    for kw in (FLAGSHIP, SMALL):
        assert tfm.supports_config(NeRFConfig(**kw))
    assert not tfm.supports_config(NeRFConfig(**dict(SMALL, width=128)))
    assert not tfm.supports_config(NeRFConfig(**dict(SMALL, depth=1)))
    assert not tfm.supports_config(
        NeRFConfig(**dict(SMALL, use_viewdirs=False)))
