"""The plain reference against the port's plain branch at a tiny size on
the CPU: the same inputs and generator draws give the same rays and the
same train step in float32, and a lower precision on the port's side
fails the comparison. The only file that imports both."""
import dataclasses

import numpy as np
import pytest
import torch

from anerf_torch.config import TrainConfig
from anerf_torch.pose.pose_opt import (PoseOptConfig, init_pose_params,
                                       pose_anchor_tree)
from anerf_torch.render.factory import build_render_config
from anerf_torch.render.raycaster import render_rays
from anerf_torch.skeleton import SMPLSkeleton
from anerf_torch.train.state import (TrainState, init_opt_state,
                                     init_pose_opt_state,
                                     make_nerf_optimizer, make_pose_optimizer)
from anerf_torch.train.trainer import make_train_step
from benchmark import scene
from benchmark.drivers.train import leaf_gap, model_of
from benchmark.reference import anerf as ref
from conftest import tiny_cell

N_FRAMES, R, NI = 8, 32, 4


def setup(name, dtype='float32', seed=3):
    cell = tiny_cell(name)
    t = dict(cell.config['train_config'], compute_dtype=dtype,
             fused_kernel=False)
    args = TrainConfig(**t)
    cfg = build_render_config(args, {'skel_type': SMPLSkeleton,
                                     'n_views': N_FRAMES})
    sk = scene.skeleton(N_FRAMES)
    cyls = ref.kp_cylinder(sk['kp3d'], 0.001, 250, 1.0, 0.25, 'y')
    pool = scene.train_batches(sk, cyls, 1, 1, R, NI, [0.0, 0.2, 2.5], 0.3,
                               seed)
    batch = {k: torch.as_tensor(v[0]) for k, v in pool[0].items()}
    params = scene.weights(cell.config, N_FRAMES, seed, 'cpu')
    return cell, args, cfg, sk, batch, params


def port_rays(cfg, params, batch, gen):
    pi = batch['pose_idx']
    return render_rays(params, cfg, batch['rays'], batch['kp3d'][pi],
                       batch['skts'][pi], batch['bones'][pi],
                       batch['cyls'][pi], cam_idxs=batch['cam_idxs'],
                       generator=gen, tau=20.0)


def ref_rays(cell, params, batch, gen):
    pi = batch['pose_idx']
    m = model_of(cell.config)
    return ref.render_rays(params, m, batch['rays'], batch['cyls'][pi],
                           batch['skts'][pi], batch['cam_idxs'], 20.0, gen,
                           1.0, m['raw_noise_std'])


@pytest.mark.parametrize('name', ['surreal', 'surreal_single'])
def test_rays_agree_in_f32_and_not_in_bf16(name):
    cell, args, cfg, sk, batch, params = setup(f'{name}.train'
                                               if name == 'surreal'
                                               else f'{name}.render')
    want, _ = ref_rays(cell, params, batch, torch.Generator().manual_seed(5))
    got = port_rays(cfg, params, batch, torch.Generator().manual_seed(5))
    f32 = float((got['rgb_map'] - want['rgb']).abs().max())
    acc = float((got['acc_map'] - want['acc']).abs().max())
    assert f32 < 2e-5 and acc < 2e-5
    low = dataclasses.replace(cfg, compute_dtype='bfloat16')
    got = port_rays(low, params, batch, torch.Generator().manual_seed(5))
    bf16 = float((got['rgb_map'] - want['rgb']).abs().max())
    assert bf16 > 20 * max(f32, 1e-7)


def test_train_step_agrees_in_f32():
    """One step of the port's plain f32 branch (FK of the refined poses,
    encoding, MLP, compositing, resampling, losses, both Adams) against
    the reference's: the loss, the gradients as the Adams get them and
    the updated parameters."""
    cell, args, cfg, sk, batch, params = setup('surreal.train')
    ref_params = scene.clone_tree(params)
    pose_cfg = PoseOptConfig(use_rot6d=True)
    opt = make_nerf_optimizer(args.lrate, args.lrate_decay,
                              args.lrate_decay_rate, args.decay_unit)
    popt = make_pose_optimizer(args.opt_pose_lrate,
                               args.opt_pose_lrate_decay,
                               args.opt_pose_decay_rate,
                               args.opt_pose_decay_unit)
    pp = init_pose_params(sk['kp3d'], sk['bones'], pose_cfg, device='cpu')
    ps, pa = init_pose_opt_state(popt, pp)
    state = TrainState(0, params, init_opt_state(opt, params), pp, ps, pa,
                       pose_anchor_tree(sk['kp3d'], sk['bones'], 'cpu'))
    step = make_train_step(args, cfg, pose_cfg, torch.as_tensor(sk['rest']),
                           opt, popt)
    new, out = step(state, batch, torch.Generator().manual_seed(9))

    from benchmark.drivers.train import reference_run
    stacked = {k: v.numpy()[None] for k, v in batch.items()}
    steps, tref, _ = reference_run(cell, sk, ref_params, stacked,
                                torch.Generator().manual_seed(9).get_state(),
                                torch.device('cpu'), 1)
    losses, gn, upd, pg, pupd = steps[0]
    assert float(out['losses']['total_loss']) == pytest.approx(
        float(losses['total_loss']), rel=1e-5)
    got = ref._flat(new.params) - ref._flat(params)
    assert leaf_gap(got, upd, tref.nets) < 1e-4
    got = ref._flat(new.pose_params) - ref._flat(pp)
    assert leaf_gap(got, pupd, tref.pose) < 1e-4


def test_the_reference_continues_from_a_state():
    """Two steps from the seed equal one step, then one from the state
    (`TrainReference.state`) that the first left, bit for bit: the path
    that follows the program from the state its window left."""
    from benchmark.drivers.train import reference_run
    cell, args, cfg, sk, batch, params = setup('surreal.train')
    sk = scene.skeleton(N_FRAMES)
    cyls = ref.kp_cylinder(sk['kp3d'], 0.001, 250, 1.0, 0.25, 'y')
    stacked = scene.train_batches(sk, cyls, 1, 2, R, NI, [0.0, 0.2, 2.5],
                                  0.3, 4)[0]
    dev = torch.device('cpu')
    g0 = torch.Generator().manual_seed(6).get_state()
    both, _, _ = reference_run(cell, sk, scene.clone_tree(params), stacked,
                               g0, dev, 2)
    one, tref, gen = reference_run(cell, sk, scene.clone_tree(params),
                                   stacked, g0, dev, 1)
    second = {k: v[1:] for k, v in stacked.items()}
    cont, _, _ = reference_run(cell, sk, scene.clone_tree(params), second,
                               gen.get_state(), dev, 1, start=tref.state())
    for a, b in zip(both[1], cont[0]):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        elif a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_fp8_control_rounds_coarser_than_bf16():
    x = torch.randn(4096) * 0.05
    q = ref._Fp8.apply(x)
    e8 = float(((q - x).abs() / x.abs().clamp_min(1e-3)).median())
    e16 = float(((x.bfloat16().float() - x).abs()
                 / x.abs().clamp_min(1e-3)).median())
    assert e8 > 8 * e16
