"""anerf_torch's reference-checkpoint import / export
(anerf_torch/pose/ckpt_compat.py) and the two loaders that read it
(train/checkpoint.py:restore_from_path on a .tar,
data/dataset.py:PoseRefinedDataset(load_refined=True)) against
anerf_tpu's, on the CPU.

Tolerances: the parameter trees are copied, so they are held bit for
bit both ways; pose_ckpt_to_pose_data and the refined datasets to 1e-5
absolute (6D -> axis-angle through the packages' own rotation ops, JAX
against torch in f32, then the same numpy FK).
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_tpu.config import TrainConfig as JTrainConfig
from anerf_tpu.data import dataset as jds
from anerf_tpu.data.fixtures import make_synthetic_h5
from anerf_tpu.pose import ckpt_compat as jcc
from anerf_tpu.render.factory import build_render_config as j_build_cfg
from anerf_tpu.render.factory import init_render_params as j_init_params
from anerf_tpu.skeleton import SMPLSkeleton as JSMPL
from anerf_tpu.skeleton import smpl_rest_pose
from anerf_tpu.train import checkpoint as jckpt
from anerf_tpu.train.state import TrainState as JTrainState

from anerf_torch.convert import params_from_numpy, params_to_numpy
from anerf_torch.data import dataset as tds
from anerf_torch.pose import ckpt_compat as tcc
from anerf_torch.train import checkpoint as tckpt
from anerf_torch.train.state import TrainState as TTrainState

N_KPS, N_CAMS = 4, 2


def _params(seed=0, fine=True):
    """JAX-initialised render params (numpy leaves): 4 x 64 MLPs with
    framecodes."""
    args = JTrainConfig(netdepth=4, netwidth=64, multires=3,
                        multires_views=2, N_samples=8,
                        N_importance=4 if fine else 0, use_viewdirs=True,
                        use_cutoff=True, cutoff_viewdir=True,
                        cutoff_inputs=True, opt_framecode=True,
                        compute_dtype='float32')
    cfg = j_build_cfg(args, {'skel_type': JSMPL, 'n_views': 3})
    return jax.tree.map(np.asarray, j_init_params(
        jax.random.PRNGKey(seed), args, cfg))


def _pose(rng, n, dim=3):
    bones = (rng.normal(size=(n, 24, dim)) * 0.3).astype(np.float32)
    if dim == 6:
        bones[..., [0, 3]] += 1.0         # near the identity's columns
    return {'pelvis': rng.normal(size=(n, 3)).astype(np.float32),
            'bones': bones}


def _same_tree(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(la, lb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize('fine', [True, False])
def test_jax_export_loads_in_the_port(tmp_path, fine):
    params = _params(1, fine)
    rng = np.random.default_rng(0)
    pose = _pose(rng, 5)
    rest = rng.normal(size=(24, 3)).astype(np.float32)
    tar = str(tmp_path / 'jax.tar')
    jcc.export_reference_checkpoint(tar, params, global_step=777, tau=300.0,
                                    pose_params=pose, rest_pose=rest)
    got, gx = tcc.load_reference_checkpoint(tar)
    want, wx = jcc.load_reference_checkpoint(tar)
    _same_tree(got, want)
    _same_tree(got, params)
    assert gx['global_step'] == wx['global_step'] == 777
    assert gx['tau'] == wx['tau'] == 300.0
    assert set(gx['poseopt_state_dict']) == {'pelvis', 'bones', 'rest_pose'}
    _same_tree(tcc.pose_state_dict_to_params(gx['poseopt_state_dict']),
               jcc.pose_state_dict_to_params(wx['poseopt_state_dict']))


def test_port_export_loads_in_jax(tmp_path):
    """Export from the port's torch tree (tensors, as a model on a device
    holds them) and read it back with both packages."""
    params = _params(2)
    tparams = params_from_numpy(params, 'cpu')
    rng = np.random.default_rng(1)
    pose = {k: torch.as_tensor(v) for k, v in _pose(rng, 4, 6).items()}
    rest = torch.as_tensor(rng.normal(size=(24, 3)).astype(np.float32))
    tar = str(tmp_path / 'port.tar')
    tcc.export_reference_checkpoint(tar, tparams, global_step=12, tau=55.5,
                                    pose_params=pose, rest_pose=rest)
    want, wx = jcc.load_reference_checkpoint(tar)
    _same_tree(want, params)
    _same_tree(want, params_to_numpy(tparams))
    assert wx['global_step'] == 12 and wx['tau'] == 55.5
    got, _ = tcc.load_reference_checkpoint(tar)
    _same_tree(got, want)
    # and the port's export of a JAX tree writes the same file contents
    tar2 = str(tmp_path / 'jax.tar')
    jcc.export_reference_checkpoint(tar2, params, global_step=12, tau=55.5,
                                    pose_params={k: v.numpy() for k, v in
                                                 pose.items()},
                                    rest_pose=rest.numpy())
    a = torch.load(tar, weights_only=False)
    b = torch.load(tar2, weights_only=False)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        if isinstance(y, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert x == y


def test_reference_layout_import(tmp_path):
    """A hand-made reference .tar (torch Linear layout, no tau, no fine
    net, cutoff_dist absent) reads the same in both packages."""
    rng = np.random.default_rng(4)
    sd = {}
    dims = [(48, 64), (64, 64), (64 + 48, 64)]
    for i, (a, b) in enumerate(dims):
        sd[f'pts_linears.{i}.weight'] = torch.randn(b, a)
        sd[f'pts_linears.{i}.bias'] = torch.randn(b)
    sd['output_linear.weight'] = torch.randn(4, 64)
    sd['output_linear.bias'] = torch.randn(4)
    torch.save({'network_fn_state_dict': sd,
                'network_fine_state_dict': {},
                'poseopt_layer_state_dict': {
                    'pelvis': torch.as_tensor(rng.normal(size=(2, 3))),
                    'bones': torch.as_tensor(rng.normal(size=(2, 24, 3)))}},
               str(tmp_path / 'ref.tar'))
    got, gx = tcc.load_reference_checkpoint(str(tmp_path / 'ref.tar'))
    want, wx = jcc.load_reference_checkpoint(str(tmp_path / 'ref.tar'))
    _same_tree(got, want)
    assert got['fine'] is None and gx['tau'] is None and wx['tau'] is None
    assert gx['global_step'] == 0
    np.testing.assert_array_equal(got['coarse']['output_linear']['w'],
                                  sd['output_linear.weight'].numpy().T)


@pytest.mark.parametrize('legacy', [False, True])
@pytest.mark.parametrize('dim', [3, 6])
def test_pose_ckpt_to_pose_data_matches_jax(tmp_path, dim, legacy):
    rng = np.random.default_rng(dim + 10 * legacy)
    pose = _pose(rng, 5, dim)
    sd = {k: torch.as_tensor(v) for k, v in pose.items()}
    sd['rest_pose'] = torch.as_tensor(
        (smpl_rest_pose[None] * 0.0025).astype(np.float32))
    tar = str(tmp_path / 'pose.tar')
    torch.save({'poseopt_layer_state_dict': sd}, tar)
    for kw in (dict(path=tar), dict(popt_sd=sd)):
        got = tcc.pose_ckpt_to_pose_data(legacy=legacy, **kw)
        want = jcc.pose_ckpt_to_pose_data(legacy=legacy, **kw)
        assert len(got) == len(want) == 6
        for name, g, w in zip(('kp3d', 'bones', 'skts', 'cyls', 'rest_pose',
                               'pelvis'), got, want):
            assert g.shape == w.shape and g.dtype == w.dtype, name
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0,
                                       err_msg=name)
    with pytest.raises(ValueError, match='rest_pose'):
        tcc.pose_ckpt_to_pose_data(popt_sd={'pelvis': sd['pelvis'],
                                            'bones': sd['bones']})


def test_pose_ckpt_root_bones_and_kp_map():
    """The reduced layout (23 bones + root_bones, kp_map) expands like
    JAX's."""
    rng = np.random.default_rng(7)
    n = 3
    sd = {'pelvis': torch.as_tensor(rng.normal(size=(n, 3)).astype(
              np.float32)),
          'bones': torch.as_tensor((rng.normal(size=(2, 23, 3)) * 0.2)
                                   .astype(np.float32)),
          'root_bones': torch.as_tensor((rng.normal(size=(n, 3)) * 0.2)
                                        .astype(np.float32)),
          'kp_map': torch.as_tensor(np.array([0, 1, 1])),
          'kp_uidxs': torch.as_tensor(np.array([0, 1])),
          'rest_pose': torch.as_tensor(
              (smpl_rest_pose[None] * 0.0025).astype(np.float32))}
    got = tcc.pose_ckpt_to_pose_data(popt_sd=sd)
    want = jcc.pose_ckpt_to_pose_data(popt_sd=sd)
    assert got[1].shape == (n, 24, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def test_restore_from_tar_matches_jax(tmp_path):
    params = _params(3)
    tar = str(tmp_path / 'm.tar')
    jcc.export_reference_checkpoint(tar, params, global_step=41)
    zero = jax.tree.map(np.zeros_like, params)
    jstate = JTrainState(step=jnp.int32(0), params=zero, opt_state=None,
                         pose_params=None, pose_opt_state=None,
                         pose_grad_acc=None, anchors=None)
    tstate = TTrainState(step=0, params=params_from_numpy(zero, 'cpu'),
                         opt_state=None, pose_params=None,
                         pose_opt_state=None, pose_grad_acc=None,
                         anchors=None)
    want = jckpt.restore_from_path(tar, jstate)
    got = tckpt.restore_from_path(tar, tstate)
    assert got.step == int(want.step) == 41
    _same_tree(params_to_numpy(got.params), jax.tree.map(np.asarray,
                                                         want.params))
    assert got.params['cutoff_dist'].device == torch.device('cpu')


@pytest.fixture(scope='module')
def h5(tmp_path_factory):
    p = tmp_path_factory.mktemp('refined') / 'syn_train_h5py.h5'
    data = make_synthetic_h5(str(p), n_kps=N_KPS, n_cams=N_CAMS, H=16, W=16)
    return str(p), data


@pytest.mark.parametrize('legacy', [False, True])
def test_pose_refined_dataset_matches_jax(h5, tmp_path, legacy):
    """PoseRefinedDataset(load_refined=True) reads the refined poses of
    its subject's pose checkpoint in place of the h5's, as JAX's does."""
    path, data = h5
    rng = np.random.default_rng(5)
    tar = str(tmp_path / 'refined.tar')
    jcc.export_reference_checkpoint(
        tar, _params(4), pose_params={
            'pelvis': data['kp3d'][:, 0] + 0.01,
            'bones': data['bones'] + rng.normal(
                size=data['bones'].shape).astype(np.float32) * 0.05},
        rest_pose=data['rest_pose'])

    def refined(mod):
        class Refined(mod.PoseRefinedDataset):
            refined_paths = {'s': (tar, legacy)}
        return Refined(path, subject='s', load_refined=True, N_samples=8,
                       seed=0)

    got, want = refined(tds), refined(jds)
    for name in ('kp3d', 'bones', 'skts', 'cyls'):
        g, w = getattr(got, name), getattr(want, name)
        assert g.shape == w.shape == (N_KPS,) + w.shape[1:], name
        np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=name)
    assert not np.allclose(got.kp3d, data['kp3d'])
    rd, rw = got.get_render_data(), want.get_render_data()
    for k in ('kp3d', 'skts', 'c2ws', 'kp_idxs', 'cam_idxs'):
        np.testing.assert_allclose(rd[k], rw[k], atol=1e-5, err_msg=k)
    assert os.path.exists(tar)
