"""anerf_torch/tools/bench.py (the throughput bench) and its companion
CLIs (e2e_rate, sr_measure, step_trace, serve_bench) against bench.py and
__graft_entry__.py, on the CPU, at small widths.

Parity with JAX on the same inputs:
  * `_batch`: every array equal to __graft_entry__._batch's bit for bit
    (both are numpy draws from default_rng(1)), dtypes too; `_flagship`'s
    skeleton: rest, bones and pelvis bit for bit, kp3d / skts / cyls
    within 1e-6 absolute (FK in torch against FK in XLA, f32).
  * one scanned dispatch (unroll 2) of `build` from JAX's `build` state
    (convert.train_state_from_numpy), test mode (perturb 0, no noise),
    f32, 16 + 8 samples so that cull 0.125 keeps 8 of 16, against
    bench.py's build step taken twice (its unroll-2 scan runs that step
    twice; the two agree within 1.3e-7). Its losses within 1e-5 relative
    (observed <= 1.8e-7), its pose params 1e-5 relative to their largest
    (1.5e-6), its network params 1e-3 (5.5e-4 default, 1.6e-5 culled
    fast_grads): in the default flavour the second step turns the first
    step's 1e-6 gap into 5.5e-4 through near-zero ReLU inputs of the fine
    view branch, while that step from JAX's own state agrees within 3e-8.
  * the dispatch's first step alone, from the same state: losses, the
    network's params and Adam first moments, the pose params and their
    Adam first moments each within 1e-5 relative to their largest
    (observed <= 3.7e-6 params, 1.1e-6 first moments, 5.2e-6 pose first
    moments). The first moments are linear in the gradient, where Adam's
    first update, about lr * g / |g|, is not: they hold the gradients.
  * `measure_render`: the bboxes of every render_path call and the box-ray
    count equal to bench.py's at res 32, 2 views.
  * `main`: the line's keys equal to bench.py's line under the same stubs,
    plus the port's own (`device`, `launches`).
bench.py's scaling table is slow (tests/test_bench_scaling.py), so the
port's table is held to that test's schema rather than run beside it.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from anerf_torch.convert import train_state_from_numpy
from anerf_torch.tools import bench as tb
from anerf_torch.tools import flagship as tf
from anerf_torch.train.state import flatten_tree

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import __graft_entry__ as graft  # noqa: E402
import bench as jb  # noqa: E402

#: the bench's flagship cut to test size, in test mode
SMALL = dict(netwidth=32, netdepth=2, netwidth_fine=32, netdepth_fine=2,
             N_samples=16, N_importance=8, multires=3, multires_views=2)
TEST_MODE = dict(raw_noise_std=0.0, perturb=0.0, compute_dtype='float32')
LOSS_RTOL = 1e-5
STATE_RTOL = 1e-5
PARAM_RTOL = 1e-3
SKEL_ATOL = 1e-6


def _relmax(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(a).max(), 1e-12)


# ------------------------------------------------------------ the setup

def test_batch_and_skeleton_match_graft_entry():
    jargs, _, _, jpose = graft._flagship(n_frames=8, n_rays=256, n_images=4)
    args, cfg, params, pose = tf._flagship(n_frames=8, n_rays=256,
                                           n_images=4, device='cpu')
    assert not args.fused_kernel and not cfg.use_fused
    assert (args.N_rand, args.N_sample_images) == (256, 4)
    for k in ('rest_pose', 'bones', 'pelvis'):
        np.testing.assert_array_equal(pose[k], jpose[k])
    for k in ('kp3d', 'skts', 'cyls'):
        np.testing.assert_allclose(pose[k], jpose[k], rtol=0,
                                   atol=SKEL_ATOL)
    # the density bias as initialised: no lift
    b = params['coarse']['alpha_linear']['b']
    assert float(b.abs().max()) < 1.0

    want = graft._batch(jpose, 256, 4)
    got = tf._batch(jpose, 256, 4)
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v)
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    # a fresh generator each call: the same batch again
    again = tf._batch(jpose, 256, 4)
    assert all(np.array_equal(again[k], got[k]) for k in got)


def _gaps(jstate, state) -> dict:
    """Relative gaps (to the largest element) of a port state from a JAX
    state with numpy leaves: the network's flat params and Adam first
    moments, the pose params and their Adam first moments."""
    ref = train_state_from_numpy(jstate, 'cpu')
    pairs = {
        'params': (flatten_tree(ref.params), flatten_tree(state.params)),
        'mu': (ref.opt_state.mu, state.opt_state.mu),
        'pose_params': (flatten_tree(ref.pose_params),
                        flatten_tree(state.pose_params)),
        'pose_mu': (ref.pose_opt_state.mu, state.pose_opt_state.mu)}
    return {k: _relmax(a.numpy(), b.numpy()) for k, (a, b) in pairs.items()}


def _assert_losses(out, jout):
    for k, v in jout['losses'].items():
        assert abs(float(out['losses'][k]) - float(v)) <= \
            LOSS_RTOL * max(abs(float(v)), 1e-6), k


@pytest.mark.parametrize('flavour', [
    {}, dict(fast_grads=True, cull_ratio=0.125)],
    ids=['default', 'cull_fast'])
def test_build_dispatch_matches_bench(flavour):
    from anerf_torch.train.loop import upload_batch

    over = dict(SMALL, **TEST_MODE, **flavour)
    jstate, jstep, jstacks, _ = jb.build(unroll=1, **over)
    jbatch = {k: np.asarray(v) for k, v in jstacks[0].items()}
    # JAX's states before and after each of two steps, and their outputs
    js, jouts = [jax.tree.map(np.asarray, jstate)], []
    for i in range(2):
        s, o = jstep(jax.tree.map(jnp.asarray, js[-1]), jstacks[0],
                     jax.random.fold_in(jax.random.PRNGKey(0), i))
        js.append(jax.tree.map(np.asarray, s))
        jouts.append(o)

    state, step, stacks, rpd = tb.build(unroll=2, device='cpu', **over)
    assert rpd == 2 * 2048
    assert len(stacks) == 2
    # the port's stacks: JAX's batch at each step, up to its FK's
    # rounding (the rays aim at the roots); the steps then run on JAX's
    for k, v in jbatch.items():
        got = stacks[0][k].numpy()
        assert got.shape == (2,) + v.shape[1:], k
        if np.issubdtype(v.dtype, np.integer):
            assert got.dtype == np.int64, k
            np.testing.assert_array_equal(got, np.repeat(v, 2, 0), k)
        else:
            np.testing.assert_allclose(got, np.repeat(v, 2, 0), rtol=0,
                                       atol=SKEL_ATOL, err_msg=k)
    cpu = torch.device('cpu')

    # the first step alone from JAX's first state
    _, step1, _, _ = tb.build(unroll=1, device='cpu', **over)
    new, out = step1(train_state_from_numpy(js[0], 'cpu'),
                     upload_batch(tb._int64(jbatch), cpu),
                     torch.Generator().manual_seed(0))
    _assert_losses(out, jouts[0])
    gaps = _gaps(js[1], new)
    assert max(gaps.values()) < STATE_RTOL, gaps

    # the scanned dispatch of two steps from JAX's first state
    two = upload_batch(
        tb._int64({k: np.repeat(v, 2, 0) for k, v in jbatch.items()}), cpu)
    new, out = step(train_state_from_numpy(js[0], 'cpu'), two,
                    torch.Generator().manual_seed(0))
    _assert_losses(out, jouts[1])
    gaps = _gaps(js[2], new)
    assert gaps['pose_params'] < STATE_RTOL, gaps
    assert gaps['params'] < PARAM_RTOL, gaps
    assert new.step == int(js[2].step) == 2


def test_cull_flavour_culls():
    """At SMALL's 16 coarse samples cull 0.125 keeps 8, as in JAX."""
    import dataclasses

    from anerf_tpu.render.factory import build_render_config
    from anerf_tpu.skeleton import SMPLSkeleton

    over = dict(SMALL, cull_ratio=0.125, fast_grads=True)
    _, cfg, _, pose = tf._flagship(n_frames=8, device='cpu', **over)
    jargs = dataclasses.replace(graft._flagship(n_frames=8)[0], **over)
    jcfg = build_render_config(jargs, {'skel_type': SMPLSkeleton,
                                       'n_views': 8,
                                       'rest_pose': pose['rest_pose']})
    assert cfg.n_keep == jcfg.n_keep == 8 < cfg.n_samples


def _spy(monkeypatch, module, seen):
    """render_path recording each call's boxes, its buckets cut to 512
    rays (the flagship's chunk pads every view to 16k rays, slow on the
    CPU; the boxes do not depend on it)."""
    fn = module.render_path

    def spy(*a, **kw):
        out = fn(*a, **dict(kw, chunk=512))
        seen.append([tuple(map(tuple, np.asarray(b).tolist()))
                     for b in out['bboxes']])
        return out
    monkeypatch.setattr(module, 'render_path', spy)


def test_measure_render_boxes_match_bench(monkeypatch):
    from anerf_torch.render import render_path as trp
    from anerf_tpu.render import render_path as jrp

    jseen, tseen = [], []
    _spy(monkeypatch, jrp, jseen)
    _spy(monkeypatch, trp, tseen)
    jmed, jrates = jb.measure_render(cull_ratio=0.125, n_views=2, res=32,
                                     n_repeats=1)
    med, rates = tb.measure_render(cull_ratio=0.125, n_views=2, res=32,
                                   n_repeats=1, device='cpu')
    assert len(tseen) == len(jseen) == 2
    assert tseen == jseen
    n_box = sum((br[0] - tl[0]) * (br[1] - tl[1]) for tl, br in tseen[-1])
    assert n_box > 0
    assert len(rates) == len(jrates) == 1
    assert med > 0 and np.isfinite(med)


# ---------------------------------------------------- in-loop, scaling

@pytest.fixture
def tmpdir_is(tmp_path, monkeypatch):
    """The temp directory the tools write to, in tmp_path."""
    import tempfile
    monkeypatch.setattr(tempfile, 'gettempdir', lambda: str(tmp_path))
    return tmp_path


@pytest.fixture
def no_tensorboard(monkeypatch):
    """train() without tensorboard, as on the card (its import takes
    10-30 s here)."""
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)


def test_measure_e2e_marks(tmpdir_is, no_tensorboard):
    tmp_path = tmpdir_is
    rate, prof = tb.measure_e2e(
        steps=40, warm_steps=10, workers=1, unroll=2, i_print=10,
        device='cpu', N_rand=64, N_sample_images=4, chunk=1024, **SMALL)
    assert np.isfinite(rate) and rate > 0
    assert len(prof) == 1 and prof[0] > 0
    # the fixture was written: the port imports make_synthetic_h5
    assert os.path.exists(tmp_path / 'torch_e2e_rate_fixture'
                          / 'syn_train_h5py.h5')


def test_bench_measure_e2e_lacks_make_synthetic_h5(tmpdir_is):
    """The fault the port does not copy: bench.py's measure_e2e calls
    make_synthetic_h5 without importing it, so on a host without the
    cached fixture it raises before training."""
    with pytest.raises(NameError, match='make_synthetic_h5'):
        jb.measure_e2e(steps=2, warm_steps=1)
    assert 'make_synthetic_h5' not in vars(jb)


def test_scaling_table_cpu_schema(tmp_path, capsys):
    out = tmp_path / 'scaling.json'
    table = tb.scaling_table(2, out_json=str(out), device='cpu')
    assert json.loads(out.read_text()) == table
    assert table['platform'] == 'cpu-virtual'
    assert table['sizes'] == [1, 2]
    train = table['train']
    assert [r['devices'] for r in train] == [1, 2]
    assert all(r['rays_per_sec'] > 0 for r in train)
    assert train[0]['eff'] == 1.0
    assert all('total_vs_single' in r for r in train)
    render = table['render']
    assert [r['devices'] for r in render] == [1, 2]
    for r in render:
        assert r['correctness_only'] is True
        assert r['total_vs_single'] > 0
        assert set(r) == {'devices', 'total_vs_single', 'correctness_only'}
    assert 'note' in table
    last = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{')][-1]
    j = json.loads(last)
    assert j['metric'] == 'weak_scaling_eff'
    assert 'render_total_vs_single' in j


def test_card_paths_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip('a GPU is present')
    with pytest.raises(RuntimeError, match='cards wanted|CUDA'):
        tb.scaling_table(2)
    with pytest.raises(RuntimeError, match='CUDA'):
        tb.main([])
    with pytest.raises(RuntimeError, match='CUDA'):
        tb.build(fused_kernel=True, unroll=1, **SMALL)


# ------------------------------------------------------------ the line

def _fake_run(cmd, *a, **kw):
    """subprocess.run standing in for the scaling subprocess: writes an
    empty table where --scaling_json points."""
    path = cmd[cmd.index('--scaling_json') + 1]
    with open(path, 'w') as f:
        json.dump({}, f)
    return subprocess.CompletedProcess(cmd, 0, '', '')


def _stub(monkeypatch, module, built):
    def build(**kw):
        built.append(kw)
        return None, None, None, 1

    monkeypatch.setattr(module, 'build', build)
    monkeypatch.setattr(module, 'measure',
                        lambda *a, **kw: (100.0, 120.0, [90., 100., 120.],
                                          None))
    monkeypatch.setattr(module, 'measure_render',
                        lambda **kw: (5.0, [4.0, 5.0, 6.0]))
    monkeypatch.setattr(module, 'measure_e2e', lambda **kw: (7.0, [7.0]))


def _last_json(capsys):
    return json.loads([ln for ln in capsys.readouterr().out.splitlines()
                       if ln.startswith('{')][-1])


@pytest.mark.parametrize('flags', [[], ['--skip_fast_grads'],
                                   ['--skip_scaling']],
                         ids=['full', 'skip_fast_grads', 'skip_scaling'])
def test_main_line_has_bench_keys(monkeypatch, capsys, flags):
    import anerf_tpu.utils.device_lock as lock

    monkeypatch.setattr(subprocess, 'run', _fake_run)
    jbuilt, tbuilt = [], []
    _stub(monkeypatch, jb, jbuilt)
    monkeypatch.setattr(jb, 'device_liveness_check', lambda: None)
    monkeypatch.setattr(lock, 'acquire', lambda *a, **kw: None)
    monkeypatch.setattr(sys, 'argv', ['bench.py'] + flags)
    jb.main()
    want = _last_json(capsys)

    _stub(monkeypatch, tb, tbuilt)
    line = tb.main(flags + ['--device', 'cpu'])
    assert _last_json(capsys) == line
    assert set(line) - tb.PORT_KEYS == set(want)
    assert tb.PORT_KEYS <= set(line)
    assert line['device'] == 'cpu'
    assert set(line['launches']) == {
        k for k in want if k.startswith(('protocol_default_', 'headline_'))
        and not k.endswith(('_spread', '_config'))}
    # the same builds in the same order
    assert [{k: v for k, v in b.items()
             if k in ('fast_grads', 'cull_ratio', 'fused_kernel')}
            for b in tbuilt] == jbuilt
    for k, v in want.items():
        if k not in ('scaling',):
            assert line[k] == v, k
    assert not tb.bad_rates(line)


def test_fused_failure_fails_the_run(monkeypatch, capsys):
    """No fallback: a fused build that raises ends the run (bench.py would
    write fused_error)."""
    _stub(monkeypatch, tb, [])
    built = tb.build

    def build(**kw):
        if kw.get('fused_kernel'):
            raise RuntimeError('K1 did not launch')
        return built(**kw)

    monkeypatch.setattr(tb, 'build', build)
    with pytest.raises(RuntimeError, match='K1 did not launch'):
        tb.main(['--device', 'cpu', '--skip_scaling'])
    assert 'fused_error' not in capsys.readouterr().out


def test_auxiliary_error_exits_nonzero(monkeypatch, capsys):
    _stub(monkeypatch, tb, [])

    def fail(**kw):
        raise ValueError('no render')

    monkeypatch.setattr(tb, 'measure_render', fail)
    with pytest.raises(SystemExit) as e:
        tb.main(['--device', 'cpu', '--skip_scaling'])
    assert e.value.code == 1
    line = _last_json(capsys)
    assert line['render_error'] == 'no render'
    assert tb.errors(line) == ['render_error']


# ---------------------------------------------------- the companion CLIs

@pytest.fixture
def tiny_builds(monkeypatch):
    """bench.build at SMALL, one step a dispatch; measure at one timed
    dispatch and no warm one (the CLIs call them by name)."""
    import functools
    monkeypatch.setattr(tb, 'build',
                        functools.partial(tb.build, unroll=1, **SMALL))
    monkeypatch.setattr(tb, 'measure', functools.partial(
        tb.measure, n_warmup=0, n_repeats=1, n_dispatch=1))


def test_sr_measure_cli(tiny_builds, capsys):
    from anerf_torch.tools import sr_measure

    rows = sr_measure.main(['--device', 'cpu'])
    assert list(rows) == [label for label, _ in sr_measure.CONFIGS]
    for r in rows.values():
        assert r['median'] > 0 and r['best'] >= r['median']
        assert r['wall_s'] >= 0
    assert _last_json(capsys) == rows


def test_step_trace_cli(tiny_builds, tmp_path, monkeypatch):
    import functools

    from anerf_torch.tools import step_trace

    monkeypatch.setattr(step_trace, 'capture', functools.partial(
        step_trace.capture, warmup=1))
    path = tmp_path / 'trace.json'
    res = step_trace.main(['--device', 'cpu', '--dispatches', '1',
                           '--top', '5', '--fast_grads', '--cull', '0.125',
                           '--json', str(path)])
    assert json.loads(path.read_text())['rows'] == res['rows']
    assert 0 < len(res['rows']) <= 5
    assert res['config'] == {'fused_kernel': False, 'fast_grads': True,
                             'cull_ratio': 0.125}
    assert all(r['lane'] == 'cpu' and r['ms'] > 0 and r['n'] > 0
               for r in res['rows'])
    assert res['rays_per_s'] > 0


def test_kernel_rows_names_k2_layer_launches():
    """The parser names each launch of K2's layer kernel by its place
    after the call's heads launch, and adds the times of a name."""
    from torch.autograd import DeviceType

    from anerf_torch.tools.step_trace import kernel_rows

    class _E:
        def __init__(self, t, key, us):
            self.time_range = type('R', (), {'start': t})()
            self.key, self.device_type = key, DeviceType.CUDA
            self.self_device_time_total = us

    names = ['k1', 'heads_bwd_kernel', 'bwd_layer_kernel<3>',
             'bwd_layer_kernel<3>', 'pe_kernel', 'k1', 'heads_bwd_kernel',
             'bwd_layer_kernel<3>', 'bwd_layer_kernel<3>']
    prof = type('P', (), {'events': lambda self: [
        _E(i, n, 10 + i) for i, n in enumerate(names)]})()
    rows = {k: (us, n) for us, n, k in kernel_rows(prof)}
    assert rows['k1'] == (10 + 15, 2)
    assert rows['bwd_layer_kernel<3> [1 after heads_bwd_kernel]'] == (
        12 + 17, 2)
    assert rows['bwd_layer_kernel<3> [2 after heads_bwd_kernel]'] == (
        13 + 18, 2)
    assert {k for _, _, k in kernel_rows(prof, split=None)} == {
        'k1', 'heads_bwd_kernel', 'bwd_layer_kernel<3>', 'pe_kernel'}


def test_e2e_rate_cli(tmpdir_is, no_tensorboard, monkeypatch, capsys):
    import functools

    from anerf_torch.tools import e2e_rate

    monkeypatch.setattr(tb, 'measure_e2e', functools.partial(
        tb.measure_e2e, i_print=2, N_rand=64, N_sample_images=4,
        chunk=1024, **SMALL))
    line = e2e_rate.main(['--device', 'cpu', '--steps', '8',
                          '--warm_steps', '2', '--unroll', '2',
                          '--workers', '1'])
    assert line['metric'] == 'e2e_inloop_rays_per_sec'
    assert line['value'] > 0 and line['per_1k_rates']
    assert line['config'] == 'cull 0.125 fast, workers=1 unroll=2'
    assert _last_json(capsys) == line


def test_serve_bench_cli(tmpdir_is, no_tensorboard, monkeypatch,
                         capsys):
    from anerf_torch.tools import serve_bench

    monkeypatch.setattr(serve_bench, 'MODEL', dict(
        serve_bench.MODEL, N_rand=64, N_sample_images=4, chunk=1024,
        scan_unroll=10, **SMALL))
    monkeypatch.setattr(serve_bench, 'N_ITERS', 10)
    res = serve_bench.main(
        ['--device', 'cpu', '--res', '16', '--n_req', '2',
         '--tcp_clients', '1', '2', '--tcp_req', '2'])
    assert res['metric'] == 'serve_coalesce_speedup'
    assert res['serial_s_per_req'] > 0 and res['coalesced_s_per_req'] > 0
    rows = res['tcp']['rows']
    assert [r['clients'] for r in rows] == [1, 2]
    assert all(r['n_requests'] == 2 and r['req_per_s'] > 0
               and r['mean_server_render_s'] > 0 for r in rows)
    assert res['tcp']['throughput_gain'] > 0
    assert _last_json(capsys) == res
