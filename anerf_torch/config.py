"""Configuration system: the full training/render flag surface.

The PyTorch port's own copy of `anerf_tpu/config.py`, so that the same
`configs/*.txt` and `args.txt` snapshots build the same configuration in
both packages. Flags that only the JAX package reads (XLA cache, scan
unroll, the numerics knobs) are kept so the files parse unchanged.

The reference's ~130 configargparse flags (run_nerf.py:184-488) are the
de-facto public API of the framework; this module mirrors them as a typed
dataclass, readable from the same `key = value` config txt files the
reference ships (configs/*/*.txt) and from CLI `--flag value` overrides.
Experiment snapshots (`args.txt`, `config.txt`) are written and re-parsed at
render time exactly like the reference (run_nerf.py:505-514,
run_render.py:992-993).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple


def _field(default, help=''):
    return dataclasses.field(default=default, metadata={'help': help})


@dataclasses.dataclass
class TrainConfig:
    # experiment
    config: Optional[str] = None
    expname: str = 'experiment'
    basedir: str = './logs/'
    datadir: str = './data/llff/fern'

    # training
    lindisp: bool = False
    netdepth: int = 8
    netwidth: int = 256
    netdepth_fine: int = 8
    netwidth_fine: int = 256
    N_rand: int = 32 * 32 * 4
    lrate: float = 5e-4
    lrate_decay: int = 250
    lrate_decay_rate: float = 0.1
    decay_unit: int = 1000
    # parsed for reference parity, dead in the reference too: its only
    # consumer is a literal `pass` (reference core/raycasters.py:219-220)
    weight_decay: Optional[float] = None
    single_net: bool = False
    coarse_weight: float = 1.0
    use_temp_loss: bool = False
    temp_coef: float = 0.05
    chunk: int = 1024 * 32          # render-time rays per device step
    netchunk: int = 1024 * 64       # kept for CLI parity; unused under jit
    no_reload: bool = False
    ft_path: Optional[str] = None
    n_iters: int = 200000
    loss_fn: str = 'MSE'
    loss_beta: float = 0.1
    reg_fn: Optional[str] = None
    reg_coef: float = 0.1
    init_poseopt: Optional[str] = None
    no_poseopt_reload: bool = False
    finetune: bool = False
    # freeze the first fix_layer density-trunk layers during finetune
    # (reference core/raycasters.py:215-217); wired via
    # train/state.py:freeze_mask_flat
    fix_layer: int = 0
    # parsed for reference parity, dead in the reference too: get_loss_fn
    # never passes to_yuv (reference core/trainer.py:147-157)
    use_yuv: bool = False

    # rendering
    density_scale: float = 1.0
    N_samples: int = 64
    N_importance: int = 0
    perturb: float = 1.0
    P_nms: float = 0.0
    use_viewdirs: bool = False
    i_embed: int = 0
    multires: int = 10
    multires_pts: int = 5
    multires_views: int = 4
    multires_bones: int = 0
    raw_noise_std: float = 0.0
    ray_noise_std: float = 0.0
    render_factor: int = 0
    save_image: bool = False

    # model
    nerf_type: str = 'nerf'
    density_type: str = 'relu'
    softplus_shift: float = 1.0
    n_subjects: int = 2

    # per-frame codes
    opt_framecode: bool = False
    n_framecodes: Optional[int] = None
    framecode_size: int = 16

    # pose optimization
    opt_rot6d: bool = False
    opt_pose: bool = False
    opt_pose_stop: Optional[int] = None
    opt_pose_coef: float = 0.0
    opt_pose_tol: float = 0.0
    opt_pose_type: str = 'B'
    opt_pose_step: int = 1
    opt_pose_lrate: float = 5e-4
    opt_pose_lrate_decay: int = 250
    opt_pose_decay_rate: float = 1.0
    # parsed for reference parity, near-dead in the reference: warmup only
    # feeds the unused PoseOptFlipFlop path (reference core/pose_opt.py:631)
    opt_pose_warmup: int = 0
    opt_pose_decay_unit: int = 400
    opt_pose_cache: bool = False
    opt_pose_joint: bool = False
    testopt: bool = False
    use_ckpt_anchor: bool = False

    # dataset
    num_workers: int = 8
    dataset_type: Tuple[str, ...] = ('h36m',)
    subject: Tuple[str, ...] = ('S9',)
    camera: Optional[int] = None
    use_val: bool = False
    white_bkgd: bool = False
    ext_scale: float = 0.001
    use_background: bool = False
    fg_ratio: Optional[float] = None
    kp_dist_type: str = 'reldist'
    view_type: str = 'relray'
    bone_type: str = 'reldir'
    pts_tr_type: str = 'local'
    train_skip: int = 1
    view_skip: int = 1
    N_cams: Optional[int] = None
    multiview: bool = False
    training_res: float = 1.0
    val_seq: Tuple[int, ...] = (6, 18)
    rand_train_kps: Optional[str] = None
    N_sample_images: int = 8
    image_batching: bool = False
    mask_image: bool = False
    patch_size: int = 1
    load_refined: bool = False

    # cutoff embedder
    use_cutoff: bool = False
    normalize_cutoff: bool = False
    cutoff_mm: float = 500
    cutoff_inputs: bool = False
    cut_to_dist: bool = False
    cutoff_shift: bool = False
    cutoff_viewdir: bool = False
    opt_cutoff: bool = False
    cutoff_step: int = 250
    cutoff_rate: float = 10.0
    cutoff_bones: bool = False
    cutoff_ancestors: int = 5
    freq_schedule: bool = False
    freq_schedule_step: int = 5
    init_freq: float = 0.0

    # logging / saving
    i_print: int = 100
    i_weights: int = 10000
    i_pose_weights: int = 2000
    i_testset: int = 50000
    i_video: int = 10000
    debug: bool = False

    # TPU-native additions (not in the reference)
    mesh_shape: Optional[int] = None   # data-parallel devices; None = all
    # persistent XLA compilation cache (first compile is 20-40s; re-runs
    # with the same config then start instantly). '' / 'none' disables.
    xla_cache_dir: Optional[str] = '~/.cache/anerf_tpu/xla'
    compute_dtype: str = 'bfloat16'    # MLP matmul dtype
    fast_grads: bool = False           # bf16 cotangents/PE: +18% step speed,
                                       # ~2 dB background-PSNR cost (PERF.md)
    # fine-grained fast-grads knobs (round-3 quality-recovery experiment,
    # VERDICT r2 weak #6). None = follow fast_grads; explicit True/False
    # overrides the corresponding half. SWEEP VERDICT (PERF.md round 3):
    # no combination recovers the no-cull fast-grads background quality —
    # even hifi_pe+fast_mlp+alpha_f32 ("fastv2", forward-bit-identical PE
    # + f32 density-head cotangents) loses ~2.4 dB global on the limbs
    # fixture. The cost lives in bf16 MLP activation cotangents
    # generally, so the default keeps f32; under deep culling
    # (cull_ratio <= 0.25) all fast flavors measured quality-equal.
    fast_pe: Optional[bool] = None     # bf16 PE emission+backward only
    fast_mlp: Optional[bool] = None    # bf16 MLP activation cotangents only
    # keep f32 cotangents on the alpha (density) head even under fast_mlp
    alpha_f32: bool = False
    # f32-forward / bf16-backward PE: forward bits identical to the
    # default (single rounding at emission); only the backward runs low
    # precision. Requires freq_schedule off. +6% alone, quality-safe
    # forward by construction.
    hifi_pe: bool = False
    # f32-forward / f32-backward PE with rematerialized (recomputed)
    # sin/cos in the backward instead of stored wide f32 residuals:
    # protocol-default gradient VALUES (f32 math throughout, only
    # reduction order differs ~1 ulp) at lower HBM traffic. Ignored when
    # fast_pe / fast_grads / hifi_pe lower the PE backward precision.
    remat_pe: bool = False
    # stochastically-rounded bf16 MLP activation cotangents: fast_mlp
    # speed with UNBIASED rounding (jax-graph analog of
    # pltpu.stochastic_round), targeting the systematic round-to-nearest
    # bias behind fast_grads' ~2 dB background loss. Experimental — a
    # numerics deviation that needs the multi-fixture quality protocol
    # before any default flip. PE backward stays f32 unless fast_pe set.
    sr_grads: bool = False
    # opt-in fused Pallas render kernel (transform+PE+MLP, custom-VJP
    # backward; kernels/fused_render.py). Requires the standard encoder
    # family + bfloat16. The backward's cotangent precision follows the
    # MLP fast-grads knob: with --fast_grads (or --fast_mlp) cotangent
    # matmuls run in bf16 (quality A/B in PERF.md); without, they stay
    # f32 end to end (value-preserving, protocol-default-numerics
    # candidate). build_render_config raises if requested but unsupported.
    fused_kernel: bool = False
    scan_unroll: int = 8               # train steps fused per device dispatch
    seed: int = 0
    # opt-in occupancy culling: keep ratio*N_samples samples per ray (the
    # ones inside the cutoff windows), skipping encode/MLP on the rest.
    # 0 disables. Diverges from the reference's measurement protocol —
    # report A/B both ways (see PERF.md).
    cull_ratio: float = 0.0
    cull_margin: float = 0.1           # widen keep region vs cutoff radius

    # --- parsed-but-dead reference flags, accepted for drop-in args.txt /
    # config compatibility. Each is defined by the reference parser
    # (run_nerf.py:184-488) and consumed NOWHERE in the reference code
    # (verified by grep; tests/test_config.py:test_flag_surface_covers_
    # reference audits this list against the reference source). They are
    # ignored here too.
    precrop_iters: int = 0             # vanilla-NeRF leftovers
    precrop_frac: float = 0.5
    opt_posecode: bool = False         # abandoned per-pose code idea
    use_bgnet: bool = False            # abandoned background-net family
    bgnet_stop: int = 500000
    bgnet_reg: float = 0.01
    use_bgfill: bool = False
    use_uncertainty: bool = False
    use_lbsnet: bool = False           # abandoned LBS-net family
    lbsnet_type: str = 'default'
    n_lbs: int = 1
    multires_lbs: int = 10
    multires_lbsviews: int = 4


_BOOL_TRUE = {'true', '1', 'yes', 'y'}
_BOOL_FALSE = {'false', '0', 'no', 'n'}


def _coerce(field: dataclasses.Field, raw):
    """Coerce a string (from txt/CLI) to the field's type."""
    if not isinstance(raw, str):
        return raw
    t = field.type
    raw = raw.strip()
    if raw.lower() == 'none':
        return None
    if t in ('bool', bool) or 'Optional[bool]' in str(t):
        if raw.lower() in _BOOL_TRUE:
            return True
        if raw.lower() in _BOOL_FALSE:
            return False
        raise ValueError(f'bad bool for {field.name}: {raw}')
    if t in ('int', int):
        return int(raw)
    if t in ('float', float):
        return float(raw)
    if 'Tuple[str' in str(t):
        return tuple(raw.replace(',', ' ').split())
    if 'Tuple[int' in str(t):
        return tuple(int(v) for v in raw.replace(',', ' ').split())
    if 'Optional[int]' in str(t):
        return int(raw)
    if 'Optional[float]' in str(t):
        return float(raw)
    return raw


def parse_config_txt(path: str) -> dict:
    """Parse a reference-style `key = value` config txt."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split('#', 1)[0].strip()
            if not line or '=' not in line:
                continue
            key, val = line.split('=', 1)
            out[key.strip()] = val.strip()
    return out


def load_config(argv: Optional[List[str]] = None,
                config_path: Optional[str] = None) -> TrainConfig:
    """Build a TrainConfig from (optional) config file + CLI-style overrides.

    argv: flat list like ['--config', 'x.txt', '--N_rand', '2048',
    '--use_cutoff'] (boolean flags may appear bare, matching the reference's
    store_true actions).
    """
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    values: dict = {}

    # 1st pass: find --config in argv
    argv = list(argv or [])
    if config_path is None and '--config' in argv:
        config_path = argv[argv.index('--config') + 1]
    if config_path:
        for k, v in parse_config_txt(config_path).items():
            if k in fields:
                values[k] = _coerce(fields[k], v)
            else:
                raise KeyError(f'unknown config key {k} in {config_path}')
        values['config'] = config_path

    # 2nd pass: CLI overrides
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith('--'):
            raise ValueError(f'unexpected token {tok}')
        name = tok[2:]
        if name == 'config':
            i += 2
            continue
        if name not in fields:
            raise KeyError(f'unknown flag --{name}')
        f = fields[name]
        is_bool = f.type in ('bool', bool) or 'Optional[bool]' in str(f.type)
        nxt = argv[i + 1] if i + 1 < len(argv) else None
        if is_bool and (nxt is None or nxt.startswith('--')):
            values[name] = True     # bare store_true style
            i += 1
        else:
            # n-ary tuple flags consume until next --flag
            if 'Tuple' in str(f.type):
                vals = []
                i += 1
                while i < len(argv) and not argv[i].startswith('--'):
                    vals.append(argv[i])
                    i += 1
                values[name] = _coerce(f, ' '.join(vals))
            else:
                values[name] = _coerce(f, nxt)
                i += 2
    return TrainConfig(**values)


def save_args_txt(cfg: TrainConfig, exp_dir: str) -> None:
    """Write args.txt + config.txt snapshots (run_nerf.py:505-514)."""
    os.makedirs(exp_dir, exist_ok=True)
    with open(os.path.join(exp_dir, 'args.txt'), 'w') as f:
        for fld in sorted(dataclasses.fields(cfg), key=lambda x: x.name):
            val = getattr(cfg, fld.name)
            if isinstance(val, tuple):
                val = ' '.join(str(v) for v in val)
            f.write(f'{fld.name} = {val}\n')
    if cfg.config is not None and os.path.exists(cfg.config):
        with open(cfg.config) as src, \
                open(os.path.join(exp_dir, 'config.txt'), 'w') as dst:
            dst.write(src.read())


def load_args_txt(path: str) -> TrainConfig:
    """Re-parse an args.txt snapshot into a TrainConfig
    (render-time reconstruction, run_render.py:992, evaluation_helpers
    txt_to_argstring equivalent)."""
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    values = {}
    for k, v in parse_config_txt(path).items():
        if k in fields:
            values[k] = _coerce(fields[k], v)
    return TrainConfig(**values)
