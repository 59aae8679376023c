"""Smoke test of the PyTorch / CUDA port (anerf_torch) on one GPU.

    python3 chip_smoke.py [--profile]
    python3 chip_smoke.py --cards N    # phase 1 and phase 11 alone, over
                                       # N cards (one rank a card, NCCL)
    python3 chip_smoke.py --quality    # phase 1 and phase 12 alone
    python3 chip_smoke.py --bench      # phase 1 and phase 13 alone
    python3 chip_smoke.py --shapes     # phase 1 and phase 14 alone

Phases (any failure exits non-zero and prints no result):
  1. device: needs CUDA; prints the card and its power limit, turns TF32
     and cuBLAS's reduced-precision bf16 sums off, builds the hand-written kernels from the checkout (one nvcc per
     source, started together; sm_90a).
  2. kernels: K1 (fused_encode_mlp_pts, the wgmma kernel) and K1-v1 (its
     first, mma.sync version, kept as the comparison) against their plain
     PyTorch version and against each other at the flagship width on one
     4096-ray bucket, S = 64 and S = 80 (and the culled S = 8 and 24),
     tau = 2000 and 35; error against
     a stated tolerance, median times (CUDA events, inputs varied between
     reps) of K1-v1 and K1 in turns (v1, K1, K1, v1) beside the bound and
     beside the MLP's products as a chain of bf16 torch.matmul calls (a
     yardstick for K1's phase B; never on the port's path). K2
     (fused_bwd, split-bf16 wgmma products) and K2-v1 (fused_bwd_v1, its
     first version, f32 FMA products) the same way on one training batch
     (2048 rays, S = 64 on the coarse net and S = 80 on the fine net):
     every output against the plain version and K2 against K2-v1, a
     second launch on the same inputs held to the same bits, both timed
     in turns beside the bound (roofline.k2_seconds) and beside the
     products as f32 torch.matmul calls (TF32 off; a yardstick); the
     launches of one call; the split products (split_gemm_probe) against
     an f64 matmul beside K2-v1's FMA GEMM on the same inputs. K2's bf16
     flavour (fused_bwd(..., bwd_f32=False)) on the same batch at S = 64,
     80 and the culled 8, 24: against its plain version within
     K2_BF16_FRO, which K2's f32 flavour (the control) must exceed, two
     launches bit-equal, its launches a call; at S = 8 and 24 also K2's
     f32 flavour against its plain version; both flavours timed in turns
     (f32, bf16, bf16, f32) beside their bounds.
  3. modes and stages: K3 (fused_encode_mlp) and K4 (fused_mlp_apply),
     K1's kernel in its other input modes, on the K1 phase's bucket, each
     against its plain version, against K1 on the same points and against
     its first version (K3-v1, K4-v1: K1-v1's body), timed in turns with
     it (v1, new, new, v1) beside its bound, K4 also beside its function
     as a chain of bf16 torch.matmul calls on its own inputs; the
     surreal_single network (single_net, multires_views 0) on one
     512-ray bucket: K1, K3 and K4 against their plain versions at S = 96,
     48 and 144, K2 in both flavours against its plain version at S = 96
     and 144; every stage of K1-d
     and K2-d (the staged kernels of anerf_torch/kernels/stages.py) on
     the K2 phase's batch against its plain digest, the full stages bit
     for bit against K1 and K2, timed beside their bounds; then the
     kernel_bench tool's three modes (anerf_torch/tools/kernel_bench.py:
     default, --decompose, --decompose_bwd) at 2048 rays, S = 64 and 80,
     the main path of K3, K4, K1-d and K2-d; K2-d's bf16 flavour at
     S = 8 and 24 against its plain digests, and the tool's --bwd_bf16
     rows (default and --decompose_bwd) at S = 8 and 24.
  4. render slice: the flagship SURREAL model (random weights from a seed,
     fused_kernel on, chunk 4096) answers three render_path requests at
     512 x 512 (bullet time of one pose, two selected poses, the bullet
     time again); each is checked for finite output and for two K1
     launches per ray bucket. A small ray batch through render_rays on the
     fused branch is held against the plain-torch branch, also with
     culling (cull_ratio 0.125). The culled render: the first request
     again at cull_ratio 0.125, its box-rays/s.
  5. train slice: one step's gradients on the fused branch (K1 + K2) held
     against the plain-torch branch on 256 rays; then 20 train steps of
     the flagship (N_rand 2048, 128 frames, pose refinement) through
     make_train_step, checked for finite and falling loss, acc in [0, 1],
     two K1 and two K2 launches per step, and poses that move only on
     their opt_pose_step interval. K1-v1, K2-v1, K3-v1 and K4-v1 must not
     run on the main paths (render and train), nor K3-v1 and K4-v1 on
     the kernel_bench path.
  6. culled fast-grads train slice: the same setup with cull_ratio 0.125
     and fast_grads (the coarse net at S = 8, the fine net at 8 + 16 =
     24, K2's bf16 flavour): one step's gradients with K2 against the
     same step with K2's plain bf16 version (fused_bwd_ref(...,
     bwd_f32=False) on the card's tensors); then N_CULL_STEPS steps,
     checked as above with two K1 and two bf16 K2 launches a step and no
     f32 K2; ms/step, rays/s, and one step under torch.profiler for the
     device idle share.
  7. training loop: `python -m anerf_torch.run_nerf`'s main, in this
     process, on the synthetic SURREAL grid (64 poses x 4 cameras at
     512 x 512, make_synthetic_h5, or its arrays in memory where h5py is
     absent) with configs/surreal/surreal.txt and the flagship's
     overrides (fused kernel, pose refinement): run 1 trains 48 steps in
     scanned dispatches of 8 (checkpoints and pose snapshots at 24 and
     48, a validation render at 48), run 2 resumes from 48 to 64. Gates:
     psnr rises, every logged value finite; checkpoint 48 restores run
     1's final state bit for bit; the pose snapshots load; the
     validation PSNR / SSIM finite (16 pngs where imageio is present);
     every batch from the native super-batch assembler; K1 and K2 (f32)
     two launches a step, K1 two more a validation bucket. Prints the
     loop's rays/s, one dispatch's loader wait / upload / steps split and
     the idle share of run 2's second dispatch under torch.profiler.
  8. render entry point: python -m anerf_torch.run_render's one-shot CLI,
     stdin and TCP servers and .tar round trip on the loop phase's
     experiment (render_entry_phase).
  9. dataset types: K1 and K2 (f32) at the configs' 3072-ray batches
     against their plain versions; then run_nerf.main on fixtures of the
     other dataset types' layouts (anerf_torch/data/fixtures.py) made from
     the loop phase's grid: H36M with configs/h36m/h36m_prot2.txt through
     the catalog (48 steps, checkpoint and validation at 48, a
     DeviceProfiler window over dispatches 3-4, resumed to 56), H36M with
     --multiview twice (bit-equal), MonoPerfCap, Mixamo, ZJU and 3DHP 16
     steps each, and a run_render val request through the h36m / S9 render
     catalog entry (datasets_phase).
 10. plain-branch knobs (knobs_phase), the flagship's width (8 x 256,
     multires 7 / 4, 64 + 16 samples, N_rand 2048) with the fused kernel
     off: (a) the JAX bench's headline_xla (cull_ratio 0.125,
     fast_grads): one step's gradients on 256 rays against the fused
     step (K1 + K2-bf16) within STEP_GRAD_RTOL (max) and KNOB_FRO
     (Frobenius), N_KNOB_STEPS steps finite with the loss falling and no
     K1 / K2 launch, ms and rays/s beside phase 6's fused step, one
     step's idle share under torch.profiler; (b) sr_grads: the SR cast of
     a fixed tensor and key on the card bit-equal to the CPU's, then
     N_KNOB_STEPS steps; (c) hifi_pe and remat_pe (culled, no
     fast_grads): the 256-ray forward bit-equal to the default's,
     remat_pe's gradients within REMAT_RTOL, and one step each of
     fast_pe and alpha_f32; (d) KNOB_ENCODERS (relpos, cat, querypts,
     axisang, rayangle, world, freq_schedule, normalize, cut_to_cutoff,
     shift_inputs) N_ENCODER_STEPS steps each, unculled: finite, loss
     falling.
 11. data parallel (dp_phase): two ranks on the one card (gloo, spawned
     by anerf_torch/parallel/mesh.py:run_ranks), each held against one
     rank: (a) the train step and the culled fast-grads step (losses,
     all-reduced gradients, each ray's raw and rgb bit-equal, the ranks'
     states bit-equal, launches a rank, one all-reduce of the step's
     own beside fused_apply's two, which no gradient crosses twice);
     (c) a 512 x 512 render_path
     (mesh=) request bit-equal; (b) run_nerf.main on the loop phase's
     grid, 24 steps (the same super-batches, states bit-equal, the
     checkpoint written once and restored by a one-rank setup, rays/s
     reported); (d) two stdin requests through run_render.main --server
     on 2 ranks (replies from rank 0 alone, equal to one device's). It
     checks correctness only: the two ranks share one card.
 12. quality (quality_phase): anerf_torch/tools/quality_ab.py, the
     quality A/B, on the blobs fixture at seed 0, N_QAB_STEPS steps a
     cell at the flagship width: control, culled, refine and
     refine_culled on the fused branch (K1 two launches a step and two
     a validation bucket; K2 f32 two a step for control and refine, K2
     bf16 two a step and no f32 for the culled fast-grads ones) and
     control on the plain branch (no K1 / K2); every row finite and the
     losses in each cell's metrics.jsonl falling; the refine cells'
     init_mpjpe_mm equal to the host's and their poses moved; then
     `python -m anerf_torch.tools.quality_ab` in a subprocess on the same
     state trains nothing and prints the same verdict line. Prints the
     card settings in force, each cell's seconds and rays/s, and the
     fused - plain and culled - control deltas (not gated).
 13. throughput bench (bench_phase): anerf_torch/tools/bench.py's
     throughput line in process at small counts (BENCH_UNROLL steps a
     dispatch, BENCH_MEASURE dispatches) for its four builds (plain and
     fused protocol default, plain and fused headline), measure_render
     (BENCH_RENDER), measure_e2e (BENCH_E2E) and scaling_table(1) on the
     card: every rate finite and > 0, no *_error field, the fused builds
     two K1 and two K2 f32 launches a step and no K2 bf16, the plain
     builds none, and every key of bench.py's line (BENCH_KEYS).
 14. kernel shapes (shapes_phase): the fused kernels at the shapes of
     anerf_torch/kernels/roofline.py:SHAPES beyond the flagship's, each
     on the route fused_render.route_plan picks (the layered route at
     8 x 512 and at multires 10 / 6 with 32 framecode columns, the single
     kernel at two weight stages at multires 10 / 4, at three at depths
     5 and 40): K1, K3, K4 against their plain versions (K1_ATOL); K2's
     saved activations (its recompute) layer by layer against f64 on
     their own inputs (ACT_LOCAL_FRO) and against the plain forward
     (ACT_FRO, ACT_FLIP); K2 in both flavours against the plain backward
     on those activations (K2_FRO, K2_BLOCK_RTOL) and, up to
     K2_OWN_DEPTH layers, against the plain version with its own
     recompute (K2_FRO); the bf16 flavour's MLP backward within
     K2_BF16_FRO scaled by depth / 8 (the f32 flavour above it), also
     at BF16_PROBE_DEPTHS; second launches bit-equal, times beside their
     bounds (roofline.config_bounds), the layered route's design floor
     (roofline.layered_design_bytes) and their plain versions, K4 timed
     in turns with its bf16 matmul chain and, on the layered route, no
     slower than it; the layered GEMM's cluster tails (an odd count of
     128-point tiles, the last one partial: K1, K4, K2's saved
     activations); the multires 10 / 4 shape again forced onto the
     layered route, its times beside the two-stage kernel's; K4 at a
     second two-stage config (K4_TWO_STAGE_BANDS), the single kernel at
     two stages and the layered route both forced, timed in turns; the
     layered route split by launch at wide-net and wide-input, each
     launch beside its own HBM floor (kernel_bench --layered; a split
     the profiler missed is printed n/m; no copy launch may run: K2's
     recompute writes its saved activations where they are made);
     then one step's gradients against the plain branch at wide-net and
     wide-input (K2-bf16 against its plain version at wide-net culled)
     and N_SHAPE_STEPS train steps at wide-net,
     wide-input and wide-net culled with fast_grads (two K1 and two K2
     a step, through the layered route), one 512 x 512 request at
     wide-net and run_nerf.main SHAPE_LOOP_STEPS steps at wide-net on
     the loop phase's grid; prints the phase's seconds
     (SHAPES_BUDGET_S). The kernels line gets a sub-row per kernel and
     shape.
With --profile, one request and one train step run again under
torch.profiler, and for each the device-busy share and the top kernels
by device time are printed.
The last lines are a JSON `kernels` record, the card line, and
{"ok": true, "device": {...}}.
"""
import json
import math
import subprocess
import sys
import time

# the driver's budget is 1200 s; this script aims to finish in well under
# half of it
H = W = 512                     # the requests' image size
# K1 vs its plain version: both round the same activations to bf16, so
# they differ only by fp32 summation order and sin/cos ulps, which flip an
# occasional bf16 rounding; observed max 5.0e-4 abs on an H100 (raw values
# up to ~2). 2e-3 keeps a 4x margin (the JAX fused-vs-XLA bound is 3e-2).
K1_ATOL = K1_RTOL = 2e-3
# render_rays through K1 vs the plain-torch branch, which rounds each
# layer's product to bf16 as XLA does: observed 4e-5 on rgb / acc.
SLICE_ATOL = SLICE_RTOL = 5e-3
# K2 vs its plain version, on every output (each dW block, dpts, dm_all,
# daux): 2e-2 relative in the Frobenius norm (the JAX kernel-vs-oracle
# bound, tests/test_fused_render.py:119) and 0.12 relative max with the
# denominator floored at 1e-7 (the JAX fused-vs-XLA gradient bound,
# tests/test_fused_render.py:260). K2's recompute and the plain version
# sum in another order, so across a batch's 10^5 points a few
# pre-activations land on the other side of 0 or of a bf16 rounding
# step and flip a ReLU mask. That moves one point's cotangent by a whole
# unit's contribution, and at tau = 2000 the window derivative (up to
# tau / 4 = 500) multiplies it into that point's dpts and its ray's
# dm_all / daux. The run prints how many rays are off by more than
# K2_RTOL of the largest value.
K2_RTOL = 2e-2
K2_FRO = 2e-2
K2_BLOCK_RTOL = 0.12
# K2 vs K2-v1 on every output, relative in the Frobenius norm. Both make
# f32-accurate cotangent products (K2 from three bf16 planes of the
# cotangent on the tensor cores, K2-v1 with f32 FMAs), and on this run's
# seeded batch no ReLU mask flips between their recomputes, so they differ
# by f32 accumulation order alone: observed at most 1.44e-6 on an H100 (a
# dW block; dpts / dm_all / daux at most 4.1e-7). 5e-6 is 3.5x that. A K2
# whose tensor cores summed a whole 2048-point chunk read 7.3e-6 to
# 8.6e-6, and K2 on the hi plane alone (bf16 cotangents), which the phase
# runs as a control, must land above the limit. A change to either
# recompute that flips a mask breaks this gate: set it again from readings.
K2_V1_FRO = 5e-6
# K2's bf16 flavour's MLP backward (its mlp stage: dW and the MLP inputs'
# cotangents dx0 / dxv) vs the plain bf16 version run on the kernel's own
# saved activations (fused_render.trace_from_act), worst relative
# Frobenius distance of any dW block, dx0 or dxv. On the same activations
# no mask can flip, so the two differ by f32 summation order and the bf16
# roundings of cotangents it moves, which the layers after carry on:
# observed 3.8e-4 to 5.0e-4 on an H100 (S = 64, 80, 8; the worst a dW
# block of the first layers). K2's f32 flavour against the same plain
# bf16 version is the control and must land above the limit: it read
# 4.4e-3 to 4.8e-3. 1.5e-3 is 3x the readings and 3x below the control.
# (Against the plain version's own recompute both flavours read 7.7e-3 to
# 1.4e-2, the flipped masks' share, so that comparison cannot tell the
# flavours apart.)
K2_BF16_FRO = 1.5e-3
# Phase 14's K2 against the plain version with its own recompute, gated at
# K2_FRO up to this many trunk layers (read 5.9e-3 to 1.86e-2 on an H100
# at depth 5 and 8). Deeper, the two recomputes' small differences
# (ACT_*) grow through the backward of the trunk: at 40 layers both
# flavours read 2.79e-2 / 4.05e-2, and the plain backward run on K2's
# saved activations reads the same distance from its own recompute to
# three digits, so the gap is the recomputes', not K2's backward's.
K2_OWN_DEPTH = 8
# K2's saved activations (its recompute: the single kernel's SAVE or the
# layered route's phase A and layer epilogues, which write the act layout
# where the activations are made) at phase 14's shapes, block
# by block. ACT_LOCAL_FRO: each MMA layer's saved output against that
# layer run in f64 on the kernel's own saved input (relative Frobenius):
# f32 summation order alone moves an occasional bf16 rounding, and no
# error carries over from the layers before; read 4.1e-5 to 8.2e-5 on an
# H100. ACT_FRO / ACT_FLIP: each block (x0, xv, every h, feat, hv)
# against the plain forward's trace, relative Frobenius, and the share
# of a layer's ReLU masks that differ; here the roundings compound from
# layer to layer: read 2.5e-4 to 6.0e-4, and at most 2.3e-5 of a layer's
# masks up to depth 8, 1.3e-4 at 40. Each limit is 5x to 8x the
# readings; a column, tile or transpose out of place is an error of
# order 1 in the Frobenius distances and flips a large share of masks.
ACT_LOCAL_FRO = 5e-4
ACT_FRO = 3e-3
ACT_FLIP = 1e-3
# one train step's gradients, fused branch vs plain branch: the bound of
# the JAX package's fused-vs-XLA gradient test
# (tests/test_fused_render.py:217-261)
STEP_GRAD_RTOL = 0.12
N_TRAIN_STEPS = 20
N_CULL_STEPS = 20
# K3 and K4 against K1 on the same points (K3 fed build_raw_inputs of
# them, K4 the plain version's embedded inputs): each pair computes its
# geometry or trig in another f32 order, which flips an occasional bf16
# rounding, as K1 and its plain version do; so K1's tolerance.
CROSS_ATOL = CROSS_RTOL = 2e-3
# K1-d's early stages against their plain digests, relative to the
# digest's largest value: a digest sums about 280 bf16 MLP inputs (or 24
# geometry values) a column, and the kernel and the plain version round
# an occasional input to the next bf16 value (the __sincosf stage more
# often: the intrinsic is off by up to about 1e-4 at the PE's largest
# angles), each time by at most 2^-8 of that input.
DIGEST_RTOL = 1e-2
# K2-d's per-point outputs that K2 does not return (the mlp stage's MLP
# input cotangents dx0 / dxv, the pe stage's digest): a flipped ReLU mask
# moves one point's row by a whole unit's contribution, which no sum over
# points dilutes, so a bound on the max does not fit them (observed: an
# entry off by 0.127 of the largest at S = 80 on an H100, Frobenius
# 5.2e-3).
# They are held to K2_FRO in the Frobenius norm, and at most this share
# of the points may have an entry off by more than K2_RTOL of the
# output's largest value (K2's own phase saw at most 10 of 2048 rays off,
# i.e. at most 10 of 163,840 points).
K2D_POINTS_OFF = 1e-3


def _median_ms(fn, inputs, reps):
    import torch
    times = []
    for i in range(reps):
        args = inputs[i % len(inputs)]
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(*args)
        e1.record()
        e1.synchronize()
        times.append(e0.elapsed_time(e1))
    times.sort()
    return times[len(times) // 2]


def _flagship_render(torch, np, **overrides):
    """The render slice's setup: the flagship (anerf_torch/tools/
    flagship.py, with `overrides`) on 8 frames at the render chunk of
    surreal.txt, a camera 2.5 units in front of each root. Returns (args,
    cfg, params, pose source)."""
    from anerf_torch.render.modes import PoseSource
    from anerf_torch.tools.flagship import flagship

    n_frames = 8
    args, cfg, params, rest, bones, kp3d, _ = flagship(
        n_frames, chunk=4096, **overrides)
    # cameras 2.5 units in front of each root, looking at it (NeRF: -z)
    c2ws = np.tile(np.eye(4, dtype=np.float32), (n_frames, 1, 1))
    c2ws[:, :3, 3] = kp3d[:, 0] + np.array([0.0, 0.0, 2.5], np.float32)
    src = PoseSource(kps=kp3d, bones=bones, c2ws=c2ws,
                     focals=np.full((n_frames,), 500.0, np.float32),
                     rest_pose=rest)
    return args, cfg, params, src


def _bucket_inputs(torch, np, cfg, params, src, seed, R=4096,
                   samples=(64, 16), culled=True):
    """One bucket of K1 operands as the main path builds them: R rays
    from a camera 2.5 units from the root of pose 0 toward the body,
    cylinder near/far, n0 = samples[0] stratified samples, n1 =
    samples[1] more, and the n0 + n1 fine set; with `culled`, the sets of
    cull_ratio 0.125: the 8 samples cull_samples keeps of the n0, and
    those 8 + the n1. Returns ({S: pts} for S = n0, n0 + n1, n1 (and 8,
    8 + n1), m_all, aux, the per-ray inputs of pack_ray_data {'rays_d',
    'skts', 'fc'})."""
    import dataclasses

    from anerf_torch.render.raycaster import cull_samples
    from anerf_torch.kernels.fused_render import pack_ray_data
    from anerf_torch.models.nerf import lookup_framecodes
    from anerf_torch.ops.cylinder import (get_kp_bounding_cylinder,
                                          get_near_far_in_cylinder)
    from anerf_torch.ops.fk import fk
    from anerf_torch.ops.sampling import sample_from_lineseg

    rng = np.random.default_rng(seed)
    dev = 'cuda'
    kp, skts, _, _ = fk(torch.as_tensor(src.bones[:1]),
                        torch.as_tensor(src.rest_pose),
                        torch.as_tensor(src.kps[:1, 0]
                                        - src.rest_pose[0]))
    root = kp[0, 0].numpy()
    o = root + np.array([0.0, 0.2, 2.5], np.float32)
    tgt = root + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    rays_o = torch.as_tensor(np.broadcast_to(o, (R, 3)).copy(), device=dev)
    rays_d = torch.as_tensor(tgt - o, device=dev)
    cyl = get_kp_bounding_cylinder(kp.numpy(), ext_scale=0.001, head='-y',
                                   extend_mm=250, top_expand_ratio=1.6,
                                   bot_expand_ratio=1.1)
    cyls = torch.as_tensor(cyl, device=dev).expand(R, 5)
    near, far = get_near_far_in_cylinder(rays_o, rays_d, cyls, 0.0, 1.0)
    n0, n1 = samples
    z0 = sample_from_lineseg(near, far, n0)
    z1 = sample_from_lineseg(near, far, n1)
    pts0 = rays_o[:, None] + rays_d[:, None] * z0[..., None]
    pts1 = rays_o[:, None] + rays_d[:, None] * z1[..., None]
    pts = {n0: pts0.contiguous(), n1: pts1.contiguous(),
           n0 + n1: torch.cat([pts0, pts1], 1).contiguous()}
    if culled:
        _, pts8 = cull_samples(dataclasses.replace(cfg, n_keep=8), z0, pts0,
                               kp.to(dev).expand(R, 24, 3),
                               params['cutoff_dist'])
        pts[8] = pts8.contiguous()
        pts[8 + n1] = torch.cat([pts8, pts1], 1).contiguous()
    skts_r = skts.to(dev).expand(R, 24, 4, 4)
    fc = lookup_framecodes(params['coarse'],
                           torch.zeros(R, dtype=torch.long, device=dev))
    m_all, aux = pack_ray_data(rays_d[:, None], skts_r, fc)
    return (pts, m_all, aux,
            {'rays_d': rays_d[:, None], 'skts': skts_r, 'fc': fc})


def _trunk_matmuls(torch, ncfg, packed, n_points):
    """The MLP's products (every MMA layer of K1, K-padded as packed) as a
    chain of bf16 torch.matmul calls at n_points rows, on random bf16
    activations: returns a function that runs them."""
    from anerf_torch.kernels import fused_render as fr
    ws = [w.to(torch.bfloat16) for w in fr._weights_f32(ncfg, packed)]
    xs = [torch.randn((n_points, w.shape[1]), device='cuda',
                      dtype=torch.bfloat16) for w in ws]

    def run():
        for x, w in zip(xs, ws):
            torch.matmul(x, w.t())
    return run


def kernel_phase(torch, np, cfg, params, src):
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed)
                for seed in range(4)]
    max_abs, max_v1, rec = 0.0, 0.0, {}
    for S, net in ((64, 'coarse'), (80, 'fine'), (8, 'coarse'),
                   (24, 'fine')):
        for tau in (2000.0, 35.0):
            pts, m_all, aux = variants[0][0][S], variants[0][1], \
                variants[0][2]
            got = fr.fused_encode_mlp_pts(ncfg, packed[net], pts, m_all,
                                          aux, S, tau)
            v1 = fr.fused_encode_mlp_pts_v1(ncfg, packed[net], pts, m_all,
                                            aux, S, tau)
            torch.cuda.synchronize()
            want = fr.fused_encode_mlp_pts_ref(ncfg, packed[net], pts,
                                               m_all, aux, S, tau)
            for name, out in (('K1', got), ('K1-v1', v1)):
                err = (out - want).abs()
                rel = (err / want.abs().clamp_min(1e-6)).max().item()
                ok = torch.allclose(out, want, atol=K1_ATOL, rtol=K1_RTOL)
                print(f'{name} S={S} tau={tau:g}: max_abs='
                      f'{err.max().item():.3e} mean_abs='
                      f'{err.mean().item():.3e} max_rel={rel:.3e} '
                      f'|raw|max={want.abs().max().item():.3f} '
                      f'tol atol=rtol={K1_ATOL} -> {"ok" if ok else "FAIL"}',
                      flush=True)
                if not (ok and torch.isfinite(out).all()):
                    raise AssertionError(f'{name} disagrees with its plain '
                                         f'version at S={S} tau={tau}')
            err_v1 = (got - v1).abs().max().item()
            ok = torch.allclose(got, v1, atol=CROSS_ATOL, rtol=CROSS_RTOL)
            print(f'K1 vs K1-v1 S={S} tau={tau:g}: max_abs={err_v1:.3e} '
                  f'(tol atol=rtol={CROSS_ATOL}) -> {"ok" if ok else "FAIL"}',
                  flush=True)
            if not ok:
                raise AssertionError(f'K1 disagrees with K1-v1 at S={S} '
                                     f'tau={tau}')
            max_abs = max(max_abs, (got - want).abs().max().item())
            max_v1 = max(max_v1, err_v1)
        ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, 2000.0)
               for v in variants]
        # in turns on the same buckets: v1, K1, K1, v1
        turns = [_median_ms(fn, ins, 21) for fn in (
            fr.fused_encode_mlp_pts_v1, fr.fused_encode_mlp_pts,
            fr.fused_encode_mlp_pts, fr.fused_encode_mlp_pts_v1)]
        trunk = _trunk_matmuls(torch, ncfg, packed[net], 4096 * S)
        rec[S] = {'ms': (turns[1] + turns[2]) / 2,
                  'v1_ms': (turns[0] + turns[3]) / 2, 'turns': turns,
                  'plain_ms': _median_ms(fr.fused_encode_mlp_pts_ref, ins,
                                         5),
                  'trunk_ms': _median_ms(lambda: trunk(), [()], 21)}
        del trunk
        print(f'K1 S={S}: in turns v1 {turns[0]:.4f}, K1 {turns[1]:.4f}, '
              f'K1 {turns[2]:.4f}, v1 {turns[3]:.4f} ms; plain '
              f'{rec[S]["plain_ms"]:.4f} ms; the MLP as bf16 torch.matmul '
              f'calls {rec[S]["trunk_ms"]:.4f} ms (medians, R=4096)',
              flush=True)

    R = 4096
    flops = 2.0 * rf.mlp_macs_per_point(ncfg) * R * (64 + 80)
    io_bytes = (R * (64 + 80) * (12 + 16)
                + 2 * (variants[0][1].numel() + variants[0][2].numel()) * 4
                + _packed_bytes(torch, packed, skip=('w', 'img_t')))
    bound_ms, bound_by = rf.bound_ms({
        'bf16': flops / rf.PEAK_BF16_FLOPS,
        'bytes': io_bytes / rf.PEAK_HBM_BYTES})
    ms = rec[64]['ms'] + rec[80]['ms']
    v1_ms = rec[64]['v1_ms'] + rec[80]['v1_ms']
    print(f'K1 bucket (S=64 + S=80): {flops / 1e12:.4f} TFLOP, '
          f'{io_bytes / 1e6:.2f} MB -> bound {bound_ms:.4f} ms '
          f'({bound_by}); K1 {ms:.4f} ms = {bound_ms / ms:.3f} of the '
          f'bound; K1-v1 {v1_ms:.4f} ms = {bound_ms / v1_ms:.3f}; K1 is '
          f'{"faster" if ms < v1_ms else "NOT faster"} than K1-v1 '
          f'({v1_ms / ms:.3f}x)', flush=True)
    for line in rf.l2_weight_lines(R):
        print(f'  {line}', flush=True)
    flops_c = 2.0 * rf.mlp_macs_per_point(ncfg) * R * (8 + 24)
    fp32_c = (rf.transform_flop_per_point() + rf.pe_flop_per_point(
        packed['coarse']['nfk'], packed['coarse']['nfv'])) * R * (8 + 24)
    bound_c, by_c = rf.bound_ms({
        'bf16': flops_c / rf.PEAK_BF16_FLOPS,
        'fp32': fp32_c / rf.PEAK_FP32_FLOPS,
        'bytes': (io_bytes - R * (64 + 80 - 8 - 24) * (12 + 16))
        / rf.PEAK_HBM_BYTES})
    ms_c = rec[8]['ms'] + rec[24]['ms']
    print(f'K1 culled bucket (S=8 + S=24): bound {bound_c:.4f} ms '
          f'({by_c}); K1 {ms_c:.4f} ms = {bound_c / ms_c:.3f} of the '
          f'bound', flush=True)
    return {'name': 'fused_encode_mlp_pts', 'route': 'cuda',
            'source': 'anerf_torch/kernels/csrc/fused_render_sm90.cu',
            'replaces': 'anerf_tpu/kernels/fused_render.py:677',
            'launches': None, 'max_abs_err': max_abs, 'ms': ms,
            'plain_ms': rec[64]['plain_ms'] + rec[80]['plain_ms'],
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
            'ms_s64': rec[64]['ms'], 'ms_s80': rec[80]['ms'],
            'culled': {'ms': ms_c, 'ms_s8': rec[8]['ms'],
                       'ms_s24': rec[24]['ms'],
                       'plain_ms': rec[8]['plain_ms'] + rec[24]['plain_ms'],
                       'bound_ms': bound_c},
            'cluster': fr.cluster_size(),
            'trunk_library_ms': rec[64]['trunk_ms'] + rec[80]['trunk_ms'],
            'v1': {'source': 'anerf_torch/kernels/csrc/fused_render.cu',
                   'ms': v1_ms, 'ms_s64': rec[64]['v1_ms'],
                   'ms_s80': rec[80]['v1_ms'], 'max_abs_vs_k1': max_v1}}


def _packed_bytes(torch, packed, skip=('img', 'img_t')):
    """Bytes of both nets' kernel operands (weights, biases, heads) that
    a kernel reads: K1 reads its weight image, skip=('w', 'img_t'); the
    others the fragment-order weights, skip=('img', 'img_t')."""
    return sum(t.numel() * t.element_size()
               for net in ('coarse', 'fine')
               for key, t in packed[net].items()
               if torch.is_tensor(t) and key not in skip)


def _cotangent_matmuls(torch, ncfg, packed, n_points):
    """K2's cotangent products (dX = dY W and dW = X^T dY of every MMA
    layer, K-padded as packed) as f32 torch.matmul calls with TF32 off,
    at n_points rows on random f32 cotangents and bf16-valued
    activations: returns a function that runs them. A yardstick for K2's
    products only; never on the port's path."""
    from anerf_torch.kernels import fused_render as fr
    ws = fr._weights_f32(ncfg, packed)
    dys = [torch.randn((n_points, w.shape[0]), device='cuda') for w in ws]
    xs = [torch.randn((n_points, w.shape[1]), device='cuda')
          .to(torch.bfloat16).float() for w in ws]

    def run():
        for w, dy, x in zip(ws, dys, xs):
            torch.matmul(dy, w)
            torch.matmul(x.t(), dy)
    return run


#: the kernels of K2's and K2-v1's sequences, by the names the profiler
#: gives them
K2_KERNELS = ('k1_sm90_kernel', 'heads_bwd_kernel', 'bwd_layer_kernel',
              'reduce_chunks_kernel', 'pe_transform_bwd_kernel')
K2_V1_KERNELS = ('fused_encode_mlp_pts_kernel', 'gemm_f32_kernel',
                 'reduce_chunks_kernel', 'pe_transform_bwd_kernel')


def _launches_per_call(torch, fn, names):
    """The device kernels of one fn() under torch.profiler: (launches of
    the kernels whose names contain one of `names`, all launches, and
    [(name, device us)] of the former in launch order)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    every, ours = 0, []
    for e in sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        every += 1
        short = next((n for n in names if n in e.name), None)
        if short:
            ours.append((short, e.time_range.elapsed_us()))
    return len(ours), every, ours


#: the split products' accuracy probe: (kind, N, K) at K2's shapes
#: (layer 0, the trunk, the skip layer's rows, the view layer)
PROBE_SHAPES = (('dx', 256, 432), ('dx', 256, 256), ('dx', 128, 928),
                ('dw', 256, 432), ('dw', 256, 688), ('dw', 128, 928))
#: the split product may be at most this many times further from f64 than
#: K2-v1's f32 FMA GEMM on the same inputs: both round only their f32
#: accumulation, in another order
SPLIT_VS_FMA = 4.0


def split_accuracy(torch, np, n_points=16384):
    """K2's split product (split_gemm_probe) and K2-v1's f32 FMA GEMM
    (fma_gemm_probe) against an f64 matmul of the same inputs at every
    PROBE_SHAPES shape: cotangents ~ N(0, 1e-3), weights ~ N(0, 0.05) and
    ReLU'd N(0, 1) activations, both rounded to bf16. Returns the rows
    (kind, N, K, split error, FMA error), relative in the Frobenius
    norm."""
    from anerf_torch.kernels import fused_render as fr
    rows = []
    for kind, N, K in PROBE_SHAPES:
        rng = np.random.default_rng(N + K)
        dy = torch.as_tensor(rng.normal(size=(n_points, N)) * 1e-3,
                             dtype=torch.float32, device='cuda')
        if kind == 'dx':
            b = torch.as_tensor(rng.normal(size=(N, K)) * 0.05,
                                dtype=torch.float32, device='cuda')
            b = b.to(torch.bfloat16)
            want = dy.double() @ b.double()
        else:
            b = torch.as_tensor(np.maximum(rng.normal(size=(n_points, K)),
                                           0.0), dtype=torch.float32,
                                device='cuda').to(torch.bfloat16)
            want = torch.cat([b.double().t() @ dy.double(),
                              dy.double().sum(0, keepdim=True)])
        got = fr.split_gemm_probe(kind, dy, b)
        fma = fr.fma_gemm_probe(kind, dy, b)
        torch.cuda.synchronize()
        err = ((got.double() - want).norm() / want.norm()).item()
        err_fma = ((fma.double() - want).norm() / want.norm()).item()
        ok = err <= SPLIT_VS_FMA * err_fma and bool(torch.isfinite(got).all())
        print(f'split accuracy {kind} N={N} K={K} ({n_points} points): '
              f'split-bf16 wgmma {err:.3e}, f32 FMA {err_fma:.3e} relative '
              f'Frobenius vs f64 (ratio {err / err_fma:.3f}, tol '
              f'{SPLIT_VS_FMA}) -> {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'split product {kind} {N}x{K}: {err:.3e} '
                                 f'against the FMA GEMM\'s {err_fma:.3e}')
        rows.append((kind, N, K, err, err_fma))
    return rows


def _k2_errors(torch, ncfg, packed, got, want, label, R):
    """K2's bounds on every output of a backward against a reference:
    each dW block within K2_FRO (Frobenius) and K2_BLOCK_RTOL (max),
    dpts / dm_all / daux the same; prints the rays off by more than
    K2_RTOL. Returns (max abs, worst dW max rel, worst other max rel,
    worst fro)."""
    from anerf_torch.kernels import fused_render as fr
    gb = fr.split_grads(ncfg, packed['nfk'], packed['nfv'], got[0])
    wb = fr.split_grads(ncfg, packed['nfk'], packed['nfv'], want[0])
    max_abs, worst_blk, worst_in, worst_fro = 0.0, 0.0, 0.0, 0.0
    for name in wb:
        d = (gb[name] - wb[name]).abs()
        rel = (d.max() / wb[name].abs().max().clamp_min(1e-7)).item()
        fro = ((gb[name] - wb[name]).norm()
               / wb[name].norm().clamp_min(1e-7)).item()
        worst_blk, worst_fro = max(worst_blk, rel), max(worst_fro, fro)
        max_abs = max(max_abs, d.max().item())
        if rel >= K2_BLOCK_RTOL or fro >= K2_FRO:
            raise AssertionError(f'{label}: dW block {name} disagrees '
                                 f'(rel {rel:.3e}, fro {fro:.3e})')
    for name, a, b in zip(('dpts', 'dm_all', 'daux'), got[1:], want[1:]):
        d = (a - b).abs()
        top = b.abs().max().clamp_min(1e-7)
        rel = (d.max() / top).item()
        fro = ((a - b).norm() / b.norm().clamp_min(1e-7)).item()
        # rays (rows of dm_all / daux, ray slices of dpts) with an entry
        # off by more than K2_RTOL of the largest value
        off = (d.reshape(R, -1) > K2_RTOL * top).any(1).sum().item()
        worst_in, worst_fro = max(worst_in, rel), max(worst_fro, fro)
        max_abs = max(max_abs, d.max().item())
        print(f'{label}: {name} max_rel={rel:.3e} fro={fro:.3e} rays off '
              f'by >{K2_RTOL}: {off}/{R} |max|={top.item():.3e}',
              flush=True)
        if not (rel < K2_BLOCK_RTOL and fro < K2_FRO
                and torch.isfinite(a).all()):
            raise AssertionError(f'{label}: {name} disagrees')
    return max_abs, worst_blk, worst_in, worst_fro


def _worst_fro(ncfg, packed, got, want):
    """The largest relative Frobenius distance of a backward's outputs
    (each dW block, dpts, dm_all, daux) from another's."""
    from anerf_torch.kernels import fused_render as fr
    gb = fr.split_grads(ncfg, packed['nfk'], packed['nfv'], got[0])
    wb = fr.split_grads(ncfg, packed['nfk'], packed['nfv'], want[0])
    pairs = [(gb[n], wb[n]) for n in wb] + list(zip(got[1:], want[1:]))
    return max(((a - b).norm() / b.norm().clamp_min(1e-7)).item()
               for a, b in pairs)


def k2_phase(torch, np, cfg, params, src):
    """K2 on one training batch's operands: 2048 rays, the coarse net at
    S = 64 and the fine net at S = 80, tau = 2000 and 35, a seeded
    cotangent. Every output against the plain version and against K2-v1
    (its first version; K2_V1_FRO, and K2 on the hi plane alone must
    exceed it), a second launch held to the same bits; K2-v1
    and K2 timed in turns (v1, K2, K2, v1) beside the bound and the
    products as f32 torch.matmul calls; the split products' accuracy
    against f64 beside the FMA GEMM's; the launches of one call."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    R = 2048
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed, R=R)
                for seed in range(4)]
    gs = {S: [torch.as_tensor(
        np.random.default_rng(10 + i).normal(size=(R, S, 4)) * 0.1,
        dtype=torch.float32, device='cuda') for i in range(4)]
        for S in (64, 80)}
    max_abs, max_v1, max_v1_plain, rec = 0.0, 0.0, 0.0, {}
    fro_v1, fro_ctl = 0.0, float('inf')
    for S, net in ((64, 'coarse'), (80, 'fine')):
        for tau in (2000.0, 35.0):
            pts, m_all, aux = variants[0][0][S], variants[0][1], \
                variants[0][2]
            args = (ncfg, packed[net], pts, m_all, aux, S, tau, gs[S][0])
            got = fr.fused_bwd(*args)
            again = fr.fused_bwd(*args)
            v1 = fr.fused_bwd_v1(*args)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f'K2 is not deterministic at S={S} '
                                     f'tau={tau}')
            want = fr.fused_bwd_ref(*args)
            e = _k2_errors(torch, ncfg, packed[net], got, want,
                           f'K2 S={S} tau={tau:g}', R)
            max_abs = max(max_abs, e[0])
            print(f'K2 S={S} tau={tau:g}: dW blocks max_rel={e[1]:.3e} '
                  f'(tol {K2_BLOCK_RTOL}); dpts / dm_all / daux max_rel='
                  f'{e[2]:.3e} (tol {K2_BLOCK_RTOL}); worst fro {e[3]:.3e} '
                  f'(tol {K2_FRO}); two launches bitwise equal -> ok',
                  flush=True)
            e = _k2_errors(torch, ncfg, packed[net], v1, want,
                           f'K2-v1 S={S} tau={tau:g}', R)
            max_v1_plain = max(max_v1_plain, e[0])
            # K2 against K2-v1: K2's bounds, then K2_V1_FRO
            e = _k2_errors(torch, ncfg, packed[net], got, v1,
                           f'K2 vs K2-v1 S={S} tau={tau:g}', R)
            max_v1 = max(max_v1, e[0])
            # the control: K2's bf16 flavour (the hi plane of the
            # cotangents alone)
            t = fr.launch_bwd(0, *args, bwd_f32=False)
            ctl = _worst_fro(ncfg, packed[net],
                             (t['dW'], t['dpts'], t['dm'], t['daux']), v1)
            fro_v1, fro_ctl = max(fro_v1, e[3]), min(fro_ctl, ctl)
            ok = e[3] < K2_V1_FRO < ctl
            print(f'K2 vs K2-v1 S={S} tau={tau:g}: dW max_rel={e[1]:.3e}, '
                  f'dpts / dm_all / daux max_rel={e[2]:.3e} (K2\'s bounds); '
                  f'worst fro {e[3]:.3e}, K2\'s bf16 flavour (the hi plane '
                  f'alone) {ctl:.3e} (limit {K2_V1_FRO}: K2 below, the '
                  f'control above) -> {"ok" if ok else "FAIL"}', flush=True)
            if not ok:
                raise AssertionError(f'K2 vs K2-v1 at S={S} tau={tau}: '
                                     f'{e[3]:.3e}, control {ctl:.3e}')
            del got, again, v1, want, t
        ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, 2000.0, g)
               for v, g in zip(variants, gs[S])]
        turns = [_median_ms(fn, ins, 11) for fn in (
            fr.fused_bwd_v1, fr.fused_bwd, fr.fused_bwd, fr.fused_bwd_v1)]
        mm = _cotangent_matmuls(torch, ncfg, packed[net], R * S)
        rec[S] = {'ms': (turns[1] + turns[2]) / 2,
                  'v1_ms': (turns[0] + turns[3]) / 2, 'turns': turns,
                  'plain_ms': _median_ms(fr.fused_bwd_ref, ins, 3),
                  'mm_ms': _median_ms(lambda: mm(), [()], 5)}
        del mm
        print(f'K2 S={S}: in turns v1 {turns[0]:.4f}, K2 {turns[1]:.4f}, '
              f'K2 {turns[2]:.4f}, v1 {turns[3]:.4f} ms; plain '
              f'{rec[S]["plain_ms"]:.4f} ms; the cotangent products as f32 '
              f'torch.matmul calls (TF32 off) {rec[S]["mm_ms"]:.4f} ms '
              f'(medians, R={R})', flush=True)

    args = (ncfg, packed['fine'], variants[1][0][80], variants[1][1],
            variants[1][2], 80, 2000.0, gs[80][1])
    n_k2, all_k2, by_launch = _launches_per_call(
        torch, lambda: fr.fused_bwd(*args), K2_KERNELS)
    n_v1, all_v1, _ = _launches_per_call(
        torch, lambda: fr.fused_bwd_v1(*args), K2_V1_KERNELS)
    print(f'launches per call: K2 {n_k2} kernels of its sequence '
          f'({all_k2} device launches with the wrapper\'s allocations and '
          f'gathers), K2-v1 {n_v1} ({all_v1})', flush=True)
    print('K2 by launch (S=80, one call under the profiler, device ms): '
          + ', '.join(f'{n} {us / 1e3:.4f}' for n, us in by_launch),
          flush=True)
    accuracy = split_accuracy(torch, np)

    nfk, nfv = packed['coarse']['nfk'], packed['coarse']['nfv']
    dw_bytes = 4 * sum(r * c for _, r, c in fr.grad_blocks(ncfg, nfk, nfv))
    times = rf.k2_seconds(ncfg, nfk, nfv, (R * 64, R * 80), R,
                          _packed_bytes(torch, packed), dw_bytes)
    bound_ms, bound_by = rf.bound_ms(times)
    ms = rec[64]['ms'] + rec[80]['ms']
    v1_ms = rec[64]['v1_ms'] + rec[80]['v1_ms']
    traffic = sum(rf.k2_design_bytes(ncfg, nfk, nfv, R * S)
                  for S in (64, 80))
    print(f'K2 step (S=64 + S=80, {R} rays): bound {bound_ms:.4f} ms '
          f'({bound_by}; bf16 {times["bf16"] * 1e3:.4f} ms = 3 split passes '
          f'of the products + the recompute, fp32 {times["fp32"] * 1e3:.4f}'
          f' ms, bytes {times["bytes"] * 1e3:.4f} ms); K2 {ms:.4f} ms = '
          f'{bound_ms / ms:.3f} of the bound; K2-v1 {v1_ms:.4f} ms = '
          f'{bound_ms / v1_ms:.3f}; K2 is '
          f'{"faster" if ms < v1_ms else "NOT faster"} than K2-v1 '
          f'({v1_ms / ms:.3f}x)', flush=True)
    hist = rf.k2_fp32_ms(ncfg, R * (64 + 80))
    print(f'  history: the products as f32 FMAs, {hist:.4f} ms at 67 '
          f'TFLOP/s (the bound before the split products)', flush=True)
    print(f'  design traffic: {traffic / 1e9:.3f} GB through HBM, '
          f'{traffic / rf.PEAK_HBM_BYTES * 1e3:.4f} ms at 3.35 TB/s',
          flush=True)
    return {'name': 'fused_bwd', 'route': 'cuda',
            'source': 'anerf_torch/kernels/csrc/fused_render_bwd_sm90.cu',
            'replaces': 'anerf_tpu/kernels/fused_render.py:962',
            'launches': None, 'max_abs_err': max_abs, 'ms': ms,
            'plain_ms': rec[64]['plain_ms'] + rec[80]['plain_ms'],
            'bound_ms': bound_ms, 'bound_by': bound_by, 'library_ms': None,
            'ms_s64': rec[64]['ms'], 'ms_s80': rec[80]['ms'],
            'launches_per_call': n_k2,
            'products_library_ms': rec[64]['mm_ms'] + rec[80]['mm_ms'],
            'split_accuracy': [{'kind': k, 'N': n, 'K': kk, 'split': e1,
                                'fma': e2} for k, n, kk, e1, e2 in accuracy],
            'v1': {'name': 'fused_bwd_v1', 'route': 'cuda',
                   'source': 'anerf_torch/kernels/csrc/fused_render_bwd.cu',
                   'replaces': 'anerf_tpu/kernels/fused_render.py:962',
                   'launches': None, 'max_abs_err': max_v1_plain,
                   'ms': v1_ms, 'plain_ms': rec[64]['plain_ms']
                   + rec[80]['plain_ms'], 'bound_ms': bound_ms,
                   'bound_by': bound_by, 'library_ms': None,
                   'ms_s64': rec[64]['v1_ms'], 'ms_s80': rec[80]['v1_ms'],
                   'launches_per_call': n_v1, 'max_abs_vs_k2': max_v1,
                   'fro_vs_k2': fro_v1, 'fro_vs_hi_plane_k2': fro_ctl}}


def _mlp_stage_fro(torch, ncfg, packed, args):
    """K2's sequence stopped after the MLP backward (K2-d's mlp stage) in
    both flavours, each against the plain bf16 MLP backward on the
    kernel's own saved activations: the worst relative Frobenius distance
    of any dW block, dx0 or dxv, (bf16 flavour, f32 flavour)."""
    from anerf_torch.kernels import fused_render as fr
    out = []
    P = args[2].shape[0] * args[5]
    for f32 in (False, True):
        t = fr.launch_bwd(2, *args, bwd_f32=f32)
        if not f32:
            want = fr.mlp_bwd_ref(*args, bwd_f32=False,
                                  trace=fr.trace_from_act(ncfg, packed,
                                                          t['act'], P))
        got = (t['dW'], t['dx0'], t['dxv'])
        pairs = list(zip(fr.split_grads(ncfg, packed['nfk'], packed['nfv'],
                                        got[0]).values(),
                         fr.split_grads(ncfg, packed['nfk'], packed['nfv'],
                                        want[0]).values()))
        pairs += [(got[1], want[1].reshape(P, -1)),
                  (got[2], want[2].reshape(P, -1))]
        out.append(max(((a - b).norm() / b.norm().clamp_min(1e-7)).item()
                       for a, b in pairs))
        del t
    return tuple(out)


def k2_bf16_phase(torch, np, cfg, params, src, n_k2_f32):
    """K2's bf16 flavour (bwd_f32=False) on the K2 phase's kind of batch
    (2048 rays, tau = 2000 and 35, a seeded cotangent) at S = 64 / 80 and
    at the culled S = 8 / 24 (the coarse / fine net): every output against
    its plain bf16 version within K2's bounds; its MLP backward against
    the plain bf16 one on its own saved activations within K2_BF16_FRO,
    which K2's f32 flavour against the same (the control) must exceed;
    two launches bit-equal; exactly the launches a call that
    fused_render.bwd_plan lists, in each flavour (n_k2_f32: the f32
    flavour's at S = 80). At S = 8 and 24 also K2's f32 flavour against
    its plain version, bit-equal across launches. Both flavours timed in
    turns (f32, bf16, bf16, f32) at every S beside their bounds. Returns
    (the bf16 record, {S: f32 ms}, {S: f32 plain ms}, f32 max abs error
    at the culled shapes)."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    R = 2048
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed, R=R)
                for seed in range(4)]
    shapes = ((64, 'coarse'), (80, 'fine'), (8, 'coarse'), (24, 'fine'))
    gs = {S: [torch.as_tensor(
        np.random.default_rng(10 + i).normal(size=(R, S, 4)) * 0.1,
        dtype=torch.float32, device='cuda') for i in range(4)]
        for S, _ in shapes}
    max_abs, max_abs_f32, fro_bf, fro_ctl = 0.0, 0.0, 0.0, float('inf')
    rec = {}
    for S, net in shapes:
        for tau in (2000.0, 35.0):
            args = (ncfg, packed[net], variants[0][0][S], variants[0][1],
                    variants[0][2], S, tau, gs[S][0])
            got = fr.fused_bwd(*args, bwd_f32=False)
            again = fr.fused_bwd(*args, bwd_f32=False)
            f32 = fr.fused_bwd(*args)
            f32_again = fr.fused_bwd(*args)
            torch.cuda.synchronize()
            for a, b, what in ((got, again, 'bf16'),
                               (f32, f32_again, 'f32')):
                if not all(torch.equal(x, y) for x, y in zip(a, b)):
                    raise AssertionError(f'K2 {what} is not deterministic '
                                         f'at S={S} tau={tau}')
            want = fr.fused_bwd_ref(*args, bwd_f32=False)
            e = _k2_errors(torch, ncfg, packed[net], got, want,
                           f'K2-bf16 S={S} tau={tau:g}', R)
            max_abs = max(max_abs, e[0])
            fro, ctl = _mlp_stage_fro(torch, ncfg, packed[net], args)
            fro_bf, fro_ctl = max(fro_bf, fro), min(fro_ctl, ctl)
            ok = fro < K2_BF16_FRO < ctl
            print(f'K2-bf16 S={S} tau={tau:g}: vs its plain version dW '
                  f'max_rel={e[1]:.3e}, dpts / dm_all / daux max_rel='
                  f'{e[2]:.3e}, worst fro {e[3]:.3e} (K2\'s bounds); MLP '
                  f'backward vs the plain bf16 version on its own '
                  f'activations: worst fro {fro:.3e}, K2 f32 {ctl:.3e} '
                  f'(limit {K2_BF16_FRO}: bf16 below, f32 above); two '
                  f'launches bitwise equal -> {"ok" if ok else "FAIL"}',
                  flush=True)
            if not ok:
                raise AssertionError(f'K2-bf16 at S={S} tau={tau}: '
                                     f'{fro:.3e}, control {ctl:.3e}')
            if S in (8, 24):
                want32 = fr.fused_bwd_ref(*args)
                e = _k2_errors(torch, ncfg, packed[net], f32, want32,
                               f'K2 S={S} tau={tau:g}', R)
                max_abs_f32 = max(max_abs_f32, e[0])
                print(f'K2 S={S} tau={tau:g}: vs its plain version dW '
                      f'max_rel={e[1]:.3e}, dpts / dm_all / daux max_rel='
                      f'{e[2]:.3e}, worst fro {e[3]:.3e} (K2\'s bounds); '
                      f'two launches bitwise equal -> ok', flush=True)
                del want32
            del got, again, f32, f32_again, want
        ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, 2000.0, g)
               for v, g in zip(variants, gs[S])]
        bf16 = lambda *a: fr.fused_bwd(*a, bwd_f32=False)
        turns = [_median_ms(fn, ins, 11) for fn in (
            fr.fused_bwd, bf16, bf16, fr.fused_bwd)]
        rec[S] = {'ms': (turns[1] + turns[2]) / 2,
                  'f32_ms': (turns[0] + turns[3]) / 2,
                  'plain_ms': _median_ms(
                      lambda *a: fr.fused_bwd_ref(*a, bwd_f32=False), ins,
                      3),
                  'f32_plain_ms': (_median_ms(fr.fused_bwd_ref, ins, 3)
                                   if S in (8, 24) else None)}
        print(f'K2 flavours S={S}: in turns f32 {turns[0]:.4f}, bf16 '
              f'{turns[1]:.4f}, bf16 {turns[2]:.4f}, f32 {turns[3]:.4f} ms; '
              f'bf16 plain {rec[S]["plain_ms"]:.4f} ms (medians, R={R})',
              flush=True)

    args = (ncfg, packed['fine'], variants[1][0][24], variants[1][1],
            variants[1][2], 24, 2000.0, gs[24][1])
    before = (fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    n_bf, all_bf, by_launch = _launches_per_call(
        torch, lambda: fr.fused_bwd(*args, bwd_f32=False), K2_KERNELS)
    counted = (fr.BWD_LAUNCHES - before[0], fr.BWD_BF16_LAUNCHES - before[1])
    print(f'launches per call: K2-bf16 {n_bf} kernels of its sequence '
          f'({all_bf} device launches), K2 f32 {n_k2_f32}; counted '
          f'(f32, bf16) {counted}', flush=True)
    print('K2-bf16 by launch (S=24, one call under the profiler, device '
          'ms): ' + ', '.join(f'{n} {us / 1e3:.4f}' for n, us in by_launch),
          flush=True)
    plan_bf = len(fr.bwd_plan(ncfg, packed['fine'], R * 24, False)
                  ['launches'])
    plan_f32 = len(fr.bwd_plan(ncfg, packed['fine'], R * 80, True)
                   ['launches'])
    print(f'launches per call against bwd_plan: bf16 {n_bf} / {plan_bf}, '
          f'f32 {n_k2_f32} / {plan_f32}', flush=True)
    if n_bf != plan_bf or n_k2_f32 != plan_f32 or counted != (0, 1):
        raise AssertionError(f'K2-bf16: {n_bf} launches a call (plan '
                             f'{plan_bf}; f32 {n_k2_f32}, plan {plan_f32}), '
                             f'counted {counted}')
    args = (ncfg, packed['fine'], variants[1][0][80], variants[1][1],
            variants[1][2], 80, 2000.0, gs[80][1])
    _, _, by_launch = _launches_per_call(
        torch, lambda: fr.fused_bwd(*args, bwd_f32=False), K2_KERNELS)
    print('K2-bf16 by launch (S=80, one call under the profiler, device '
          'ms): ' + ', '.join(f'{n} {us / 1e3:.4f}' for n, us in by_launch),
          flush=True)

    nfk, nfv = packed['coarse']['nfk'], packed['coarse']['nfv']
    dw_bytes = 4 * sum(r * c for _, r, c in fr.grad_blocks(ncfg, nfk, nfv))
    w_bytes = _packed_bytes(torch, packed)
    bounds = {}
    for key, pair, f32 in (('bf16', (64, 80), False),
                           ('bf16_culled', (8, 24), False),
                           ('f32_culled', (8, 24), True)):
        bounds[key] = rf.bound_ms(rf.k2_seconds(
            ncfg, nfk, nfv, tuple(R * S for S in pair), R, w_bytes,
            dw_bytes, f32))
    ms = rec[64]['ms'] + rec[80]['ms']
    ms_c = rec[8]['ms'] + rec[24]['ms']
    f32_ms = rec[64]['f32_ms'] + rec[80]['f32_ms']
    f32_c = rec[8]['f32_ms'] + rec[24]['f32_ms']
    for what, t, b in (('K2-bf16 step (S=64 + S=80)', ms, bounds['bf16']),
                       ('K2-bf16 culled step (S=8 + S=24)', ms_c,
                        bounds['bf16_culled']),
                       ('K2 f32 culled step (S=8 + S=24)', f32_c,
                        bounds['f32_culled'])):
        print(f'{what}, {R} rays: {t:.4f} ms, bound {b[0]:.4f} ms '
              f'({b[1]}) = {b[0] / t:.3f} of the bound', flush=True)
    print(f'K2 flavours in the same turns: S=64 + S=80 f32 {f32_ms:.4f} ms, '
          f'bf16 {ms:.4f} ms; S=8 + S=24 f32 {f32_c:.4f} ms, bf16 '
          f'{ms_c:.4f} ms', flush=True)
    # the bf16 flavour's own design floor: its HBM bytes with bf16
    # cotangent tiles and its plan's chunks (roofline.k2_design_bytes)
    floors = {}
    for key, pair in (('s64_80', (64, 80)), ('s8_24', (8, 24))):
        b = 0
        for S in pair:
            chunk = fr.bwd_plan(ncfg, packed['coarse'], R * S,
                                False)['chunk']
            b += rf.k2_design_bytes(ncfg, nfk, nfv, R * S, chunk, 2,
                                    packed['coarse']['fc'])
        floors[key] = b / rf.PEAK_HBM_BYTES * 1e3
    print(f'K2-bf16 design floor (bf16 cotangent tiles): S=64 + S=80 '
          f'{floors["s64_80"]:.4f} ms ({ms / floors["s64_80"]:.2f}x), '
          f'S=8 + S=24 {floors["s8_24"]:.4f} ms '
          f'({ms_c / floors["s8_24"]:.2f}x)', flush=True)
    out = {'name': 'fused_bwd(bwd_f32=False)', 'route': 'cuda',
           'source': 'anerf_torch/kernels/csrc/fused_render_bwd_sm90.cu',
           'replaces': 'anerf_tpu/kernels/fused_render.py:962',
           'launches': None, 'max_abs_err': max_abs, 'ms': ms,
           'plain_ms': rec[64]['plain_ms'] + rec[80]['plain_ms'],
           'bound_ms': bounds['bf16'][0], 'bound_by': bounds['bf16'][1],
           'library_ms': None, 'ms_s64': rec[64]['ms'],
           'ms_s80': rec[80]['ms'], 'f32_ms': f32_ms,
           'culled': {'ms': ms_c, 'ms_s8': rec[8]['ms'],
                      'ms_s24': rec[24]['ms'], 'f32_ms': f32_c,
                      'plain_ms': rec[8]['plain_ms'] + rec[24]['plain_ms'],
                      'bound_ms': bounds['bf16_culled'][0]},
           'launches_per_call': n_bf, 'fro_vs_plain': fro_bf,
           'f32_fro_vs_plain': fro_ctl}
    f32_culled = {'ms': f32_c, 'ms_s8': rec[8]['f32_ms'],
                  'ms_s24': rec[24]['f32_ms'],
                  'plain_ms': rec[8]['f32_plain_ms']
                  + rec[24]['f32_plain_ms'],
                  'bound_ms': bounds['f32_culled'][0],
                  'max_abs_err': max_abs_f32}
    return out, f32_culled


def _mlp_chain(torch, ncfg, packed):
    """K4's function as a chain of bf16 torch.matmul calls, one addmm (the
    product and the bias) a layer, ReLU, the skip concat and the heads, on
    K4's own inputs x0 (P, dnet_input) and xv (P, view_in) in bf16:
    returns fn(x0, xv) -> raw (P, 4). A yardstick for K4 (its
    library_ms); never on the port's path. Its roundings differ from
    K4's (the library's bias is bf16, its heads bf16 products)."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    bf, W = torch.bfloat16, ncfg.width
    k0, kv = ncfg.dnet_input, fm.view_in(ncfg)
    k0p = packed['k0p']
    ws = fr._weights_f32(ncfg, packed)
    # each block's live input columns only, transposed to (K, N)
    wts = []
    for i, w in enumerate(ws):
        if i == 0:
            w = w[:, :k0]
        elif i < ncfg.depth and (i - 1) in ncfg.skips:
            w = torch.cat([w[:, :k0], w[:, k0p:]], 1)
        elif i == ncfg.depth + 1:
            w = w[:, :W + kv]
        wts.append(w.t().to(bf).contiguous())
    bs = [b.to(bf) for b in packed['b'][:W * (ncfg.depth + 1)].split(W)]
    bs.append(packed['b'][W * (ncfg.depth + 1):].to(bf))
    w_rgb = packed['w_rgb'].t().to(bf).contiguous()
    w_alpha = packed['w_alpha'][:, None].to(bf).contiguous()
    b_out = packed['b_out']

    def run(x0, xv):
        h = torch.relu(torch.addmm(bs[0], x0, wts[0]))
        for i in range(1, ncfg.depth):
            x = torch.cat([x0, h], -1) if (i - 1) in ncfg.skips else h
            h = torch.relu(torch.addmm(bs[i], x, wts[i]))
        alpha = torch.matmul(h, w_alpha)
        feat = torch.addmm(bs[ncfg.depth], h, wts[ncfg.depth])
        hv = torch.relu(torch.addmm(bs[-1], torch.cat([feat, xv], -1),
                                    wts[-1]))
        return torch.cat([torch.matmul(hv, w_rgb), alpha], -1).float() \
            + b_out
    return run


def _hold_modes(torch, kernels, v, S, net, tau, k1, R, label=''):
    """Each of `kernels` ({id: (kernel, first version, plain version,
    args maker)}) on bucket `v` at S and tau: against its plain version
    (K1_ATOL), against K1's output `k1` on the same points and against
    its first version (CROSS_ATOL); the first version against the plain
    version (K1_ATOL). Returns {id: max abs error against the plain
    version}."""
    errs = {}
    for kid, (kernel, v1, plain, make) in kernels.items():
        args = make(v, S, net, tau)
        got = kernel(*args).reshape(R, S, 4)
        old = v1(*args).reshape(R, S, 4)
        torch.cuda.synchronize()
        want = plain(*args).reshape(R, S, 4)
        err = (got - want).abs().max().item()
        err_k1 = (got - k1).abs().max().item()
        err_v1 = (got - old).abs().max().item()
        err_old = (old - want).abs().max().item()
        ok = (torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
              and torch.allclose(got, k1, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              and torch.allclose(got, old, atol=CROSS_ATOL, rtol=CROSS_RTOL)
              and torch.allclose(old, want, atol=K1_ATOL, rtol=K1_RTOL)
              and bool(torch.isfinite(got).all()))
        print(f'{kid}{label} S={S} tau={tau:g}: max_abs={err:.3e} vs plain '
              f'(tol atol=rtol={K1_ATOL}), {err_k1:.3e} vs K1, {err_v1:.3e} '
              f'vs {kid}-v1 ({kid}-v1 {err_old:.3e} vs plain) (tol '
              f'atol=rtol={CROSS_ATOL}) -> {"ok" if ok else "FAIL"}',
              flush=True)
        if not ok:
            raise AssertionError(f'{kid}{label} disagrees at S={S} '
                                 f'tau={tau}')
        errs[kid] = err
    return errs


def _mode_kernels(torch, ncfg, packed, packed4):
    """K3 and K4 with their first versions, plain versions and makers of
    their arguments from a bucket of _bucket_inputs: K3 on
    build_raw_inputs of its points, K4 on their embedded inputs."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    k0, kv = ncfg.dnet_input, fm.view_in(ncfg)
    bf = torch.bfloat16

    def k3_args(v, S, net, tau):
        x = fr.build_raw_inputs(v[0][S], v[3]['rays_d'], v[3]['skts'],
                                v[3]['fc'])
        return ncfg, packed[net], x, tau

    def k4_args(v, S, net, tau):
        x0, xv = fr._encode(packed[net], v[0][S], v[1], v[2], S, tau)
        return (ncfg, packed4[net], x0[..., :k0].reshape(-1, k0).to(bf),
                xv[..., :kv].reshape(-1, kv).to(bf))

    return {'K3': (fr.fused_encode_mlp, fr.fused_encode_mlp_v1,
                   fr.fused_encode_mlp_ref, k3_args),
            'K4': (fm.fused_mlp_apply, fm.fused_mlp_apply_v1,
                   fm.fused_mlp_apply_ref, k4_args)}


def modes_phase(torch, np, cfg, params, src):
    """K3 and K4 (K1's kernel in its IN_RAW and IN_EMBEDDED modes) at the
    flagship width on one 4096-ray bucket (the coarse net at S = 64, the
    fine net at S = 80; tau = 2000 and 35): each held to its plain
    version, to K1 on the same points and to its first version (K3-v1,
    K4-v1: K1-v1's body); each pair timed in turns (v1, new, new, v1)
    beside the bound, and K4 beside its function as a chain of bf16
    torch.matmul calls on its own inputs (library_ms). Returns their
    `kernels` records."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    packed4 = {net: fm.pack_params(params[net], cfg.nerf)
               for net in ('coarse', 'fine')}
    ncfg = cfg.nerf
    k0, kv = ncfg.dnet_input, fm.view_in(ncfg)
    R = 4096
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed)
                for seed in range(4)]
    kernels = _mode_kernels(torch, ncfg, packed, packed4)
    max_abs = {kid: 0.0 for kid in kernels}
    rec = {kid: {} for kid in kernels}
    for S, net in ((64, 'coarse'), (80, 'fine')):
        for tau in (2000.0, 35.0):
            v = variants[0]
            k1 = fr.fused_encode_mlp_pts(ncfg, packed[net], v[0][S], v[1],
                                         v[2], S, tau)
            for kid, err in _hold_modes(torch, kernels, v, S, net, tau,
                                        k1, R).items():
                max_abs[kid] = max(max_abs[kid], err)
        for kid, (kernel, v1, plain, make) in kernels.items():
            ins = [make(v, S, net, 2000.0) for v in variants]
            # in turns on the same buckets: v1, new, new, v1
            turns = [_median_ms(fn, ins, 21)
                     for fn in (v1, kernel, kernel, v1)]
            rec[kid][S] = {'ms': (turns[1] + turns[2]) / 2,
                           'v1_ms': (turns[0] + turns[3]) / 2,
                           'turns': turns,
                           'plain_ms': _median_ms(plain, ins, 5),
                           'v1_vs_new': (kernel(*ins[0]) - v1(*ins[0]))
                           .abs().max().item()}
            line = (f'{kid} S={S}: in turns v1 {turns[0]:.4f}, {kid} '
                    f'{turns[1]:.4f}, {kid} {turns[2]:.4f}, v1 '
                    f'{turns[3]:.4f} ms; plain {rec[kid][S]["plain_ms"]:.4f}'
                    f' ms')
            if kid == 'K4':
                chain = _mlp_chain(torch, ncfg, packed4[net])
                xs = [a[2:] for a in ins]
                rec[kid][S]['library_ms'] = _median_ms(chain, xs, 21)
                dev = (chain(*xs[0]) - kernel(*ins[0])).abs().max().item()
                line += (f'; the bf16 torch.matmul chain '
                         f'{rec[kid][S]["library_ms"]:.4f} ms (max_abs '
                         f'{dev:.3e} from K4, other roundings)')
            print(f'{line} (medians, R={R})', flush=True)
            del ins

    P = R * (64 + 80)
    bf16_s = 2.0 * rf.mlp_macs_per_point(ncfg) * P / rf.PEAK_BF16_FLOPS
    img_only = ('w', 'img_t')      # K3 and K4 read the weight image
    times = {
        'K3': {'bf16': bf16_s,
               'fp32': rf.pe_flop_per_point(7, 4) * P / rf.PEAK_FP32_FLOPS,
               'bytes': (P * (4 * fr.RAW_W + 16)
                         + _packed_bytes(torch, packed, skip=img_only))
               / rf.PEAK_HBM_BYTES},
        'K4': {'bf16': bf16_s,
               'bytes': (P * (2 * (k0 + kv) + 16)
                         + _packed_bytes(torch, packed4, skip=img_only))
               / rf.PEAK_HBM_BYTES}}
    out = []
    for kid, name, replaces in (
            ('K3', 'fused_encode_mlp',
             'anerf_tpu/kernels/fused_render.py:555'),
            ('K4', 'fused_mlp_apply', 'anerf_tpu/kernels/fused_mlp.py:146')):
        bound, bound_by = rf.bound_ms(times[kid])
        r = rec[kid]
        ms, v1_ms = r[64]['ms'] + r[80]['ms'], r[64]['v1_ms'] + r[80]['v1_ms']
        lib_ms = (r[64]['library_ms'] + r[80]['library_ms']
                  if kid == 'K4' else None)
        print(f'{kid} bucket (S=64 + S=80): bound {bound:.4f} ms '
              f'({bound_by}); {kid} {ms:.4f} ms = {bound / ms:.3f} of the '
              f'bound; {kid}-v1 {v1_ms:.4f} ms = {bound / v1_ms:.3f}; {kid} '
              f'is {"faster" if ms < v1_ms else "NOT faster"} than {kid}-v1 '
              f'({v1_ms / ms:.3f}x)'
              + (f'; the matmul chain {lib_ms:.4f} ms' if lib_ms else ''),
              flush=True)
        out.append({'name': name, 'route': 'cuda',
                    'source': 'anerf_torch/kernels/csrc/fused_render_sm90.cu',
                    'replaces': replaces, 'launches': None,
                    'max_abs_err': max_abs[kid], 'ms': ms,
                    'plain_ms': r[64]['plain_ms'] + r[80]['plain_ms'],
                    'bound_ms': bound, 'bound_by': bound_by,
                    'library_ms': lib_ms, 'ms_s64': r[64]['ms'],
                    'ms_s80': r[80]['ms'],
                    'v1': {'source':
                           'anerf_torch/kernels/csrc/fused_render_modes.cu',
                           'ms': v1_ms, 'ms_s64': r[64]['v1_ms'],
                           'ms_s80': r[80]['v1_ms'], 'max_abs_vs_new': max(
                               r[64]['v1_vs_new'], r[80]['v1_vs_new'])}})
    return out


def single_net_phase(torch, np):
    """configs/surreal/surreal_single.txt's network (anerf_torch/tools/
    flagship.py: SURREAL_SINGLE: one net for both passes, multires_views
    0, 96 + 48 samples) at full width on one 512-ray bucket: K1, K3 and
    K4 against their plain versions, K3 and K4 against K1 and their
    first versions at S = 96 (the coarse pass), 48 (the fine pass:
    single_net renders the new samples alone) and 144, tau = 2000 and
    35; K2 in both flavours against its plain version of the same
    flavour at K2's bounds, S = 96 and 144. Returns the worst errors."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render.raycaster import pack_fused_params
    from anerf_torch.tools.flagship import SURREAL_SINGLE

    _, cfg, params, src = _flagship_render(torch, np, **SURREAL_SINGLE)
    ncfg = cfg.nerf
    if not (cfg.single_net and cfg.embed_view.num_freqs == 0
            and fm.view_in(ncfg) == 88):
        raise AssertionError('SURREAL_SINGLE is not the single-net, '
                             'multires_views 0 network')
    packed = pack_fused_params(params, cfg)
    packed['fine'] = packed['coarse']            # one net for both passes
    p4 = fm.pack_params(params['coarse'], ncfg)
    kernels = _mode_kernels(torch, ncfg, packed, {'coarse': p4, 'fine': p4})
    R = 512
    v = _bucket_inputs(torch, np, cfg, params, src, 0, R=R,
                       samples=(96, 48), culled=False)
    worst = {'K1': 0.0, 'K3': 0.0, 'K4': 0.0, 'K2': 0.0, 'K2-bf16': 0.0}
    for S in (96, 48, 144):
        for tau in (2000.0, 35.0):
            k1 = fr.fused_encode_mlp_pts(ncfg, packed['coarse'], v[0][S],
                                         v[1], v[2], S, tau)
            torch.cuda.synchronize()
            want = fr.fused_encode_mlp_pts_ref(ncfg, packed['coarse'],
                                               v[0][S], v[1], v[2], S, tau)
            err = (k1 - want).abs().max().item()
            ok = (torch.allclose(k1, want, atol=K1_ATOL, rtol=K1_RTOL)
                  and bool(torch.isfinite(k1).all()))
            print(f'K1 (single net) S={S} tau={tau:g}: max_abs={err:.3e} '
                  f'(tol atol=rtol={K1_ATOL}) -> {"ok" if ok else "FAIL"}',
                  flush=True)
            if not ok:
                raise AssertionError(f'K1 (single net) disagrees at S={S}')
            worst['K1'] = max(worst['K1'], err)
            for kid, e in _hold_modes(torch, kernels, v, S, 'coarse',
                                      tau, k1, R, ' (single net)').items():
                worst[kid] = max(worst[kid], e)
    for S in (96, 144):
        g = torch.as_tensor(np.random.default_rng(30 + S).normal(
            size=(R, S, 4)) * 0.1, dtype=torch.float32, device='cuda')
        args = (ncfg, packed['coarse'], v[0][S], v[1], v[2], S, 2000.0, g)
        for f32, kid in ((True, 'K2'), (False, 'K2-bf16')):
            got = fr.fused_bwd(*args, bwd_f32=f32)
            again = fr.fused_bwd(*args, bwd_f32=f32)
            torch.cuda.synchronize()
            want = fr.fused_bwd_ref(*args, bwd_f32=f32)
            err = _k2_errors(torch, ncfg, packed['coarse'], got, want,
                             f'{kid} (single net) S={S}', R)
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f'{kid} (single net) is not '
                                     f'deterministic at S={S}')
            print(f'{kid} (single net) S={S}: max_abs={err[0]:.3e}, worst '
                  f'dW max_rel {err[1]:.3e}, worst fro {err[3]:.3e} (bounds '
                  f'{K2_BLOCK_RTOL} / {K2_FRO}); relaunch bit-equal -> ok',
                  flush=True)
            worst[kid] = max(worst[kid], err[0])
            del got, again, want
    return worst


def _k2_style_errors(torch, ncfg, nfk, nfv, got, want, label, per_point):
    """K2's bounds on a K2-d stage's outputs: each dW block (the first
    output) within K2_FRO in the Frobenius norm and K2_BLOCK_RTOL in the
    max, relative; each other output the same, or, if `per_point`, within
    K2_FRO and K2D_POINTS_OFF. Returns (max abs, worst max rel, worst
    share of points off)."""
    from anerf_torch.kernels import fused_render as fr
    pairs = [(a, b, False) for a, b in zip(
        fr.split_grads(ncfg, nfk, nfv, got[0]).values(),
        fr.split_grads(ncfg, nfk, nfv, want[0]).values())]
    pairs += [(a, b, per_point) for a, b in zip(got[1:], want[1:])]
    max_abs, worst, worst_off = 0.0, 0.0, 0.0
    for a, b, pp in pairs:
        d = (a - b).abs()
        top = b.abs().max().clamp_min(1e-7)
        rel = (d.max() / top).item()
        fro = ((a - b).norm() / b.norm().clamp_min(1e-7)).item()
        off = (d.reshape(-1, d.shape[-1]) > K2_RTOL * top).any(1) \
            .float().mean().item()
        ok = (fro < K2_FRO and bool(torch.isfinite(a).all())
              and (off < K2D_POINTS_OFF if pp else rel < K2_BLOCK_RTOL))
        if not ok:
            raise AssertionError(f'{label}: rel {rel:.3e}, fro {fro:.3e}, '
                                 f'points off {off:.3e}')
        max_abs, worst = max(max_abs, d.max().item()), max(worst, rel)
        worst_off = max(worst_off, off) if pp else worst_off
    return max_abs, worst, worst_off


def stages_phase(torch, np, cfg, params, src):
    """Every stage of K1-d and K2-d on one training batch's operands (2048
    rays; the coarse net at S = 64, the fine net at S = 80; tau = 2000):
    each against its plain digest, the full stages bit for bit against K1
    and K2; median times beside the stages' bounds. Returns their
    `kernels` records."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.kernels import stages
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg = cfg.nerf
    nfk, nfv = packed['coarse']['nfk'], packed['coarse']['nfv']
    _, k0p, _, kvp = fr.input_widths(nfk, nfv)
    R, tau = 2048, 2000.0
    variants = [_bucket_inputs(torch, np, cfg, params, src, seed, R=R)
                for seed in range(4)]
    gs = {S: [torch.as_tensor(
        np.random.default_rng(10 + i).normal(size=(R, S, 4)) * 0.1,
        dtype=torch.float32, device='cuda') for i in range(4)]
        for S in (64, 80)}
    w_net = _packed_bytes(torch, packed) // 2
    w_net_k1 = _packed_bytes(torch, packed, skip=('w', 'img_t')) // 2
    dw_bytes = 4 * sum(r * c for _, r, c in fr.grad_blocks(ncfg, nfk, nfv))
    rec = {'K1-d': {st: {} for st in stages.FWD_STAGES},
           'K2-d': {st: {} for st in stages.BWD_STAGES}}
    for S, net in ((64, 'coarse'), (80, 'fine')):
        k1_ins = [(ncfg, packed[net], v[0][S], v[1], v[2], S, tau)
                  for v in variants]
        for stage in stages.FWD_STAGES:
            got = stages.decompose_fwd(stage, *k1_ins[0])
            if stage == 'full':
                want = fr.fused_encode_mlp_pts(*k1_ins[0])
                torch.cuda.synchronize()
                ok, err, rel = torch.equal(got, want), 0.0, 0.0
            else:
                torch.cuda.synchronize()
                want = stages.decompose_fwd_ref(stage, *k1_ins[0])
                err = (got - want).abs().max().item()
                rel = err / want.abs().max().clamp_min(1e-7).item()
                ok = rel < DIGEST_RTOL and bool(torch.isfinite(got).all())
            print(f'K1-d {stage} S={S}: max_abs={err:.3e} max_rel={rel:.3e} '
                  f'(tol {"bit-equal to K1" if stage == "full" else DIGEST_RTOL}'
                  f') -> {"ok" if ok else "FAIL"}', flush=True)
            if not ok:
                raise AssertionError(f'K1-d {stage} disagrees at S={S}')
            ins = [(stage,) + a for a in k1_ins]
            bound = rf.bound_ms(rf.k1d_stage_seconds(
                stage, ncfg, nfk, nfv, R * S, R, w_net_k1))
            rec['K1-d'][stage][S] = (
                _median_ms(stages.decompose_fwd, ins, 11),
                _median_ms(stages.decompose_fwd_ref, ins, 3), bound, err)
        k2_ins = [a + (g,) for a, g in zip(k1_ins, gs[S])]
        for stage in stages.BWD_STAGES:
            got = stages.decompose_bwd(stage, *k2_ins[0])
            if stage == 'full':
                want = fr.fused_bwd(*k2_ins[0])
                torch.cuda.synchronize()
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f'K2-d full is not K2 at S={S}')
            torch.cuda.synchronize()
            want = stages.decompose_bwd_ref(stage, *k2_ins[0])
            off = 0.0
            if stage == 'recompute':
                err = (got[0] - want[0]).abs().max().item()
                rel = err / want[0].abs().max().item()
                if not torch.allclose(got[0], want[0], atol=K1_ATOL,
                                      rtol=K1_RTOL):
                    raise AssertionError(f'K2-d recompute disagrees at S={S}')
            else:
                err, rel, off = _k2_style_errors(
                    torch, ncfg, nfk, nfv, got, want, f'K2-d {stage} S={S}',
                    per_point=stage != 'full')
            print(f'K2-d {stage} S={S}: max_abs={err:.3e} max_rel={rel:.3e}'
                  f' points off by >{K2_RTOL}: {off:.3e}'
                  f'{" (bit-equal to K2)" if stage == "full" else ""} -> ok',
                  flush=True)
            del got, want
            ins = [(stage,) + a for a in k2_ins]
            bound = rf.bound_ms(rf.k2d_stage_seconds(
                stage, ncfg, nfk, nfv, k0p, kvp, R * S, R, w_net, dw_bytes))
            rec['K2-d'][stage][S] = (
                _median_ms(stages.decompose_bwd, ins, 7),
                _median_ms(stages.decompose_bwd_ref, ins, 3), bound, err)

    # K2-d in the bf16 flavour at the culled shapes. Every point there is
    # in a window, where a flipped mask between two recomputes is more
    # frequent than at S = 64 / 80, so the per-point stages are held on
    # the kernel's own activations: mlp bit-equal to K2's sequence stopped
    # there, whose MLP backward is within K2_BF16_FRO of the plain bf16
    # one on its saved activations; pe's digest within K2_FRO of the plain
    # PE backward fed that stage's own dx0 / dxv; full bit-equal to K2.
    bf16_err = 0.0
    for S, net in ((8, 'coarse'), (24, 'fine')):
        g = torch.as_tensor(np.random.default_rng(20 + S).normal(
            size=(R, S, 4)) * 0.1, dtype=torch.float32, device='cuda')
        args = (ncfg, packed[net], variants[0][0][S], variants[0][1],
                variants[0][2], S, tau, g)
        got = {st: stages.decompose_bwd(st, *args, bwd_f32=False)
               for st in stages.BWD_STAGES}
        t = fr.launch_bwd(2, *args, bwd_f32=False)
        torch.cuda.synchronize()
        want = stages.decompose_bwd_ref('recompute', *args, bwd_f32=False)
        err = (got['recompute'][0] - want[0]).abs().max().item()
        if not torch.allclose(got['recompute'][0], want[0], atol=K1_ATOL,
                              rtol=K1_RTOL):
            raise AssertionError(f'K2-d bf16 recompute disagrees at S={S}')
        mlp = (t['dW'], t['dx0'].view(R, S, -1), t['dxv'].reshape(R, S, -1))
        fro, _ = _mlp_stage_fro(torch, ncfg, packed[net], args)
        digest = fr.pe_transform_bwd_ref(packed[net], *args[2:7], mlp[1],
                                         mlp[2], pe_only=True)
        pe_fro = ((got['pe'][1] - digest).norm() / digest.norm()).item()
        ok = (all(torch.equal(a, b) for a, b in zip(got['mlp'], mlp))
              and torch.equal(got['pe'][0], mlp[0])
              and all(torch.equal(a, b) for a, b in zip(
                  got['full'], fr.fused_bwd(*args, bwd_f32=False)))
              and fro < K2_BF16_FRO and pe_fro < K2_FRO)
        bf16_err = max(bf16_err, err)
        print(f'K2-d bf16 S={S}: recompute max_abs={err:.3e}; mlp bit-equal '
              f'to K2 stopped there, its MLP backward {fro:.3e} from the '
              f'plain one on its own activations (limit {K2_BF16_FRO}); pe '
              f'digest {pe_fro:.3e} from the plain PE backward on that '
              f'stage\'s cotangents (limit {K2_FRO}); full bit-equal to '
              f'K2-bf16 -> {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'K2-d bf16 disagrees at S={S}')
        del got, t, mlp

    out = []
    for kid, name, src_file, replaces in (
            ('K1-d', 'decompose_fwd', 'fused_render_sm90.cu',
             'tools/kernel_bench.py:194'),
            ('K2-d', 'decompose_bwd', 'fused_render_bwd_sm90.cu',
             'tools/kernel_bench.py:314')):
        per = {}
        for stage, by_s in rec[kid].items():
            per[stage] = {
                'ms_s64': by_s[64][0], 'ms_s80': by_s[80][0],
                'plain_ms': by_s[64][1] + by_s[80][1],
                'bound_ms': by_s[64][2][0] + by_s[80][2][0],
                'bound_by': by_s[64][2][1],
                'max_abs_err': max(by_s[64][3], by_s[80][3])}
            print(f'{kid} {stage} (S=64 + S=80, R={R}): kernel '
                  f'{by_s[64][0] + by_s[80][0]:.4f} ms (S=64 '
                  f'{by_s[64][0]:.4f}, S=80 {by_s[80][0]:.4f}), plain '
                  f'{per[stage]["plain_ms"]:.4f} ms, bound '
                  f'{per[stage]["bound_ms"]:.4f} ms '
                  f'({per[stage]["bound_by"]})', flush=True)
        top = max(per.values(), key=lambda p: p['bound_ms'])
        out.append({'name': name, 'route': 'cuda',
                    'source': f'anerf_torch/kernels/csrc/{src_file}',
                    'replaces': replaces, 'launches': None,
                    'max_abs_err': max(p['max_abs_err']
                                       for p in per.values()),
                    'ms': sum(p['ms_s64'] + p['ms_s80']
                              for p in per.values()),
                    'plain_ms': sum(p['plain_ms'] for p in per.values()),
                    'bound_ms': sum(p['bound_ms'] for p in per.values()),
                    'bound_by': top['bound_by'], 'library_ms': None,
                    'stages': per})
    out[1]['bf16_culled_max_abs_err'] = bf16_err
    return out


def tool_phase(torch):
    """The kernel_bench tool's three modes at 2048 rays, S = 64 and 80,
    and its --bwd_bf16 rows (default mode and --decompose_bwd) at S = 8
    and 24: the main path of K3, K4, K1-d and K2-d. Their counts (K3-v1's
    and K4-v1's too, which must stay 0) are set to 0 just before and read
    just after. Returns {kernel id: launches}."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import stages
    from anerf_torch.tools import kernel_bench as kb

    fr.RAW_LAUNCHES = fm.LAUNCHES = 0
    fr.RAW_V1_LAUNCHES = fm.V1_LAUNCHES = 0
    stages.FWD_LAUNCHES = stages.BWD_LAUNCHES = 0
    runs = [(mode, (64, 80), True)
            for mode in ('bench', 'decompose', 'decompose_bwd')]
    runs += [(mode, (8, 24), False) for mode in ('bench', 'decompose_bwd')]
    for mode, shapes, f32 in runs:
        rec = kb.run(mode, n_rays=2048, reps=8, shapes=shapes, bwd_f32=f32)
        if not f32 and not any(r.get('kind') == 'bwd_bf16'
                               or r.get('bwd_f32') is False
                               for r in rec['rows']):
            raise AssertionError(f'{mode} --bwd_bf16: no bf16 rows')
        for row in rec['rows']:
            for key, val in row.items():
                if (key.endswith('_ms') or key == 'ms') \
                        and not math.isfinite(val):
                    raise AssertionError(f'{mode}: {key} = {val}')
    counts = {'K3': fr.RAW_LAUNCHES, 'K4': fm.LAUNCHES,
              'K1-d': stages.FWD_LAUNCHES, 'K2-d': stages.BWD_LAUNCHES}
    v1 = {'K3-v1': fr.RAW_V1_LAUNCHES, 'K4-v1': fm.V1_LAUNCHES}
    print(f'launches on the kernel_bench path: {counts}, by the first '
          f'versions {v1}', flush=True)
    if not all(counts.values()):
        raise AssertionError(f'a kernel did not run on its path: {counts}')
    if any(v1.values()):
        raise AssertionError(f'K3-v1 or K4-v1 ran on the path: {v1}')
    return {**counts, **v1}


def reference_check(torch, np, cfg, params, src, n_keep=0):
    """The rendered output against a reference: render_rays through K1 vs
    the plain-torch (XLA-mirror) branch on a small batch of rays aimed at
    the body of the bullet-time pose; with n_keep, both culled to that
    many samples a ray (cull_samples)."""
    import dataclasses

    from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
    from anerf_torch.render import modes
    from anerf_torch.render.raycaster import render_rays

    bt = modes.load_bullettime(src, np.array([0]), n_bullet=4)
    dev = 'cuda'
    R = 256
    rng = np.random.default_rng(5)
    root = bt['kp3d'][0, 0]
    o = bt['c2ws'][0, :3, 3]
    tgt = root + rng.normal(size=(R, 3)).astype(np.float32) * 0.3
    d = (tgt - o).astype(np.float32)
    rays = np.concatenate([np.broadcast_to(o, (R, 3)), d,
                           np.zeros((R, 1)), np.ones((R, 1)),
                           d / np.linalg.norm(d, axis=-1, keepdims=True)],
                          -1).astype(np.float32)
    cyl = get_kp_bounding_cylinder(bt['kp3d'][:1], ext_scale=0.001,
                                   extend_mm=250, top_expand_ratio=1.6,
                                   bot_expand_ratio=1.1, head='-y')
    kw = dict(ray_batch=torch.as_tensor(rays, device=dev),
              kp_batch=torch.as_tensor(bt['kp3d'][:1], device=dev)
              .expand(R, 24, 3),
              skts=torch.as_tensor(bt['skts'][:1], device=dev)
              .expand(R, 24, 4, 4),
              bones=None,
              cyls=torch.as_tensor(cyl, device=dev).expand(R, 5),
              cam_idxs=torch.zeros(R, dtype=torch.long, device=dev),
              tau=2000.0)
    tcfg = dataclasses.replace(cfg.test_mode(), n_keep=n_keep)
    got = render_rays(params, tcfg, **kw)
    want = render_rays(params, dataclasses.replace(tcfg, use_fused=False),
                       **kw)
    for k in ('rgb_map', 'acc_map', 'rgb0', 'acc0'):
        err = (got[k] - want[k]).abs().max().item()
        ok = torch.allclose(got[k], want[k], atol=SLICE_ATOL,
                            rtol=SLICE_RTOL)
        print(f'render_rays fused vs plain branch ({R} rays'
              f'{f", culled to {n_keep}" if n_keep else ""}): {k} '
              f'max_abs={err:.3e} -> {"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'render_rays {k}: fused branch disagrees '
                                 'with the plain branch')


def _requests(np, src):
    from anerf_torch.render import modes
    return [
        ('bullet pose 0 x4', lambda: modes.load_bullettime(
            src, np.array([0]), n_bullet=4)),
        ('selected poses 1,2', lambda: modes.load_selected(
            src, np.array([1, 2]))),
        ('bullet pose 0 x4 again', lambda: modes.load_bullettime(
            src, np.array([0]), n_bullet=4)),
    ]


def _render(torch, args, cfg, params, data):
    """One request through render_path; returns (out, seconds)."""
    from anerf_torch.render.render_path import render_path
    t0 = time.perf_counter()
    out = render_path(params, cfg, data['c2ws'], (H, W, data['focals']),
                      data['kp3d'], data['skts'], data['bones'],
                      cam_idxs=data['cam_idxs'], tau=2000.0,
                      chunk=args.chunk, ext_scale=args.ext_scale,
                      white_bkgd=True, use_framecode_idx=args.opt_framecode)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def slice_phase(torch, np, args, cfg, params, src, k1_bucket_ms,
                requests=None, label=''):
    """render_path requests through the fused branch (`requests`, indices
    into _requests; all three by default); returns the K1 launches they
    made (counts are reset just before each request and read just after
    it) and each request's box-rays/s."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render.render_path import n_buckets_for

    launches, rates = 0, []
    reqs = _requests(np, src)
    for name, build in [reqs[i] for i in (requests or range(len(reqs)))]:
        data = build()
        fr.LAUNCHES = 0
        out, dt = _render(torch, args, cfg, params, data)
        got_launches = fr.LAUNCHES
        n_rays = [int((br[0] - tl[0]) * (br[1] - tl[1]))
                  for tl, br in out['bboxes']]
        buckets = sum(n_buckets_for(n, args.chunk) for n in n_rays if n)
        n_img = len(data['c2ws'])
        # K1's share of the request, from its median bucket time above
        k1_share = buckets * k1_bucket_ms / 1e3 / dt
        rates.append(sum(n_rays) / dt)
        print(f'request "{name}"{label}: {n_img} images {H}x{W}, '
              f'{sum(n_rays)} box rays, {buckets} buckets, {got_launches} '
              f'K1 launches, '
              f'{dt:.3f} s, {sum(n_rays) / dt:.1f} box-rays/s, '
              f'K1 ~{k1_share:.3f} of the time, '
              f'acc mean {out["accs"].mean():.4f}', flush=True)
        if out['rgbs'].shape != (n_img, H, W, 3):
            raise AssertionError(f'rgbs shape {out["rgbs"].shape}')
        if not np.isfinite(out['rgbs']).all():
            raise AssertionError('non-finite rgb')
        if out['accs'].min() < 0.0 or out['accs'].max() > 1.0:
            raise AssertionError('acc outside [0, 1]')
        if out['accs'].max() < 0.01:
            raise AssertionError('the body does not show up in the images')
        if got_launches != 2 * buckets or buckets == 0:
            raise AssertionError(f'{got_launches} K1 launches for '
                                 f'{buckets} buckets')
        launches += got_launches
    return launches, rates


def _flagship_train(torch, np, **overrides):
    """The train slice's setup: the flagship on 128 frames with N_rand 2048
    and N_sample_images 128 from configs/surreal/surreal.txt (and
    `overrides` of its TrainConfig); one batch of 16 rays per frame aimed
    at its root (as __graft_entry__._batch aims them) with a constant
    gray target. Returns (args, cfg, pose config, rest pose, state,
    optimizers, batch)."""
    from anerf_torch.ops.cylinder import get_kp_bounding_cylinder
    from anerf_torch.tools.bench import _train_state
    from anerf_torch.tools.flagship import flagship

    n_frames, n_rays = 128, 2048
    args, cfg, params, rest, bones, kp3d, _ = flagship(
        n_frames, N_rand=n_rays, N_sample_images=n_frames, **overrides)
    cyls = get_kp_bounding_cylinder(kp3d, ext_scale=0.001, head='y')
    state, pose_cfg, opt, popt = _train_state(
        args, params, {'kp3d': kp3d, 'bones': bones}, torch.device('cuda'))

    brng = np.random.default_rng(1)
    kp_idxs = brng.permutation(n_frames).astype(np.int64)
    pose_idx = np.repeat(np.arange(n_frames), n_rays // n_frames)
    roots = kp3d[kp_idxs][:, 0]
    rays_o = (roots + np.array([0.0, 0.2, 2.5], np.float32))[pose_idx]
    targets = roots[pose_idx] + brng.normal(
        size=(n_rays, 3)).astype(np.float32) * 0.3
    rays_d = targets - rays_o
    viewdirs = rays_d / np.linalg.norm(rays_d, axis=-1, keepdims=True)
    rays = np.concatenate([rays_o, rays_d, np.zeros((n_rays, 1)),
                           np.ones((n_rays, 1)), viewdirs], -1)
    dev = lambda a, dt=torch.float32: torch.as_tensor(
        np.asarray(a), dtype=dt, device='cuda')
    batch = {'rays': dev(rays), 'target_s': dev(np.full((n_rays, 3), 0.3)),
             'fgs': dev(np.ones((n_rays, 1))),
             'bgs': dev(np.ones((n_rays, 3))),
             'cam_idxs': dev(kp_idxs[pose_idx], torch.long),
             'pose_idx': dev(pose_idx, torch.long),
             'kp_idxs': dev(kp_idxs, torch.long),
             'cyls': dev(cyls[kp_idxs])}
    return (args, cfg, pose_cfg, torch.as_tensor(rest, device='cuda'),
            state, opt, popt, batch)


def _step_grads(torch, setup, tcfg, R=256, outputs=False):
    """One step's loss (the two rgb MSEs) on the first R rays in test
    mode through render_rays with `tcfg`: its gradients w.r.t. every
    param leaf (ravel order: 'coarse', 'cutoff_dist', 'fine') and the
    per-ray skts (with `outputs`, also render_rays' outputs)."""
    from anerf_torch.pose.pose_opt import fk_lookup
    from anerf_torch.render.raycaster import render_rays
    from anerf_torch.train.state import tree_leaves
    from anerf_torch.train.trainer import derive_schedules

    args, cfg, pose_cfg, rest, state, _, _, batch = setup
    n_img = R // 16
    kp, bones, skts, _, _ = fk_lookup(state.pose_params,
                                      batch['kp_idxs'][:n_img], rest,
                                      pose_cfg)
    rep = lambda t: t.repeat_interleave(16, 0)
    tau, _ = derive_schedules(args, cfg, 0)
    leaves = tree_leaves(state.params)
    for x in leaves:
        x.requires_grad_(True)
    sk = rep(skts.detach()).requires_grad_(True)
    out = render_rays(state.params, tcfg, batch['rays'][:R], rep(kp), sk,
                      rep(bones), batch['cyls'][:n_img].
                      repeat_interleave(16, 0),
                      cam_idxs=batch['cam_idxs'][:R], tau=tau)
    loss = torch.mean((out['rgb_map'] - batch['target_s'][:R]) ** 2) \
        + torch.mean((out['rgb0'] - batch['target_s'][:R]) ** 2)
    grads = torch.autograd.grad(loss, leaves + [sk], allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    if outputs:
        return grads, {k: v.detach() for k, v in out.items()}
    return grads


def _compare_step_grads(torch, setup, got, want, label, fro_tol=None):
    """Every leaf's gradient (and skts') of `got` against `want` within
    STEP_GRAD_RTOL relative max (and `fro_tol` relative Frobenius);
    cutoff_dist gets none in `got`. Returns (worst max rel, worst fro,
    skts' max rel)."""
    from anerf_torch.train.state import tree_leaves
    i_cut = len(tree_leaves(setup[4].params['coarse']))
    worst, worst_fro = 0.0, 0.0
    for i, (gf, gp) in enumerate(zip(got, want)):
        if i == i_cut:
            if gf is not None and gf.abs().max().item() != 0.0:
                raise AssertionError(f'{label}: cutoff_dist has a gradient')
            continue
        rel = ((gf - gp).abs().max()
               / gp.abs().max().clamp_min(1e-7)).item()
        fro = ((gf - gp).norm() / gp.norm().clamp_min(1e-7)).item()
        worst, worst_fro = max(worst, rel), max(worst_fro, fro)
        if not (rel < STEP_GRAD_RTOL
                and (fro_tol is None or fro < fro_tol)):
            raise AssertionError(f'{label}: step gradient {i} '
                                 f'({tuple(gp.shape)}): max rel {rel:.3e}, '
                                 f'fro {fro:.3e}')
    return worst, worst_fro, rel


def train_reference_check(torch, np, setup, label=''):
    """One step's gradients on 256 rays in test mode: every param leaf
    and the per-ray skts through the fused branch (K1 + K2) against the
    plain-torch branch; cutoff_dist gets no gradient on the fused
    branch."""
    import dataclasses

    cfg = setup[1]
    got, want = (_step_grads(torch, setup, dataclasses.replace(
        cfg.test_mode(), use_fused=fused)) for fused in (True, False))
    worst, _, rel = _compare_step_grads(torch, setup, got, want,
                                        f'fused vs plain branch{label}')
    print(f'train step gradients{label}, fused (K1 + K2) vs plain '
          f'branch (256 rays, {len(got)} leaves + skts): worst max_rel '
          f'{worst:.3e} (tol {STEP_GRAD_RTOL}), skts '
          f'{rel:.3e}; cutoff_dist gets no gradient -> ok', flush=True)


def culled_k2_check(torch, np, setup, label=''):
    """The culled fast-grads step's gradients on 256 rays in test mode
    with K2 (its bf16 flavour, on the card) against the same step with
    K2's plain bf16 version (fused_bwd_ref(..., bwd_f32=False)) on the
    card's tensors in its place: every param leaf and the per-ray skts
    within STEP_GRAD_RTOL (max) and K2_FRO (Frobenius)."""
    from anerf_torch.kernels import fused_render as fr

    tcfg = setup[1].test_mode()
    fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
    got = _step_grads(torch, setup, tcfg)
    torch.cuda.synchronize()
    counted = (fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    kernel = fr.fused_bwd
    fr.fused_bwd = lambda *a: fr.fused_bwd_ref(*a)
    try:
        want = _step_grads(torch, setup, tcfg)
    finally:
        fr.fused_bwd = kernel
    if counted != (0, 2):
        raise AssertionError(f'culled fast-grads step: K2 launches (f32, '
                             f'bf16) {counted}')
    worst, fro, rel = _compare_step_grads(
        torch, setup, got, want, f'K2-bf16 vs its plain version{label}',
        K2_FRO)
    print(f'culled fast-grads step gradients{label}, K2-bf16 vs its plain '
          f'version in its place (256 rays, S = 8 + 24, {len(got)} leaves '
          f'+ skts): worst max_rel {worst:.3e} (tol {STEP_GRAD_RTOL}), '
          f'worst fro {fro:.3e} (tol {K2_FRO}), skts {rel:.3e}; K2 '
          f'launches (f32, bf16) {counted} -> ok', flush=True)


def train_phase(torch, np, setup, profile=False, n_steps=N_TRAIN_STEPS,
                label='train'):
    """n_steps steps of make_train_step; the counts are set to 0 just
    before each step and read just after it: on the fused branch two K1
    and two K2 launches a step, all of K2's in the flavour the config
    asks for (bf16 with eff_fast_mlp), on the plain branch none. With
    `profile`, one more step runs under the profiler afterwards. Returns
    (K1 launches, K2 launches, median step seconds, the profiled step's
    idle share or None)."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.train.state import flatten_tree
    from anerf_torch.train.trainer import make_train_step

    args, cfg, pose_cfg, rest, state, opt, popt, batch = setup
    step = make_train_step(args, cfg, pose_cfg, rest, opt, popt)
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf16 = cfg.eff_fast_mlp
    losses, times, k1, k2 = [], [], 0, 0
    for i in range(n_steps):
        poses = flatten_tree(state.pose_params)
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        t0 = time.perf_counter()
        state, out = step(state, batch, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        n1 = fr.LAUNCHES
        n2, other = ((fr.BWD_BF16_LAUNCHES, fr.BWD_LAUNCHES) if bf16
                     else (fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES))
        k1, k2 = k1 + n1, k2 + n2
        loss = out['losses']['total_loss'].item()
        acc = out['stats']['alpha'].item()
        moved = not torch.equal(poses, flatten_tree(state.pose_params))
        losses.append(loss)
        print(f'{label} step {i}: loss {loss:.5f} psnr '
              f'{out["stats"]["psnr"].item():.3f} acc mean {acc:.4f} '
              f'kp_loss {out["losses"]["kp_loss"].item():.3e} '
              f'{times[-1] * 1e3:.1f} ms, K1 x{n1}, K2 '
              f'{"bf16" if bf16 else "f32"} x{n2}, poses '
              f'{"moved" if moved else "kept"}', flush=True)
        if not np.isfinite(loss) or not 0.0 <= acc <= 1.0:
            raise AssertionError(f'step {i}: loss {loss}, acc {acc}')
        want = (2, 2, 0) if cfg.use_fused else (0, 0, 0)
        if (n1, n2, other) != want:
            raise AssertionError(f'step {i}: {n1} K1, {n2} K2 and {other} '
                                 f'K2 of the other flavour')
        if moved != (i % args.opt_pose_step == 0):
            raise AssertionError(f'step {i}: poses moved={moved} off their '
                                 f'interval')
    if not np.mean(losses[-5:]) < losses[0]:
        raise AssertionError(f'loss does not fall: {losses}')
    t = sorted(times[2:])[len(times[2:]) // 2]
    finite = all(torch.isfinite(flatten_tree(x)).all().item()
                 for x in (state.params, state.pose_params))
    if not finite:
        raise AssertionError(f'{label}: non-finite params after {n_steps} '
                             f'steps')
    print(f'{label}: {n_steps} steps, loss {losses[0]:.5f} -> mean of '
          f'the last five {np.mean(losses[-5:]):.5f}; median step '
          f'{t * 1e3:.2f} ms = {args.N_rand / t:.1f} rays/s (steps 2..)',
          flush=True)
    idle = None
    if profile:
        idle = profile_phase(torch, f'{label} step ({args.N_rand} rays)',
                             lambda: step(state, batch, gen))
    return k1, k2, t, idle


def profile_phase(torch, label, fn):
    """fn() once under torch.profiler; prints the device-busy share of
    the wall time and the kernels that take the device time, and returns
    the idle share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    return _profile_report(torch, prof, label, dt)


def _profile_report(torch, prof, label, dt):
    """The device-busy share of a profiled window of dt seconds, and the
    kernels that take the device time, printed; returns the idle share."""
    from anerf_torch.tools.step_trace import kernel_rows

    # device kernels by name (the step_trace tool's parser)
    rows = kernel_rows(prof, split=None)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f'profile {label} (under the profiler): '
          f'wall {dt * 1e3:.1f} ms, device busy {busy_ms:.1f} ms, '
          f'idle share {1.0 - busy_ms / (dt * 1e3):.3f}', flush=True)
    for dev_us, count, key in rows[:12]:
        print(f'  {dev_us / 1e3:10.3f} ms {100 * dev_us / 1e3 / busy_ms:5.1f}%'
              f' x{count:<6d} {key[:90]}', flush=True)
    return 1.0 - busy_ms / (dt * 1e3)


# phase 10, the plain branch's knobs. The (d) configurations: every
# encoder kind and PE mode of the JAX package at least once (the fused
# branch refuses them all); 'cat' needs use_cutoff off (its 75 inputs are
# not a multiple of the 24 joints' windows), 'querypts' and 'world' a view
# window off (theirs are 3 wide), 'axisang' axis-angle poses (rot6d bones
# are 6 wide)
KNOB_ENCODERS = (
    ('relpos / axisang / rayangle, freq_schedule, normalize',
     dict(kp_dist_type='relpos', bone_type='axisang', view_type='rayangle',
          cutoff_bones=True, freq_schedule=True, normalize_cutoff=True,
          opt_rot6d=False)),
    ('cat / reldir / world', dict(kp_dist_type='cat', view_type='world',
                                  use_cutoff=False)),
    ('querypts / Nope / relray, cut_to_cutoff, shift_inputs',
     dict(kp_dist_type='querypts', bone_type='Nope', cut_to_dist=True,
          cutoff_shift=True, cutoff_viewdir=False)),
)
N_KNOB_STEPS = 20
N_ENCODER_STEPS = 8
# (a)'s fused (K1 + K2-bf16) vs plain fast_grads step gradients, worst
# relative Frobenius distance of a leaf (STEP_GRAD_RTOL bounds the max).
# K2_FRO does not fit: the branches round at other points (the fused
# kernels keep each product in f32 before the bf16 activation, the plain
# branch rounds the product to bf16 as XLA does; fast_grads adds bf16
# cotangent roundings at other sites in each). A CPU run with the
# kernels' plain versions on this phase's 256 rays read 2.3e-2, and the
# same pair without fast_grads (fused f32 vs plain default) already 1.9e-2
# (plain fast_grads vs plain default: 2.0e-2); an H100 read 2.0e-2.
# 4e-2 is 1.75x the largest reading.
KNOB_FRO = 4e-2
# remat_pe's gradients vs the default's (autograd through the same f32
# chain), worst max relative over the leaves and skts: the two differ by
# f32 summation order alone (observed 1.8e-7 on the CPU test's inputs,
# tests/test_torch_knobs.py)
REMAT_RTOL = 1e-5


def _sr_card_vs_cpu(torch, np):
    """_sr_cast of a fixed (2048 x 256) tensor and key on the card against
    the CPU's, bit for bit (the hash's int64 arithmetic on both)."""
    from anerf_torch.models.nerf import _sr_cast
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.normal(size=(2048, 256)).astype(np.float32)
                        * 30.0)
    key = torch.as_tensor(np.array([0x9E3779B9, 12345], np.uint32).view(
        np.int32))
    cpu = _sr_cast(x, key).float().view(torch.int32)
    card = _sr_cast(x.cuda(), key.cuda()).float().view(torch.int32).cpu()
    if not torch.equal(cpu, card):
        raise AssertionError(f'SR cast: card differs from the CPU in '
                             f'{int((cpu != card).sum())} elements')
    ups = int((card != x.to(torch.bfloat16).float().view(torch.int32)).sum())
    print(f'SR cast (2048 x 256, one key): card == CPU bit for bit; '
          f'{ups} of {x.numel()} elements off round-to-nearest -> ok',
          flush=True)


def _one_step(torch, np, setup, label):
    """One plain-branch make_train_step step: finite loss, no kernel."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.train.trainer import make_train_step

    args, cfg, pose_cfg, rest, state, opt, popt, batch = setup
    step = make_train_step(args, cfg, pose_cfg, rest, opt, popt)
    fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
    t0 = time.perf_counter()
    _, out = step(state, batch, torch.Generator(device='cuda').manual_seed(0))
    loss = out['losses']['total_loss'].item()
    dt = time.perf_counter() - t0
    n = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    print(f'{label}: one step, loss {loss:.5f}, {dt * 1e3:.1f} ms '
          f'(first call), kernel launches {n}', flush=True)
    if not np.isfinite(loss) or n != (0, 0, 0):
        raise AssertionError(f'{label}: loss {loss}, launches {n}')


def knobs_phase(torch, np, fused_step_s):
    """Phase 10: the plain branch at the settings only it runs, at the
    flagship's width (8 x 256, multires 7 / 4, 64 + 16 samples, N_rand
    2048). (a) JAX's headline_xla (cull_ratio 0.125, fast_grads, no fused
    kernel): one step's gradients against the fused step (K1 + K2-bf16)
    on the same batch, N_KNOB_STEPS steps with no kernel launched, ms
    and rays/s beside phase 6's fused step, one step's idle share. (b)
    sr_grads on that step: the SR cast on the card equal to the CPU's,
    N_KNOB_STEPS steps. (c) hifi_pe and remat_pe (culled, no fast_grads):
    forwards bit-equal to the default's, remat's gradients within
    REMAT_RTOL; fast_pe and alpha_f32 one step each. (d) KNOB_ENCODERS,
    N_ENCODER_STEPS steps each, unculled. Returns the phase's numbers."""
    import dataclasses

    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.train.state import tree_leaves

    t_phase = time.perf_counter()
    rec = {}
    setup = _flagship_train(torch, np, cull_ratio=0.125, fast_grads=True,
                            fused_kernel=False)
    cfg = setup[1]
    if cfg.use_fused or cfg.n_keep != 8 or not cfg.eff_fast_pe:
        raise AssertionError('phase 10 (a) is not headline_xla')
    fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
    want = _step_grads(torch, setup, cfg.test_mode())
    torch.cuda.synchronize()
    plain_n = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    got = _step_grads(torch, setup, dataclasses.replace(cfg.test_mode(),
                                                        use_fused=True))
    if plain_n != (0, 0, 0):
        raise AssertionError(f'plain headline_xla step launched {plain_n}')
    worst, fro, rel = _compare_step_grads(
        torch, setup, got, want, 'fused (K1 + K2-bf16) vs plain fast_grads',
        KNOB_FRO)
    print(f'(a) headline_xla step gradients, fused (K1 + K2-bf16) vs plain '
          f'fast_grads (256 rays, S = 8 + 24): worst max_rel {worst:.3e} '
          f'(tol {STEP_GRAD_RTOL}), worst fro {fro:.3e} (tol {KNOB_FRO}), '
          f'skts {rel:.3e}; plain launches {plain_n} -> ok', flush=True)
    _, _, step_s, idle = train_phase(torch, np, setup, profile=True,
                                     n_steps=N_KNOB_STEPS,
                                     label='(a) plain headline_xla train')
    rays = setup[0].N_rand
    rec['headline_xla'] = {'step_ms': step_s * 1e3,
                           'rays_per_s': rays / step_s, 'idle_share': idle,
                           'fused_step_ms': fused_step_s * 1e3,
                           'grad_max_rel': worst, 'grad_fro': fro}
    print(f'(a) plain headline_xla: {step_s * 1e3:.2f} ms/step = '
          f'{rays / step_s:.1f} rays/s, device idle share {idle:.3f}; '
          f'fused (phase 6) {fused_step_s * 1e3:.2f} ms/step = '
          f'{rays / fused_step_s:.1f} rays/s', flush=True)
    del setup

    _sr_card_vs_cpu(torch, np)
    setup = _flagship_train(torch, np, cull_ratio=0.125, fast_grads=True,
                            fused_kernel=False, sr_grads=True)
    _, _, sr_s, _ = train_phase(torch, np, setup, n_steps=N_KNOB_STEPS,
                                label='(b) plain sr_grads train')
    rec['sr_grads'] = {'step_ms': sr_s * 1e3, 'rays_per_s': rays / sr_s}
    print(f'(b) sr_grads: {sr_s * 1e3:.2f} ms/step beside (a) '
          f'{step_s * 1e3:.2f} ms/step', flush=True)
    del setup

    setup = _flagship_train(torch, np, cull_ratio=0.125, fused_kernel=False)
    cfg = setup[1].test_mode()
    base_g, base_out = _step_grads(torch, setup, cfg, outputs=True)
    for knob in ('hifi_pe', 'remat_pe'):
        g, out = _step_grads(torch, setup,
                             dataclasses.replace(cfg, **{knob: True}),
                             outputs=True)
        same = all(torch.equal(out[k], base_out[k]) for k in base_out)
        if not same:
            raise AssertionError(f'(c) {knob}: forward not bit-equal to '
                                 f'the default')
        if knob == 'remat_pe':
            rels = [((a - b).abs().max() / b.abs().max().clamp_min(1e-30)
                     ).item() for a, b in zip(g, base_g) if b is not None]
            rec['remat_grad_max_rel'] = max(rels)
            if not max(rels) < REMAT_RTOL:
                raise AssertionError(f'(c) remat_pe gradients: max rel '
                                     f'{max(rels):.3e}')
    print(f'(c) hifi_pe and remat_pe forwards bit-equal to the default '
          f'(256 rays, culled); remat_pe gradients worst max_rel '
          f'{rec["remat_grad_max_rel"]:.3e} (tol {REMAT_RTOL}, '
          f'{len(tree_leaves(setup[4].params))} leaves + skts) -> ok',
          flush=True)
    del setup
    for knob in ('fast_pe', 'alpha_f32'):
        over = dict(fast_mlp=True) if knob == 'alpha_f32' else {}
        setup = _flagship_train(torch, np, cull_ratio=0.125,
                                fused_kernel=False, **{knob: True}, **over)
        _one_step(torch, np, setup, f'(c) {knob}')
        del setup

    rec['encoders'] = {}
    for name, over in KNOB_ENCODERS:
        setup = _flagship_train(torch, np, fused_kernel=False, **over)
        ncfg = setup[1].nerf
        _, _, enc_s, _ = train_phase(torch, np, setup,
                                     n_steps=N_ENCODER_STEPS,
                                     label=f'(d) {name}')
        rec['encoders'][name] = {'step_ms': enc_s * 1e3,
                                 'dnet_input': ncfg.dnet_input,
                                 'input_ch_views': ncfg.input_ch_views}
        del setup
    rec['seconds'] = time.perf_counter() - t_phase
    print(f'phase 10 (plain-branch knobs) took {rec["seconds"]:.1f} s',
          flush=True)
    return rec


# the loop phase: python -m anerf_torch.run_nerf's main on the synthetic
# SURREAL grid (configs/surreal/surreal.txt's catalog layout: N_cams x
# N_kps images at H x W), under a git-ignored working directory
LOOP_KPS, LOOP_CAMS = 64, 4
LOOP_DIR = 'logs/chip_loop'
LOOP_UNROLL = 8
LOOP_STEPS = (48, 64)           # run 1 ends at 48, run 2 resumes to 64


class _Tee:
    """stdout that also keeps what was written (to read the loop's
    'resumed from step' line)."""

    def __init__(self, out):
        self.out, self.parts = out, []

    def write(self, s):
        self.parts.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def _loop_argv(n_iters):
    """run_nerf's argv: surreal.txt, the flagship's overrides
    (anerf_torch/tools/flagship.py), scanned dispatches of LOOP_UNROLL
    steps, a print per dispatch, checkpoints and pose snapshots every 24
    steps, a validation render at 48."""
    import os
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'configs', 'surreal', 'surreal.txt')
    return ['--config', cfg, '--basedir', 'logs', '--expname', 'flagship',
            '--fused_kernel', '--compute_dtype', 'bfloat16', '--opt_pose',
            '--opt_rot6d', '--opt_pose_step', '2', '--opt_framecode',
            '--opt_pose_coef', '2.0', '--opt_pose_tol', '0.01',
            '--scan_unroll', str(LOOP_UNROLL), '--i_print',
            str(LOOP_UNROLL), '--i_weights', '24', '--i_pose_weights', '24',
            '--i_testset', '48', '--n_iters', str(n_iters)]


def _box_rays_buckets(bboxes, chunk):
    """(box rays, ray buckets) of a render_path call from the [tl, br]
    boxes it returns: the buckets are half its K1 launches (an empty box
    launches nothing)."""
    from anerf_torch.render.render_path import n_buckets_for

    rays = buckets = 0
    for tl, br in bboxes:
        n = max(int(br[0] - tl[0]), 0) * max(int(br[1] - tl[1]), 0)
        rays += n
        buckets += n_buckets_for(n, chunk) if n else 0
    return rays, buckets


def _val_buckets(ctx):
    """The ray buckets of the last validation render (ctx.val_bboxes)."""
    return _box_rays_buckets(ctx.val_bboxes, ctx.args.chunk)[1]


def _print_uploads(label, ups):
    """The upload's parts per dispatch (ms): the pinned buffer's
    allocation, the packing without it, and the rest of upload_batch
    (the non-blocking copy's issue and the per-leaf views)."""
    parts = ['/'.join(f'{x * 1e3:.2f}' for x in (
        u['alloc'], u['pack'] - u['alloc'], u['upload'] - u['pack']))
        for u in ups]
    print(f'loop {label} upload per dispatch (alloc/pack/copy ms): '
          + ' '.join(parts), flush=True)


def _same_state(torch, a, b):
    from anerf_torch.train.checkpoint import state_tree
    from anerf_torch.train.state import tree_leaves
    la, lb = tree_leaves(state_tree(a)), tree_leaves(state_tree(b))
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


def loop_phase(torch, np):
    """The training entry point on the card: run_nerf.main twice in this
    process (run 1: 48 steps; run 2: resumed to 64), the counts set to 0
    just before each run and read just after it. Gates: psnr rises and
    every logged loss is finite; checkpoints 24 and 48 exist and 48
    restores run 1's final state bit for bit; the pose snapshots load;
    the validation render at 48 is finite; every dispatch's batch came
    from the native super-batch assembler; K1 / K2 (f32) launch 2 each a
    step plus K1's 2 a validation bucket, K2-bf16 none. Prints the loop's
    rays/s (all the rays of dispatches 2-6 over their wall time), one
    dispatch's wait / upload / step split, the upload's parts per
    dispatch and the idle share of run 2's second dispatch under a
    device-only profiler. Returns (K1, K2) launches and those numbers."""
    import contextlib
    import importlib.util
    import os
    import shutil

    from torch.profiler import ProfilerActivity, profile

    from anerf_torch.config import load_config
    from anerf_torch.data import pipeline
    from anerf_torch.data.fixtures import make_synthetic_h5, synthetic_data
    from anerf_torch.data.schema import h5_arrays
    from anerf_torch.data.surreal import SurrealDataset
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.run_nerf import main as run_nerf_main
    from anerf_torch.train import loop as loop_mod
    from anerf_torch.train.checkpoint import (load_pose_checkpoint,
                                              restore_checkpoint)

    root = os.path.abspath(LOOP_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(os.path.join(root, 'data', 'surreal'))
    has_h5py = importlib.util.find_spec('h5py') is not None
    has_imageio = importlib.util.find_spec('imageio') is not None
    kw = dict(n_kps=LOOP_KPS, n_cams=LOOP_CAMS, H=H, W=W)
    t0 = time.perf_counter()
    if has_h5py:
        make_synthetic_h5(os.path.join(
            root, 'data', 'surreal', 'surreal_train_h5py.h5'), **kw)
        source = 'h5 (data/surreal/surreal_train_h5py.h5)'
        data = None
    else:
        data = h5_arrays(synthetic_data(**kw))
        source = 'arrays (h5py absent)'
    print(f'loop: data source: {source}; {LOOP_KPS * LOOP_CAMS} images '
          f'{H}x{W} ({LOOP_CAMS} cameras x {LOOP_KPS} poses) made in '
          f'{time.perf_counter() - t0:.1f} s; validation pngs: '
          + ('written' if has_imageio else 'none (imageio absent)'),
          flush=True)

    # the upload's parts, timed on the host's clock per call: the pinned
    # buffer's allocation, the packing (allocation included) and the
    # whole upload_batch (the non-blocking copy's issue and the views)
    ups = []
    alloc_fn, pack_fn, upload_fn = (loop_mod._host_buffer,
                                    loop_mod.pack_batch,
                                    loop_mod.upload_batch)

    def timed(fn, key, new_row=False):
        def call(*a):
            if new_row:
                ups.append({})
            t = time.perf_counter()
            r = fn(*a)
            ups[-1][key] = time.perf_counter() - t
            return r
        return call

    recs = []

    def log_fn(rec):
        recs.append(dict(rec, t=time.perf_counter()))
        steps_s = rec['dispatch_s'] - rec['wait_s'] - rec['upload_s']
        print(f"loop step {rec['step']}: loss {rec['total_loss']:.5f} psnr "
              f"{rec['psnr']:.3f} rays/s {rec['rays_per_sec']:.1f}; "
              f"dispatch {rec['dispatch_s'] * 1e3:.1f} ms = wait "
              f"{rec['wait_s'] * 1e3:.1f} + upload "
              f"{rec['upload_s'] * 1e3:.2f} + steps {steps_s * 1e3:.1f}",
              flush=True)

    def run(n_iters, log):
        args = load_config(_loop_argv(n_iters))
        ds = None if data is None else SurrealDataset(
            data, N_samples=args.N_rand // args.N_sample_images,
            split='train')
        tee = _Tee(sys.stdout)
        pipeline.SUPER_BATCHES = pipeline.ITEM_BATCHES = 0
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        cwd = os.getcwd()
        os.chdir(root)
        ups.clear()
        loop_mod.upload_batch = timed(upload_fn, 'upload', True)
        loop_mod.pack_batch = timed(pack_fn, 'pack')
        loop_mod._host_buffer = timed(alloc_fn, 'alloc')
        try:
            with contextlib.redirect_stdout(tee):
                ctx = run_nerf_main(_loop_argv(n_iters), dataset=ds,
                                    log_fn=log, save_images=has_imageio)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
            (loop_mod._host_buffer, loop_mod.pack_batch,
             loop_mod.upload_batch) = alloc_fn, pack_fn, upload_fn
        counts = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES,
                  pipeline.SUPER_BATCHES, pipeline.ITEM_BATCHES)
        return ctx, counts, ''.join(tee.parts)

    # ---- run 1: 48 steps, 6 dispatches
    n1 = LOOP_STEPS[0]
    t0 = time.perf_counter()
    ctx1, (k1, k2, k2b, sup, item), _ = run(n1, log_fn)
    wall1 = time.perf_counter() - t0
    exp = os.path.join(root, 'logs', 'flagship')
    for r in recs:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f'loop step {r["step"]}: non-finite {bad}')
    if [r['step'] for r in recs] != list(range(LOOP_UNROLL, n1 + 1,
                                               LOOP_UNROLL)):
        raise AssertionError(f'loop prints at {[r["step"] for r in recs]}')
    if not recs[-1]['psnr'] > recs[0]['psnr']:
        raise AssertionError(f'loop psnr does not rise: {recs[0]["psnr"]} '
                             f'-> {recs[-1]["psnr"]}')
    ckpts = sorted(os.listdir(os.path.join(exp, 'checkpoints')))
    if ckpts != ['24', '48']:
        raise AssertionError(f'checkpoints {ckpts}')
    back = restore_checkpoint(exp, ctx1.state, step=48)
    if not _same_state(torch, back, ctx1.state):
        raise AssertionError('checkpoint 48 does not restore run 1\'s '
                             'final state bit for bit')
    for step in (24, 48):
        snap = load_pose_checkpoint(os.path.join(
            exp, 'pose_checkpoints', f'{step:08d}.npz'))
        if int(snap['global_step']) != step or snap['pose_params'][
                'bones'].shape != tuple(ctx1.state.pose_params['bones']
                                        .shape):
            raise AssertionError(f'pose snapshot {step}')
    if not np.array_equal(snap['pose_params']['pelvis'],
                          ctx1.state.pose_params['pelvis'].cpu().numpy()):
        raise AssertionError('pose snapshot 48 is not run 1\'s poses')
    with open(os.path.join(exp, 'metrics.jsonl')) as f:
        val = [r for r in map(json.loads, f) if 'val/psnr' in r]
    if len(val) != 1 or val[0]['step'] != 48 or not all(
            np.isfinite(val[0][k]) for k in ('val/psnr', 'val/ssim')):
        raise AssertionError(f'validation records {val}')
    val_dir = os.path.join(exp, 'val', f'{48:08d}')
    pngs = sorted(os.listdir(val_dir)) if os.path.isdir(val_dir) else []
    if len(pngs) != (16 if has_imageio else 0):
        raise AssertionError(f'validation pngs {pngs}')
    dispatches = n1 // LOOP_UNROLL
    if item or sup < dispatches:
        raise AssertionError(f'loader: {sup} native super-batches, {item} '
                             f'per-item batches for {dispatches} dispatches')
    buckets = _val_buckets(ctx1)
    if (k1, k2, k2b) != (2 * n1 + 2 * buckets, 2 * n1, 0):
        raise AssertionError(f'run 1: K1 {k1}, K2 {k2}, K2-bf16 {k2b}; '
                             f'want {2 * n1 + 2 * buckets}, {2 * n1}, 0 '
                             f'({buckets} validation buckets)')
    print(f'loop run 1: {n1} steps in {wall1:.1f} s; psnr '
          f'{recs[0]["psnr"]:.3f} -> {recs[-1]["psnr"]:.3f}; validation '
          f'at 48: psnr {val[0]["val/psnr"]:.3f} ssim '
          f'{val[0]["val/ssim"]:.4f} ({buckets} buckets); checkpoints '
          f'{ckpts}, 48 restored bit for bit; pose snapshots 24, 48 '
          f'loaded; {sup} native super-batches, {item} per-item; K1 x{k1}, '
          f'K2 x{k2}, K2-bf16 x{k2b} -> ok', flush=True)

    # the loop's rate: all the rays of dispatches 2-6 over their whole
    # wall time (the print at 8 to the print at 48; the checkpoint and
    # pose snapshot at 24 inside, the validation at 48 after). Beside it:
    # the median of the per-dispatch rates, run 1 whole (set-up, the
    # first dispatch, checkpoints and the validation included) and
    # metrics.jsonl's cumulative rays/s at 48. One dispatch's split: the
    # one ending at 40 (no checkpoint inside it)
    rays = ctx1.args.N_rand * LOOP_UNROLL
    per = sorted(rays / (b['t'] - a['t']) for a, b in zip(recs, recs[1:]))
    d = next(r for r in recs if r['step'] == 40)
    steps_s = d['dispatch_s'] - d['wait_s'] - d['upload_s']
    loop = {'rays_per_s': rays * (len(recs) - 1)
            / (recs[-1]['t'] - recs[0]['t']),
            'rays_per_s_dispatch_median': per[len(per) // 2],
            'rays_per_s_run1': ctx1.args.N_rand * n1 / wall1,
            'rays_per_s_logged': recs[-1]['rays_per_sec'],
            'dispatch_ms': d['dispatch_s'] * 1e3,
            'wait_ms': d['wait_s'] * 1e3, 'upload_ms': d['upload_s'] * 1e3,
            'steps_ms': steps_s * 1e3}
    print(f'loop rays/s: {loop["rays_per_s"]:.1f} (all rays of dispatches '
          f'2-6 over their wall time); per-dispatch median '
          f'{loop["rays_per_s_dispatch_median"]:.1f}; run 1 whole '
          f'{loop["rays_per_s_run1"]:.1f}; metrics.jsonl at 48 '
          f'{loop["rays_per_s_logged"]:.1f} (cumulative from the start); '
          f'dispatch 33-40: {loop["dispatch_ms"]:.1f} ms = loader wait '
          f'{loop["wait_ms"]:.2f} + upload {loop["upload_ms"]:.2f} + '
          f'{LOOP_UNROLL} steps {loop["steps_ms"]:.1f} '
          f'({loop["steps_ms"] / LOOP_UNROLL:.2f} ms a step)', flush=True)
    _print_uploads('run 1', ups)

    # ---- run 2: resumed at 48, 2 dispatches; the second one profiled
    n2 = LOOP_STEPS[1]
    # device activity only, so that the host's own time is barely
    # touched: the profiled dispatch's wall stays comparable with the
    # unprofiled ones
    prof = profile(activities=[ProfilerActivity.CUDA])
    window = {}

    def log_fn2(rec):
        log_fn(rec)
        if rec['step'] == n1 + LOOP_UNROLL:
            prof.start()
            window['t0'] = time.perf_counter()
        elif rec['step'] == n2:
            torch.cuda.synchronize()
            window['dt'] = time.perf_counter() - window['t0']
            prof.stop()

    recs.clear()
    ctx2, (k1b, k2_2, k2b_2, sup2, item2), out = run(n2, log_fn2)
    if 'resumed from step 48' not in out or ctx2.start_step != 48 \
            or ctx2.state.step != n2:
        raise AssertionError(f'run 2 did not resume from 48 (start '
                             f'{ctx2.start_step}, step {ctx2.state.step})')
    n_run2 = n2 - n1
    if (k1b, k2_2, k2b_2) != (2 * n_run2, 2 * n_run2, 0) or item2 \
            or sup2 < n_run2 // LOOP_UNROLL:
        raise AssertionError(f'run 2: K1 {k1b}, K2 {k2_2}, K2-bf16 '
                             f'{k2b_2}, {sup2} super-batches, {item2} '
                             f'per-item')
    idle = _profile_report(torch, prof, f'loop dispatch {n1 + 9}-{n2} '
                           f'(run 2, resumed)', window['dt'])
    if not idle < 1.0:
        raise AssertionError('the profiler saw no device time in the loop')
    loop['idle_share'] = idle
    loop['profiled_ms'] = window['dt'] * 1e3
    _print_uploads('run 2', ups)
    print(f'loop run 2: printed "resumed from step 48", {n_run2} steps; '
          f'K1 x{k1b}, K2 x{k2_2}; {sup2} native super-batches -> ok; '
          f'profiled dispatch: wall {window["dt"] * 1e3:.1f} ms (dispatch '
          f'33-40 unprofiled: {loop["dispatch_ms"]:.1f}), idle share '
          f'{idle:.3f}', flush=True)
    return k1 + k1b, k2 + k2_2, loop, data


RENDER_PHASE_IDXS = [0, 8, 16, 24, 32, 40, 48, 56]   # the surreal catalog's
TCP_CLIENTS, TCP_REQS = 4, 2
SOCK_TIMEOUT = 300.0
MESH_RES = 255                  # run_render's default --mesh_res
# whole images, fused branch against the plain one: NeRF's last interval
# is 1e10 long, so the sign of a ray's farthest density decides its
# coarse or fine acc between 0 and 1, and where that density lies within
# the branches' bf16 difference (~1e-3) of 0 the pixel flips between the
# background and the body's colour (seen on the CPU with a model 4 steps
# old: raw values equal to 3e-4, the last one 1e-4 against -0; none on
# an H100 with the phase's model). At most this share of
# the box pixels may be off by more than SLICE_ATOL / SLICE_RTOL.
FLIP_SHARE = 1e-2


def _check_images(np, out, label):
    """A request's images: finite, accs in [0, 1], the body visible."""
    if not np.isfinite(out['rgbs']).all():
        raise AssertionError(f'{label}: non-finite rgb')
    if out['accs'].min() < 0.0 or out['accs'].max() > 1.0:
        raise AssertionError(f'{label}: acc outside [0, 1]')
    if out['accs'].max() < 0.01:
        raise AssertionError(f'{label}: the body does not show up')


class _Counted:
    """Wraps a RenderSession's render_prepared / render_once: the K1
    count set to 0 just before each call and read just after it; each
    render_path call checked (images, K1 = 2 x its buckets) and recorded
    (frames, box rays, buckets, launches, seconds on the host clock
    ending in a synchronize); each mesh request checked for 0 launches."""

    def __init__(self, torch, np, sess, chunk):
        self.torch, self.np, self.sess, self.chunk = torch, np, sess, chunk
        self.records, self.meshes = [], []
        self.prepared, self.once = sess.render_prepared, sess.render_once
        sess.render_prepared, sess.render_once = self._prepared, self._once

    def _prepared(self, preps):
        from anerf_torch.kernels import fused_render as fr
        fr.LAUNCHES = 0
        t0 = time.perf_counter()
        outs = self.prepared(preps)
        self.torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = fr.LAUNCHES
        rays = buckets = 0
        for p, o in zip(preps, outs):
            r, b = _box_rays_buckets(o['bboxes'], self.chunk)
            rays, buckets = rays + r, buckets + b
            _check_images(self.np, o, p['args'].runname)
        if launches != 2 * buckets or buckets == 0:
            raise AssertionError(f'{[p["args"].runname for p in preps]}: '
                                 f'{launches} K1 launches for {buckets} '
                                 f'buckets')
        self.records.append({
            'runs': [p['args'].runname for p in preps],
            'frames': sum(len(o['rgbs']) for o in outs), 'rays': rays,
            'buckets': buckets, 'launches': launches, 'seconds': dt})
        return outs

    def _once(self, args):
        from anerf_torch.kernels import fused_render as fr
        if args.render_type != 'mesh':
            return self.once(args)
        fr.LAUNCHES = 0
        t0 = time.perf_counter()
        out = self.once(args)
        dt = time.perf_counter() - t0
        if fr.LAUNCHES:
            raise AssertionError(f'mesh request: {fr.LAUNCHES} K1 launches')
        self.meshes.append(dict(out['meshes'][0], seconds=dt))
        return out

    def launches(self):
        return sum(r['launches'] for r in self.records)


def render_entry_phase(torch, np, data):
    """The render entry point on the card (phase 8), in the loop phase's
    directory, on the experiment it trained (logs/flagship: surreal.txt
    with the flagship's overrides; its newest checkpoint, 48, with the
    density heads' bias lifted by 2): the
    one-shot CLI (val, two images, --eval); a RenderSession serving the
    stdin protocol on a pipe (one request a render type, a 256 x 256
    render_res, a correction and an unknown field that must fail, quit),
    a mesh at --mesh_res 255; the .tar export of its params and poses
    read back by a second session (bit-equal renders; correction now
    answers); one request on the plain branch against the fused one; the
    TCP server with 4 client threads of 2 requests each, without and
    with --coalesce; one request under a device-only profiler. K1 counted
    on every request (2 x its buckets; the mesh 0). Returns the phase's
    K1 launches and its numbers."""
    import contextlib
    import copy
    import dataclasses
    import importlib.util
    import io
    import os
    import queue
    import socket
    import threading

    from torch.profiler import ProfilerActivity, profile

    from anerf_torch import run_render as rr
    from anerf_torch.config import load_args_txt
    from anerf_torch.data.surreal import SurrealDataset
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.pose.ckpt_compat import export_reference_checkpoint
    from anerf_torch.render.raycaster import MESH_CHUNK
    from anerf_torch.utils.marching import load_ply

    t_phase = time.perf_counter()
    root = os.path.abspath(LOOP_DIR)
    has_imageio = importlib.util.find_spec('imageio') is not None
    log = open(os.path.join(root, 'render_entry.log'), 'w')
    cwd = os.getcwd()
    os.chdir(root)
    try:
        exp = os.path.join('logs', 'flagship')
        nerf_args = load_args_txt(os.path.join(exp, 'args.txt'))
        skw = {}
        if data is not None:
            # no h5py: the fixture's arrays stand in for the file, for
            # the training dataset of setup() and for the catalog entry
            skw = dict(dataset=SurrealDataset(
                data, N_samples=nerf_args.N_rand // nerf_args.N_sample_images,
                split='train'), h5=data)
        save = [] if has_imageio else ['--no_save']
        print(f'render entry: data source '
              f'{"arrays (h5py absent)" if data is not None else "h5"}; '
              + ('pngs written' if has_imageio
                 else 'no_save (imageio absent)'), flush=True)
        # 48 steps leave the model's density at or below 0 wherever the
        # requests look (on an H100 the acc of every image stayed under
        # 0.01, the validation's PSNR 28 being the white background's):
        # lift both density heads' bias by 2 in the newest
        # checkpoint, the one every load path reads, as the flagship
        # helper lifts its random weights (anerf_torch/tools/flagship.py)
        step = max(int(d) for d in os.listdir(os.path.join(exp,
                                                           'checkpoints')))
        ckpt = os.path.join(exp, 'checkpoints', str(step), 'state.pt')
        tree = torch.load(ckpt, weights_only=True)
        for net in ('coarse', 'fine'):
            tree['params'][net]['alpha_linear']['b'] += 2.0
        torch.save(tree, ckpt)
        base = ['--nerf_args', os.path.join(exp, 'args.txt'), '--ckptpath',
                os.path.join(exp, 'checkpoints'), '--dataset', 'surreal',
                '--entry', 'female', '--outputdir', 'render_output'] + save
        chunk = nerf_args.chunk

        # ---- 1. the one-shot CLI
        fr.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = rr.main(base + ['--render_type', 'val', '--selected_idxs',
                                  '0', '8', '--eval', '--runname', 'cli'],
                          **skw)
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t0
        cli_k1 = fr.LAUNCHES
        rays, buckets = _box_rays_buckets(out['bboxes'], chunk)
        _check_images(np, out, 'cli')
        ev = out['eval']
        if not (np.isfinite(ev['psnr']) and np.isfinite(ev['ssim'])) \
                or cli_k1 != 2 * buckets or out['rgbs'].shape != (2, H, W, 3):
            raise AssertionError(f'one-shot CLI: eval {ev}, {cli_k1} K1 '
                                 f'launches for {buckets} buckets')
        print(f'render entry 1, one-shot CLI (val, images 0 and 8, --eval, '
              f'session load included): {cli_s:.3f} s, psnr '
              f'{ev["psnr"]:.3f} ssim {ev["ssim"]:.4f}, {rays} box rays, '
              f'{buckets} buckets, K1 x{cli_k1} -> ok', flush=True)
        cli_rgbs = out['rgbs']
        del out

        # ---- 2. one session: the stdin server on a pipe
        t0 = time.perf_counter()
        sess = rr.RenderSession(rr.config_parser().parse_args(
            base + ['--runname', 'srv']), **skw)
        load_s = time.perf_counter() - t0
        plain_sess = copy.copy(sess)
        plain_sess.cfg = dataclasses.replace(sess.cfg, use_fused=False)
        counted = _Counted(torch, np, sess, chunk)
        base_args = rr.config_parser().parse_args(base + ['--runname',
                                                          'srv'])
        reqs = [
            {'render_type': 'bullet', 'selected_idxs': [0]},
            {'render_type': 'interpolate', 'selected_idxs': [0, 8]},
            {'render_type': 'animate', 'selected_idxs': [0, 8]},
            {'render_type': 'poserot', 'selected_idxs': [0]},
            {'render_type': 'correction', 'selected_idxs': [0]},
            {'render_type': 'bubble', 'selected_idxs': [0]},
            {'render_type': 'val', 'nonsense': 1},
            {'render_type': 'retarget', 'selected_idxs': [8]},
            {'render_type': 'selected', 'selected_idxs': [16]},
            {'render_type': 'val', 'selected_idxs': [24],
             'render_res': [256, 256], 'eval': True},
            {'render_type': 'mesh', 'selected_idxs': [0],
             'mesh_res': MESH_RES},
        ]
        for i, q in enumerate(reqs):
            q['runname'] = f'srv{i}_{q["render_type"]}'
        # the mesh's iso level: halfway between the least and the largest
        # density of a 33^3 probe of the same grid (the default level,
        # 10, need not cross the surface of a model 48 steps old)
        reqs[-1]['mesh_thres'] = float(np.mean(_density_probe(torch, np,
                                                              sess)))
        want = []
        for q in reqs:
            if q['render_type'] == 'mesh' or set(q) - rr.SERVE_KEYS:
                want.append(None)
                continue
            try:
                prep = sess.prepare(_request_ns(base_args, q))
                want.append(len(prep['data']['c2ws']))
            except ValueError:
                want.append('error')
        r_fd, w_fd = os.pipe()
        with os.fdopen(w_fd, 'w') as f:
            f.write(''.join(json.dumps(q) + '\n' for q in reqs)
                    + json.dumps({'cmd': 'quit'}) + '\n')
        replies = io.StringIO()
        t0 = time.perf_counter()
        with os.fdopen(r_fd, 'r') as fin, contextlib.redirect_stdout(log):
            rr.serve(base_args, stdin=fin, stdout=replies, session=sess)
        stdin_s = time.perf_counter() - t0
        lines = [json.loads(ln) for ln in replies.getvalue().splitlines()]
        ready, lines, bye = lines[0], lines[1:-1], lines[-1]
        if not ready.get('ready') or bye != {'ok': True, 'bye': True} \
                or len(lines) != len(reqs):
            raise AssertionError(f'stdin server: ready {ready}, {len(lines)} '
                                 f'replies for {len(reqs)}, last {bye}')
        recs = {r['runs'][0]: r for r in counted.records}
        for q, rep, n in zip(reqs, lines, want):
            name = q['runname']
            if 'nonsense' in q:
                if rep['ok'] or 'unknown request fields' not in rep['error']:
                    raise AssertionError(f'{name}: {rep}')
            elif q['render_type'] == 'correction':
                if rep != {'ok': False, 'error': 'ValueError: correction '
                           'mode needs a pose-opt checkpoint'}:
                    raise AssertionError(f'{name}: {rep}')
            elif not rep['ok'] or rep['runname'] != name:
                raise AssertionError(f'{name}: {rep}')
            elif q['render_type'] != 'mesh' and (
                    rep['n_frames'] != n or recs[name]['frames'] != n):
                raise AssertionError(f'{name}: {rep["n_frames"]} frames, '
                                     f'its builder gives {n}')
        print(f'render entry 2, stdin server on a pipe (session loaded in '
              f'{load_s:.3f} s): {len(reqs)} requests + quit in '
              f'{stdin_s:.3f} s, replies in order; correction and an '
              f'unknown field refused, the server answered after them',
              flush=True)
        for q, rep in zip(reqs, lines):
            r = recs.get(q['runname'])
            if r is None:
                continue
            print(f'  {q["runname"]}: {r["frames"]} frames, {r["rays"]} box '
                  f'rays, {r["buckets"]} buckets, K1 x{r["launches"]}; '
                  f'render {r["seconds"]:.3f} s, '
                  f'{r["rays"] / r["seconds"]:.1f} box-rays/s; reply '
                  f'seconds {rep["seconds"]} render_seconds '
                  f'{rep.get("render_seconds")}'
                  + (f'; eval {rep["eval"]}' if 'eval' in rep else ''),
                  flush=True)

        # ---- 3. the mesh at the CLI default resolution
        (m,) = counted.meshes
        verts, faces = load_ply(m['path'])
        if not (len(verts) == m['n_verts'] > 0
                and len(faces) == m['n_faces'] > 0):
            raise AssertionError(f'mesh: {m}, read back {len(verts)} verts '
                                 f'{len(faces)} faces')
        n_pts = (MESH_RES + 1) ** 3
        print(f'render entry 3, mesh (--mesh_res {MESH_RES}, --mesh_thres '
              f'{reqs[-1]["mesh_thres"]:.3f}, {n_pts} points in chunks of '
              f'{MESH_CHUNK}): density grid {m["density_seconds"]:.3f} s '
              f'({n_pts / m["density_seconds"]:.1f} points/s), request '
              f'{m["seconds"]:.3f} s, {m["n_verts"]} vertices, '
              f'{m["n_faces"]} faces, .ply read back, K1 x0 -> ok',
              flush=True)

        # ---- 4. the .tar round trip
        tar = os.path.join(exp, 'flagship.tar')
        export_reference_checkpoint(tar, sess.params, global_step=step,
                                    tau=sess.tau,
                                    pose_params=tree['pose_params'],
                                    rest_pose=sess.src.rest_pose)
        tar_args = rr.config_parser().parse_args(
            base + ['--runname', 'tar', '--ckptpath', tar])
        tar_sess = rr.RenderSession(tar_args, h5=skw.get('h5'))
        same_cfg = tar_sess.cfg == sess.cfg
        tau32 = (np.float32(tar_sess.tau), np.float32(sess.tau))
        tar_counted = _Counted(torch, np, tar_sess, chunk)
        q = _request_ns(base_args, {'render_type': 'bullet',
                                    'selected_idxs': [8], 'runname': 'rt'})
        with contextlib.redirect_stdout(log):
            a = sess.render_prepared([sess.prepare(q)])[0]
            b = tar_sess.render_prepared([tar_sess.prepare(q)])[0]
        bit_equal = all(np.array_equal(a[k], b[k]) for k in a)
        if same_cfg and tau32[0] == tau32[1]:
            if not bit_equal:
                raise AssertionError('.tar and native sessions build the '
                                     'same config and tau but render '
                                     'different bits')
        elif not np.allclose(a['rgbs'], b['rgbs'], atol=SLICE_ATOL,
                             rtol=SLICE_RTOL):
            raise AssertionError('.tar session off the native one')
        with contextlib.redirect_stdout(log):
            (rep,), _ = rr._process_batch(tar_sess, base_args, [json.dumps(
                {'render_type': 'correction', 'selected_idxs': [0],
                 'runname': 'tar_correction'})])
        if not rep['ok'] or rep['n_frames'] != 8:
            raise AssertionError(f'.tar correction: {rep}')
        print(f'render entry 4, .tar round trip (step {step}, tau '
              f'{sess.tau} native / {tar_sess.tau} read back, equal in '
              f'f32: {tau32[0] == tau32[1]}; configs equal: {same_cfg}): '
              f'bullet of image 8, {len(a["rgbs"])} frames, bit-equal '
              f'{bit_equal}; correction from the .tar poses: '
              f'{rep["n_frames"]} frames ok', flush=True)
        del a, b

        # ---- 5. fused against plain on the card (the CLI's request)
        q = _request_ns(base_args, {'render_type': 'val',
                                    'selected_idxs': [0, 8]})
        fr.LAUNCHES = 0
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            plain = rr.RenderSession.render_prepared(
                plain_sess, [plain_sess.prepare(q)])[0]
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = float(np.abs(plain['rgbs'] - cli_rgbs).max())
        off = int((~np.isclose(cli_rgbs, plain['rgbs'], atol=SLICE_ATOL,
                               rtol=SLICE_RTOL)).any(-1).sum())
        box_rays = _box_rays_buckets(plain['bboxes'], chunk)[0]
        if fr.LAUNCHES or off > FLIP_SHARE * box_rays:
            raise AssertionError(f'fused vs plain: {off} of {box_rays} box '
                                 f'pixels off, max_abs {err}; K1 '
                                 f'x{fr.LAUNCHES} on the plain branch')
        print(f'render entry 5, fused vs plain branch on the card (val, '
              f'images 0 and 8): rgbs max_abs {err:.3e}; {off} of '
              f'{box_rays} box pixels ({off / box_rays:.2e}) outside '
              f'{SLICE_ATOL} (limit {FLIP_SHARE:.0e}); plain render '
              f'{plain_s:.3f} s -> ok', flush=True)
        del plain

        # ---- 6. the TCP server: 4 client threads x 2 requests, each way
        tcp = {}
        for coalesce in (False, True):
            args = rr.config_parser().parse_args(
                base + ['--runname', 'tcp', '--no_save', '--server',
                        '--port', '0'] + (['--coalesce'] if coalesce else []))
            ready = queue.Queue()

            class Ready(io.StringIO):
                def flush(self):
                    ready.put(self.getvalue())

            n0 = len(counted.records)
            server = threading.Thread(target=rr.serve_tcp, args=(args,),
                                      kwargs=dict(port=0, stdout=Ready(),
                                                  session=sess),
                                      daemon=True)
            got, errors = {}, []

            def client(c):
                try:
                    with socket.create_connection(
                            ('127.0.0.1', port), timeout=SOCK_TIMEOUT) as s:
                        f = s.makefile('r', encoding='utf-8')
                        names = [f'tcp{int(coalesce)}_c{c}_{j}'
                                 for j in range(TCP_REQS)]
                        for j, name in enumerate(names):
                            idx = RENDER_PHASE_IDXS[(c * TCP_REQS + j)
                                                    % len(RENDER_PHASE_IDXS)]
                            s.sendall((json.dumps({
                                'render_type': 'val', 'selected_idxs': [idx],
                                'runname': name}) + '\n').encode())
                        got[c] = (names, [json.loads(f.readline())
                                          for _ in names])
                except Exception as e:      # raised below, in this thread
                    errors.append(f'client {c}: {type(e).__name__}: {e}')

            with contextlib.redirect_stdout(log):
                server.start()
                port = json.loads(ready.get(timeout=SOCK_TIMEOUT))['port']
                t0 = time.perf_counter()
                clients = [threading.Thread(target=client, args=(c,))
                           for c in range(TCP_CLIENTS)]
                for t in clients:
                    t.start()
                for t in clients:
                    t.join(SOCK_TIMEOUT)
                wall = time.perf_counter() - t0
                with socket.create_connection(('127.0.0.1', port),
                                              timeout=SOCK_TIMEOUT) as s:
                    s.sendall(b'{"cmd": "quit"}\n')
                    bye = json.loads(s.makefile('r').readline())
                server.join(SOCK_TIMEOUT)
            if errors or any(t.is_alive() for t in clients) \
                    or server.is_alive() or bye.get('bye') is not True:
                raise AssertionError(f'TCP: {errors}, bye {bye}')
            reps = []
            for c in range(TCP_CLIENTS):
                names, rs = got[c]
                if [r.get('runname') for r in rs] != names or not all(
                        r['ok'] and r['n_frames'] == 1 for r in rs):
                    raise AssertionError(f'TCP client {c}: {rs}')
                reps += rs
            recs_t = counted.records[n0:]
            frames = sum(r['frames'] for r in recs_t)
            rays = sum(r['rays'] for r in recs_t)
            tcp['coalesce' if coalesce else 'per_request'] = {
                'frames_per_s': frames / wall, 'box_rays_per_s': rays / wall,
                'wall_s': wall, 'dispatches': len(recs_t),
                'seconds': [r['seconds'] for r in reps],
                'render_seconds': [r.get('render_seconds') for r in reps],
                'batched': [r.get('batched', 1) for r in reps]}
            way = '--coalesce' if coalesce else 'per request'
            print(f'render entry 6, TCP {way}: {TCP_CLIENTS} clients x '
                  f'{TCP_REQS} requests, '
                  f'every reply on its own connection; {frames} frames in '
                  f'{wall:.3f} s = {frames / wall:.2f} frames/s, '
                  f'{rays / wall:.1f} box-rays/s, {len(recs_t)} render_path '
                  f'calls; seconds {[r["seconds"] for r in reps]}, '
                  f'render_seconds '
                  f'{[r.get("render_seconds") for r in reps]}, batched '
                  f'{[r.get("batched", 1) for r in reps]}', flush=True)

        # ---- one request under a device-only profiler
        q = _request_ns(base_args, {'render_type': 'val',
                                    'selected_idxs': [0], 'runname': 'prof'})
        prep = sess.prepare(q)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(log):
                sess.render_prepared([prep])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        idle = _profile_report(torch, prof, 'render entry request (val, '
                               'image 0)', dt)
        if not idle < 1.0:
            raise AssertionError('the profiler saw no device time')
    finally:
        os.chdir(cwd)
        log.close()

    served = [r for r in counted.records if len(r['runs']) == 1
              and r['runs'][0].startswith('srv')]
    one = sorted(tcp['per_request']['render_seconds'])
    k1 = cli_k1 + counted.launches() + tar_counted.launches()
    numbers = {
        'cli_s': cli_s, 'session_load_s': load_s, 'stdin_s': stdin_s,
        'requests': {r['runs'][0]: {k: r[k] for k in (
            'frames', 'rays', 'buckets', 'seconds')} for r in served},
        'one_frame_request_s_median': one[len(one) // 2],
        'box_rays_per_s': sum(r['rays'] for r in served)
        / sum(r['seconds'] for r in served),
        'mesh_density_s': m['density_seconds'], 'mesh_request_s':
        m['seconds'], 'mesh_points_per_s': n_pts / m['density_seconds'],
        'mesh_verts': m['n_verts'], 'mesh_faces': m['n_faces'],
        'tcp': tcp, 'idle_share': idle, 'profiled_ms': dt * 1e3,
        'k1_launches': k1, 'wall_s': time.perf_counter() - t_phase}
    print(f'render entry: K1 x{k1} (CLI {cli_k1}, session '
          f'{counted.launches()}, .tar session {tar_counted.launches()}); '
          f'phase wall {numbers["wall_s"]:.1f} s', flush=True)
    return k1, numbers


# the datasets phase: every other dataset type of the training entry point,
# on fixtures that rearrange the loop phase's synthetic grid (LOOP_KPS
# poses x LOOP_CAMS cameras at H x W) into each type's layout
# (anerf_torch/data/fixtures.py), under a git-ignored working directory
DATA_DIR = 'logs/chip_datasets'
DATA_UNROLL = 8
DATA_STEPS = (48, 56)           # run (a) ends at 48; resumed to 56
DATA_SHORT = 16                 # runs (a') and (b)
DATA_PROFILE = 16               # DeviceProfiler: the prints at 16 and 32
DATA_RAYS = 3072                # N_rand of the configs below
# run (b): (type, subject, config, argv added to it); ZJU and 3DHP have
# no config of their own and take h36m_prot2.txt's network
OTHER_TYPES = (
    ('perfcap', 'weipeng', 'perfcap/perfcap.txt', ()),
    ('mixamo', 'james', 'mixamo/mixamo.txt', ()),
    ('zju', '377', 'h36m/h36m_prot2.txt',
     ('--dataset_type', 'zju', '--subject', '377')),
    ('3dhp', 'S1', 'h36m/h36m_prot2.txt',
     ('--dataset_type', '3dhp', '--subject', 'S1')),
)


def _data_argv(config, expname, n_iters, *extra):
    """run_nerf's argv: the config as written, the flagship's overrides
    (the fused kernel, bf16), scanned dispatches of DATA_UNROLL steps with
    a print each, checkpoints, pose snapshots and a validation render at
    DATA_STEPS[0] (48)."""
    import os
    cfg = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       'configs', config)
    at = str(DATA_STEPS[0])
    return ['--config', cfg, '--basedir', 'logs', '--expname', expname,
            '--fused_kernel', '--compute_dtype', 'bfloat16',
            '--scan_unroll', str(DATA_UNROLL), '--i_print',
            str(DATA_UNROLL), '--i_weights', at, '--i_pose_weights', at,
            '--i_testset', at, '--n_iters', str(n_iters), *extra]


def _grid_dict(arrays):
    """The loop phase's H5Arrays as a synthetic_data dict (images
    unflattened), the base the type fixtures rearrange."""
    n, h, w = (int(x) for x in arrays['img_shape'][:3])
    out = {}
    for k in arrays:
        if k == 'img_shape':
            continue
        v = arrays[k]
        if k in ('imgs', 'masks', 'sampling_masks', 'bkgds'):
            v = v.reshape(v.shape[0], h, w, v.shape[-1])
        out[k] = float(v) if k == 'ext_scale' else v
    return out


def _check_3072(torch, np, cfg, params, src):
    """K1 and K2 (f32) on one bucket of the configs' 3072-ray batches at
    S = 64 (coarse) and 80 (fine), against their plain versions within
    K1_ATOL / K2's bounds; the launch geometry (points, 64-row tiles,
    K2's 2048-point chunks) and the device memory K2's call peaks at.
    These launches are comparisons: the runs' counts start after them."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render.raycaster import pack_fused_params

    packed = pack_fused_params(params, cfg)
    ncfg, R = cfg.nerf, DATA_RAYS
    pts, m_all, aux, _ = _bucket_inputs(torch, np, cfg, params, src, 30,
                                        R=R, culled=False)
    out = {}
    for S, net in ((64, 'coarse'), (80, 'fine')):
        P = R * S
        args = (ncfg, packed[net], pts[S], m_all, aux, S, 2000.0)
        got = fr.fused_encode_mlp_pts(*args)
        want = fr.fused_encode_mlp_pts_ref(*args)
        err = (got - want).abs().max().item()
        if not (torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
                and torch.isfinite(got).all()):
            raise AssertionError(f'K1 at {R} rays, S={S}: max_abs {err}')
        g = torch.as_tensor(np.random.default_rng(40 + S).normal(
            size=(R, S, 4)) * 0.1, dtype=torch.float32, device='cuda')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        k2 = fr.fused_bwd(*args, g)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        e = _k2_errors(torch, ncfg, packed[net], k2,
                       fr.fused_bwd_ref(*args, g), f'K2 {R} rays S={S}', R)
        out[S] = {'k1_max_abs': err, 'k2_max_abs': e[0],
                  'k2_worst_fro': e[3], 'k2_peak_bytes': peak}
        print(f'{R} rays S={S}: {P} points = {P // 64} tiles of 64 rows '
              f'(remainder {P % 64}), {-(-P // fr.BWD_CHUNK)} K2 chunks of '
              f'{fr.BWD_CHUNK} (remainder {P % fr.BWD_CHUNK}); K1 max_abs '
              f'{err:.3e} (tol {K1_ATOL}); K2 worst fro {e[3]:.3e} (tol '
              f'{K2_FRO}); K2 call peak {peak / 2 ** 30:.3f} GiB above '
              f'its inputs -> ok', flush=True)
        del got, want, k2, g
    return out


def datasets_phase(torch, np, data, cfg, params, src):
    """Every other dataset type through run_nerf.main on the card, in
    DATA_DIR, on fixtures of each type's layout made from the loop
    phase's grid (`data`, its H5Arrays, or the same grid made anew when
    h5py held it in a file). First K1 and K2 at the configs' 3072 rays
    against their plain versions (_check_3072). Then:
      (a) H36M, configs/h36m/h36m_prot2.txt as written with the
          flagship's overrides, through the catalog entry h36m / S9 with
          the fixture (2 sequences x 4 cameras x 32 instants) standing in
          for its file: 48 steps (checkpoint, pose snapshot, validation
          at 48; DeviceProfiler over dispatches 3-4), then resumed to 56;
      (a') H36M with --multiview, 16 steps, twice (one loader thread,
          seeded datasets): the two final states bit-equal;
      (b) MonoPerfCap, Mixamo (their configs), ZJU 377 and 3DHP S1
          (h36m_prot2.txt's network), 16 steps each;
      (c) one run_render val request from run (a)'s checkpoint 48
          through the render catalog's h36m / S9 entry.
    Gates: every logged value finite; H36M's loss falls; checkpoint 48
    restores run (a)'s state bit for bit; the loader's route (native
    super-batches for H36M and ZJU, per-item batches for the temporal
    types); K1 2 a step + 2 a validation bucket, K2 (f32) 2 a step,
    K2-bf16 none; the render's K1 2 a bucket. Prints per run the loop's
    rays/s over dispatches 2 onward, one dispatch's wait / upload /
    steps, the route and the launches. Returns (K1, K2) launches and the
    numbers."""
    import contextlib
    import os
    import shutil

    from anerf_torch import run_render as rr
    from anerf_torch.config import load_config
    from anerf_torch.data import fixtures as fx
    from anerf_torch.data import pipeline
    from anerf_torch.data.catalog import (DATASET_CATALOG,
                                          get_dataset_from_catalog)
    from anerf_torch.data.fixtures import synthetic_data
    from anerf_torch.data.h36m import H36MDataset
    from anerf_torch.data.mixamo import selected_path
    from anerf_torch.data.schema import h5_arrays
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.run_nerf import main as run_nerf_main
    from anerf_torch.train.checkpoint import restore_checkpoint
    from anerf_torch.utils.logging import DeviceProfiler

    t_phase = time.perf_counter()
    checks = _check_3072(torch, np, cfg, params, src)
    root = os.path.abspath(DATA_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    t0 = time.perf_counter()
    base = (_grid_dict(data) if data is not None else synthetic_data(
        n_kps=LOOP_KPS, n_cams=LOOP_CAMS, H=H, W=W))

    def arrays(kind, subject, d):
        return h5_arrays(d, path=os.path.join(
            root, DATASET_CATALOG[kind][subject]))
    n_inst = LOOP_KPS // 2
    fixtures = {'h36m': arrays('h36m', 'S9', fx.h36m_data(
        n_instants=n_inst, base=base))}
    fixtures['perfcap'] = arrays('perfcap', 'weipeng', fx.perfcap_data(
        n_frames=LOOP_KPS, base=base))
    mix, selected = fx.mixamo_data(n_frames=LOOP_KPS // 2, n_cams=2,
                                   base=base)
    fixtures['mixamo'] = arrays('mixamo', 'james', mix)
    os.makedirs(os.path.dirname(fixtures['mixamo'].path))
    np.save(selected_path(fixtures['mixamo'].path), selected)
    fixtures['zju'] = arrays('zju', '377', fx.zju_data(
        n_frames=LOOP_KPS // 2, n_cams=LOOP_CAMS, base=base))
    fixtures['3dhp'] = arrays('3dhp', 'S1', fx.mpi3dhp_data(
        n_frames=LOOP_KPS, base=base))
    del base, mix
    print('datasets: fixtures ' + ', '.join(
        f'{k} {len(v["imgs"])} images' for k, v in fixtures.items())
        + f' at {H}x{W}, made in {time.perf_counter() - t0:.1f} s from the '
        f'loop grid', flush=True)

    runs = {}

    def run(label, argv, ds, log=None):
        """run_nerf.main with the counts set to 0 just before it and read
        just after it; returns (ctx, records, counts)."""
        recs = []

        def log_fn(rec):
            recs.append(dict(rec, t=time.perf_counter()))
            if log is not None:
                log(rec)

        pipeline.SUPER_BATCHES = pipeline.ITEM_BATCHES = 0
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        cwd = os.getcwd()
        os.chdir(root)
        tee = _Tee(sys.stdout)
        try:
            with contextlib.redirect_stdout(tee):
                ctx = run_nerf_main(argv, dataset=ds, log_fn=log_fn,
                                    save_images=False)
            torch.cuda.synchronize()
        finally:
            os.chdir(cwd)
        counts = {'K1': fr.LAUNCHES, 'K2': fr.BWD_LAUNCHES,
                  'K2-bf16': fr.BWD_BF16_LAUNCHES,
                  'super': pipeline.SUPER_BATCHES,
                  'item': pipeline.ITEM_BATCHES}
        for r in recs:
            bad = [k for k, v in r.items() if not np.isfinite(v)]
            if bad:
                raise AssertionError(f'{label} step {r["step"]}: '
                                     f'non-finite {bad}')
        return ctx, recs, counts, ''.join(tee.parts)

    def report(label, ctx, recs, counts, n_steps, native, val_buckets=0,
               skip_s=0.0):
        """The run's gates on its launches and route, and its numbers."""
        k1_want = 2 * n_steps + 2 * val_buckets
        if (counts['K1'], counts['K2'], counts['K2-bf16']) != (
                k1_want, 2 * n_steps, 0):
            raise AssertionError(f'{label}: launches {counts}; want K1 '
                                 f'{k1_want}, K2 {2 * n_steps}, K2-bf16 0')
        dispatches = n_steps // DATA_UNROLL
        route = 'native' if native else 'per-item'
        if native and (counts['item'] or counts['super'] < dispatches) or \
                not native and (counts['super'] or counts['item']
                                < dispatches * DATA_UNROLL):
            raise AssertionError(f'{label}: loader {counts}, want the '
                                 f'{route} route')
        rays = ctx.args.N_rand * DATA_UNROLL
        last = recs[-1]
        num = {'rays_per_s': rays * (len(recs) - 1)
               / (last['t'] - recs[0]['t'] - skip_s),
               'dispatch_ms': last['dispatch_s'] * 1e3,
               'wait_ms': last['wait_s'] * 1e3,
               'upload_ms': last['upload_s'] * 1e3,
               'steps_ms': (last['dispatch_s'] - last['wait_s']
                            - last['upload_s']) * 1e3,
               'route': route, 'super_batches': counts['super'],
               'item_batches': counts['item'], 'k1': counts['K1'],
               'k2': counts['K2'], 'loss_first': recs[0]['total_loss'],
               'loss_last': last['total_loss']}
        print(f'{label}: rays/s {num["rays_per_s"]:.1f} (dispatches 2-'
              f'{len(recs)}, the loop clock); dispatch {last["step"]}: '
              f'{num["dispatch_ms"]:.1f} ms = wait {num["wait_ms"]:.2f} + '
              f'upload {num["upload_ms"]:.2f} + steps '
              f'{num["steps_ms"]:.1f}; loader {route} ({counts["super"]} '
              f'super-batches, {counts["item"]} per-item batches); loss '
              f'{num["loss_first"]:.5f} -> {num["loss_last"]:.5f}; K1 '
              f'x{counts["K1"]}, K2 x{counts["K2"]} -> ok', flush=True)
        return num

    # ---- (a) H36M at full width through the catalog, 48 then 56 steps
    n1, n2 = DATA_STEPS
    args = load_config(_data_argv('h36m/h36m_prot2.txt', 'h36m', n1))
    n_samples = args.N_rand // args.N_sample_images
    if (args.N_rand, args.netwidth) != (DATA_RAYS, 256):
        raise AssertionError('h36m_prot2.txt is not the full-width '
                             '3072-ray config')
    ds = get_dataset_from_catalog(args, n_samples, 'h36m', 'S9',
                                  source=fixtures['h36m'])
    prof = DeviceProfiler(os.path.join(root, 'logs', 'h36m'),
                          start_step=DATA_PROFILE, num_steps=DATA_PROFILE)
    window = {'hooks_s': 0.0}

    def profile_hooks(rec):
        # the profiler's start (the tracer's set-up) and its stop (the
        # trace written) run between two dispatches: their time is left
        # out of the loop's rate
        t = time.perf_counter()
        prof.maybe_stop(rec['step'])
        if prof.last is not None and 'dt' not in window:
            window['dt'] = t - window['t0']
        prof.maybe_start(rec['step'])
        if prof.active and 't0' not in window:
            window['t0'] = time.perf_counter()
        window['hooks_s'] += time.perf_counter() - t

    t0 = time.perf_counter()
    ctx, recs, counts, _ = run('datasets h36m', _data_argv(
        'h36m/h36m_prot2.txt', 'h36m', n1), ds, profile_hooks)
    wall = time.perf_counter() - t0
    exp = os.path.join(root, 'logs', 'h36m')
    if not recs[-1]['total_loss'] < recs[0]['total_loss']:
        raise AssertionError(f'H36M loss does not fall: '
                             f'{recs[0]["total_loss"]} -> '
                             f'{recs[-1]["total_loss"]}')
    back = restore_checkpoint(exp, ctx.state, step=n1)
    if not _same_state(torch, back, ctx.state):
        raise AssertionError(f'H36M checkpoint {n1} does not restore bit '
                             f'for bit')
    buckets = _val_buckets(ctx)
    num = report('datasets h36m run 1', ctx, recs, counts, n1, True,
                 buckets, window['hooks_s'])
    idle = _profile_report(torch, prof.last, f'datasets h36m dispatches '
                           f'{DATA_PROFILE + 1}-{2 * DATA_PROFILE} '
                           '(DeviceProfiler)', window['dt'])
    if not idle < 1.0 or not os.path.exists(prof.trace_path):
        raise AssertionError('DeviceProfiler saw no device time')
    num.update(idle_share=idle, profiled_ms=window['dt'] * 1e3,
               profiler_hooks_ms=window['hooks_s'] * 1e3,
               dispatches_ms=[r['dispatch_s'] * 1e3 for r in recs],
               trace=os.path.relpath(prof.trace_path, root),
               wall_s=wall, val_buckets=buckets, checks=checks)
    print(f'datasets h36m run 1: {n1} steps in {wall:.1f} s, checkpoint '
          f'{n1} restored bit for bit, validation at {n1} ({buckets} '
          f'buckets); DeviceProfiler trace {num["trace"]} (its start and '
          f'stop {window["hooks_s"] * 1e3:.1f} ms, left out of the rate); '
          f'dispatch ms ' + ' '.join(f'{r["dispatch_s"] * 1e3:.1f}'
                                     for r in recs), flush=True)
    ctx2, recs2, counts2, out = run('datasets h36m run 2', _data_argv(
        'h36m/h36m_prot2.txt', 'h36m', n2), ds)
    if f'resumed from step {n1}' not in out or ctx2.start_step != n1:
        raise AssertionError(f'H36M run 2 did not resume from {n1}')
    if (counts2['K1'], counts2['K2']) != (2 * (n2 - n1), 2 * (n2 - n1)):
        raise AssertionError(f'H36M run 2 launches {counts2}')
    k1, k2 = counts['K1'] + counts2['K1'], counts['K2'] + counts2['K2']
    runs['h36m'] = num
    del ctx, ctx2, back

    # ---- (a') H36M --multiview, twice: bit-equal
    states = []
    for i in range(2):
        mv = H36MDataset(fixtures['h36m'], N_samples=n_samples,
                         split='full', subject='S9', multiview=True, seed=0)
        ctx, recs, counts, _ = run(f'datasets h36m multiview {i + 1}',
                                   _data_argv('h36m/h36m_prot2.txt',
                                              f'h36m_mv{i}', DATA_SHORT,
                                              '--multiview',
                                              '--num_workers', '1'), mv)
        runs[f'h36m_multiview_{i + 1}'] = report(
            f'datasets h36m multiview run {i + 1}', ctx, recs, counts,
            DATA_SHORT, True)
        k1, k2 = k1 + counts['K1'], k2 + counts['K2']
        states.append(ctx.state)
        shape = tuple(ctx.state.pose_params['bones'].shape)
    if shape[:2] != (n_inst * 2, 23) or \
            'root_bones' not in states[0].pose_params:
        raise AssertionError(f'the shared pose table is {shape}')
    if not _same_state(torch, states[0], states[1]):
        raise AssertionError('two identical multiview runs differ')
    print(f'datasets h36m multiview: pose table bones {shape} (shared by '
          f'the 4 views of each instant), root_bones '
          f'{tuple(states[0].pose_params["root_bones"].shape)}; two runs '
          f'bit-equal (params, Adam states, pose accumulators) -> ok',
          flush=True)
    del states, ctx

    # ---- (b) the other types, 16 steps each
    for kind, subject, config, extra in OTHER_TYPES:
        argv = _data_argv(config, kind, DATA_SHORT, *extra)
        a = load_config(argv)
        ds_b = get_dataset_from_catalog(a, a.N_rand // a.N_sample_images,
                                        kind, subject,
                                        source=fixtures[kind])
        ctx, recs, counts, _ = run(f'datasets {kind}', argv, ds_b)
        runs[kind] = report(f'datasets {kind} ({subject}, '
                            f'{os.path.basename(config)})', ctx, recs,
                            counts, DATA_SHORT, kind == 'zju')
        k1, k2 = k1 + counts['K1'], k2 + counts['K2']
        del ctx, ds_b

    # ---- (c) a render request from run (a)'s checkpoint 48
    fr.LAUNCHES = 0
    cwd = os.getcwd()
    os.chdir(root)
    log = open(os.path.join(root, 'render.log'), 'w')
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(log):
            out = rr.main(['--nerf_args', os.path.join(
                'logs', 'h36m', 'args.txt'), '--ckptpath', os.path.join(
                'logs', 'h36m', 'checkpoints'), '--dataset', 'h36m',
                '--entry', 'S9', '--render_type', 'val', '--selected_idxs',
                '0', str(4 * n_inst), '--runname', 'h36m_val', '--no_save'],
                dataset=ds, h5=fixtures['h36m'])
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        log.close()
    rays, buckets = _box_rays_buckets(out['bboxes'], args.chunk)
    if not (np.isfinite(out['rgbs']).all() and out['accs'].min() >= 0.0
            and out['accs'].max() <= 1.0) or buckets == 0 \
            or fr.LAUNCHES != 2 * buckets or len(out['rgbs']) != 2:
        raise AssertionError(f'H36M render: {fr.LAUNCHES} K1 launches for '
                             f'{buckets} buckets')
    k1 += fr.LAUNCHES
    runs['render'] = {'seconds': render_s, 'rays': rays,
                      'buckets': buckets, 'k1': fr.LAUNCHES,
                      'shape': list(out['rgbs'].shape)}
    print(f'datasets h36m render (val, images 0 and {4 * n_inst}, from '
          f'checkpoint {n1}, session load included): {render_s:.3f} s, '
          f'{rays} box rays, {buckets} buckets, K1 x{fr.LAUNCHES}, images '
          f'{tuple(out["rgbs"].shape)} -> ok', flush=True)
    runs['wall_s'] = time.perf_counter() - t_phase
    print(f'datasets: K1 x{k1}, K2 x{k2}; phase wall '
          f'{runs["wall_s"]:.1f} s', flush=True)
    return k1, k2, runs


# phase 11, data parallel: two ranks on the one card (gloo: NCCL refuses
# two ranks on one device), spawned by parallel/mesh.py:run_ranks with a
# FileStore in a temporary directory. It checks that two ranks reproduce
# one; two ranks share the card's SMs, so it says nothing of scaling.
DP_RANKS = 2
DP_TIMEOUT = 300.0              # each spawn, and each collective in it
DP_DIR = 'logs/chip_dp'
DP_UNROLL, DP_STEPS = 8, 24     # 3 dispatches; the checkpoint at 24
# the two-rank step's all-reduced flat gradients against one rank's,
# relative in the Frobenius norm: each rank sums its block's points and
# the all-reduce sums the two blocks, where one device sums them all, so
# the f32 sums differ in their order, and then K2's weight gradients are
# rounded to bf16 (after the ranks' mean, as in JAX), where that order
# flips an occasional rounding. Read on an H100: 1.17e-5 (the f32 step)
# and 9.3e-7 (the culled fast-grads step); 1e-4 is 8.5x the larger.
# Rounding each rank's before the mean read 1.5e-3.
DP_GRAD_FRO = 1e-4
DP_LOSS_RTOL = 1e-6
DP_REQUESTS = ({'render_type': 'val', 'selected_idxs': [0, 8],
                'eval': True, 'runname': 'dp_a'},
               {'render_type': 'val', 'selected_idxs': [16], 'eval': True,
                'runname': 'dp_b'})


def _digest(np, tensors):
    import hashlib
    h = hashlib.sha1()
    for t in tensors:
        h.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return h.hexdigest()


def _dp_step(torch, np, mesh, **overrides):
    """One test-mode step of the train slice's setup (`overrides` of its
    config) on `mesh` (None: this process, one device), counts set to 0
    just before and read just after: its losses and stats, the flat
    gradients the two optimizers got, each fused_apply call's raw and
    render_rays' rgb_map / rgb0, the K1 / K2 / K2-bf16 launches and a
    digest of the new state."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render import raycaster as rc
    from anerf_torch.train import trainer as tr
    from anerf_torch.train.checkpoint import state_tree
    from anerf_torch.train.state import tree_leaves

    from anerf_torch.parallel import mesh as pm
    from anerf_torch.train.state import flatten_tree

    args, cfg, pose_cfg, rest, state, opt, popt, batch = _flagship_train(
        torch, np, **overrides)
    seen, raws, rgbs, reduced = {}, [], {}, []

    def spy(name, update):
        def call(g, s):
            seen[name] = g.detach().cpu().numpy()
            return update(g, s)
        return call

    def spy_apply(*a):
        raw = apply(*a)
        raws.append(raw.detach())
        return raw

    def spy_render(*a, **kw):
        out = render(*a, **kw)
        rgbs.update(rgb=out['rgb_map'].detach(), rgb0=out['rgb0'].detach())
        return out

    def spy_mean(who, mean):
        # the bytes each all-reduce carries: the step's own, and
        # fused_apply's backward's (which imports it when it runs)
        def call(m, flat):
            reduced.append((who, flat.numel() * flat.element_size()))
            return mean(m, flat)
        return call

    opt.update, popt.update = spy('nerf', opt.update), spy('pose',
                                                           popt.update)
    apply, render = rc.fused_apply, tr.render_rays
    means = tr.all_reduce_mean, pm.all_reduce_mean
    rc.fused_apply, tr.render_rays = spy_apply, spy_render
    tr.all_reduce_mean = spy_mean('step', means[0])
    pm.all_reduce_mean = spy_mean('fused', means[1])
    try:
        step = tr.make_train_step(args, cfg.test_mode(), pose_cfg, rest,
                                  opt, popt, mesh=mesh)
        torch.cuda.synchronize()
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        t0 = time.perf_counter()
        new, out = step(state, batch, None)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    finally:
        rc.fused_apply, tr.render_rays = apply, render
        tr.all_reduce_mean, pm.all_reduce_mean = means
    # what the step's own all-reduce should carry: every flat gradient
    # but the networks' leaves fused_apply's backward averaged, and the
    # logged values (all but the two gradient norms)
    n_net = sum(x.numel() for x in fr.mesh_averaged_leaves(cfg.nerf,
                                                           state.params))
    n_step = (flatten_tree(state.params).numel() - n_net
              + flatten_tree(state.pose_params).numel()
              + len(out['losses']) + len(out['stats']) - 2)
    return {'out': {g: {k: float(v) for k, v in out[g].items()}
                    for g in ('losses', 'stats')}, 'reduced': reduced,
            'step_bytes_want': 4 * n_step,
            'grads': seen, 'raw': [r.cpu().numpy() for r in raws],
            'rgb': {k: v.cpu().numpy() for k, v in rgbs.items()},
            'counts': counts, 'seconds': dt,
            'digest': _digest(np, [x for x in tree_leaves(state_tree(new))
                                   if isinstance(x, torch.Tensor)])}


def _dp_render(torch, np, mesh):
    """One 512 x 512 render_path request (pose 1 of the render slice's
    model, chunk 4096) on `mesh` (None: one device): its images, boxes,
    K1 launches and seconds."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.render import modes
    from anerf_torch.render.render_path import render_path

    args, cfg, params, src = _flagship_render(torch, np)
    data = modes.load_selected(src, np.array([1]))
    torch.cuda.synchronize()
    fr.LAUNCHES = 0
    t0 = time.perf_counter()
    out = render_path(params, cfg, data['c2ws'], (H, W, data['focals']),
                      data['kp3d'], data['skts'], data['bones'],
                      cam_idxs=data['cam_idxs'], tau=2000.0,
                      chunk=args.chunk, ext_scale=args.ext_scale,
                      white_bkgd=True, use_framecode_idx=args.opt_framecode,
                      mesh=mesh)
    torch.cuda.synchronize()
    return dict(out, launches=fr.LAUNCHES,
                seconds=time.perf_counter() - t0, chunk=args.chunk)


def _dp_rank_steps(mesh):
    """A rank of dp_phase (a) and (c): the f32 step, the culled
    fast-grads step and the render request."""
    import numpy as np
    import torch

    return {'f32': _dp_step(torch, np, mesh),
            'culled': _dp_step(torch, np, mesh, cull_ratio=0.125,
                               fast_grads=True),
            'render': _dp_render(torch, np, mesh)}


def _dp_loop_argv(n_iters):
    """The loop phase's argv in DP_DIR's experiment: dispatches of
    DP_UNROLL steps, a checkpoint and a validation render at DP_STEPS."""
    import os
    argv = _loop_argv(n_iters)
    argv[argv.index('--basedir') + 1] = os.path.abspath(DP_DIR)
    argv[argv.index('--expname') + 1] = 'flagship_dp'
    for flag, v in (('--i_weights', DP_STEPS), ('--i_pose_weights', DP_STEPS),
                    ('--i_testset', DP_STEPS)):
        argv[argv.index(flag) + 1] = str(v)
    return argv


def _dp_arrays(np, npy_dir):
    """The loop phase's grid as H5Arrays, read back from the .npy files
    dp_phase wrote (memory-mapped: every rank reads the same pages)."""
    import os
    from anerf_torch.data.schema import H5Arrays
    return H5Arrays({f[:-4]: np.load(os.path.join(npy_dir, f),
                                     mmap_mode='r')
                     for f in sorted(os.listdir(npy_dir))})


def _dp_dataset(np, args, source):
    from anerf_torch.data.surreal import SurrealDataset
    return SurrealDataset(source, N_samples=args.N_rand
                          // args.N_sample_images, split='train')


def _dp_rank_loop(mesh, argv, source):
    """A rank of dp_phase (b): run_nerf.main as a rank of `mesh`, counts
    set to 0 just before and read just after, with the digest of every
    super-batch it stepped on; then a digest of its final params and
    Adam states, all-gathered. Returns (super-batch digests, the ranks'
    state digests, rank 0's print records, launches, validation
    buckets, seconds)."""
    import hashlib
    import os

    import numpy as np
    import torch

    from anerf_torch.config import load_config
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.parallel.mesh import all_gather_rows
    from anerf_torch.run_nerf import main as run_nerf_main
    from anerf_torch.train import loop as loop_mod
    from anerf_torch.train.checkpoint import state_tree
    from anerf_torch.train.state import tree_leaves

    if isinstance(source, str) and os.path.isdir(source):
        source = _dp_arrays(np, source)
    ds = _dp_dataset(np, load_config(argv), source)
    digests, recs = [], []
    views = loop_mod.batch_views

    def spy(buf, layout):
        digests.append(hashlib.sha1(buf.cpu().numpy().tobytes()).hexdigest())
        return views(buf, layout)

    def log_fn(rec):
        recs.append(dict(rec, t=time.perf_counter()))
        print(f"dp loop step {rec['step']}: loss {rec['total_loss']:.5f} "
              f"psnr {rec['psnr']:.3f} rays/s {rec['rays_per_sec']:.1f}; "
              f"dispatch {rec['dispatch_s'] * 1e3:.1f} ms", flush=True)

    loop_mod.batch_views = spy
    try:
        torch.cuda.synchronize()
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        t0 = time.perf_counter()
        ctx = run_nerf_main(argv, mesh=mesh, dataset=ds, log_fn=log_fn,
                            save_images=False)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    finally:
        loop_mod.batch_views = views
    own = _digest(np, [x for x in tree_leaves(state_tree(ctx.state))
                       if isinstance(x, torch.Tensor)])
    got = all_gather_rows(mesh, torch.tensor(
        [list(bytes.fromhex(own))], dtype=torch.float32,
        device=mesh.device))
    states = [bytes(int(v) for v in row).hex() for row in got.tolist()]
    return (digests, states, recs, counts, _val_buckets(ctx), dt)


def _capture_stdout(fn):
    """fn()'s output on file descriptor 1, which spawned ranks share:
    (fn's result, the text)."""
    import os
    import tempfile
    sys.stdout.flush()
    saved = os.dup(1)
    with tempfile.TemporaryFile('w+') as f:
        os.dup2(f.fileno(), 1)
        try:
            result = fn()
        finally:
            sys.stdout.flush()
            os.dup2(saved, 1)
            os.close(saved)
        f.seek(0)
        return result, f.read()


def _dp_serve(torch, np, argv, skw, launch):
    """DP_REQUESTS on stdin through run_render.main --server (`launch`:
    the ranks' keywords, or none: one device); its reply lines."""
    import io
    from anerf_torch import run_render as rr
    stdin = sys.stdin
    sys.stdin = io.StringIO(''.join(json.dumps(r) + '\n'
                                    for r in DP_REQUESTS))
    try:
        _, text = _capture_stdout(lambda: rr.main(argv, **skw, **launch))
    finally:
        sys.stdin = stdin
    return [json.loads(ln) for ln in text.splitlines()
            if ln.startswith('{"ok"')]


def _check_dp_step(np, label, one, ranks):
    """(a)'s gates for one step: returns the worst numbers."""
    r0 = ranks[0]
    if any(r['digest'] != r0['digest'] for r in ranks):
        raise AssertionError(f'{label}: the ranks\' states differ after '
                             f'the step')
    worst = {'loss': 0.0, 'norm': 0.0}
    for grp in ('losses', 'stats'):
        for k, want in one['out'][grp].items():
            got = r0['out'][grp][k]
            if any(r['out'][grp][k] != got for r in ranks):
                raise AssertionError(f'{label}: {k} differs between ranks')
            floor = 1e-6 if k == 'MPJPC' else 1e-30
            rel = abs(got - want) / max(abs(want), floor)
            # the gradient norms move with the gradients
            kind = 'norm' if k.endswith('_norm') else 'loss'
            tol = DP_GRAD_FRO if kind == 'norm' else DP_LOSS_RTOL
            worst[kind] = max(worst[kind], rel)
            if rel > tol:
                raise AssertionError(f'{label}: {k} {got} against one '
                                     f'rank\'s {want} (rel {rel:.3e})')
    fro = {}
    if not np.abs(one['grads']['pose']).max() > 0:
        raise AssertionError(f'{label}: no pose gradient')
    for name in ('nerf', 'pose'):
        if not all(np.array_equal(r0['grads'][name], r['grads'][name])
                   for r in ranks):
            raise AssertionError(f'{label}: the ranks\' {name} gradients '
                                 f'differ')
        a = r0['grads'][name].astype(np.float64)
        b = one['grads'][name].astype(np.float64)
        fro[name] = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        if not fro[name] < DP_GRAD_FRO:
            raise AssertionError(f'{label}: {name} gradients {fro[name]:.3e}'
                                 f' from one rank\'s (tol {DP_GRAD_FRO})')
    # each ray's raw and rgb on its rank against one rank's, bit for bit
    if len(one['raw']) != len(r0['raw']):
        raise AssertionError(f'{label}: fused_apply calls')
    for i, raw in enumerate(one['raw']):
        if not np.array_equal(np.concatenate([r['raw'][i] for r in ranks]),
                              raw):
            raise AssertionError(f'{label}: raw of fused_apply call {i} '
                                 f'differs from one rank\'s')
    for k in ('rgb', 'rgb0'):
        if not np.array_equal(np.concatenate([r['rgb'][k] for r in ranks]),
                              one['rgb'][k]):
            raise AssertionError(f'{label}: {k} differs from one rank\'s')
    for r in ranks:
        if r['counts'] != one['counts']:
            raise AssertionError(f'{label}: a rank launched (K1, K2, '
                                 f'K2-bf16) {r["counts"]}, one rank '
                                 f'{one["counts"]}')
    # one all-reduce of the step's own, which no weight gradient that
    # fused_apply averaged crosses again
    own = [b for who, b in r0['reduced'] if who == 'step']
    fused = [b for who, b in r0['reduced'] if who == 'fused']
    if own != [r0['step_bytes_want']] or len(fused) != 2 or any(
            r['reduced'] != r0['reduced'] for r in ranks):
        raise AssertionError(f'{label}: all-reduces {r0["reduced"]}; want '
                             f'the step\'s one of {r0["step_bytes_want"]} '
                             f'bytes and two of fused_apply')
    print(f'dp (a) {label} step: all-reduced bytes a rank, the step\'s '
          f'{own[0]} and fused_apply\'s {fused} ({own[0] + sum(fused)} in '
          f'all)', flush=True)
    print(f'dp (a) {label} step, {len(ranks)} ranks x '
          f'{len(r0["rgb"]["rgb"])} rays '
          f'against one rank: losses and stats within {worst["loss"]:.3e} '
          f'(tol {DP_LOSS_RTOL}), gradient norms {worst["norm"]:.3e}; flat '
          f'gradients fro nerf '
          f'{fro["nerf"]:.3e} pose {fro["pose"]:.3e} (tol {DP_GRAD_FRO}); '
          f'raw ({len(one["raw"])} fused_apply calls), rgb_map, rgb0 bit-'
          f'equal; the ranks\' states bit-equal; (K1, K2, K2-bf16) a rank '
          f'{r0["counts"]} = one rank\'s -> ok', flush=True)
    return {'loss_rel': worst['loss'], 'norm_rel': worst['norm'],
            'grad_fro': fro['nerf'],
            'pose_grad_fro': fro['pose'], 'counts': list(r0['counts']),
            'allreduce_bytes': {'step': own[0], 'fused': fused}}


def dp_phase(torch, np, data, loop, devices=None, backend='gloo'):
    """Data parallel (phase 11): one rank a device of `devices` (default
    DP_RANKS ranks on the one card, gloo: a correctness check; --cards
    N: one rank a card, NCCL), spawned by run_ranks (FileStore in a
    temporary directory). (a) the train slice's step in test mode
    (N_rand 2048, split over the ranks) and the culled fast-grads step,
    each against one rank
    on the same batch: losses and stats within DP_LOSS_RTOL, the
    all-reduced flat gradients within DP_GRAD_FRO (Frobenius), every
    fused_apply call's raw and render_rays' rgb_map / rgb0 bit-equal,
    the ranks' states bit-equal, each rank's K1 / K2 launches the one-rank
    pattern. (c) one 512 x 512 render_path(mesh=) request at chunk 4096
    bit-equal to one rank's, 2 K1 launches a rank a bucket. (b)
    run_nerf.main on the loop phase's grid (`data`, its H5Arrays, or
    None: the h5 file of LOOP_DIR), 3 dispatches of 8, the checkpoint
    and a validation render at 24: every rank on the same super-batches,
    their params and Adam states bit-equal (a digest all-gathered),
    losses falling, the checkpoint written once and restored bit for bit
    by a one-rank setup; the loop's rays/s beside one rank's on the same
    argv in this process, and the loop phase's (`loop`, or None),
    reported, not gated. (d) DP_REQUESTS through run_render.main
    --server on the ranks (stdin relayed to rank 0) against one device:
    one ready line and one
    reply a request, from rank 0 alone, the --eval metrics equal (the
    renders bit-equal). Returns (K1, K2, K2-bf16 launches of the ranks'
    main-path runs, the phase's numbers)."""
    import os
    import shutil
    import tempfile

    from anerf_torch.config import load_config
    from anerf_torch.parallel.mesh import run_ranks
    from anerf_torch.render.render_path import n_buckets_for
    from anerf_torch.run_nerf import main as run_nerf_main
    from anerf_torch.train.checkpoint import state_tree
    from anerf_torch.train.loop import setup
    from anerf_torch.train.state import tree_leaves

    t_phase = time.perf_counter()
    devices = devices or ['cuda:0'] * DP_RANKS
    n = len(devices)
    numbers = {'ranks': n, 'devices': devices, 'backend': backend}
    with tempfile.TemporaryDirectory() as store:
        launch = dict(devices=devices, backend=backend, init=store)
        # ---- (a) and (c): one spawn
        one = {'f32': _dp_step(torch, np, None),
               'culled': _dp_step(torch, np, None, cull_ratio=0.125,
                                  fast_grads=True),
               'render': _dp_render(torch, np, None)}
        t0 = time.perf_counter()
        two = run_ranks(_dp_rank_steps, n, timeout=DP_TIMEOUT,
                        deadline=DP_TIMEOUT, **launch)
        numbers['spawn_steps_s'] = time.perf_counter() - t0
        numbers['f32'] = _check_dp_step(np, 'f32', one['f32'],
                                        [r['f32'] for r in two])
        numbers['culled'] = _check_dp_step(np, 'culled fast-grads',
                                           one['culled'],
                                           [r['culled'] for r in two])
        want = one['render']
        tl, br = want['bboxes'][0]
        box = int((br[0] - tl[0]) * (br[1] - tl[1]))
        buckets = n_buckets_for(box, want['chunk'])
        for r in two:
            got = r['render']
            for k in ('rgbs', 'disps', 'accs', 'bboxes'):
                if not np.array_equal(got[k], want[k]):
                    raise AssertionError(f'dp (c): {k} differs from one '
                                         f'rank\'s render')
            if got['launches'] != 2 * buckets:
                raise AssertionError(f'dp (c): a rank launched K1 '
                                     f'{got["launches"]} times for '
                                     f'{buckets} buckets')
        if want['accs'].max() < 0.01:
            raise AssertionError('dp (c): the body does not show')
        numbers['render'] = {
            'box_rays': box, 'buckets': buckets,
            'one_rank_s': want['seconds'],
            'ranks_s': max(r['render']['seconds'] for r in two)}
        print(f'dp (c) render_path(mesh=) 512x512, {box} box rays, '
              f'{buckets} buckets of 4096 ({buckets * 4096 // n} rays a '
              f'rank): rgbs, disps, accs bit-equal to one rank\'s; K1 x'
              f'{two[0]["render"]["launches"]} a rank; one rank '
              f'{want["seconds"]:.3f} s, {n} ranks '
              f'{numbers["render"]["ranks_s"]:.3f} s -> ok', flush=True)

        # ---- (b) the training loop through run_nerf.main
        root = os.path.abspath(DP_DIR)
        shutil.rmtree(root, ignore_errors=True)
        os.makedirs(root)
        if data is not None:
            source = os.path.join(root, 'grid')
            os.makedirs(source)
            for k, v in data.items():
                np.save(os.path.join(source, f'{k}.npy'), dict.__getitem__(
                    data, k))
        else:
            source = os.path.join(os.path.abspath(LOOP_DIR), 'data',
                                  'surreal', 'surreal_train_h5py.h5')
        argv = _dp_loop_argv(DP_STEPS)
        t0 = time.perf_counter()
        loop_out = run_ranks(_dp_rank_loop, n, timeout=DP_TIMEOUT,
                             deadline=DP_TIMEOUT, args=(argv, source),
                             **launch)
        numbers['spawn_loop_s'] = time.perf_counter() - t0
        d0, states, recs, c0, val_b, loop_s = loop_out[0]
        if any(r[0] != d0 for r in loop_out) or \
                len(d0) != DP_STEPS // DP_UNROLL or len(set(d0)) != len(d0):
            raise AssertionError(f'dp (b): the ranks\' super-batches '
                                 f'{[r[0] for r in loop_out]}')
        if len(set(states)) != 1:
            raise AssertionError(f'dp (b): the ranks\' states differ: '
                                 f'{states}')
        if [r['step'] for r in recs] != list(range(DP_UNROLL, DP_STEPS + 1,
                                                   DP_UNROLL)):
            raise AssertionError(f'dp (b): prints at '
                                 f'{[r["step"] for r in recs]}')
        if not recs[-1]['total_loss'] < recs[0]['total_loss']:
            raise AssertionError(f'dp (b): the loss does not fall: '
                                 f'{[r["total_loss"] for r in recs]}')
        want_counts = (2 * DP_STEPS + 2 * val_b, 2 * DP_STEPS, 0)
        for c in [r[3] for r in loop_out]:
            if tuple(c) != want_counts:
                raise AssertionError(f'dp (b): a rank launched (K1, K2, '
                                     f'K2-bf16) {c}, want {want_counts}')
        exp = os.path.join(root, 'flagship_dp')
        ckpts = sorted(os.listdir(os.path.join(exp, 'checkpoints')))
        if ckpts != [str(DP_STEPS)]:
            raise AssertionError(f'dp (b): checkpoints {ckpts}')
        args = load_config(argv)
        src = _dp_arrays(np, source) if data is not None else source
        ctx = setup(args, _dp_dataset(np, args, src), device='cuda')
        restored = _digest(np, [x for x in tree_leaves(state_tree(
            ctx.state)) if isinstance(x, torch.Tensor)])
        if ctx.start_step != DP_STEPS or restored != states[0]:
            raise AssertionError('dp (b): checkpoint 24 does not restore '
                                 'the ranks\' state bit for bit into one '
                                 'rank\'s setup')
        rays = args.N_rand * DP_UNROLL
        rate = rays * (len(recs) - 1) / (recs[-1]['t'] - recs[0]['t'])
        # one rank on the same argv, in this process, for the rate
        one_recs = []
        one_argv = list(argv)
        one_argv[one_argv.index('--expname') + 1] = 'flagship_one'
        run_nerf_main(one_argv, devices=['cuda:0'],
                      dataset=_dp_dataset(np, args, src),
                      log_fn=lambda r: one_recs.append(
                          dict(r, t=time.perf_counter())),
                      save_images=False)
        torch.cuda.synchronize()
        one_rate = rays * (len(one_recs) - 1) / (one_recs[-1]['t']
                                                 - one_recs[0]['t'])
        numbers['loop'] = {
            'rays_per_s': rate, 'one_rank_rays_per_s': one_rate,
            'loop_phase_rays_per_s': None if loop is None
            else loop['rays_per_s'],
            'dispatch_ms': [r['dispatch_s'] * 1e3 for r in recs],
            'one_rank_dispatch_ms': [r['dispatch_s'] * 1e3
                                     for r in one_recs],
            'loss': [r['total_loss'] for r in recs], 'seconds': loop_s,
            'val_buckets': val_b}
        print(f'dp (b) run_nerf.main, {n} ranks x {args.N_rand // n} '
              f'rays, {DP_STEPS} steps in dispatches of {DP_UNROLL}: the '
              f'same {len(d0)} super-batches on every rank; states '
              f'bit-equal (all-gathered digest); loss '
              f'{recs[0]["total_loss"]:.5f} -> {recs[-1]["total_loss"]:.5f};'
              f' checkpoint {ckpts} written once, restored bit for bit by '
              f'one rank\'s setup; (K1, K2) a rank {tuple(c0)}; loop '
              f'{rate:.1f} rays/s (dispatches 2-3) against one rank\'s '
              f'{one_rate:.1f} on the same argv (the loop phase: '
              f'{numbers["loop"]["loop_phase_rays_per_s"]}); not gated '
              f'-> ok', flush=True)

        # ---- (d) the stdin server on 2 ranks
        nerf = os.path.join(exp, 'args.txt')
        # the checkpoint's density is near 0 where the requests look:
        # lift both heads' bias by 2 (as the render entry phase does)
        ckpt = os.path.join(exp, 'checkpoints', str(DP_STEPS), 'state.pt')
        tree = torch.load(ckpt, weights_only=True)
        for net in ('coarse', 'fine'):
            tree['params'][net]['alpha_linear']['b'] += 2.0
        torch.save(tree, ckpt)
        sargv = ['--nerf_args', nerf, '--ckptpath',
                 os.path.join(exp, 'checkpoints'), '--dataset', 'surreal',
                 '--entry', 'female', '--outputdir',
                 os.path.join(root, 'render_output'), '--no_save',
                 '--server', '--runname', 'dp']
        skw = {'dataset': _dp_dataset(np, args, src)}
        if data is not None:
            skw['h5'] = src
        t0 = time.perf_counter()
        single = _dp_serve(torch, np, sargv, skw, {'devices': ['cuda:0']})
        numbers['serve_one_s'] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ranked = _dp_serve(torch, np, sargv, skw, launch)
        numbers['serve_ranks_s'] = time.perf_counter() - t0
        if [r.get('ready', False) for r in ranked] != [True, False, False]:
            raise AssertionError(f'dp (d): replies {ranked}')
        for a, b in zip(single[1:], ranked[1:]):
            if not (a['ok'] and b['ok'] and a['eval'] == b['eval']
                    and a['n_frames'] == b['n_frames']):
                raise AssertionError(f'dp (d): {b} against one device\'s '
                                     f'{a}')
        print(f'dp (d) run_render.main --server on {n} ranks: one ready '
              f'line and {len(ranked) - 1} replies, from rank 0 alone, '
              f'--eval metrics equal to one device\'s '
              f'({ranked[1]["eval"]["psnr"]:.4f} dB); one device '
              f'{numbers["serve_one_s"]:.1f} s, {n} ranks '
              f'{numbers["serve_ranks_s"]:.1f} s with their start -> ok',
              flush=True)
    numbers['wall_s'] = time.perf_counter() - t_phase
    print(f'phase 11 (data parallel, {n} ranks, {backend}) took '
          f'{numbers["wall_s"]:.1f} s', flush=True)
    k1 = sum(r[k]['counts'][0] for r in two for k in ('f32', 'culled')) \
        + sum(r['render']['launches'] for r in two) \
        + sum(r[3][0] for r in loop_out)
    k2 = sum(r['f32']['counts'][1] for r in two) \
        + sum(r[3][1] for r in loop_out)
    k2b = sum(r['culled']['counts'][2] for r in two)
    return k1, k2, k2b, numbers


QAB_DIR = 'logs/chip_quality'
# each cell's steps: 20 dispatches of the protocol's scan_unroll 10, at
# the protocol's N_rand 2048; enough for the loss to fall and the poses to
# move (10 of the refine recipe's 20-step pose intervals), short enough
# that the five cells stay near 120 s (the sweep's 4000 steps are the
# CLI's own runs)
N_QAB_STEPS = 200
QAB_PRINT = 10                  # metrics.jsonl's losses every 10 steps
QAB_FUSED = ('control', 'culled', 'refine', 'refine_culled')
# the fused cells whose steps run K2's f32 flavour; the others set
# fast_grads and run its bf16 flavour
QAB_F32 = ('control', 'refine')
# the loss gate: the mean of the last QAB_LOSS_TAIL logged total losses
# below the first one logged (step 10), with the protocol's
# raw_noise_std 1.0 making single records noisy
QAB_LOSS_TAIL = 3
# the poses moved: the refined MPJPE (unrounded) at least this far from
# the perturbed start (mm); 10 Adam pose updates at lrate 5e-4 move it
# by tenths of a mm, a frozen pose table by exactly 0
QAB_POSE_MOVED_MM = 1e-3


def _qab_host_init_mm(np):
    """init_mpjpe_mm of the blobs fixture's perturbed copy at seed 0,
    computed here on the host from the fixture's tables and the
    reference's perturbation, apart from the tool's own route."""
    from anerf_torch.data.fixtures import synthetic_data
    from anerf_torch.pose.pose_opt import perturb_poses
    from anerf_torch.utils.metrics import mpjpe
    data = synthetic_data(n_kps=8, n_cams=3, H=64, W=64, style='blobs')
    f32 = {k: np.asarray(data[k], np.float32)
           for k in ('bones', 'kp3d', 'rest_pose', 'gt_kp3d')}
    _, _, kp = perturb_poses(f32['bones'], f32['kp3d'], f32['rest_pose'],
                             noise_degree=5.0, noise_pelvis_mm=20.0,
                             ext_scale=1e-3,
                             rng=np.random.default_rng(10_000))
    return mpjpe(kp.astype(np.float32), f32['gt_kp3d']) / 1e-3, \
        f32['gt_kp3d']


def quality_phase(torch, np):
    """Phase 12: anerf_torch/tools/quality_ab.py on the card, N_QAB_STEPS
    steps a cell on the blobs fixture at seed 0: the fused cells of
    QAB_FUSED and the plain control, one call each with the launch counts
    set to 0 just before and read after its train() and after its
    validation; then the CLI in a subprocess on the same state. Returns
    (K1, K2 f32, K2 bf16 launches, the phase's numbers)."""
    import os
    import re
    import shutil

    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.tools import quality_ab as tq
    from anerf_torch.train import loop as loop_mod
    from anerf_torch.utils.device import settings_in_force

    settings = settings_in_force()
    print(f'quality: card settings {json.dumps(settings)}', flush=True)
    if any(settings.values()):
        raise AssertionError(f'quality: the card settings are not in '
                             f'force: {settings}')
    shutil.rmtree(QAB_DIR, ignore_errors=True)
    os.makedirs(QAB_DIR)
    work = os.path.abspath(QAB_DIR)
    state = os.path.join(work, 'rows.jsonl')
    kw = dict(steps=N_QAB_STEPS, styles=['blobs'], seeds=[0],
              cull_ratio=0.125, state_path=state, device='cuda',
              workdir=work, fixed={'i_print': QAB_PRINT})
    host_init, gt_kp = _qab_host_init_mm(np)
    train, seen = loop_mod.train, {}

    def counted(*a, **k):
        ctx = train(*a, **k)
        torch.cuda.synchronize()
        seen['counts'] = (fr.LAUNCHES, fr.BWD_LAUNCHES,
                          fr.BWD_BF16_LAUNCHES)
        seen['ctx'] = ctx
        return ctx

    cells, totals = {}, [0, 0, 0]
    loop_mod.train = counted
    try:
        for fused, label in ([(True, v) for v in QAB_FUSED]
                             + [(False, 'control')]):
            torch.cuda.synchronize()
            fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
            t0 = time.perf_counter()
            v = tq.quality_ab(**kw, variants=(label,), fused_kernel=fused)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            after = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
            row, = v['rows']
            ctx, steps = seen.pop('ctx'), seen.pop('counts')
            name = row['config']
            n = 2 * N_QAB_STEPS
            if fused:
                f32 = label in QAB_F32
                want = (n, n if f32 else 0, 0 if f32 else n)
                val = 2 * _val_buckets(ctx)
            else:
                want, val = (0, 0, 0), 0
            if steps != want or after != (want[0] + val,) + want[1:]:
                raise AssertionError(
                    f'quality {name}: launches (K1, K2 f32, K2 bf16) '
                    f'{steps} in the steps, {after} with the validation; '
                    f'expected {want} and K1 +{val}')
            for k in ('psnr', 'fg_psnr', 'fg_ssim', 'rays_per_s'):
                if not math.isfinite(row[k]):
                    raise AssertionError(f'quality {name}: {k} {row[k]}')
            log = os.path.join(work, 'torch_qab_blobs_64', re.sub(
                r'\W+', '_', f'torch_qab_blobs_0_{name}'), 'metrics.jsonl')
            with open(log) as f:
                loss = [json.loads(line)['total_loss'] for line in f]
            tail = sum(loss[-QAB_LOSS_TAIL:]) / QAB_LOSS_TAIL
            if len(loss) != N_QAB_STEPS // QAB_PRINT or not all(
                    map(math.isfinite, loss)) or not tail < loss[0]:
                raise AssertionError(f'quality {name}: logged losses '
                                     f'{loss} do not fall')
            cell = dict(psnr=row['psnr'], fg_psnr=row['fg_psnr'],
                        fg_ssim=row['fg_ssim'], rays_per_s=row['rays_per_s'],
                        cell_s=dt, loss_first=loss[0], loss_tail=tail,
                        launches=list(after))
            if label in tq.AB_PERTURBED:
                moved = tq._refined_pose_metrics(ctx, gt_kp, digits=None)
                if row['init_mpjpe_mm'] != round(host_init, 1):
                    raise AssertionError(
                        f'quality {name}: init_mpjpe_mm '
                        f'{row["init_mpjpe_mm"]} against the host\'s '
                        f'{host_init:.4f}')
                if not abs(moved['mpjpe_mm'] - host_init) \
                        >= QAB_POSE_MOVED_MM:
                    raise AssertionError(
                        f'quality {name}: the poses did not move (MPJPE '
                        f'{moved["mpjpe_mm"]:.4f} mm from {host_init:.4f})')
                cell.update(init_mpjpe_mm=host_init,
                            mpjpe_mm=moved['mpjpe_mm'],
                            pa_mpjpe_mm=moved['pa_mpjpe_mm'])
            del ctx
            cells[name] = cell
            totals = [a + b for a, b in zip(totals, after)]
            print(f'quality {name}: {dt:.1f} s a cell of {N_QAB_STEPS} '
                  f'steps, {row["rays_per_s"]:.1f} rays/s, psnr '
                  f'{row["psnr"]:.2f} fg_psnr {row["fg_psnr"]:.2f} fg_ssim '
                  f'{row["fg_ssim"]:.3f}, loss {loss[0]:.4f} -> {tail:.4f}; '
                  f'launches {list(after)}'
                  + (f'; MPJPE {host_init:.2f} -> '
                     f'{cell["mpjpe_mm"]:.2f} mm' if 'mpjpe_mm' in cell
                     else ''), flush=True)

        # every cell is in the state now: the verdict in this process,
        # then the CLI on the same state trains nothing and prints it
        torch.cuda.synchronize()
        fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
        with open(state) as f:
            n_rows = len(f.readlines())
        verdict = tq.quality_ab(**kw, variants=QAB_FUSED, fused_kernel=True)
        if seen or fr.LAUNCHES or fr.BWD_LAUNCHES or fr.BWD_BF16_LAUNCHES:
            raise AssertionError('quality: the resumed call trained a cell')
    finally:
        loop_mod.train = train
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, '-m', 'anerf_torch.tools.quality_ab',
         '--fused_kernel', '--ab_steps', str(N_QAB_STEPS), '--ab_styles',
         'blobs', '--ab_seeds', '0', '--ab_cull', '0.125', '--ab_variants',
         *QAB_FUSED, '--ab_state', state, '--ab_dir', work],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    out = cli.stdout.strip().splitlines()
    with open(state) as f:
        rows_after = len(f.readlines())
    if cli.returncode != 0 or not out or out[-1] != json.dumps(verdict):
        raise AssertionError(f'quality: the CLI exited {cli.returncode} or '
                             f'printed another verdict:\n{cli.stdout[-2000:]}'
                             f'\n{cli.stderr[-2000:]}')
    if rows_after != n_rows or any(line.startswith('cell ') for line in out):
        raise AssertionError('quality: the CLI trained a cell on a state '
                             'that holds every one')
    fused_minus_plain = cells['control+fused']['psnr'] \
        - cells['control']['psnr']
    print(f'quality: the CLI resumed {len(QAB_FUSED)} cells in {cli_s:.1f} '
          f's and printed the same verdict; fused - plain control '
          f'{fused_minus_plain:+.2f} dB, culled+fused - control+fused '
          f'{verdict["deltas"]["culled+fused"]["median"]:+.2f} dB, '
          f'refine_culled+fused - refine+fused '
          f'{verdict["deltas"]["refine_culled+fused"]["median"]:+.2f} dB '
          f'(printed, not gated)', flush=True)
    return (*totals, dict(cells=cells, cli_s=cli_s,
                          fused_minus_plain_db=fused_minus_plain,
                          deltas=verdict['deltas'], settings=settings))


# phase 13, the throughput bench (anerf_torch/tools/bench.py) at small
# counts. BENCH_KEYS: every key of bench.py's throughput line
# (bench.py:815-933), which the port's line must hold under the same names
BENCH_KEYS = (
    'metric', 'value', 'unit', 'vs_baseline',
    'protocol_default_xla', 'protocol_default_xla_spread',
    'protocol_default_fused', 'protocol_default_fused_spread',
    'protocol_default', 'headline_xla', 'headline_xla_spread',
    'headline_config', 'best', 'headline_fused', 'headline_fused_spread',
    'render_box_rays_per_sec', 'render_box_rays_spread',
    'e2e_inloop_rays_per_sec', 'e2e_inloop_window_steps',
    'e2e_inloop_per_1k_rates', 'scaling', 'baseline_rays_per_sec',
    'baseline_band_rays_per_sec', 'vs_baseline_low', 'vs_baseline_high',
    'vs_baseline_headline', 'vs_baseline_headline_low',
    'vs_baseline_headline_high')
BENCH_UNROLL = 4
BENCH_MEASURE = dict(n_warmup=1, n_repeats=2, n_dispatch=2)
BENCH_RENDER = dict(n_views=2, res=256, n_repeats=1)
BENCH_E2E = dict(steps=600, warm_steps=200)


def bench_phase(torch, np):
    """The bench's throughput line in this process (tools/bench.py:
    throughput) at BENCH_UNROLL steps a dispatch and BENCH_MEASURE's
    dispatches, for all four of its builds; then measure_render at
    BENCH_RENDER, measure_e2e at BENCH_E2E and scaling_table(1) on the
    card. The counts are set to 0 just before each build and read just
    after its measure (bench.py's `launches`). Gates: every rate finite
    and > 0, no *_error field; the fused builds launch K1 and K2 f32 two
    times a step and no K2 bf16, the plain builds none; the line holds
    every key of BENCH_KEYS and only the port's own beside them; the
    scaling table is the card's with one row. Returns (K1 launches, K2
    launches, the line)."""
    from anerf_torch.tools import bench as tb

    t0 = time.perf_counter()
    line = tb.throughput(device='cuda', unroll=BENCH_UNROLL,
                         measure_kw=BENCH_MEASURE, render_kw=BENCH_RENDER,
                         e2e_kw=BENCH_E2E,
                         scaling=lambda: tb.scaling_table(1))
    dt = time.perf_counter() - t0
    print(f'bench: {dt:.1f} s; line: {json.dumps(line)}', flush=True)
    if tb.errors(line):
        raise AssertionError(f'bench: {tb.errors(line)}: '
                             f'{[line[k] for k in tb.errors(line)]}')
    bad = tb.bad_rates(line)
    if bad:
        raise AssertionError(f'bench: rates not finite and > 0: {bad}')
    missing = set(BENCH_KEYS) - set(line)
    extra = set(line) - set(BENCH_KEYS) - tb.PORT_KEYS
    if missing or extra:
        raise AssertionError(f'bench: keys missing {sorted(missing)}, '
                             f'unknown {sorted(extra)}')
    steps = (BENCH_MEASURE['n_warmup'] + BENCH_MEASURE['n_repeats']
             * BENCH_MEASURE['n_dispatch']) * BENCH_UNROLL
    k1 = k2 = 0
    for build, n in line['launches'].items():
        fused = build.endswith('_fused')
        want = ({'K1': 2 * steps, 'K2_f32': 2 * steps, 'K2_bf16': 0}
                if fused else {'K1': 0, 'K2_f32': 0, 'K2_bf16': 0})
        if n != want:
            raise AssertionError(f'bench: {build} launched {n}, want '
                                 f'{want}')
        k1, k2 = k1 + n['K1'], k2 + n['K2_f32']
    if len(line['launches']) != 4:
        raise AssertionError(f'bench: builds {sorted(line["launches"])}')
    table = line['scaling']
    if table['platform'] != 'gpu' or table['sizes'] != [1]:
        raise AssertionError(f'bench: scaling table {table}')
    print(f'bench: fused builds K1 x{k1}, K2 f32 x{k2} over {steps} steps '
          f'each; protocol plain {line["protocol_default_xla"]} / fused '
          f'{line["protocol_default_fused"]}, headline plain '
          f'{line["headline_xla"]} / fused {line["headline_fused"]}, '
          f'render {line["render_box_rays_per_sec"]}, in-loop '
          f'{line["e2e_inloop_rays_per_sec"]} rays/s (small counts, not '
          f'the protocol)', flush=True)
    return k1, k2, dict(line, phase_s=dt)


def _density_probe(torch, np, sess, res=32):
    """The least and the largest raw density of image 0's pose on a
    res^3 version of render_mesh_mode's grid (plain torch, no kernel)."""
    from anerf_torch.ops.fk import get_smpl_l2ws_np
    from anerf_torch.render.raycaster import render_mesh_density

    src = sess.src
    l2ws = get_smpl_l2ws_np(src.bones[0], src.rest_pose)
    l2ws[..., :3, -1] += src.kps[0, :1]

    def put(x):
        return torch.as_tensor(np.asarray(x, np.float32), device='cuda')
    sigma = render_mesh_density(
        sess.params, sess.cfg, put(l2ws[..., :3, -1][None]),
        put(np.linalg.inv(l2ws)[None]), put(src.bones[:1]), radius=1.3,
        res=res, tau=float(sess.tau))
    return float(sigma.min()), float(sigma.max())


def _request_ns(base_args, req):
    """A server request's namespace: the base args with its fields."""
    import argparse
    return argparse.Namespace(**{**vars(base_args), **req})


# ---- phase 14: the fused kernels at the shapes beyond the flagship's ----
# rays of the shapes phase's kernel buckets (S = 64 coarse, 80 fine) and
# of its K2 batches: the flagship train step's N_rand
SHAPE_RAYS = 2048
#: the slice's end-to-end configs: configs/surreal/surreal.txt with these
#: overrides (the flagship's fused kernel, pose refinement, framecodes)
SHAPE_CONFIGS = {
    'wide-net': dict(netwidth=512, netwidth_fine=512),
    'wide-input': dict(multires=10, multires_views=6, framecode_size=32),
}
N_SHAPE_STEPS = 20
SHAPE_LOOP_STEPS = 16
SHAPES_BUDGET_S = 120
SHAPE_DIR = 'logs/chip_shapes'


def _shape_operands(torch, np, name, flag, seed, depth=None, bands=None):
    """A roofline.SHAPES network (with `depth` trunk layers in place of its
    own, and the PE bands `bands` = (multires, multires_views), where
    given) with random weights (seeded), its K1 / K3 and K4 operands, and
    one bucket of SHAPE_RAYS rays of the flagship render setup `flag`
    (_bucket_inputs: S = 64, 16 and 80) with random framecodes of the
    network's width. Returns (ncfg, packed, packed4, route, route4,
    bucket)."""
    import dataclasses

    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    from anerf_torch.models.nerf import init_nerf_params

    _, cfg, params, src = flag
    ncfg, nfk, nfv = rf.shape_config(name)
    if depth is not None:
        ncfg = dataclasses.replace(ncfg, depth=depth)
    if bands is not None:
        nfk, nfv = bands
        ncfg = dataclasses.replace(ncfg, input_ch=24 * (1 + 2 * nfk),
                                   input_ch_views=72 * (1 + 2 * nfv))
    net = init_nerf_params(ncfg, torch.Generator().manual_seed(seed), 'cuda')
    net['alpha_linear']['b'] += 2.0
    packed = fr.pack_render_params(net, ncfg, nfk, nfv,
                                   params['cutoff_dist'])
    packed4 = fm.pack_params(net, ncfg)
    v = _bucket_inputs(torch, np, cfg, params, src, seed, R=SHAPE_RAYS,
                       culled=False)
    g = torch.Generator(device='cuda').manual_seed(seed)
    fc = torch.randn((SHAPE_RAYS, fr.fc_width(ncfg)), device='cuda',
                     generator=g) * v[3]['fc'].std()
    m_all, aux = fr.pack_ray_data(v[3]['rays_d'], v[3]['skts'], fc)
    bucket = (v[0], m_all, aux, dict(v[3], fc=fc))
    return (ncfg, packed, packed4,
            fr.route_plan(ncfg, packed['k0'], packed['kv']),
            fr.route_plan(ncfg, *fm.kernel_widths(ncfg), embedded=True),
            bucket)


def _bf16_mlp_tol(ncfg):
    """K2_BF16_FRO for a trunk of ncfg.depth layers. The constant was set
    from readings at the flagship's 8 layers; each trunk layer rounds one
    more cotangent to bf16, and a rounding that the two summation orders
    put on either side of a bf16 step moves every layer below it, so the
    distance grows with the depth (read 2.4e-4 at depth 5, 4.6e-4 to
    8.3e-4 at 8, 3.3e-3 at 40 on an H100). The law was set after the
    reading at 40; the depths in between (BF16_PROBE_DEPTHS) test it:
    9.7e-4 at 16 and 1.8e-3 at 24, 0.32 and 0.41 of the limit (0.44 at
    40). The f32 flavour, the control, must still land above it (6.6e-3
    at 16, 8.7e-3 at 24, 1.7e-2 at 40)."""
    return K2_BF16_FRO * max(1.0, ncfg.depth / 8)


#: trunk depths between the flagship's and plain-trunk-40's at which
#: _bf16_depth_probe reads K2's mlp stage in both flavours
BF16_PROBE_DEPTHS = (16, 24)


def _bf16_depth_probe(torch, np, flag):
    """K2's mlp stage in both flavours (_mlp_stage_fro, S = 64) on the
    plain-trunk network at BF16_PROBE_DEPTHS: the bf16 flavour within
    _bf16_mlp_tol, the f32 flavour (the control) above it. Returns
    {depth: (bf16 fro, f32 fro, tol)}."""
    out = {}
    for i, depth in enumerate(BF16_PROBE_DEPTHS):
        ncfg, packed, _, _, _, (pts, m_all, aux, _) = _shape_operands(
            torch, np, 'plain-trunk-40', flag, 200 + i, depth=depth)
        g = torch.randn((SHAPE_RAYS, 64, 4), device='cuda',
                        generator=torch.Generator(device='cuda')
                        .manual_seed(300 + i))
        fro16, fro32 = _mlp_stage_fro(
            torch, ncfg, packed, (ncfg, packed, pts[64], m_all, aux, 64,
                                  2000.0, g))
        tol = _bf16_mlp_tol(ncfg)
        print(f'shapes K2 mlp stage at depth {depth} (plain trunk, width '
              f'256): bf16 flavour fro {fro16:.3e} (tol {tol:.3e}), f32 '
              f'flavour (control) {fro32:.3e}', flush=True)
        if not fro16 < tol < fro32:
            raise AssertionError(f'shapes depth {depth}: K2-bf16 mlp stage '
                                 f'{fro16:.3e}, control {fro32:.3e}')
        out[depth] = (fro16, fro32, tol)
        del packed, pts, m_all, aux, g
        torch.cuda.empty_cache()
    return out


def _act_errors(torch, ncfg, packed, act, want, P):
    """K2's saved activations (`act`, its recompute) of P points, block by
    block. Returns (the worst relative Frobenius distance of any MMA
    layer's saved output from that layer run in f64 on the kernel's own
    saved input, ReLU and bf16 rounding as the kernel does them; the
    worst relative Frobenius distance of any block (x0, xv, every h,
    feat, hv) from the plain forward's trace `want`; the share of ReLU
    masks of each trunk layer and of hv that differ from `want`'s)."""
    from anerf_torch.kernels import fused_render as fr
    got = fr.trace_from_act(ncfg, packed, act, P)
    W, d = ncfg.width, ncfg.depth
    bs = list(packed['b'][:W * (d + 1)].split(W)) + \
        [packed['b'][W * (d + 1):]]
    hs = got['hs']
    ins = [got['x0']] + [
        torch.cat([got['x0'], hs[i - 1]], -1) if (i - 1) in ncfg.skips
        else hs[i - 1] for i in range(1, d)] + [
        hs[-1], torch.cat([got['feat'], got['xv']], -1)]
    outs = hs + [got['feat'], got['hv']]
    rel = lambda a, b: ((a - b).norm() / b.norm().clamp_min(1e-7)).item()
    local = 0.0
    for i, (x, y) in enumerate(zip(ins, outs)):
        z = x.double() @ got['ws'][i].double().t() + bs[i].double()
        z = (z if i == d else torch.relu(z)).float()
        local = max(local, rel(y, z.to(torch.bfloat16).float()))
        del z
    flat = lambda x: x.reshape(P, x.shape[-1])
    pairs = [(got[k], flat(want[k])) for k in ('x0', 'xv', 'feat', 'hv')]
    pairs += [(a, flat(b)) for a, b in zip(hs, want['hs'])]
    glob = max(rel(a, b) for a, b in pairs)
    flips = [((a > 0) != (flat(b) > 0)).float().mean().item()
             for a, b in zip(hs + [got['hv']], want['hs'] + [want['hv']])]
    return local, glob, flips


def _same_bits(torch, a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _design_floor_ms(kid, ncfg, packed, k4_widths, R, Ss):
    """The layered route's own HBM floor (roofline.layered_design_bytes
    at 3.35 TB/s) of a kernel of _shape_kernels on R rays at each S of
    Ss: K1 its points; K3 its f32 rows in place of the points; K4 its
    embedded rows read in place; K2 (both flavours) the recompute writing
    its saved activations once, then the backward sequence's bytes
    (roofline.k2_design_bytes less its single-kernel recompute: the f32
    flavour's f32 cotangents and 2048-point chunks, the bf16 flavour's
    bf16 cotangent tiles and its plan's chunks, fused_render.bwd_plan)."""
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf
    k0, kv, fc = packed['k0'], packed['kv'], packed['fc']
    total = 0
    for S in Ss:
        P = R * S
        if kid == 'K4':
            total += rf.layered_design_bytes(ncfg, *k4_widths, P,
                                             embedded=True)
            continue
        total += rf.layered_design_bytes(ncfg, k0, kv, P,
                                         save=kid.startswith('K2'))
        if kid == 'K3':
            total += (4 * fr.raw_width(fc) - 12) * P
        elif kid.startswith('K2'):
            F = fr.act_rows(ncfg, packed['nfk'], packed['nfv'])['F']
            plan = fr.bwd_plan(ncfg, packed, P, kid == 'K2')
            chunk = fr.BWD_CHUNK if kid == 'K2' else plan['chunk']
            total += rf.k2_design_bytes(
                ncfg, packed['nfk'], packed['nfv'], P, chunk,
                plan['cot_bytes'], fc) - (12 + 2 * F + 16) * P
    return total / rf.PEAK_HBM_BYTES * 1e3


#: the layered GEMM's tails (clusters of LAYERED_CLUSTER 128-point
#: tiles), which phase 14's batches (an even count of whole tiles) miss:
#: K1 and K2's recompute on TAIL_RAYS rays at S = 80 (163,440 points,
#: 1,277 tiles, the last of 112 rows), K4 on TAIL_ROWS input rows (1,025
#: tiles, the last of 77 rows); both leave the last cluster's second
#: tile wholly past the points
TAIL_RAYS = 2043
TAIL_ROWS = 2048 * 64 + 77


def _shape_tails(torch, name, ncfg, packed, packed4, k4_in, bucket,
                 layered, layered4, tau):
    """The layered GEMM's tails at one shape: where `layered`, K1 on the
    first TAIL_RAYS rays of `bucket` at S = 80 against its plain version
    (K1_ATOL) and K2's saved activations (its recompute) on them within
    ACT_LOCAL_FRO / ACT_FRO / ACT_FLIP; where `layered4`, K4 on the
    first TAIL_ROWS of its inputs `k4_in` ((x0, xv), S = 80) within
    K1_ATOL; each launched twice, bit-equal."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr

    pts, m_all, aux = bucket
    Rt, S = TAIL_RAYS, 80
    cases = []
    if layered:
        args = (ncfg, packed, pts[S][:Rt].contiguous(), m_all[:Rt * 3],
                aux[:Rt], S, tau)
        cases.append(('K1', fr.fused_encode_mlp_pts,
                      fr.fused_encode_mlp_pts_ref, args, Rt * S))
    if layered4:
        args = (ncfg, packed4) + tuple(x[:TAIL_ROWS] for x in k4_in)
        cases.append(('K4', fm.fused_mlp_apply, fm.fused_mlp_apply_ref,
                      args, TAIL_ROWS))
    for kid, kernel, plain, args, P in cases:
        tiles = -(-P // fr.LAYERED_GM)
        got, again = kernel(*args), kernel(*args)
        want = plain(*args)
        e = (got - want).abs().max().item()
        ok = (torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
              and torch.equal(got, again)
              and bool(torch.isfinite(got).all()))
        print(f'shapes {name} {kid} tail: {P} points, {tiles} tiles of '
              f'{fr.LAYERED_GM} (the last of {P - (tiles - 1) * fr.LAYERED_GM}'
              f' rows): max_abs={e:.3e} vs plain (tol atol=rtol={K1_ATOL}), '
              f'relaunch bit-equal {torch.equal(got, again)} -> '
              f'{"ok" if ok else "FAIL"}', flush=True)
        if not ok:
            raise AssertionError(f'shapes {name}: {kid} disagrees on {P} '
                                 'points')
        del got, again, want
    if not layered:
        return
    args = cases[0][3]
    dev = pts[S].device
    g = torch.randn((Rt, S, 4), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    t = fr.launch_bwd(0, *args, g)
    t2 = fr.launch_bwd(0, *args, g)
    P = Rt * S
    saved = lambda tr: [tr['x0'], tr['xv'], *tr['hs'], tr['feat'],
                        tr['hv']]
    keys = ('dW', 'dpts', 'dm', 'daux')
    same = (_same_bits(torch, [t[k] for k in keys], [t2[k] for k in keys])
            and _same_bits(torch, *(saved(fr.trace_from_act(
                ncfg, packed, x['act'], P)) for x in (t, t2))))
    e_loc, e_glob, flips = _act_errors(
        torch, ncfg, packed, t['act'], fr._forward_trace(*args), P)
    ok = (same and e_loc < ACT_LOCAL_FRO and e_glob < ACT_FRO
          and max(flips) < ACT_FLIP)
    print(f'shapes {name} K2 tail: {P} points, saved activations vs f64 on '
          f'their own input fro {e_loc:.3e} (tol {ACT_LOCAL_FRO}), vs the '
          f'plain forward {e_glob:.3e} (tol {ACT_FRO}), masks flipped at '
          f'most {max(flips):.1e} (tol {ACT_FLIP}), relaunch bit-equal '
          f'{same} -> {"ok" if ok else "FAIL"}', flush=True)
    if not ok:
        raise AssertionError(f'shapes {name}: K2 saved activations disagree'
                             f' on {P} points')


#: the second configuration at which K4's two-stage rule is timed
#: (route_plan: the layered route wherever the single kernel needs two
#: weight stages, first timed at multires 10 / 4, phase 14's two-stage
#: shape): the flagship's kp bands and multires_views 6, K4's x0 432 and
#: xv 952 columns (the view input the wide one where the first had x0)
K4_TWO_STAGE_BANDS = (7, 6)


def _k4_two_stage(torch, np, flag, seed=150):
    """K4 at K4_TWO_STAGE_BANDS (8 x 256, 16-wide framecodes): the single
    kernel forced at two weight stages and the layered route forced, each
    against its plain version (K1_ATOL) and relaunched bit-equal, timed in
    turns (single, layered, layered, single; medians of 5, S = 64 + 80 on
    SHAPE_RAYS rays). Returns {single_ms, layered_ms, faster, route}:
    `route`, route_plan's pick, is the faster one's where the readings
    agree with the rule."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr

    ncfg, packed, packed4, _, route4, (pts, m_all, aux, _) = _shape_operands(
        torch, np, 'two-stage', flag, seed, bands=K4_TWO_STAGE_BANDS)
    k0, kv = fm.kernel_widths(ncfg)
    need = fr.sm90_smem_bytes(k0, kv, 2)
    if not (fr.sm90_smem_bytes(k0, kv, fr.SM90_STAGES) > fr.SM90_MAX_SMEM
            >= need):
        raise AssertionError(f'K4 at {K4_TWO_STAGE_BANDS}: not a two-stage '
                             'config')
    routes = {'single': fr.Route('single', 2, need, 'forced'),
              'layered': fr.Route('layered', 0, 0, 'forced')}

    def on(kind):
        def run(*a):
            plan = fr.route_plan
            fr.route_plan = lambda *x, **k: routes[kind]
            try:
                return fm.fused_mlp_apply(*a)
            finally:
                fr.route_plan = plan
        return run

    tau, bf = 2000.0, torch.bfloat16
    ms = {'single': 0.0, 'layered': 0.0}
    err = 0.0
    for S in (64, 80):
        x0, xv = fr._encode(packed, pts[S], m_all, aux, S, tau)
        args = (ncfg, packed4,
                x0[..., :ncfg.dnet_input].reshape(-1, ncfg.dnet_input).to(bf),
                xv[..., :fm.view_in(ncfg)].reshape(-1, fm.view_in(ncfg))
                .to(bf))
        want = fm.fused_mlp_apply_ref(*args)
        for kind in ms:
            got, again = on(kind)(*args), on(kind)(*args)
            torch.cuda.synchronize()
            ok = (torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
                  and torch.equal(got, again))
            if not ok:
                raise AssertionError(f'K4 at {K4_TWO_STAGE_BANDS} on the '
                                     f'{kind} route disagrees at S={S}')
            err = max(err, (got - want).abs().max().item())
        turns = [_median_ms(on(kind), [args], 5)
                 for kind in ('single', 'layered', 'layered', 'single')]
        ms['single'] += (turns[0] + turns[3]) / 2
        ms['layered'] += (turns[1] + turns[2]) / 2
    faster = min(ms, key=ms.get)
    print(f'shapes K4 two-stage rule at multires {K4_TWO_STAGE_BANDS[0]} / '
          f'{K4_TWO_STAGE_BANDS[1]} (x0 {k0}, xv {kv}): single kernel at 2 '
          f'stages {ms["single"]:.4f} ms, layered route {ms["layered"]:.4f}'
          f' (medians of turns, S = 64 + 80, {SHAPE_RAYS} rays; max_abs '
          f'{err:.3e} vs plain): the {faster} route is the faster, '
          f'route_plan picks {route4.kind}', flush=True)
    return {'single_ms': ms['single'], 'layered_ms': ms['layered'],
            'faster': faster, 'route': route4.kind, 'max_abs_err': err}


def _shape_kernels(torch, np, name, flag, seed, forced=False):
    """K1, K3, K4 and K2 in both flavours at one roofline.SHAPES network
    on its route (`forced`: the layered route forced by the caller): each
    against its plain version (K1_ATOL; K2's saved activations within
    ACT_LOCAL_FRO / ACT_FRO / ACT_FLIP, its outputs on them within
    K2_FRO / K2_BLOCK_RTOL and, up to K2_OWN_DEPTH, with the plain
    version's own recompute within K2_FRO, and its bf16 flavour's MLP
    backward on its own saved activations within _bf16_mlp_tol, which the
    f32 flavour must exceed), a second launch bit-equal, times (medians
    of CUDA events, S = 64 + 80) beside the bound (roofline.config_bounds
    on this run's rays), the layered route's design floor
    (_design_floor_ms) and the plain version's; K4 timed in turns with
    its function as bf16 torch.matmul calls (chain, K4, K4, chain), and
    on the layered route, unforced, no slower than them; unforced, the
    layered GEMM's cluster tails (_shape_tails). Returns ({kernel id:
    record}, {kernel id: design floor ms, on the layered route})."""
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf

    ncfg, packed, packed4, route, route4, (pts, m_all, aux, ray) = \
        _shape_operands(torch, np, name, flag, seed)
    R, tau, bf = SHAPE_RAYS, 2000.0, torch.bfloat16
    k0, kv = ncfg.dnet_input, fm.view_in(ncfg)

    def k4_args(S):
        x0, xv = fr._encode(packed, pts[S], m_all, aux, S, tau)
        return (ncfg, packed4, x0[..., :k0].reshape(-1, k0).to(bf),
                xv[..., :kv].reshape(-1, kv).to(bf))

    raw = {S: fr.build_raw_inputs(pts[S], ray['rays_d'], ray['skts'],
                                  ray['fc']) for S in (64, 80)}
    fwd = {'K1': (fr.fused_encode_mlp_pts, fr.fused_encode_mlp_pts_ref,
                  lambda S: (ncfg, packed, pts[S], m_all, aux, S, tau)),
           'K3': (fr.fused_encode_mlp, fr.fused_encode_mlp_ref,
                  lambda S: (ncfg, packed, raw[S], tau)),
           'K4': (fm.fused_mlp_apply, fm.fused_mlp_apply_ref, k4_args)}
    bounds = rf.config_bounds(ncfg, packed['nfk'], packed['nfv'], R,
                              (64, 80), R, (64, 80))
    recs, floors = {}, {}
    for kid, (kernel, plain, make) in fwd.items():
        err, ms, plain_ms, library_ms = 0.0, 0.0, 0.0, 0.0
        layered0 = dict(fr.LAYERED_LAUNCHES)
        for S in (64, 80):
            args = make(S)
            got = kernel(*args)
            again = kernel(*args)
            torch.cuda.synchronize()
            want = plain(*args)
            e = (got - want).abs().max().item()
            ok = (torch.allclose(got, want, atol=K1_ATOL, rtol=K1_RTOL)
                  and torch.equal(got, again)
                  and bool(torch.isfinite(got).all()))
            print(f'shapes {name} {kid} S={S}: max_abs={e:.3e} vs plain '
                  f'(tol atol=rtol={K1_ATOL}), relaunch bit-equal '
                  f'{torch.equal(got, again)} -> {"ok" if ok else "FAIL"}',
                  flush=True)
            if not ok:
                raise AssertionError(f'shapes {name}: {kid} disagrees at '
                                     f'S={S}')
            err = max(err, e)
            if kid == 'K4':
                # in turns on the same inputs: chain, K4, K4, chain
                chain = _mlp_chain(torch, ncfg, packed4)
                turns = [_median_ms(fn, [a], 5) for fn, a in (
                    (chain, args[2:]), (kernel, args), (kernel, args),
                    (chain, args[2:]))]
                ms += (turns[1] + turns[2]) / 2
                library_ms += (turns[0] + turns[3]) / 2
                del chain
            else:
                ms += _median_ms(kernel, [args], 5)
            plain_ms += _median_ms(plain, [args], 3)
            del got, again, want
        rt = route4 if kid == 'K4' else route
        n_layered = sum(fr.LAYERED_LAUNCHES.values()) - sum(
            layered0.values())
        if (n_layered > 0) != (rt.kind == 'layered'):
            raise AssertionError(f'shapes {name}: {kid} took the wrong route '
                                 f'({n_layered} layered calls, plan '
                                 f'{rt.kind})')
        b_ms, b_by, _ = bounds[kid]
        recs[kid] = {'shape': name, 'route': rt.kind, 'stages': rt.stages,
                     'route_why': rt.why, 'max_abs_err': err, 'ms': ms,
                     'plain_ms': plain_ms, 'bound_ms': b_ms,
                     'bound_by': b_by,
                     'library_ms': library_ms if kid == 'K4' else None}
        if rt.kind == 'layered':
            floors[kid] = _design_floor_ms(
                kid, ncfg, packed, fm.kernel_widths(ncfg), R, (64, 80))
        if kid == 'K4' and rt.kind == 'layered' and not forced:
            ok = ms <= library_ms
            print(f'shapes {name} K4 on the layered route {ms:.4f} ms, the '
                  f'bf16 matmul chain {library_ms:.4f} (medians of the same '
                  f'turns, S = 64 + 80): '
                  f'{"no slower" if ok else "SLOWER"} -> '
                  f'{"ok" if ok else "FAIL"}', flush=True)
            if not ok:
                raise AssertionError(f'shapes {name}: K4 on the layered route '
                                     f'{ms:.4f} ms, slower than the chain '
                                     f'{library_ms:.4f}')
    if not forced:
        _shape_tails(torch, name, ncfg, packed, packed4, k4_args(80)[2:],
                     (pts, m_all, aux), route.kind == 'layered',
                     route4.kind == 'layered', tau)
    # K2 in both flavours on a batch of R rays at S = 64 and 80: its saved
    # activations (the recompute) block by block (_act_errors), its
    # outputs against the plain backward on those activations
    # (trace_from_act: the backward's arithmetic alone, K2_FRO) and, up
    # to K2_OWN_DEPTH layers, against the plain version with its own
    # recompute (K2_FRO). Deeper, flipped ReLU masks compound through the
    # trunk; the run prints the plain backward's own distance between
    # the two recomputes beside K2's (the witness that the gap is the
    # recompute's roundings, not K2's)
    gen = torch.Generator(device='cuda').manual_seed(seed + 1)
    for kid, f32 in (('K2', True), ('K2 bf16', False)):
        ms, plain_ms, worst, own, mabs = 0.0, 0.0, 0.0, 0.0, 0.0
        plain_gap, local, glob, flip = 0.0, 0.0, 0.0, 0.0
        for S in (64, 80):
            g = torch.randn((R, S, 4), device='cuda', generator=gen)
            args = (ncfg, packed, pts[S], m_all, aux, S, tau, g, f32)
            t = fr.launch_bwd(0, *args[:-1], bwd_f32=f32)
            got = (t['dW'], t['dpts'], t['dm'], t['daux'])
            again = fr.fused_bwd(*args)
            torch.cuda.synchronize()
            if not _same_bits(torch, got, again):
                raise AssertionError(f'shapes {name}: {kid} relaunch differs')
            e_loc, e_glob, flips = _act_errors(
                torch, ncfg, packed, t['act'], fr._forward_trace(
                    ncfg, packed, pts[S], m_all, aux, S, tau), R * S)
            print(f'shapes {name} {kid} S={S}: saved activations, each '
                  f'layer vs f64 on its own saved input fro {e_loc:.3e} '
                  f'(tol {ACT_LOCAL_FRO}); vs the plain forward worst '
                  f'block fro {e_glob:.3e} (tol {ACT_FRO}), ReLU masks '
                  f'flipped by layer (h_0 .. h_{ncfg.depth - 1}, hv) '
                  + ' '.join(f'{f:.1e}' for f in flips)
                  + f' (tol {ACT_FLIP})', flush=True)
            if not (e_loc < ACT_LOCAL_FRO and e_glob < ACT_FRO
                    and max(flips) < ACT_FLIP):
                raise AssertionError(f'shapes {name}: {kid} saved '
                                     f'activations disagree at S={S}')
            local, glob = max(local, e_loc), max(glob, e_glob)
            flip = max(flip, max(flips))
            dW, dx0, dxv = fr.mlp_bwd_ref(
                *args[:-1], bwd_f32=f32,
                trace=fr.trace_from_act(ncfg, packed, t['act'], R * S))
            want = (dW,) + fr.pe_transform_bwd_ref(packed, pts[S], m_all,
                                                   aux, S, tau, dx0, dxv)
            e, _, _, fro = _k2_errors(torch, ncfg, packed, got, want,
                                      f'shapes {name} {kid} S={S}', R)
            worst, mabs = max(worst, fro), max(mabs, e)
            del t, dW, dx0, dxv
            ref = fr.fused_bwd_ref(*args)
            e_own = _worst_fro(ncfg, packed, got, ref)
            e_gap = _worst_fro(ncfg, packed, want, ref)
            own, plain_gap = max(own, e_own), max(plain_gap, e_gap)
            if ncfg.depth <= K2_OWN_DEPTH and not e_own < K2_FRO:
                raise AssertionError(f'shapes {name}: {kid} vs the plain '
                                     f'version at S={S}: fro {e_own:.3e}')
            ms += _median_ms(fr.fused_bwd, [args], 3)
            plain_ms += _median_ms(fr.fused_bwd_ref, [args], 1)
            del got, again, want, ref
        gated = ncfg.depth <= K2_OWN_DEPTH
        print(f'shapes {name} {kid}: worst fro {worst:.3e} against the plain '
              f'backward on its own activations (gated, {K2_FRO}); '
              f'{own:.3e} against the plain version with its own '
              f'recompute ({f"gated, {K2_FRO}" if gated else "not gated"}'
              f'), where the plain backward on K2\'s activations reads '
              f'{plain_gap:.3e}', flush=True)
        b_ms, b_by, _ = bounds[kid]
        if route.kind == 'layered':
            floors[kid] = _design_floor_ms(kid, ncfg, packed, None, R,
                                           (64, 80))
        recs[kid] = {'shape': name, 'route': route.kind,
                     'stages': route.stages, 'route_why': route.why,
                     'max_abs_err': mabs, 'max_fro_err': worst,
                     'fro_vs_plain_recompute': own,
                     'plain_recompute_gap': plain_gap,
                     'act_local_fro': local, 'act_fro': glob,
                     'act_flip': flip,
                     'ms': ms, 'plain_ms': plain_ms, 'bound_ms': b_ms,
                     'bound_by': b_by, 'library_ms': None}
    args = (ncfg, packed, pts[64], m_all, aux, 64, tau,
            torch.randn((R, 64, 4), device='cuda', generator=gen))
    fro16, fro32 = _mlp_stage_fro(torch, ncfg, packed, args)
    tol = _bf16_mlp_tol(ncfg)
    print(f'shapes {name} K2 mlp stage vs the plain bf16 backward on its '
          f'own activations: bf16 flavour fro {fro16:.3e} (tol {tol:.3e}), '
          f'f32 flavour (control) {fro32:.3e}', flush=True)
    if not fro16 < tol < fro32:
        raise AssertionError(f'shapes {name}: K2-bf16 mlp stage {fro16:.3e}'
                             f', control {fro32:.3e}')
    recs['K2 bf16']['mlp_stage_fro'] = fro16
    for kid, rec in recs.items():
        print(f'shapes {name} {kid}: route {rec["route"]} '
              f'({rec["route_why"]}); {rec["ms"]:.4f} ms at S = 64 + 80, '
              f'{R} rays; bound {rec["bound_ms"]:.4f} ({rec["bound_by"]}); '
              + (f'design floor {floors[kid]:.4f}; '
                 if kid in floors else '')
              + f'plain {rec["plain_ms"]:.4f}'
              + (f'; bf16 matmul chain {rec["library_ms"]:.4f}'
                 if rec['library_ms'] is not None else ''), flush=True)
    return recs, floors


def _shape_train(torch, np, name, overrides, n_steps=N_SHAPE_STEPS):
    """One step's gradients held to a reference first (fast_grads:
    culled_k2_check, K2-bf16 against its plain version in its place;
    else train_reference_check, the fused branch against the plain
    branch), then N_SHAPE_STEPS flagship-style train steps (N_rand 2048,
    pose refinement) of a SHAPE_CONFIGS config through train_phase's
    gates: finite, loss falling, two K1 and two K2 launches a step.
    Returns (K1 launches, K2 launches, median step seconds, the steps'
    layered calls by kernel)."""
    from anerf_torch.kernels import fused_render as fr

    setup = _flagship_train(torch, np, **overrides)
    check = culled_k2_check if overrides.get('fast_grads') \
        else train_reference_check
    check(torch, np, setup, label=f' (shapes {name})')
    layered0 = dict(fr.LAYERED_LAUNCHES)
    k1, k2, step_s, _ = train_phase(torch, np, setup, n_steps=n_steps,
                                    label=f'shapes {name} train')
    return k1, k2, step_s, {k: n - layered0[k]
                            for k, n in fr.LAYERED_LAUNCHES.items()}


def _shape_loop(torch, np, data):
    """run_nerf.main at wide-net on the loop phase's grid: SHAPE_LOOP_STEPS
    steps in dispatches of LOOP_UNROLL, counts set to 0 just before and
    read just after: finite losses, two K1 and two K2 (f32) launches a
    step. Returns (K1, K2, rays/s of the last dispatch)."""
    import contextlib
    import os
    import shutil

    from anerf_torch.config import load_config
    from anerf_torch.data.surreal import SurrealDataset
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.run_nerf import main as run_nerf_main

    argv = _loop_argv(SHAPE_LOOP_STEPS)
    argv[argv.index('--expname') + 1] = 'wide_net'
    for flag, v in (('--i_weights', 10 ** 6), ('--i_pose_weights', 10 ** 6),
                    ('--i_testset', 10 ** 6)):
        argv[argv.index(flag) + 1] = str(v)
    argv += ['--netwidth', '512', '--netwidth_fine', '512']
    args = load_config(argv)
    ds = SurrealDataset(data, N_samples=args.N_rand // args.N_sample_images,
                        split='train')
    root = os.path.abspath(SHAPE_DIR)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    recs = []
    cwd = os.getcwd()
    os.chdir(root)
    fr.LAUNCHES = fr.BWD_LAUNCHES = fr.BWD_BF16_LAUNCHES = 0
    try:
        with contextlib.redirect_stdout(_Tee(sys.stdout)):
            run_nerf_main(argv, dataset=ds, log_fn=recs.append,
                          save_images=False)
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
    counts = (fr.LAUNCHES, fr.BWD_LAUNCHES, fr.BWD_BF16_LAUNCHES)
    for r in recs:
        print(f"shapes wide-net loop step {r['step']}: loss "
              f"{r['total_loss']:.5f} psnr {r['psnr']:.3f} rays/s "
              f"{r['rays_per_sec']:.1f}", flush=True)
        if not all(np.isfinite(v) for v in r.values()):
            raise AssertionError(f'wide-net loop step {r["step"]}: {r}')
    if [r['step'] for r in recs] != list(range(
            LOOP_UNROLL, SHAPE_LOOP_STEPS + 1, LOOP_UNROLL)):
        raise AssertionError(f'wide-net loop prints {recs}')
    if counts != (2 * SHAPE_LOOP_STEPS, 2 * SHAPE_LOOP_STEPS, 0):
        raise AssertionError(f'wide-net loop: K1, K2, K2-bf16 {counts}')
    return counts[0], counts[1], recs[-1]['rays_per_sec']


def shapes_phase(torch, np, data=None):
    """Phase 14: the fused kernels at every shape the JAX gate admits
    beyond the flagship's. (a) K1, K3, K4 and K2 in both flavours on
    each roofline.SHAPES network, on the route `route_plan` picks (the
    layered route at wide-net and wide-input, the single kernel at two
    stages at multires 10, at three at depth 5 and 40), held to their
    plain versions with relaunches bit-equal and timed beside their
    bounds (_shape_kernels), multires 10 again on the layered route,
    and K2's mlp stage at BF16_PROBE_DEPTHS (_bf16_depth_probe); (b) at
    wide-net, wide-input and wide-net with cull_ratio 0.125 and
    fast_grads (K2's bf16 flavour), one step's gradients against a
    reference and N_SHAPE_STEPS train steps (_shape_train); (c) one 512 x 512 render_path request at wide-net;
    (d) run_nerf.main SHAPE_LOOP_STEPS steps at wide-net on the loop
    phase's grid (`data`: its H5Arrays, made here when None). The counts
    are set to 0 just before each main path and read just after. Returns
    ({kernel id: [records by shape]}, launches by kernel, summary)."""
    import os

    from anerf_torch.data.fixtures import synthetic_data
    from anerf_torch.data.schema import h5_arrays
    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr
    from anerf_torch.kernels import roofline as rf

    t0 = time.perf_counter()
    flag = _flagship_render(torch, np)
    recs = {}
    floors = {}
    for i, name in enumerate(rf.SHAPES):
        own, floor = _shape_kernels(torch, np, name, flag, 100 + i)
        for kid, rec in own.items():
            recs.setdefault(kid, []).append(rec)
        floors.update({f'{kid}@{name}': ms for kid, ms in floor.items()})
        torch.cuda.empty_cache()
        if name == 'two-stage':
            # the same shape forced onto the layered route, checked the
            # same way, its times beside the two-stage single kernel's
            plan = fr.route_plan
            fr.route_plan = lambda *a, **k: fr.Route(
                'layered', 0, 0, 'forced onto the layered route')
            try:
                forced, _ = _shape_kernels(torch, np, name, flag,
                                           100 + i, forced=True)
            finally:
                fr.route_plan = plan
            for kid, rec in forced.items():
                own = recs[kid][-1]
                own['layered_ms'] = rec['ms']
                faster = ('the forced layered route'
                          if rec['ms'] < own['ms']
                          else f'its own route ({own["route"]})')
                print(f'shapes two-stage {kid}: {own["route"]} '
                      f'({own["route_why"]}) {own["ms"]:.4f} ms, layered '
                      f'route forced {rec["ms"]:.4f} ms: {faster} is the '
                      f'faster', flush=True)
            del forced
            torch.cuda.empty_cache()
    k4_two_stage = _k4_two_stage(torch, np, flag)
    torch.cuda.empty_cache()
    probe = _bf16_depth_probe(torch, np, flag)
    # the layered route split by launch (kernel_bench --layered, this
    # checkout's package) at the shapes route_plan sends there, each in a
    # process of its own: in this long one torch.profiler was seen to
    # drop most of a window's kernels. A split the profiler missed is
    # printed as such (n/m) and does not fail the phase
    split = {}
    for name in ('wide-net', 'wide-input'):
        cmd = [sys.executable, '-m', 'anerf_torch.tools.kernel_bench',
               '--layered', name, '--rays', str(SHAPE_RAYS), '--reps', '3']
        print(f'shapes {name}: the layered route by launch '
              f'({" ".join(cmd[1:])})', flush=True)
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=SHAPES_BUDGET_S,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        lines = proc.stdout.strip().splitlines()
        print('\n'.join(lines[-47:-1]), flush=True)
        if proc.returncode:
            raise AssertionError(f'kernel_bench --layered {name}: rc '
                                 f'{proc.returncode}\n{proc.stderr[-2000:]}')
        rec = json.loads(lines[-1])
        # K2's recompute writes its saved activations where they are made:
        # no copy kernel may run in any window of the split
        copies = sorted({n for names in rec['device_kernels'].values()
                         for n in names if 'to_act' in n})
        print(f'shapes {name}: copy launches in the split\'s profiler '
              f'windows: {copies or "none"}', flush=True)
        if copies:
            raise AssertionError(f'shapes {name}: {copies} launched')
        split[name] = {'profiler_misses': rec['profiler_misses']}
        for r in rec['rows']:
            per = split[name].setdefault(r['kernel'], {})
            per[r['launch']] = (None if r['ms'] is None
                                or per.get(r['launch'], 0.0) is None
                                else per.get(r['launch'], 0.0) + r['ms'])
            floor = split[name].setdefault(f'{r["kernel"]} floor_ms', {})
            floor[r['launch']] = floor.get(r['launch'], 0.0) + r['floor_ms']
    t_kernels = time.perf_counter() - t0

    # the main paths, counts from here on
    for k in fr.LAYERED_LAUNCHES:
        fr.LAYERED_LAUNCHES[k] = 0
    launches = {n: {'K1': 0, 'K2': 0, 'K2 bf16': 0} for n in SHAPE_CONFIGS}
    summary = {'bf16_depth_probe': probe, 'layered_split': split,
               'design_floor_ms': floors, 'k4_two_stage': k4_two_stage}
    layered_train = dict.fromkeys(fr.LAYERED_LAUNCHES, 0)
    for name, overrides in list(SHAPE_CONFIGS.items()) + [
            ('wide-net culled fast-grads',
             dict(SHAPE_CONFIGS['wide-net'], cull_ratio=0.125,
                  fast_grads=True))]:
        k1, k2, step_s, layered = _shape_train(torch, np, name, overrides)
        n = launches[name.split()[0]]
        n['K1'] += k1
        n['K2 bf16' if 'fast_grads' in overrides else 'K2'] += k2
        summary[f'{name} step_ms'] = step_s * 1e3
        for k, c in layered.items():
            layered_train[k] += c
        torch.cuda.empty_cache()
    n_k1 = sum(n['K1'] for n in launches.values())
    n_k2 = sum(n['K2'] + n['K2 bf16'] for n in launches.values())
    if (layered_train['k1'], layered_train['k2']) != (n_k1, n_k2):
        raise AssertionError(f'shapes train: layered calls {layered_train}'
                             f' for K1 {n_k1}, K2 {n_k2}: the wide configs '
                             'must take the layered route')
    args, cfg, params, src = _flagship_render(
        torch, np, **SHAPE_CONFIGS['wide-net'])
    k1_ms = recs['K1'][0]['ms'] * 4096 / SHAPE_RAYS
    k1, rates = slice_phase(torch, np, args, cfg, params, src, k1_ms,
                            requests=(0,), label=' (wide-net)')
    launches['wide-net']['K1'] += k1
    summary['wide-net box_rays_per_s'] = rates[0]
    del args, cfg, params, src
    if data is None:
        data = h5_arrays(synthetic_data(n_kps=LOOP_KPS, n_cams=LOOP_CAMS,
                                        H=H, W=W))
    k1, k2, rate = _shape_loop(torch, np, data)
    launches['wide-net']['K1'] += k1
    launches['wide-net']['K2'] += k2
    summary['wide-net loop rays_per_s'] = rate
    for name, n in launches.items():
        missing = [k for k, c in n.items() if c == 0
                   and not (k == 'K2 bf16' and name != 'wide-net')]
        if missing:
            raise AssertionError(f'shapes {name}: {missing} never launched '
                                 'on the main paths')
    summary['layered_calls'] = dict(fr.LAYERED_LAUNCHES)
    if fr.V1_LAUNCHES or fr.BWD_V1_LAUNCHES or fr.RAW_V1_LAUNCHES \
            or fm.V1_LAUNCHES:
        raise AssertionError('a first version ran at the new shapes')
    dt = time.perf_counter() - t0
    summary['seconds'] = dt
    summary['kernel_seconds'] = t_kernels
    print(f'shapes phase: {dt:.1f} s ({t_kernels:.1f} s of kernel checks); '
          f'launches on its main paths {launches}; layered calls '
          f'{summary["layered_calls"]}', flush=True)
    if dt > SHAPES_BUDGET_S:
        print(f'shapes phase: WARNING over its {SHAPES_BUDGET_S} s budget',
              flush=True)
    return recs, launches, summary


def _shape_rows(recs, launches):
    """The kernels line's sub-rows of phase 14: one per kernel and shape,
    with the kernel line's keys; `launches` ({config: {kernel id: n}})
    counts the phase's main paths, which run K1 and K2 at the wide
    configs; K3 and K4, and the kernel-level shapes, have none (0)."""
    ids = {'K1': ('fused_encode_mlp_pts', 'fused_render.py:677'),
           'K3': ('fused_encode_mlp', 'fused_render.py:555'),
           'K4': ('fused_mlp_apply', 'fused_mlp.py:146'),
           'K2': ('fused_bwd', 'fused_render.py:962'),
           'K2 bf16': ('fused_bwd_bf16', 'fused_render.py:962')}
    rows = []
    for kid, per in recs.items():
        name, at = ids[kid]
        for rec in per:
            layered = rec['route'] == 'layered'
            src = ('fused_render_layered_sm90.cu' if layered
                   else 'fused_render_sm90.cu')
            if kid.startswith('K2'):
                src = ('fused_render_bwd_sm90.cu (recompute: ' + src + ')')
            rows.append(dict(
                rec, name=f'{name}@{rec["shape"]}', route='cuda',
                kernel_route=rec['route'],
                source=f'anerf_torch/kernels/csrc/{src}',
                replaces=f'anerf_tpu/kernels/{at}',
                launches=launches.get(rec['shape'], {}).get(kid, 0)))
    return rows


def _ptxas_lines(log):
    """One line per kernel of nvcc's `-Xptxas -v` report: the kernel's
    name (demangled by the toolkit's cu++filt where it is found, without
    its parameter list), its registers, stack and spills."""
    import os
    import re
    import shutil

    kernels, name, spill = [], None, ''
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
        elif 'spill' in line:
            spill = line.strip()
        elif 'Used' in line and 'registers' in line:
            kernels.append((name, f'{line.split(":", 1)[-1].strip()}; '
                                  f'{spill}'))
    names = [n for n, _ in kernels]
    filt = shutil.which('cu++filt') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cu++filt')
    if os.path.exists(filt):
        out = subprocess.run([filt], input='\n'.join(names),
                             capture_output=True, text=True).stdout
        if len(out.splitlines()) == len(names):
            names = out.splitlines()
    return [f'{re.sub(r"[(][^()]*[)]$", "", n)}: {r}'
            for n, (_, r) in zip(names, kernels)]


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false; this check '
              'needs a GPU', file=sys.stderr)
        return 1
    import numpy as np

    from anerf_torch.kernels import fused_mlp as fm
    from anerf_torch.kernels import fused_render as fr

    # TF32 off, the plain branch's bf16 products summed in f32, as XLA's
    # are: resolving the card applies the settings every run on it has
    from anerf_torch import resolve_device
    resolve_device('cuda')
    print(f'torch {torch.__version__} cuda {torch.version.cuda}; '
          f'tf32 matmul={torch.backends.cuda.matmul.allow_tf32} '
          f'cudnn={torch.backends.cudnn.allow_tf32}; bf16 reduced-precision '
          f'reduction='
          f'{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}',
          flush=True)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f'card: {card}', flush=True)

    t0 = time.perf_counter()
    for name, (path, log) in fr.build_libraries().items():
        print(f'built {path.name}', flush=True)
        for line in _ptxas_lines(log):
            print(f'  ptxas: {line}', flush=True)
    print(f'build took {time.perf_counter() - t0:.1f} s; K1 runs clusters '
          f'of {fr.cluster_size()} CTAs', flush=True)
    from anerf_torch.kernels import roofline as rf
    if fr.cluster_size() != rf.K1_CLUSTER:
        raise AssertionError('roofline.K1_CLUSTER does not match the kernel')

    if '--cards' in argv:
        n = int(argv[argv.index('--cards') + 1])
        if torch.cuda.device_count() < n:
            raise AssertionError(f'--cards {n}: {torch.cuda.device_count()} '
                                 f'cards visible')
        from anerf_torch.data.fixtures import synthetic_data
        from anerf_torch.data.schema import h5_arrays
        data = h5_arrays(synthetic_data(n_kps=LOOP_KPS, n_cams=LOOP_CAMS,
                                        H=H, W=W))
        *_, dp = dp_phase(torch, np, data, None,
                          devices=[f'cuda:{i}' for i in range(n)],
                          backend='nccl')
        print('data parallel: ' + json.dumps(dp))
        print(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0
    if '--quality' in argv:
        *_, quality = quality_phase(torch, np)
        print('quality: ' + json.dumps(quality))
        print(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0
    if '--bench' in argv:
        *_, bench = bench_phase(torch, np)
        print('bench: ' + json.dumps(bench))
        print(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0
    if '--shapes' in argv:
        recs, launches, shapes = shapes_phase(torch, np)
        print('shapes: ' + json.dumps(shapes))
        print(json.dumps({'kernels': _shape_rows(recs, launches)}))
        print(card)
        print(json.dumps({'ok': True, 'device': {
            'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': torch.cuda.device_count()}}))
        return 0

    args, cfg, params, src = _flagship_render(torch, np)
    k1 = kernel_phase(torch, np, cfg, params, src)
    k2 = k2_phase(torch, np, cfg, params, src)
    k2['bf16'], k2['culled'] = k2_bf16_phase(
        torch, np, cfg, params, src, k2['launches_per_call'])
    k3, k4 = modes_phase(torch, np, cfg, params, src)
    single = single_net_phase(torch, np)
    k1d, k2d = stages_phase(torch, np, cfg, params, src)
    tool = tool_phase(torch)
    for rec, kid in ((k3, 'K3'), (k4, 'K4'), (k1d, 'K1-d'), (k2d, 'K2-d')):
        rec['launches'] = tool[kid]
    k3['v1']['launches'], k4['v1']['launches'] = tool['K3-v1'], tool['K4-v1']
    k1['single_net_max_abs_err'] = single['K1']
    k2['single_net_max_abs_err'] = single['K2']
    k2['bf16']['single_net_max_abs_err'] = single['K2-bf16']
    k3['single_net_max_abs_err'] = single['K3']
    k4['single_net_max_abs_err'] = single['K4']
    reference_check(torch, np, cfg, params, src)
    reference_check(torch, np, cfg, params, src, n_keep=8)
    # K1-v1, K2-v1, K3-v1 and K4-v1 must not run from here to the end (the
    # main paths)
    fr.V1_LAUNCHES = fr.BWD_V1_LAUNCHES = 0
    fr.RAW_V1_LAUNCHES = fm.V1_LAUNCHES = 0
    render_k1, rates = slice_phase(torch, np, args, cfg, params, src,
                                   k1['ms'])
    if '--profile' in argv:
        name, build = _requests(np, src)[1]
        data = build()
        profile_phase(torch, f'request "{name}"',
                      lambda: _render(torch, args, cfg, params, data))
    setup = _flagship_train(torch, np)
    train_reference_check(torch, np, setup)
    train_k1, train_k2, step_s, _ = train_phase(torch, np, setup,
                                                 '--profile' in argv)
    del setup

    # the culled paths: cull_ratio 0.125 (S = 8 coarse, 8 + 16 fine)
    import dataclasses
    cull_cfg = dataclasses.replace(cfg, n_keep=8)
    cull_k1, cull_rates = slice_phase(
        torch, np, args, cull_cfg, params, src, k1['culled']['ms'],
        requests=(0,), label=' (culled to 8)')
    setup = _flagship_train(torch, np, cull_ratio=0.125, fast_grads=True)
    if not (setup[1].n_keep == 8 and setup[1].eff_fast_mlp):
        raise AssertionError('the culled fast-grads config is not culled '
                             'to 8 samples with fast_grads')
    culled_k2_check(torch, np, setup)
    cull_train_k1, cull_train_k2, cull_step_s, cull_idle = train_phase(
        torch, np, setup, profile=True, n_steps=N_CULL_STEPS,
        label='culled fast-grads train')
    print(f'culled fast-grads train: median step {cull_step_s * 1e3:.2f} '
          f'ms = {setup[0].N_rand / cull_step_s:.1f} rays/s, device idle '
          f'share {cull_idle:.3f}; culled render '
          + ', '.join(f'{r:.1f}' for r in cull_rates) + ' box-rays/s',
          flush=True)

    del setup
    loop_k1, loop_k2, loop, loop_data = loop_phase(torch, np)
    entry_k1, entry = render_entry_phase(torch, np, loop_data)
    data_k1, data_k2, datasets = datasets_phase(torch, np, loop_data, cfg,
                                                params, src)
    knobs = knobs_phase(torch, np, cull_step_s)
    dp_k1, dp_k2, dp_k2b, dp = dp_phase(torch, np, loop_data, loop)
    q_k1, q_k2, q_k2b, quality = quality_phase(torch, np)
    b_k1, b_k2, bench = bench_phase(torch, np)
    shape_recs, shape_launches, shapes = shapes_phase(torch, np, loop_data)
    del loop_data

    k1['launches'] = (render_k1 + train_k1 + cull_k1 + cull_train_k1
                      + loop_k1 + entry_k1 + data_k1 + dp_k1 + q_k1 + b_k1)
    k2['launches'] = train_k2 + loop_k2 + data_k2 + dp_k2 + q_k2 + b_k2
    k1['bench_launches'], k2['bench_launches'] = b_k1, b_k2
    k2['bf16']['launches'] = cull_train_k2 + dp_k2b + q_k2b
    k1['dp_launches'], k2['dp_launches'] = dp_k1, dp_k2
    k2['bf16']['dp_launches'] = dp_k2b
    k1['quality_launches'], k2['quality_launches'] = q_k1, q_k2
    k2['bf16']['quality_launches'] = q_k2b
    k1['v1']['launches'] = fr.V1_LAUNCHES
    k2['v1']['launches'] = fr.BWD_V1_LAUNCHES
    k1['loop_launches'], k2['loop_launches'] = loop_k1, loop_k2
    k1['render_entry_launches'] = entry_k1
    k1['datasets_launches'], k2['datasets_launches'] = data_k1, data_k2
    print(f'launches on the main paths: K1 {render_k1} (render requests) + '
          f'{train_k1} (train steps) + {cull_k1} (culled request) + '
          f'{cull_train_k1} (culled train steps) + {loop_k1} (training '
          f'loop) + {entry_k1} (render entry point) + {data_k1} (dataset '
          f'types) + {dp_k1} (data parallel ranks) + {q_k1} (quality) + '
          f'{b_k1} (bench), K2 '
          f'{train_k2} (train steps) + {loop_k2} (training loop) + '
          f'{data_k2} (dataset types) + {dp_k2} (data parallel ranks) + '
          f'{q_k2} (quality) + {b_k2} (bench), K2-bf16 {cull_train_k2} '
          f'(culled train steps) '
          f'+ {dp_k2b} (data parallel ranks) + {q_k2b} (quality), K1-v1 '
          f'{fr.V1_LAUNCHES}, K2-v1 {fr.BWD_V1_LAUNCHES}, K3-v1 '
          f'{fr.RAW_V1_LAUNCHES}, K4-v1 {fm.V1_LAUNCHES}', flush=True)
    print('loop: ' + json.dumps(loop), flush=True)
    print('render entry: ' + json.dumps(entry), flush=True)
    print('datasets: ' + json.dumps(datasets), flush=True)
    print('knobs: ' + json.dumps(knobs), flush=True)
    print('data parallel: ' + json.dumps(dp), flush=True)
    print('quality: ' + json.dumps(quality), flush=True)
    print('bench: ' + json.dumps(bench), flush=True)
    print('shapes: ' + json.dumps(shapes), flush=True)
    if fr.V1_LAUNCHES or fr.BWD_V1_LAUNCHES or fr.RAW_V1_LAUNCHES \
            or fm.V1_LAUNCHES:
        raise AssertionError('a first version ran on the main path')
    k2['step_ms'] = step_s * 1e3
    k2['bf16']['step_ms'] = cull_step_s * 1e3
    k1['culled']['box_rays_per_s'] = cull_rates

    print(json.dumps({'kernels': [k1, k2, k3, k4, k1d, k2d]
                      + _shape_rows(shape_recs, shape_launches)}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
