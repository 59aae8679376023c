"""Where K1's time goes inside one CTA: clock stamps at its phase
boundaries, and variants of its design, on one GPU.

    python -m anerf_torch.tools.k1_phases [--variants base cl1 ...]
        [--rays 4096] [--S 64] [--source other.cu ...]
        [--modes pts raw embedded]

Builds, for each variant, a copy of csrc/fused_render_sm90.cu (and of
each `--source`, another version of the same kernel, e.g. a parent
commit's, as variant base only, and timed only if its code no longer
has the stamps' anchors) with a
clock64() stamp written by thread 0 of every CTA at each phase boundary
(the copy goes to the git-ignored anerf_torch/_build/; the port's own
library is not touched), launches it on the flagship network at random
weights and `--rays` random rays of S points, and prints per variant the
mean cycles of each phase over the CTAs, the kernel's median time and its
largest difference from K1-v1 on the same inputs (the nomma / nowait
variants compute garbage on purpose). Phases: clsync (barrier set-up,
the first cluster barrier and the register hand-over), phase_a (geometry,
window, kp bands), trunk, feat, xv (the late view-input build), view
(view layer and heads), out. `--modes` stamps the kernel in each input
mode given: pts (K1), raw (K3, on build_raw_inputs of the same points;
phase_a is its v | r staging, window and kp bands, xv its per-point view
bands) and embedded (K4, on the points' embedded inputs; phase_a and xv
are its copies), each against its first version (K1-v1, K3-v1, K4-v1).

Variants (source edits of the copy):
  base          the kernel as it is;
  cl1, cl4      clusters of 1 or 4 CTAs instead of 2;
  st2           two weight stages instead of three;
  release_cl    remote empty-barrier arrives with .release.cluster
                semantics (the first version's);
  nomma         no wgmma: the pipeline and the epilogues alone;
  nowait        no weight copies and no waits for them: the MMA on
                whatever the stages hold, at the rate the tensor cores
                and the epilogues allow;
  nomma_nowait  no wgmma, no weight copies, no waits: the skeleton.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..kernels import fused_render as fr

PHASES = ['clsync', 'phase_a', 'trunk', 'feat', 'xv', 'view', 'out']
#: lines of the kernel after which a stamp is taken, in PHASES order
ANCHORS = [
    '  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n',
    '      X0[swz(it / pad0, d.k0 + it % pad0)] = __float2bfloat16_rn(0.f);\n'
    '  }\n  consumers_sync();\n',
    '    hin = smem_u32(hout);\n  }\n',
    '    consumers_sync();   // HA is spent by both warpgroups\n  }\n',
    '    build_xv<STAGE, MODE>(X0, d, l, pts, aux, W24, row0, P, S, nfv, '
    'tid);\n  fence_async_smem();\n  consumers_sync();\n',
    '    store_heads<3>(hd, HD, wg, 0);\n    consumers_sync();\n  }\n',
    '[(TM + hr) * 4 + ho] + b_out[ho];\n',
]
_MMA = ('      wgmma<NACC>(d, gmma_desc(a + kk * 32), '
        'gmma_desc(b + kk * 32));\n')
_WAIT = '    mbar_wait(ring.full + 8 * s, (ring.it / NSTG) & 1);\n'
_PRODUCE = [('        produce<NSTG>(img, l, depth, skip, smem_u32(stage0), '
             'full, empty);\n', '        ;\n')]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    'base': [],
    'cl1': [('constexpr int CL = 2;', 'constexpr int CL = 1;')],
    'cl4': [('constexpr int CL = 2;', 'constexpr int CL = 4;')],
    'st2': [('constexpr int STAGES = 3;', 'constexpr int STAGES = 2;')],
    'release_cl': [('"mbarrier.arrive.shared::cluster.b64',
                    '"mbarrier.arrive.release.cluster.shared::cluster.b64')],
    'nomma': [(_MMA, '      ;\n')],
    'nowait': [(_WAIT, '')] + _PRODUCE,
    'nomma_nowait': [(_MMA, '      ;\n'), (_WAIT, '')] + _PRODUCE,
}
_STAMP = '  if (threadIdx.x == 0) g_stamp[blockIdx.x * 8 + {}] = clock64();\n'


def instrumented_source(variant: str, path=None, stamps: bool = True
                        ) -> str:
    """csrc/fused_render_sm90.cu (or the kernel source at `path`) with the
    variant's edits and a stamp after each of ANCHORS (and one at the
    kernel's start; with `stamps` False the stamps stay at 0). Raises if
    an edit or an anchor no longer matches the source exactly once."""
    cu = Path(path or fr._CSRC / 'fused_render_sm90.cu')
    src = cu.read_text()
    # the shared helpers beside the source (the cluster's arrives among
    # them) inline, so that a variant can edit them for K1 alone
    common = '#include "sm90_common.cuh"\n'
    if src.count(common) == 1 and (cu.parent / 'sm90_common.cuh').exists():
        src = src.replace(common, (cu.parent / 'sm90_common.cuh').read_text()
                          .replace('#pragma once\n', ''))
    for old, new in VARIANTS[variant]:
        if src.count(old) != 1:
            raise ValueError(f'{variant}: {old!r} is not in the kernel once')
        src = src.replace(old, new)
    for i, anchor in enumerate(ANCHORS if stamps else [], 1):
        if src.count(anchor) != 1:
            raise ValueError(f'anchor {i} is not in the kernel once')
        src = src.replace(anchor, anchor + _STAMP.format(i))
    head = '  extern __shared__ __align__(1024) unsigned char smem_raw[];\n'
    if src.count(head) != 1:
        raise ValueError('the kernel entry is not in the source once')
    if stamps:
        src = src.replace(head, _STAMP.format(0) + head)
    src = src.replace('namespace {\n', '__device__ long long g_stamp[1 << 20];'
                      '\n\nnamespace {\n', 1)
    return src + ('\nextern "C" int anerf_read_stamps(void* dst, size_t n) '
                  '{\n  return (int)cudaMemcpyFromSymbol(dst, g_stamp, n);\n}'
                  '\n')


def build(job: Tuple[str, str, str | None]) -> ctypes.CDLL:
    """Build (name, variant, source path or None) into _build/k1_phases."""
    name, variant, path = job
    out = fr._BUILD_DIR / 'k1_phases'
    out.mkdir(parents=True, exist_ok=True)
    cu = out / f'{name}.cu'
    try:
        text = instrumented_source(variant, path)
    except ValueError:
        if path is None:
            raise
        text = instrumented_source(variant, path, stamps=False)  # times only
    cu.write_text(text)
    lib = out / f'{name}.so'
    nvcc = os.path.join(os.environ.get('CUDA_HOME', '/usr/local/cuda'),
                        'bin', 'nvcc')
    proc = subprocess.run(
        [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
         '-O3', '-shared', '-Xcompiler', '-fPIC',
         *([f'-I{Path(path).resolve().parent}'] if path else []),
         f'-I{fr._CSRC}', '-o', str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f'nvcc failed for {variant}:\n{proc.stderr}')
    so = ctypes.CDLL(str(lib))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    # (stages, operands, P, [S,] depth, skip, widths, [fc, tau,] stream),
    # as fused_render._library declares them
    so.anerf_fused_encode_mlp_pts_sm90.argtypes = \
        [i] + [p] * 10 + [i] * 3 + [p] + [i] * 3 + [f, p]
    for entry, types in (('anerf_fused_encode_mlp_raw_sm90',
                          [i] + [p] * 8 + [i] * 2 + [p] + [i] * 3 + [f, p]),
                         ('anerf_fused_mlp_sm90',
                          [i] + [p] * 8 + [i] * 2 + [p] + [i] * 2 + [p])):
        if hasattr(so, entry):      # a --source may predate K3's and K4's
            getattr(so, entry).argtypes = types
    so.anerf_read_stamps.argtypes = [p, ctypes.c_size_t]
    return so


def _operands(dev, R, S, seed=1):
    """K1's operands of R random rays of S points, and the same points'
    K3 rows (build_raw_inputs)."""
    from ..ops.rotations import axisang_to_rot
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    skts = torch.zeros((R, 24, 4, 4), device=dev)
    skts[..., :3, :3] = axisang_to_rot(t(rng.normal(size=(R, 24, 3))))
    skts[..., :3, 3] = t(rng.normal(size=(R, 24, 3)) * 0.3)
    skts[..., 3, 3] = 1.0
    rays_d, fc = t(rng.normal(size=(R, 1, 3))), t(rng.normal(size=(R, 16)))
    m_all, aux = fr.pack_ray_data(rays_d, skts, fc)
    pts = t(rng.normal(size=(R, S, 3)) * 0.4)
    return pts, m_all, aux, fr.build_raw_inputs(pts, rays_d, skts, fc)


def _launchers(mode, ncfg, packed, pts, m_all, aux, x_raw, S, out,
               stages=fr.SM90_STAGES):
    """(entry point name, its arguments, the first version's output, the
    tensors the arguments point into) of K1 (pts), K3 (raw) or K4
    (embedded) on the same points, with `stages` weight stages."""
    from ..kernels import fused_mlp as fm
    tau, stream = 2000.0, torch.cuda.current_stream().cuda_stream
    heads = (packed['b'].data_ptr(), packed['w_rgb'].data_ptr(),
             packed['w_alpha'].data_ptr(), packed['b_out'].data_ptr())
    P, sk = pts.shape[0] * S, packed['skip'].data_ptr()
    if mode == 'pts':
        return ('anerf_fused_encode_mlp_pts_sm90', (
            stages, pts.data_ptr(), m_all.data_ptr(), aux.data_ptr(),
            packed['img'].data_ptr(), *heads, packed['cut'].data_ptr(),
            out.data_ptr(), P, S, ncfg.depth, sk, 7, 4, packed['fc'], tau,
            stream),
            fr.fused_encode_mlp_pts_v1(ncfg, packed, pts, m_all, aux, S,
                                       tau), ())
    if mode == 'raw':
        return ('anerf_fused_encode_mlp_raw_sm90', (
            stages, x_raw.data_ptr(), packed['img'].data_ptr(), *heads,
            packed['cut'].data_ptr(), out.data_ptr(), P, ncfg.depth, sk, 7,
            4, packed['fc'], tau, stream),
            fr.fused_encode_mlp_v1(ncfg, packed, x_raw, tau), ())
    k0, kv = fm.kernel_widths(ncfg)
    x0, xv = fr._encode(packed, pts, m_all, aux, S, tau)
    bf = torch.bfloat16
    x0 = x0[..., :k0].reshape(P, k0).to(bf).contiguous()
    xv = xv[..., :kv].reshape(P, kv).to(bf).contiguous()
    return ('anerf_fused_mlp_sm90', (
        stages, x0.data_ptr(), xv.data_ptr(), packed['img'].data_ptr(),
        *heads, out.data_ptr(), P, ncfg.depth, sk, k0, kv, stream),
        fm.fused_mlp_apply_v1(ncfg, packed, x0, xv).reshape(out.shape),
        (x0, xv))


def run(variants, n_rays: int = 4096, S: int = 64, reps: int = 9,
        sources=(), modes=('pts',)):
    from ..models.nerf import NeRFConfig, init_nerf_params
    if not torch.cuda.is_available():
        raise RuntimeError('k1_phases needs a CUDA device')
    dev = torch.device('cuda')
    jobs = [(v, v, None) for v in variants] + [
        (f'base@{Path(p).name}', 'base', p) for p in sources]
    with ThreadPoolExecutor(len(jobs)) as pool:
        libs = dict(zip([j[0] for j in jobs], pool.map(build, jobs)))
    ncfg = NeRFConfig(depth=8, width=256, input_ch=360, input_ch_bones=72,
                      input_ch_views=648, use_framecode=True,
                      framecode_ch=16, n_framecodes=4)
    params = init_nerf_params(ncfg, torch.Generator().manual_seed(0), dev)
    packed = fr.pack_render_params(params, ncfg, 7, 4,
                                   torch.full((24,), 0.5, device=dev))
    pts, m_all, aux, x_raw = _operands(dev, n_rays, S)
    out = torch.empty((n_rays, S, 4), device=dev)
    n_cta = -(-n_rays * S // 64)
    rows = []
    for (name, lib), mode in [(nl, m) for m in modes for nl in libs.items()]:
        # `inputs` holds the tensors `args` points into while they launch
        entry, args, v1, inputs = _launchers(
            mode, ncfg, packed, pts, m_all, aux, x_raw, S, out,
            2 if name == 'st2' else fr.SM90_STAGES)
        if not hasattr(lib, entry):
            continue
        if mode != 'pts':
            name = f'{name}:{mode}'
        times = []
        for _ in range(reps):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            if getattr(lib, entry)(*args):
                raise RuntimeError(f'{name}: launch failed')
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        stamps = np.zeros(n_cta * 8, np.int64)
        if lib.anerf_read_stamps(stamps.ctypes.data, stamps.nbytes):
            raise RuntimeError(f'{name}: reading the stamps failed')
        st = stamps.reshape(n_cta, 8).astype(np.float64)
        cycles = np.diff(st, axis=1).mean(0)
        row = {'variant': name, 'ms': sorted(times)[reps // 2],
               'max_abs_vs_v1': (out - v1).abs().max().item(),
               'cycles': None, 'cycles_total': None}
        if st.any():     # a --source whose anchors differ is only timed
            row['cycles'] = dict(zip(PHASES, (round(c) for c in cycles)))
            row['cycles_total'] = round(float((st[:, 7] - st[:, 0]).mean()))
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--variants', nargs='+', default=list(VARIANTS),
                    choices=list(VARIANTS))
    ap.add_argument('--rays', type=int, default=4096)
    ap.add_argument('--S', type=int, default=64)
    ap.add_argument('--source', nargs='*', default=[],
                    help='other versions of csrc/fused_render_sm90.cu')
    ap.add_argument('--modes', nargs='+', default=['pts'],
                    choices=['pts', 'raw', 'embedded'],
                    help='input modes: K1 (pts), K3 (raw), K4 (embedded)')
    a = ap.parse_args(argv)
    from ..utils.device import card_line
    print(f'card: {card_line()}', flush=True)
    run(a.variants, a.rays, a.S, sources=a.source, modes=a.modes)
    return 0


if __name__ == '__main__':
    sys.exit(main())
