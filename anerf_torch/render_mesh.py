"""Turntable-render extracted .ply meshes (torch port of render_mesh.py,
the reference's render_mesh CLI; numpy, no device):

  python -m anerf_torch.render_mesh --expname m1 --basedir render_output/

Drop-in flag compatibility with the reference: --expname/--basedir
locate `<basedir>/<expname>/meshes/*.ply` and write to
`<basedir>/<expname>/mesh_render/`; --mesh_ind renders one mesh,
--skip subsamples; -ww/-hh set the image size (the software rasterizer
renders square frames at max(ww, hh)). Our additions: --mesh_dir /
--outputdir override the derived paths, --step_deg / --fps control the
turntable, and an .mp4 is written next to the jpgs.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('-ww', '--width', type=int, default=512)
    p.add_argument('-hh', '--height', type=int, default=512)
    p.add_argument('--expname', type=str, default='mesh')
    p.add_argument('--basedir', type=str, default='render_output/')
    p.add_argument('--mesh_ind', type=int, default=None,
                   help='render only the mesh at this index')
    p.add_argument('--skip', type=int, default=1,
                   help='render every skip-th mesh')
    p.add_argument('--mesh_dir', type=str, default=None,
                   help='.ply directory (default <basedir>/<expname>/meshes)')
    p.add_argument('--outputdir', type=str, default=None,
                   help='default <basedir>/<expname>/mesh_render')
    p.add_argument('--res', type=int, default=None,
                   help='square render resolution (overrides -ww/-hh)')
    p.add_argument('--step_deg', type=float, default=4.0)
    p.add_argument('--fps', type=int, default=14)
    args = p.parse_args(argv)

    import imageio

    from anerf_torch.utils.marching import load_ply
    from anerf_torch.utils.mesh_render import render_turntable

    mesh_dir = args.mesh_dir or os.path.join(args.basedir, args.expname,
                                             'meshes')
    outdir = args.outputdir or os.path.join(args.basedir, args.expname,
                                            'mesh_render')
    res = args.res or max(args.width, args.height)
    os.makedirs(outdir, exist_ok=True)

    ply_files = sorted(glob.glob(os.path.join(mesh_dir, '*.ply')))
    if args.mesh_ind is not None:
        ply_files = ply_files[args.mesh_ind:args.mesh_ind + 1]
    else:
        ply_files = ply_files[::args.skip]
    if not ply_files:
        raise SystemExit(f'no .ply meshes under {mesh_dir}')

    for ply in ply_files:
        name = os.path.splitext(os.path.basename(ply))[0]
        verts, faces = load_ply(ply)
        frames = render_turntable(verts, faces, step_deg=args.step_deg,
                                  res=res)
        for i, f in enumerate(frames):
            imageio.imwrite(os.path.join(outdir, f'{name}_{i:03d}.jpg'),
                            (np.clip(f, 0, 1) * 255).astype(np.uint8))
        try:
            imageio.mimwrite(os.path.join(outdir, f'{name}.mp4'),
                             (np.clip(frames, 0, 1) * 255).astype(np.uint8),
                             fps=args.fps)
        except Exception as e:
            print(f'video write skipped: {e}')
        print(f'{name}: {len(frames)} views -> {outdir}')


if __name__ == '__main__':
    main()
