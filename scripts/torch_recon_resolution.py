"""The whole chain's NeRF against the frame size: does the held-out PSNR
rise when the NeRF trains on the chain's own SLAM poses?

For one frame size (fx = fy = 40 * width / 64, the 48x64 walk's field of
view) it renders the seed-0 walk, runs `eval/recon_e2e.run` with the
trained weights for the refined and the plain trainer at each NeRF step
count, and, with `--control`, the same NeRF stage on the renderer's
ground-truth poses through the same export and prepare
(`recon_e2e.gt_pose_nerf`). One JSON line per run.

    python scripts/torch_recon_resolution.py --size 384 512 \
        --steps 400 1600 --control                   # the port, on the card
    python scripts/torch_recon_resolution.py --size 48 64 --device cpu
    JAX_PLATFORMS=cpu python scripts/torch_recon_resolution.py \
        --package jax --size 384 512                 # the JAX package, CPU

`--package jax` runs the JAX package's `eval/recon_e2e.run` (CPU; the
orbax checkpoint `checkpoints/synth_tpu_r3_step2000`, the renderer's
focal scaled to the frame as above). `--native FX ...` also trains
`nerf/train_native.train` at its defaults for 2000 steps on
`synth_scene(frames=16)` at the frame size with each focal given.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WEIGHTS = "weights/vonet_synth_tpu_r3_step2000.pth"
ORBAX = "checkpoints/synth_tpu_r3_step2000"


def port_runs(args, f):
    from wild_video_3d_reconstruction_torch.eval import recon_e2e
    from wild_video_3d_reconstruction_torch.nerf import train_native
    from wild_video_3d_reconstruction_torch.train.synth import \
        render_sequence

    ht, wd = args.size
    scene = render_sequence(0, frames=args.frames, ht=ht, wd=wd, fx=f, fy=f,
                            path="walk")
    for refine in (True, False):
        for steps in args.steps:
            workdir = tempfile.mkdtemp(prefix="recon_res_")
            t0 = time.perf_counter()
            rep = recon_e2e.run(params=WEIGHTS, frames=args.frames, ht=ht,
                                wd=wd, nerf_steps=steps, workdir=workdir,
                                refine=refine, device=args.device, fx=f,
                                fy=f, scene=scene)
            rep["wall_s"] = time.perf_counter() - t0
            if args.control:
                gt = recon_e2e.gt_pose_nerf(scene, workdir, refine, steps,
                                            args.device)
                rep["gt_pose_control"] = {k: gt[k]
                                          for k in ("psnr_init", "psnr")}
            print(json.dumps({"package": "port", "HxW": [ht, wd],
                              **rep}), flush=True)
    for fx in args.native:
        data = train_native.synth_scene(frames=16, ht=ht, wd=wd, fx=fx,
                                        fy=fx)
        _, rep = train_native.train(*data, log=lambda *a: None,
                                    device=args.device)
        print(json.dumps({"package": "port", "nerf_native_fx": fx,
                          "HxW": [ht, wd],
                          **{k: rep[k] for k in ("psnr_init", "psnr",
                                                 "steps")}}), flush=True)


def jax_runs(args, f):
    import jax

    import wild_video_3d_reconstruction_tpu.train.synth as synth
    from wild_video_3d_reconstruction_tpu.eval import recon_e2e
    from wild_video_3d_reconstruction_tpu.models.vonet import init_vonet
    from wild_video_3d_reconstruction_tpu.train.trainer import \
        load_checkpoint

    # recon_e2e.run renders at the renderer's default focal: scale it
    synth.render_sequence = functools.partial(synth.render_sequence, fx=f,
                                              fy=f)
    params = load_checkpoint(os.path.abspath(ORBAX),
                             init_vonet(jax.random.PRNGKey(0)))
    ht, wd = args.size
    for refine in (True, False):
        for steps in args.steps:
            t0 = time.perf_counter()
            rep = recon_e2e.run(params=params, frames=args.frames, ht=ht,
                                wd=wd, nerf_steps=steps,
                                workdir=tempfile.mkdtemp(prefix="recon_res_"),
                                refine=refine)
            rep["wall_s"] = time.perf_counter() - t0
            print(json.dumps({"package": "jax", "HxW": [ht, wd], **rep}),
                  flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=["port", "jax"], default="port")
    ap.add_argument("--size", type=int, nargs=2, default=[384, 512])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--steps", type=int, nargs="+", default=[400])
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--native", type=float, nargs="*", default=[])
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    f = 40.0 * args.size[1] / 64
    if args.package == "jax":
        jax_runs(args, f)
    else:
        port_runs(args, f)


if __name__ == "__main__":
    main()
