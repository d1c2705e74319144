"""Live 3D visualisation of a run: Rerun when it is installed, files
otherwise.

Counterpart of the JAX package's `utils/viz.py`. With Rerun it logs the
map's points, the trajectory as a line strip, the newest camera and its
image; without it, each update writes the map as a PLY file and the
keyframe trajectory as text under `path`, the JAX package's own choice of
output when Rerun is missing. The demo's `--viz` / `--rerun` run the
steady frames in `sync_mode`, as the JAX demo does.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


class Visualizer:
    def __init__(self, slam, path="viz_out", use_rerun=True, scale=100.0):
        self.slam = slam
        self.path = Path(path)
        self.scale = scale
        self.rr = None
        if use_rerun:
            try:
                import rerun as rr
                rr.init("DPVO Visualization")
                rr.connect()
                rr.set_time_sequence("#frame", 0)
                self.rr = rr
            except Exception:
                self.rr = None
        if self.rr is None:
            self.path.mkdir(parents=True, exist_ok=True)

    def update(self, frame_n=None, image=None):
        """Log the current map and trajectory."""
        from ..ops import lie

        slam = self.slam
        n = slam.n if frame_n is None else frame_n
        points, colors = slam.points_and_colors()
        points = points * self.scale
        poses_c2w = lie.se3_inv(
            slam.state.poses[:max(slam.n, 1)].float()).cpu().numpy()
        translations = poses_c2w[:, :3] * self.scale

        if self.rr is not None:
            rr = self.rr
            rr.set_time_sequence("#frame", n)
            rr.log("world/points", rr.Points3D(points, colors=colors))
            rr.log("world/path", rr.LineStrips3D([translations],
                                                 colors=[[255, 0, 0]]))
            if image is not None:
                rr.log("world/image", rr.Image(np.asarray(image)[..., ::-1]))
            intr = slam.state.intrinsics[0].cpu().numpy()
            rr.log(f"world/camera/{n}", rr.Pinhole(
                focal_length=float(intr[0]),
                height=slam.ht / 4, width=slam.wd / 4))
            rr.log(f"world/camera/{n}", rr.Transform3D(
                translation=translations[-1],
                rotation=rr.Quaternion(xyzw=poses_c2w[-1, 3:7]),
                scale=0.5))
        else:
            from ..io.export import save_ply
            save_ply(self.path / f"map_{n:05d}.ply", points, colors)
            np.savetxt(self.path / f"traj_{n:05d}.txt", poses_c2w)

    def final(self):
        self.update()
