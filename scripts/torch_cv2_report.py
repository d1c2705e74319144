"""What OpenCV can do on this machine, for the port's cv2 paths.

Prints one JSON line with:

- `cv2.__version__` and the "Video I/O" lines of its build information;
- whether `cv2.imencode(".jpg", ..., JPEG quality 95)` and `cv2.imdecode`
  round-trip a rendered 384x512 frame (bytes, largest and mean pixel
  change): the loop closure's keyframe cache;
- whether `cv2.undistort` runs with the TUM fr1 calibration on a 480x640
  frame, and the share of pixels it changes: the TUM / EuRoC streams;
- whether `cv2.VideoWriter` writes an `.mp4` ("mp4v") that
  `cv2.VideoCapture` opens and reads back, with the backend it used:
  the demo's video input.

With `--demo` it also runs the port's demo (`demo.run`, configs/fast.yaml,
the trained weights) on a directory of JPEG frames (with a calibration
that has distortion terms, so the frames are undistorted on the way in)
and on the `.mp4`, over the seed-0 walk rendered at 384x512 (fx = fy =
320), and prints each run's frames, seconds and Sim(3) ATE against the
renderer's ground truth beside the identity floor.

    python scripts/torch_cv2_report.py [--demo] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402

WEIGHTS = "weights/vonet_synth_tpu_r3_step2000.pth"
HT, WD, FX = 384, 512, 320.0
FRAMES = 24
# a mild barrel distortion for the JPEG run (k1, k2, p1, p2)
DISTORTION = (0.02, -0.01, 0.0, 0.0)


def video_io_lines(cv2):
    info = cv2.getBuildInformation().splitlines()
    out, on = [], False
    for line in info:
        if line.strip().startswith("Video I/O"):
            on = True
            continue
        if on:
            if line.strip() == "" or not line.startswith("    "):
                break
            out.append(" ".join(line.split()))
    return out


def report(frame, workdir):
    import cv2

    from wild_video_3d_reconstruction_torch.eval import harness

    rec = {"cv2_version": cv2.__version__, "video_io": video_io_lines(cv2)}
    ok, enc = cv2.imencode(".jpg", frame, [cv2.IMWRITE_JPEG_QUALITY, 95])
    dec = cv2.imdecode(enc, cv2.IMREAD_COLOR) if ok else None
    diff = np.abs(dec.astype(int) - frame) if dec is not None else None
    rec["jpeg95"] = dict(
        encoded=bool(ok), bytes=int(enc.size) if ok else 0,
        decoded_shape=list(dec.shape) if dec is not None else None,
        max_abs_change=int(diff.max()) if diff is not None else None,
        mean_abs_change=float(diff.mean()) if diff is not None else None)

    calib = harness.TUM_FR1_CALIB
    fx, fy, cx, cy = calib[:4]
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    big = cv2.resize(frame, (640, 480), interpolation=cv2.INTER_LINEAR)
    und = cv2.undistort(big, K, calib[4:])
    rec["undistort_tum_fr1"] = dict(
        shape=list(und.shape),
        changed_share=float((und != big).any(-1).mean()))

    path = os.path.join(workdir, "clip.mp4")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (frame.shape[1], frame.shape[0]))
    opened_w = bool(writer.isOpened())
    for _ in range(4):
        writer.write(frame)
    writer.release()
    cap = cv2.VideoCapture(path)
    opened_r = bool(cap.isOpened())
    backend = cap.getBackendName() if opened_r else None
    n, shape = 0, None
    while True:
        ret, img = cap.read()
        if not ret:
            break
        n, shape = n + 1, list(img.shape)
    cap.release()
    rec["mp4"] = dict(writer_opened=opened_w, bytes=os.path.getsize(path)
                      if os.path.exists(path) else 0,
                      capture_opened=opened_r, backend=backend,
                      frames_read=n, frame_shape=shape)
    return rec


def demo_runs(workdir, device):
    """The demo over a JPEG directory and over an .mp4 of the walk."""
    import cv2

    from wild_video_3d_reconstruction_torch import demo
    from wild_video_3d_reconstruction_torch.eval import synth_ate
    from wild_video_3d_reconstruction_torch.train.synth import \
        render_sequence
    from wild_video_3d_reconstruction_torch.utils.config import load_config

    images, poses_gt, intr = render_sequence(0, frames=FRAMES, ht=HT, wd=WD,
                                             fx=FX, fy=FX)
    jpgdir = os.path.join(workdir, "jpg")
    os.makedirs(jpgdir)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    mp4 = os.path.join(workdir, "walk.mp4")
    writer = cv2.VideoWriter(mp4, cv2.VideoWriter_fourcc(*"mp4v"), 10.0,
                             (WD, HT))
    # distorted frames, so that undistorting with DISTORTION gives the
    # frame back (up to resampling): each distorted pixel samples the frame
    # where cv2.undistortPoints sends it
    pts = np.stack(np.meshgrid(np.arange(WD, dtype=np.float32),
                               np.arange(HT, dtype=np.float32)), -1)
    und = cv2.undistortPoints(pts.reshape(-1, 1, 2), K, np.array(DISTORTION),
                              P=K).reshape(HT, WD, 2)
    for t in range(FRAMES):
        bgr = np.ascontiguousarray(images[t][..., ::-1])
        dist = cv2.remap(bgr, und[..., 0], und[..., 1], cv2.INTER_LINEAR,
                         borderMode=cv2.BORDER_REFLECT)
        cv2.imwrite(os.path.join(jpgdir, f"{t:06d}.jpg"), dist,
                    [cv2.IMWRITE_JPEG_QUALITY, 95])
        writer.write(bgr)
    writer.release()
    cfg = load_config("configs/fast.yaml", MOTION_PROBE_THRESH=0.0)
    out = {}
    for name, src, calib in (
            ("jpeg_dir", jpgdir, np.concatenate([intr, DISTORTION])),
            ("mp4", mp4, np.asarray(intr, np.float64))):
        t0 = time.perf_counter()
        poses, tstamps, _ = demo.run(
            cfg, WEIGHTS, src, calib, path=os.path.join(workdir, name),
            save_trajectory=True, device=device)
        seconds = time.perf_counter() - t0
        ate, n, floor = synth_ate.ate_against(
            poses, tstamps, poses_gt[:len(poses)])
        out[name] = dict(frames=len(poses), seconds=seconds,
                         ate_rmse=ate, ate_floor_identity=floor,
                         finite=bool(np.isfinite(poses).all()))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from wild_video_3d_reconstruction_torch.train.synth import \
        render_sequence

    frame = np.ascontiguousarray(render_sequence(
        0, frames=1, ht=HT, wd=WD, fx=FX, fy=FX)[0][0][..., ::-1])
    with tempfile.TemporaryDirectory() as workdir:
        rec = report(frame, workdir)
        if args.demo:
            rec["demo"] = demo_runs(workdir, args.device)
    print(json.dumps({"metric": "cv2_report", **rec}), flush=True)
    return rec


if __name__ == "__main__":
    main()
