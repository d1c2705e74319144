"""Rendered synthetic worlds with exact ground truth (numpy only).

The port's own copy of the JAX package's `train/synth.py`: a textured
piecewise-planar world seen by a moving camera, so images, poses, the
1/4-resolution disparities and the full-resolution depth
(`_PlaneWorld._surface`) agree to machine precision; `render(occ=)` adds
an independently moving occluder disc and returns its mask. Same seeds,
same draws: the images, poses, disparities and masks equal the JAX
package's bitwise (`tests/test_torch_synth.py`).

  render_clip      a short training-style clip over slanted plane(s)
  render_sequence  a long walk / orbit / out-and-back / multi-loop
                   trajectory over a multi-plane world (the SLAM
                   evaluation input of `eval/synth_ate.py`)
  make_world_batch a batch of clips in the training step's layout
"""

from __future__ import annotations

import numpy as np


# texture rows blended at a time (elementwise, so the result does not
# depend on it): a walk of hundreds of frames at 384x512 needs textures of
# 10^8 pixels, whose float64 temporaries would otherwise take tens of GB
_TEXTURE_ROWS = 512


def _texture(rng, h, w, octaves=4):
    """Smooth multi-octave noise texture in [0, 255], [h, w, 3]."""
    img = np.zeros((h, w, 3))
    for o in range(octaves):
        s = 2 ** o
        small = rng.normal(size=(max(2, h // (4 * s)), max(2, w // (4 * s)),
                                 3))
        ys = np.linspace(0, small.shape[0] - 1, h)
        xs = np.linspace(0, small.shape[1] - 1, w)
        y0 = np.clip(ys.astype(int), 0, small.shape[0] - 2)
        x0 = np.clip(xs.astype(int), 0, small.shape[1] - 2)
        fx = (xs - x0)[None, :, None]
        for r in range(0, h, _TEXTURE_ROWS):
            yb = y0[r:r + _TEXTURE_ROWS]
            fy = (ys[r:r + _TEXTURE_ROWS] - yb)[:, None, None]
            a = small[yb][:, x0]
            b = small[yb][:, x0 + 1]
            c = small[yb + 1][:, x0]
            d = small[yb + 1][:, x0 + 1]
            layer = (1 - fy) * ((1 - fx) * a + fx * b) + \
                fy * ((1 - fx) * c + fx * d)
            img[r:r + _TEXTURE_ROWS] += layer / s
    img -= img.min()
    img /= img.max() + 1e-9
    return (img * 255).astype(np.uint8)


def _so3_exp(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _quat_from_R(R):
    """[x, y, z, w] quaternion (the layout of ops.lie poses)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
                         (R[1, 0] - R[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (R[j, i] + R[i, j]) / s
    q[k] = (R[k, i] + R[i, k]) / s
    q[3] = (R[k, j] - R[j, k]) / s
    return q if q[3] >= 0 else -q


class _PlaneWorld:
    """A piecewise-planar textured world in the frame-0 camera's
    coordinates: per pixel ray the nearest positive intersection over
    `n_planes` infinite slanted planes wins (correct visibility, zero
    holes, exact analytic depth). A single plane is a classically
    ambiguous geometry for monocular BA (the plane-induced homography
    family lets scale/z slide), so SLAM evaluation uses >= 2 planes."""

    def __init__(self, rng, ht, wd, fx, fy, tex_scale=3, n_planes=1):
        self.ht, self.wd, self.fx, self.fy = ht, wd, fx, fy
        self.cx, self.cy = wd / 2.0, ht / 2.0
        self.planes = []          # (n, dist, texture)
        self.TS = tex_scale
        self.off_u = (tex_scale - 1) // 2 * wd
        self.off_v = (tex_scale - 1) // 2 * ht
        for i in range(n_planes):
            n = np.array([rng.uniform(-0.35, 0.35),
                          rng.uniform(-0.35, 0.35), 1.0])
            n /= np.linalg.norm(n)
            dist = rng.uniform(2.0, 3.0) + 1.5 * i
            self.planes.append((n, dist,
                                _texture(rng, tex_scale * ht,
                                         tex_scale * wd)))

        vv, uu = np.mgrid[0:ht, 0:wd].astype(np.float64)
        self.rays = np.stack([(uu - self.cx) / fx, (vv - self.cy) / fy,
                              np.ones_like(uu)], -1)
        v4, u4 = np.mgrid[0:ht // 4, 0:wd // 4].astype(np.float64)
        self.rays4 = np.stack([((u4 * 4 + 2) - self.cx) / fx,
                               ((v4 * 4 + 2) - self.cy) / fy,
                               np.ones_like(u4)], -1)

    def intrinsics(self):
        return np.array([self.fx, self.fy, self.cx, self.cy], np.float32)

    def _surface(self, Rk, tk, rays):
        """Nearest-plane intersection of pixel rays of camera (Rk, tk):
        (world points, camera-k depth, winning plane index)."""
        c = -Rk.T @ tk
        d = rays @ Rk
        best_s = None
        best_i = None
        for i, (n, dist, _) in enumerate(self.planes):
            denom = d @ n
            s = np.where(denom > 1e-9, (dist - c @ n) /
                         np.where(np.abs(denom) > 1e-9, denom, 1e-9),
                         np.inf)
            s = np.where(s > 0, s, np.inf)
            if best_s is None:
                best_s, best_i = s, np.full(s.shape, i)
            else:
                best_i = np.where(s < best_s, i, best_i)
                best_s = np.minimum(s, best_s)
        best_s = np.where(np.isfinite(best_s), best_s, 1e6)
        X = c[None, None] + best_s[..., None] * d
        zk = (X @ Rk.T + tk)[..., 2]
        return X, zk, best_i

    def render(self, Rk, tk, occ=None, gain=1.0, bias=0.0):
        """(image [H,W,3] u8, disp4 [H/4,W/4]) for w2c camera (Rk, tk).

        occ: optional moving occluder disc ((cx, cy, cz) world center,
        radius, texture) on the fronto-parallel plane z = cz — an
        independently moving object: its pixels get the occluder's TRUE
        per-frame depth (per-frame-consistent geometry) but move against
        the ego-motion flow (the dynamic-object outlier real footage
        contains). gain/bias: per-frame exposure jitter.

        When occ is given, also returns mask [H, W] bool
        (True = static/usable, the `io.stream` mask convention)."""
        X, _, pid = self._surface(Rk, tk, self.rays)
        u0 = X[..., 0] / X[..., 2] * self.fx + self.cx
        v0 = X[..., 1] / X[..., 2] * self.fy + self.cy
        tu = np.clip(u0 + self.off_u, 0, self.TS * self.wd - 2)
        tv = np.clip(v0 + self.off_v, 0, self.TS * self.ht - 2)
        x0i = tu.astype(int)
        y0i = tv.astype(int)
        fu = (tu - x0i)[..., None]
        fv = (tv - y0i)[..., None]
        img = np.zeros((self.ht, self.wd, 3))
        for i, (_, _, tex) in enumerate(self.planes):
            li = ((1 - fu) * (1 - fv) * tex[y0i, x0i]
                  + fu * (1 - fv) * tex[y0i, x0i + 1]
                  + (1 - fu) * fv * tex[y0i + 1, x0i]
                  + fu * fv * tex[y0i + 1, x0i + 1])
            img = np.where((pid == i)[..., None], li, img)
        _, z4, _ = self._surface(Rk, tk, self.rays4)

        mask = None
        if occ is not None:
            (ocx, ocy, ocz), orad, otex = occ

            def occ_hit(rays, Rm, tm, z_bg):
                c = -Rm.T @ tm
                d = rays @ Rm
                s = np.where(np.abs(d[..., 2]) > 1e-9,
                             (ocz - c[2]) / np.where(
                                 np.abs(d[..., 2]) > 1e-9, d[..., 2], 1.0),
                             np.inf)
                P = c[None, None] + s[..., None] * d
                zc = (P @ Rm.T + tm)[..., 2]
                hit = ((s > 0)
                       & (np.hypot(P[..., 0] - ocx, P[..., 1] - ocy)
                          < orad)
                       & (zc < z_bg))
                return hit, P, zc

            z_bg = (X @ Rk.T + tk)[..., 2]
            hit, P, zc = occ_hit(self.rays, Rk, tk, z_bg)
            th, tw = otex.shape[:2]
            ou = np.clip(((P[..., 0] - ocx) / orad * 0.5 + 0.5) * (tw - 1),
                         0, tw - 1).astype(int)
            ov = np.clip(((P[..., 1] - ocy) / orad * 0.5 + 0.5) * (th - 1),
                         0, th - 1).astype(int)
            img = np.where(hit[..., None], otex[ov, ou], img)
            mask = ~hit
            hit4, _, zc4 = occ_hit(self.rays4, Rk, tk, z4)
            z4 = np.where(hit4, zc4, z4)

        disp4 = (1.0 / np.maximum(z4, 1e-6)).astype(np.float32)
        img = np.clip(img * gain + bias, 0, 255).astype(np.uint8)
        if occ is not None:
            return img, disp4, mask
        return img, disp4


def _pose7(Rk, tk):
    q = _quat_from_R(Rk)
    out = np.zeros(7, np.float32)
    out[:3] = tk
    out[3:] = q
    return out


def render_clip(rng, frames=6, ht=48, wd=64, fx=40.0, fy=40.0,
                n_planes=1, harden=False):
    """One clip: (images [T,H,W,3] u8, poses_w2c [T,7], disps4 [T,H/4,W/4],
    intrinsics [4]). Smooth random-walk camera over slanted plane(s); the
    constant-velocity component is drawn per clip (random direction and
    magnitude) so the learned update operator sees diverse motion stats
    instead of a fixed drift it could absorb as a prior.

    harden=True draws the in-the-wild nuisances real footage carries
    (VERDICT r2 #5): ~50% of clips get an independently moving textured
    occluder disc (ego-motion-inconsistent flow outliers) and every frame
    gets exposure jitter (gain 0.85-1.2, bias +-8)."""
    world = _PlaneWorld(rng, ht, wd, fx, fy, n_planes=n_planes)
    Rk = np.eye(3)
    tk = np.zeros(3)
    vel = rng.normal(size=3)
    vel *= rng.uniform(0.03, 0.12) / np.linalg.norm(vel)
    images = np.zeros((frames, ht, wd, 3), np.uint8)
    poses = np.zeros((frames, 7), np.float32)
    disps = np.zeros((frames, ht // 4, wd // 4), np.float32)

    occ0 = occ_vel = otex = None
    if harden and rng.random() < 0.5:
        zo = rng.uniform(1.2, 1.8)
        span = zo / fx * wd
        occ0 = np.array([rng.uniform(-0.3, 0.3) * span,
                         rng.uniform(-0.3, 0.3) * span, zo])
        occ_vel = rng.normal(0, 0.06 * span, 3) * np.array([1, 1, 0.2])
        occ_rad = rng.uniform(0.10, 0.16) * span
        otex = _texture(rng, 48, 48, octaves=3)
    for k in range(frames):
        gain, bias = (1.0, 0.0)
        if harden:
            gain = rng.uniform(0.85, 1.2)
            bias = rng.uniform(-8.0, 8.0)
        if occ0 is not None:
            occ = (tuple(occ0 + k * occ_vel), occ_rad, otex)
            images[k], disps[k], _ = world.render(Rk, tk, occ=occ,
                                                  gain=gain, bias=bias)
        else:
            images[k], disps[k] = world.render(Rk, tk, gain=gain,
                                               bias=bias)
        poses[k] = _pose7(Rk, tk)
        dR = _so3_exp(rng.normal(0, 0.02, 3))
        dt = rng.normal(0, 0.04, 3) + vel
        Rk = dR @ Rk
        tk = dR @ tk + dt
    return images, poses, disps, world.intrinsics()


def render_sequence(seed, frames=60, ht=48, wd=64, fx=40.0, fy=40.0,
                    amp=0.45, n_planes=3, path="walk"):
    """A long trajectory + multi-plane world for SLAM evaluation. Returns
    (images [T,H,W,3] u8, poses_w2c [T,7], intrinsics [4]).

    path="walk": held-out random walk from the training distribution
    (unseen seeds/scene); path="orbit": bounded sinusoidal sweep — a
    motion pattern the training clips never contain, probing
    generalization of the learned update operator; path="outback": go
    out along a smooth jittered line, turn around, and retrace the same
    waypoints — frame t and frame T-1-t observe the same 3D structure
    (with genuine parallax during the traverse), which is the geometry
    loop closure needs (`eval/loop_ate.py`)."""
    rng = np.random.default_rng(seed)
    # texture sized so a walk of `frames` steps stays on texture
    ts = 3 + 2 * (frames // 25)
    world = _PlaneWorld(rng, ht, wd, fx, fy, tex_scale=ts,
                        n_planes=n_planes)
    images = np.zeros((frames, ht, wd, 3), np.uint8)
    poses = np.zeros((frames, 7), np.float32)
    if path == "walk":
        Rk = np.eye(3)
        tk = np.zeros(3)
        vel = rng.normal(size=3)
        vel *= rng.uniform(0.03, 0.1) / np.linalg.norm(vel)
        for k in range(frames):
            images[k], _ = world.render(Rk, tk)
            poses[k] = _pose7(Rk, tk)
            dR = _so3_exp(rng.normal(0, 0.015, 3))
            Rk = dR @ Rk
            tk = dR @ tk + rng.normal(0, 0.03, 3) + vel
    elif path == "outback":
        # waypoints for the outbound half; the return half retraces them
        # in reverse so revisit pairs (t, T-t) share exact poses — the
        # pairing `eval.loop_ate.revisit_gap` measures
        half = frames // 2
        vel = np.array([0.05, 0.0, 0.01]) * (amp / 0.45)
        way_t = [np.zeros(3)]
        way_w = [np.zeros(3)]
        for k in range(1, half + 1):
            way_w.append(way_w[-1] + rng.normal(0, 0.008, 3))
            way_t.append(way_t[-1] + vel + rng.normal(0, 0.01, 3))
        for k in range(frames):
            i = k if k <= half else frames - k
            Rw = _so3_exp(way_w[i])
            images[k], _ = world.render(Rw, way_t[i])
            poses[k] = _pose7(Rw, way_t[i])
    elif path == "multiloop":
        # several laps over the SAME jittered waypoint lap: frame t and
        # frame t + lap_len observe identical structure, so every lap
        # after the first offers loop-closure revisits along its whole
        # length (the 500+-frame multi-loop soak world, VERDICT r2 #6)
        laps = max(frames // 125, 2)
        lap_len = frames // laps
        vel = np.array([0.05, 0.0, 0.01]) * (amp / 0.45)
        way_t, way_w = [np.zeros(3)], [np.zeros(3)]
        half = lap_len // 2
        for k in range(1, half + 1):      # out...
            way_w.append(way_w[-1] + rng.normal(0, 0.008, 3))
            way_t.append(way_t[-1] + vel + rng.normal(0, 0.01, 3))
        for k in range(half + 1, lap_len):  # ...and back along the lap
            way_w.append(way_w[lap_len - k])
            way_t.append(way_t[lap_len - k])
        for k in range(frames):
            i = k % lap_len
            Rw = _so3_exp(way_w[i])
            images[k], _ = world.render(Rw, way_t[i])
            poses[k] = _pose7(Rw, way_t[i])
    else:
        for k in range(frames):
            ph = 2 * np.pi * k / frames
            tk = np.array([amp * np.sin(2 * ph), 0.6 * amp * np.sin(ph),
                           0.25 * amp * np.sin(3 * ph)])
            w = np.array([0.04 * np.sin(ph + 1.0), 0.05 * np.sin(2 * ph),
                          0.03 * np.sin(ph)])
            Rk = _so3_exp(w)
            images[k], _ = world.render(Rk, tk)
            poses[k] = _pose7(Rk, tk)
    return images, poses, world.intrinsics()


def make_world_batch(seed, batch_size, tc, ht=48, wd=64, harden=False):
    """Batch of rendered clips in the training step's layout (numpy):
    images [B, T, H, W, 3] uint8, poses [B, T, 7], disps [B, T, H/4, W/4],
    intrinsics [B, 4]; T = tc.frames."""
    rng = np.random.default_rng(seed)
    ims, ps, ds, it = [], [], [], []
    for _ in range(batch_size):
        a, b, c, d = render_clip(rng, frames=tc.frames, ht=ht, wd=wd,
                                 harden=harden)
        ims.append(a)
        ps.append(b)
        ds.append(c)
        it.append(d)
    return {"images": np.stack(ims), "poses": np.stack(ps),
            "disps": np.stack(ds), "intrinsics": np.stack(it)}
