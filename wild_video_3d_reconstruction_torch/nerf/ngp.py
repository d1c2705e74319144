"""Instant-NGP radiance field: multiresolution hash encoding, two small
MLPs, volume rendering, and the Adam split the field trains with.

The port's copy of the JAX package's `nerf/ngp.py`, in plain PyTorch (the
JAX module is plain XLA too: it reaches no Pallas kernel). The field is an
`nn.Module` (`NGPField`: the hash table `[L, T, F]` as one parameter, the
five dense layers as `w [n_in, n_out]` and `b`, the level resolutions as a
buffer); `field_from_numpy` carries a JAX field's weights across. The
random draws of the renderers (stratified jitter, the importance samples'
uniforms) are either passed in (the parity tests pass the JAX package's)
or drawn from a `torch.Generator`.

On the card the table's gradient is a scatter-add (the adjoint of the
corner gathers) whose fp32 atomics sum in no fixed order: two card runs
differ at rounding, so card and CPU agree within a tolerance, never
bitwise.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

# large primes for spatial hashing (instant-ngp's choice of coprimes)
_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF


def level_resolutions(levels, base_res, max_res):
    """The static per-level grid resolutions (int32 numpy)."""
    if levels > 1:
        growth = float(np.exp(np.log(max_res / base_res) / (levels - 1)))
    else:
        growth = 1.0
    return np.floor(base_res * growth ** np.arange(levels)).astype(np.int32)


def hash_grid_init(generator=None, levels=8, table_size=2 ** 14, features=2,
                   base_res=16, max_res=256):
    """Per-level hash tables [L, T, F] (uniform in +-1e-4 like instant-ngp,
    from `generator`) and the level resolutions (int32)."""
    table = torch.rand((levels, table_size, features), generator=generator)
    table = table * 2e-4 - 1e-4
    res = torch.from_numpy(level_resolutions(levels, base_res, max_res))
    return table, res


def _hash_mul(c, prime):
    """uint32 c * prime, wrapped, in int64: the JAX package multiplies
    uint32 corner coordinates by primes of which one (2654435761) is above
    2^31 and relies on the wrap-around. Masking before and after the
    product keeps the low 32 bits, which the xor and `% T` then act on (the
    product of two 32-bit values can pass 2^63, where int64 wraps in two's
    complement and the low 32 bits are still right)."""
    return ((c & _MASK32) * prime) & _MASK32


def _hash(corner_idx, table_size):
    """Spatial hash of integer corner coords [..., 3] -> [0, T) (int64)."""
    c = corner_idx.long()
    h = _hash_mul(c[..., 0], _PRIMES[0]) ^ _hash_mul(c[..., 1], _PRIMES[1]) \
        ^ _hash_mul(c[..., 2], _PRIMES[2])
    return h % table_size


class _Rows(torch.autograd.Function):
    """rows[idx] of a [R, F] table; the adjoint adds the output's
    gradient into a zero table with `index_add_` (fp32 atomics on the
    card, so two card runs sum in different orders)."""

    @staticmethod
    def forward(ctx, rows, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = rows.shape[0]
        return rows[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        F = grad.shape[-1]
        out = torch.zeros((ctx.n_rows, F), dtype=grad.dtype,
                          device=grad.device)
        return out.index_add_(0, idx.reshape(-1), grad.reshape(-1, F)), None


def hash_encode(x, table, level_res):
    """Multiresolution hash encoding of points `x` in [0, 1]^3.

    x: [..., 3]; table: [L, T, F]; returns [..., L*F], the trilinear blend
    of the 8 hashed corner features at each level, in the JAX package's
    order (corners summed 0..7, features level-major)."""
    L, T, F = table.shape
    lead = x.shape[:-1]
    xf = x.reshape(-1, 3)                                   # [N, 3]
    N = xf.shape[0]

    res = level_res.to(xf.dtype) - 1.0                      # [L]
    xs = xf.T[:, None, :] * res[None, :, None]              # [3, L, N]
    x0 = torch.floor(xs)
    frac = xs - x0
    x0 = x0.long()
    # per axis, the hashes and weights of its two corners: [3, 2, L, N]
    corner = torch.stack([x0, x0 + 1], 1)
    primes = torch.tensor(_PRIMES, device=x.device)[:, None, None, None]
    hashed = _hash_mul(corner, primes)
    weight = torch.stack([1.0 - frac, frac], 1)
    # corner c = (i, j, k) at [i, j, k]: x's offset i, y's j, z's k
    h = hashed[0][:, None, None] ^ hashed[1][None, :, None] \
        ^ hashed[2][None, None, :]                          # [2, 2, 2, L, N]
    # (1 * w0) * w1 * w2, the JAX package's product order
    w = weight[0][:, None, None] * weight[1][None, :, None] \
        * weight[2][None, None, :]
    base = (torch.arange(L, device=x.device) * T)[:, None]  # [L, 1]
    f = _Rows.apply(table.reshape(L * T, F), base + h % T)  # [2,2,2,L,N,F]
    # the 8 corners summed in the JAX package's order (0 .. 7)
    out = (w[..., None] * f).reshape(8, L, N, F).sum(0)
    return out.permute(1, 0, 2).reshape(*lead, L * F)


def sh_encode(d):
    """Real spherical harmonics basis up to degree 3 (16 coeffs) of unit
    directions [..., 3]: the view-direction encoding instant-ngp uses."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.48860251190291987 * y,
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)


def rodrigues(w):
    """so(3) exponential: axis-angle [..., 3] -> rotation [..., 3, 3]
    (Taylor-guarded; used for pose refinement)."""
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-12
    # double-where: the untaken branch must see a benign theta or its
    # cotangent is 0 * inf = NaN at w == 0
    safe2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe2)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / safe2)
    zeros = torch.zeros_like(w[..., 0])
    K = torch.stack([
        torch.stack([zeros, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], zeros, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], zeros], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def contract(x):
    """mipnerf-360 scene contraction: R^3 -> ball of radius 2. Points
    inside the unit ball are unchanged; outside, radius r maps to
    2 - 1/r, so unbounded backgrounds land at finite grid coordinates."""
    r = torch.linalg.norm(x, dim=-1, keepdim=True)
    rs = torch.clamp(r, min=1e-6)
    return torch.where(r <= 1.0, x, (2.0 - 1.0 / rs) * x / rs)


class Dense(nn.Module):
    """x @ w + b with w [n_in, n_out] (the JAX layout), w uniform in
    +-sqrt(1 / n_in), b zero."""

    def __init__(self, n_in, n_out, generator=None):
        super().__init__()
        k = float(np.sqrt(1.0 / n_in))
        self.w = nn.Parameter(
            torch.rand((n_in, n_out), generator=generator) * (2 * k) - k)
        self.b = nn.Parameter(torch.zeros(n_out))

    def forward(self, x):
        return x @ self.w + self.b


class NGPField(nn.Module):
    """The radiance field's parameters (JAX `field_init`; `field_query`
    evaluates it): the hash table [L, T, F], the density MLP (sigma1,
    sigma2: 1 density + geo_feat features) and the color MLP (rgb1..3 over
    the SH view encoding, the geo features and an optional per-image
    appearance embedding of app_dim)."""

    def __init__(self, levels=8, table_size=2 ** 14, features=2, base_res=16,
                 max_res=256, hidden=64, geo_feat=15, app_dim=0,
                 generator=None):
        super().__init__()
        table, res = hash_grid_init(generator, levels, table_size, features,
                                    base_res, max_res)
        self.table = nn.Parameter(table)
        self.register_buffer("level_res", res)
        enc = levels * features
        self.sigma1 = Dense(enc, hidden, generator)
        self.sigma2 = Dense(hidden, 1 + geo_feat, generator)
        self.rgb1 = Dense(16 + geo_feat + app_dim, hidden, generator)
        self.rgb2 = Dense(hidden, hidden, generator)
        self.rgb3 = Dense(hidden, 3, generator)
        self.app_dim = app_dim


class RefinedField(nn.Module):
    """What the refined trainer learns: the field plus, per training
    image, an appearance embedding and an SE(3) pose delta (axis-angle
    `pose_w`, translation `pose_t`, in the normalized scene)."""

    def __init__(self, field, n_train):
        super().__init__()
        self.field = field
        self.app = nn.Parameter(torch.zeros(n_train, field.app_dim))
        self.pose_w = nn.Parameter(torch.zeros(n_train, 3))
        self.pose_t = nn.Parameter(torch.zeros(n_train, 3))


_DENSE = ("sigma1", "sigma2", "rgb1", "rgb2", "rgb3")


def field_from_numpy(params, static, device="cuda"):
    """A JAX field's weights as a port module: `params` is the JAX
    pytree of numpy arrays (`table` [L, T, F], each dense layer's `w`
    [n_in, n_out] and `b`), `static` its `{"level_res": ...}`. With the
    refined trainer's pytree (`field`, `app`, `pose_w`, `pose_t`) the
    result is a `RefinedField`."""
    if "field" in params:
        field = field_from_numpy(params["field"], static, device)
        out = RefinedField(field, np.asarray(params["app"]).shape[0])
        with torch.no_grad():
            for k in ("app", "pose_w", "pose_t"):
                getattr(out, k).copy_(torch.from_numpy(
                    np.asarray(params[k], np.float32)))
        return out.to(device)
    L, T, F = np.asarray(params["table"]).shape
    hidden = np.asarray(params["sigma1"]["w"]).shape[1]
    geo = np.asarray(params["sigma2"]["w"]).shape[1] - 1
    app = np.asarray(params["rgb1"]["w"]).shape[0] - 16 - geo
    field = NGPField(L, T, F, hidden=hidden, geo_feat=geo, app_dim=app)
    state = {"table": params["table"],
             "level_res": np.asarray(static["level_res"], np.int32)}
    for k in _DENSE:
        state[f"{k}.w"] = params[k]["w"]
        state[f"{k}.b"] = params[k]["b"]
    field.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in state.items()})
    return field.to(device)


def field_query(field, x, d, app=None):
    """(sigma [...], rgb [..., 3]) at points x in [0, 1]^3 with unit view
    directions d; `app`: optional per-point appearance embedding."""
    h = hash_encode(x, field.table, field.level_res)
    h = torch.relu(field.sigma1(h))
    h = field.sigma2(h)
    # truncated-exp density activation (exp clipped for fp stability)
    sigma = torch.exp(torch.clamp(h[..., 0], -15.0, 15.0))
    geo = h[..., 1:]
    parts = [sh_encode(d), geo]
    if app is not None:
        parts.append(app)
    c = torch.cat(parts, dim=-1)
    c = torch.relu(field.rgb1(c))
    c = torch.relu(field.rgb2(c))
    rgb = torch.sigmoid(field.rgb3(c))
    return sigma, rgb


def as_device(x, device, dtype=torch.float32):
    """A tensor or an array (copied: it may be read-only) on `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def _uniform(shape, u, generator, device):
    """The injected uniforms `u`, or a fresh draw of `shape`."""
    if u is not None:
        return as_device(u, device)
    return torch.rand(shape, generator=generator, device=device)


def render_rays(field, origins, dirs, generator=None, n_samples=64,
                near=0.05, far=3.0, bg=1.0, stratified=True, jitter=None):
    """Volume-render a batch of rays [B, 3] -> (rgb [B, 3], depth [B],
    acc [B]). Fixed `n_samples` points per ray, jittered within their
    spacing by `jitter` [B, S] uniforms (drawn from `generator` when not
    given) when stratified; exclusive-transmittance compositing."""
    B = origins.shape[0]
    t = torch.linspace(near, far, n_samples, device=origins.device)
    t = t.expand(B, n_samples)
    if stratified:
        dt = (far - near) / (n_samples - 1)
        t = t + _uniform((B, n_samples), jitter, generator,
                         origins.device) * dt
    pts = origins[:, None] + t[..., None] * dirs[:, None]   # [B, S, 3]
    pts = torch.clamp(pts, 0.0, 1.0)
    sigma, rgb = field_query(field, pts, dirs[:, None].expand(pts.shape))
    rgb_out, depth, acc, _ = _composite(sigma, rgb, t, far - near, bg)
    return rgb_out, depth, acc


def _composite(sigma, rgb, t, tail_delta, bg):
    """Exclusive-transmittance alpha compositing over samples t [B, S]."""
    tt = torch.cat([t, t[:, -1:] + tail_delta], dim=-1)     # jnp.diff(append=)
    delta = tt[:, 1:] - tt[:, :-1]
    alpha = 1.0 - torch.exp(-sigma * delta)
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    trans = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]],
                      dim=-1)                               # exclusive
    w = alpha * trans                                       # [B, S]
    acc = torch.sum(w, dim=-1)
    rgb_out = torch.sum(w[..., None] * rgb, dim=1) + (1.0 - acc[:, None]) * bg
    depth = torch.sum(w * t, dim=-1)
    return rgb_out, depth, acc, w


def _sample_pdf(t, weights, n, generator=None, u=None):
    """Inverse-CDF importance sampling of `n` new depths per ray from the
    piecewise-constant weight histogram over sorted sample depths t [B, S]
    (the NeRF fine-sampling rule). `u` [B, n] are the uniforms (drawn from
    `generator` when not given); ray b's k-th sample lands at the
    (k + u[b, k]) / n quantile."""
    B, S = t.shape
    mid = 0.5 * (t[:, 1:] + t[:, :-1])                      # [B, S-1]
    edges = torch.cat([t[:, :1], mid, t[:, -1:]], -1)       # [B, S+1]
    w = weights + 1e-5
    pdf = w / torch.sum(w, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros((B, 1), dtype=t.dtype, device=t.device),
                     torch.cumsum(pdf, dim=-1)], -1)        # [B, S+1]
    q = (torch.arange(n, device=t.device)
         + _uniform((B, n), u, generator, t.device)) / n
    idx = torch.searchsorted(cdf.contiguous(), q.contiguous(), right=True)
    below = torch.clamp(idx - 1, 0, S)
    above = torch.clamp(idx, 0, S)
    g = torch.gather
    c_below, c_above = g(cdf, -1, below), g(cdf, -1, above)
    denom = torch.clamp(c_above - c_below, min=1e-8)
    frac = (q - c_below) / denom
    e_below = g(edges, -1, below)
    return e_below + frac * (g(edges, -1, above) - e_below)


def render_rays_hier(field, origins, dirs, generator=None, n_coarse=32,
                     n_fine=32, near=0.05, far=3.0, bg=1.0, app=None,
                     contraction=False, stratified=True, u_coarse=None,
                     u_fine=None):
    """Hierarchical volume rendering: a coarse stratified pass places a
    second, importance-sampled pass where the mass is (one shared field,
    queried twice). `u_coarse` [B, n_coarse] jitters the coarse samples
    (when stratified), `u_fine` [B, n_fine] places the fine ones; either
    is drawn from `generator` when not given.

    contraction=True treats (origins, dirs) as normalized world coords
    (cameras inside the unit ball), samples linear in disparity out to
    `far`, and maps points through the mipnerf-360 contraction into the
    hash grid's [0, 1]^3 domain.
    """
    B = origins.shape[0]
    dev = origins.device
    if stratified:
        # jitter within each stratum, keeping s in [0, 1): linspace + u/n
        # would push the last sample past 1, which in contraction mode
        # crosses the 1/t disparity pole
        s = (torch.arange(n_coarse, device=dev)
             + _uniform((B, n_coarse), u_coarse, generator, dev)) / n_coarse
    else:
        s = torch.linspace(0.0, 1.0, n_coarse, device=dev).expand(
            B, n_coarse)
    if contraction:                     # linear in disparity
        t_c = 1.0 / (1.0 / near * (1.0 - s) + 1.0 / far * s)
    else:
        t_c = near + (far - near) * s

    def to_grid(pts):
        if contraction:
            return contract(pts) / 4.0 + 0.5
        return torch.clamp(pts, 0.0, 1.0)

    def query(t):
        pts = origins[:, None] + t[..., None] * dirs[:, None]
        d = dirs[:, None].expand(pts.shape)
        a = None if app is None else \
            app[:, None].expand(*t.shape, app.shape[-1])
        return field_query(field, to_grid(pts), d, a)

    sigma_c, rgb_c = query(t_c)
    _, _, _, w_c = _composite(sigma_c, rgb_c, t_c, far - near, bg)

    t_f = _sample_pdf(t_c, w_c.detach(), n_fine, generator, u_fine)
    t = torch.sort(torch.cat([t_c, t_f], dim=-1), dim=-1).values
    sigma, rgb = query(t)
    rgb_out, depth, acc, _ = _composite(sigma, rgb, t, far - near, bg)
    return rgb_out, depth, acc


class Adam:
    """optax's `multi_transform` of `adam`s, written out: each group is
    (parameters, learning rate or schedule of the update count, b1, b2,
    eps); the update is optax's, in its order of operations and in fp32:
    the moments (1 - b) * g + b * m, their bias corrections at count + 1,
    m_hat / (sqrt(v_hat) + eps), times -lr(count), added to the parameter.
    The scalars are Python floats (no copy to the device per parameter)."""

    def __init__(self, groups):
        self.groups = [(list(ps), lr, b1, b2, eps)
                       for ps, lr, b1, b2, eps in groups]
        self.count = 0
        self.mu = [[torch.zeros_like(p) for p in g[0]] for g in self.groups]
        self.nu = [[torch.zeros_like(p) for p in g[0]] for g in self.groups]

    @property
    def params(self):
        return [p for g in self.groups for p in g[0]]

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self):
        f32 = np.float32
        count = self.count
        self.count += 1
        for (ps, lr, b1, b2, eps), mus, nus in zip(self.groups, self.mu,
                                                   self.nu):
            rate = lr(count) if callable(lr) else lr
            neg_lr = float(-f32(rate))
            bc1 = float(f32(1) - f32(b1) ** f32(self.count))
            bc2 = float(f32(1) - f32(b2) ** f32(self.count))
            for p, mu, nu in zip(ps, mus, nus):
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                mu.copy_((1 - b1) * g + b1 * mu)
                nu.copy_((1 - b2) * (g * g) + b2 * nu)
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
                p.add_(u * neg_lr)


def make_optimizer(field, lr=1e-2, lr_mlp=None):
    """Adam with the instant-ngp split over an `NGPField`: high lr for
    the hash table, lr_mlp (default 0.3 lr) for the MLPs; b1 0.9, b2
    0.99, eps 1e-15 for both."""
    lr_mlp = lr_mlp if lr_mlp is not None else lr * 0.3
    mlp = [p for n, p in field.named_parameters() if n != "table"]
    return Adam([([field.table], lr, 0.9, 0.99, 1e-15),
                 (mlp, lr_mlp, 0.9, 0.99, 1e-15)])


def pose_schedule(pose_lr, steps, refine_pose=True):
    """The refined trainer's pose learning rate as a function of the
    update count: optax's `join_schedules` of a constant 0 for
    warmup = max(steps // 10, 1) updates and then (the second schedule
    seeing count - warmup, from count == warmup on) a cosine decay from
    pose_lr over max(steps - warmup, 1) updates to 0.1 pose_lr."""
    if not refine_pose:
        return lambda count: 0.0
    warmup = max(steps // 10, 1)
    decay = max(steps - warmup, 1)

    def schedule(count):
        if count < warmup:
            return 0.0
        c = min(count - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / decay))
        return pose_lr * (0.9 * cosine + 0.1)

    return schedule


def _render_chunk(field, o, d, app, n_samples, n_fine, near, far, hier,
                  contraction, fine_u):
    """Deterministic chunk renderer (no jitter; the hierarchical pass's
    importance samples take `fine_u`, the same for every chunk)."""
    if hier:
        a = None if app is None else app.expand(o.shape[0], app.shape[-1])
        return render_rays_hier(field, o, d, n_coarse=n_samples,
                                n_fine=n_fine, near=near, far=far, app=a,
                                contraction=contraction, stratified=False,
                                u_fine=fine_u)
    return render_rays(field, o, d, n_samples=n_samples, near=near, far=far,
                       stratified=False)


@torch.no_grad()
def render_image(field, c2w, intr, hw, n_samples=64, near=0.05, far=3.0,
                 convention="opencv", chunk=4096, scene_transform=None,
                 hier=False, n_fine=32, contraction=False, app=None,
                 return_acc=False, fine_u=None):
    """Render a full image [H, W, 3] (and depth [H, W], numpy) in chunks
    of `chunk` rays on the field's device.

    With hier=True the fine samples of every chunk take the same uniforms
    `fine_u` [chunk, n_fine], as the JAX package's renderer keys every
    chunk with PRNGKey(0): the image depends on `chunk`. When not given
    they are one draw of a CPU generator seeded 0 (the same on every
    device and every call)."""
    dev = field.table.device
    rays_o, rays_d = camera_rays(c2w, intr, hw, convention, dev)
    if scene_transform is not None:
        rays_o, rays_d = scene_transform(rays_o, rays_d)
    n = rays_o.shape[0]
    pad = (-n) % chunk
    ro = torch.cat([rays_o, torch.zeros((pad, 3), device=dev)])
    rd = torch.cat([rays_d, torch.ones((pad, 3), device=dev)])
    if hier and fine_u is None:
        fine_u = torch.rand((chunk, n_fine),
                            generator=torch.Generator().manual_seed(0))
    if fine_u is not None:
        fine_u = as_device(fine_u, dev)
    a = None if app is None else as_device(app, dev)
    outs = [_render_chunk(field, ro[i:i + chunk], rd[i:i + chunk], a,
                          n_samples, n_fine, float(near), float(far), hier,
                          contraction, fine_u)
            for i in range(0, n + pad, chunk)]
    h, w = hw
    rgb = torch.cat([o[0] for o in outs])[:n].cpu().numpy()
    depth = torch.cat([o[1] for o in outs])[:n].cpu().numpy()
    out = (rgb.reshape(h, w, 3), depth.reshape(h, w))
    if return_acc:
        acc = torch.cat([o[2] for o in outs])[:n].cpu().numpy()
        out = out + (acc.reshape(h, w),)
    return out


def camera_rays(c2w, intr, hw, convention="opencv", device="cpu"):
    """World-space (origins, dirs) [H*W, 3] fp32 tensors for a pinhole
    camera, computed in float64 numpy and then cast.

    convention="opencv": +z forward, +y down (the SLAM / synth convention);
    "opengl": -z forward, +y up (nerfstudio transforms.json).
    """
    h, w = hw
    fx, fy, cx, cy = [float(v) for v in intr]
    v, u = np.mgrid[0:h, 0:w].astype(np.float64) + 0.5
    if convention == "opencv":
        d = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], -1)
    else:
        d = np.stack([(u - cx) / fx, -(v - cy) / fy, -np.ones_like(u)], -1)
    d = d.reshape(-1, 3) @ np.asarray(c2w)[:3, :3].T
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(np.asarray(c2w)[:3, 3], d.shape)
    return (torch.tensor(o, dtype=torch.float32, device=device),
            torch.tensor(d, dtype=torch.float32, device=device))


def to_unit(x, center, scale, offset=0.5):
    """(x - center) * scale + offset: on a tensor in its dtype, `center`
    cast to it first (as the JAX package's fp32 arrays take a float64
    numpy center), on numpy arrays in numpy's promotion."""
    if isinstance(x, torch.Tensor):
        center = torch.as_tensor(np.asarray(center), dtype=x.dtype,
                                 device=x.device)
    return (x - center) * scale + offset


def normalize_scene(points, margin=0.15):
    """Map world points into the unit cube: returns (center, scale) with
    p_unit = (p - center) * scale + 0.5, chosen so every given point
    (cameras and scene-content samples) lands within
    [margin, 1 - margin]^3 (the field's domain is [0, 1]^3)."""
    pos = np.asarray(points, np.float64).reshape(-1, 3)
    center = (pos.max(0) + pos.min(0)) / 2.0
    extent = float((pos.max(0) - pos.min(0)).max())
    scale = (1.0 - 2 * margin) / max(extent, 1e-6)
    return center, scale
