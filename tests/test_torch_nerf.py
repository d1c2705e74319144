"""The port's NeRF (`nerf/ngp.py`, `nerf/train_native.py`) against the JAX
package, on the CPU at tiny sizes.

Both sides start from the JAX field (`field_init(PRNGKey(seed))`, carried
across by `ngp.field_from_numpy`) and see the same draws: the tests
compute the JAX key sequence of each function themselves and pass its
numbers to the port (`jax_*_draws` below), since the port draws from a
`torch.Generator` (R20). Tolerances, absolute unless said:

* the hash indices near and above max_res (up to 2^32 - 1, where the
  uint32 products wrap): equal;
* `camera_rays` (float64 numpy, then cast) and `normalize_scene`: equal;
* `hash_encode`, `sh_encode`, `rodrigues` (and its gradient at w = 0),
  `contract`, `field_query`, `_composite`: 1e-6;
* `render_rays`, `render_rays_hier`: 1e-5; `_sample_pdf` 1e-4 (a sample
  in a bin of weight ~1e-5 divides a 1-ulp difference of the two cdf
  cumsums by that weight);
* the gradients of a loss through `render_rays_hier`: 1e-4 of each
  tensor's largest value;
* the optimizer against optax over 5 updates (the pose schedule's
  boundary at warmup - 1, warmup, warmup + 1 among them): relative 1e-6;
* `train` / `train_refine` for 3 steps: each step's loss 2e-5 (the JAX
  log's 5 decimals), the report's PSNRs 5e-3 dB and pose_delta_rms 1e-5,
  each dense, pose and appearance tensor 1e-2 of the largest move the
  JAX run made in it, the table 1e-2 lr but for at most 1% of its
  entries (Adam's eps of 1e-15: see `_table_close`).
The JAX package's behaviour tests (`tests/test_nerf_native.py`) run on
the port in `tests/test_torch_nerf_behaviour.py`.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from wild_video_3d_reconstruction_torch.nerf import ngp as tngp  # noqa: E402
from wild_video_3d_reconstruction_torch.nerf import (  # noqa: E402
    train_native as ttn)
from wild_video_3d_reconstruction_tpu.nerf import ngp as jngp  # noqa: E402
from wild_video_3d_reconstruction_tpu.nerf import (  # noqa: E402
    train_native as jtn)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)         # beside the other test workers
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the JAX draws, computed as the JAX functions compute them


def jax_hier_draws(key, n, n_coarse, n_fine):
    """`render_rays_hier`'s coarse jitter and fine uniforms under key."""
    ka, kb, _ = jax.random.split(key, 3)
    return (np.asarray(jax.random.uniform(ka, (n, n_coarse))),
            np.asarray(jax.random.uniform(kb, (n, n_fine))))


def jax_train_draws(seed, steps, batch, n_rays, n_samples):
    """`train`'s per-step (ray index, stratified jitter)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        out.append((np.asarray(jax.random.randint(k1, (batch,), 0, n_rays)),
                    np.asarray(jax.random.uniform(k2, (batch, n_samples)))))
    return out


def jax_refine_draws(seed, steps, batch, n_pix, n_coarse, n_fine):
    """`train_refine`'s per-step (pixel index, coarse jitter, fine u)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        idx = np.asarray(jax.random.randint(k1, (batch,), 0, n_pix))
        out.append((idx, *jax_hier_draws(k2, batch, n_coarse, n_fine)))
    return out


def jax_align_draws(seed, n_views, steps, n_pix, n_coarse, n_fine):
    """`train_refine(eval_align=True)`'s alignment draws: one key per
    step (views in order) for the pixels and the hierarchical sampler."""
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(n_views * steps):
        key, sub = jax.random.split(key)
        idx = np.asarray(jax.random.randint(sub, (1024,), 0, n_pix))
        out.append((idx, *jax_hier_draws(sub, 1024, n_coarse, n_fine)))
    return out


def jax_render_u(n_fine, chunk=4096):
    """The fine uniforms of JAX `_render_chunk` (PRNGKey(0) per chunk)."""
    return jax_hier_draws(jax.random.PRNGKey(0), chunk, 1, n_fine)[1]


def jax_field(seed=0, **kw):
    """(JAX params, static) of `field_init(PRNGKey(seed))` and the same
    field as a port module on the CPU."""
    params, static = jngp.field_init(jax.random.PRNGKey(seed), **kw)
    pn = jax.tree_util.tree_map(np.asarray, params)
    sn = {"level_res": np.asarray(static["level_res"])}
    return params, static, tngp.field_from_numpy(pn, sn, "cpu")


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy()
                               if isinstance(b, torch.Tensor) else b,
                               rtol=0, atol=atol)


def _rays(rng, n, lo=0.3, hi=0.7):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# field pieces


@pytest.mark.parametrize("table_size", [2 ** 10, 2 ** 14, 1000])
def test_hash_indices_match_jax_near_max_res(table_size):
    """Corner indices at and above max_res (256, 4096) and up to
    2^32 - 1, where c * 2654435761 passes 2^32 (uint32 wrap in JAX) and
    2^63 (int64 wrap in the port): the indices are equal."""
    rng = np.random.default_rng(0)
    special = np.array([0, 1, 254, 255, 256, 257, 4095, 4096, 2 ** 16,
                        2 ** 31 - 1, 2 ** 31, 2 ** 32 - 1], np.uint64)
    corners = np.concatenate([
        np.stack(np.meshgrid(special, special, special), -1).reshape(-1, 3),
        rng.integers(0, 2 ** 32, (500, 3), dtype=np.uint64)])
    ref = np.asarray(jngp._hash(jnp.asarray(corners.astype(np.uint32)),
                                table_size))
    out = tngp._hash(torch.tensor(corners.astype(np.int64)), table_size)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.min() >= 0 and out.max() < table_size


def test_hash_encode_matches_jax():
    table, res = jngp.hash_grid_init(jax.random.PRNGKey(1), levels=6,
                                     table_size=2 ** 10, features=2,
                                     base_res=4, max_res=256)
    x = np.random.default_rng(1).uniform(0, 1, (2, 97, 3)).astype(np.float32)
    x[0, :4] = [[0, 0, 0], [1, 1, 1], [0.75, 0.75, 0.75], [1, 0, 1]]
    ref = jngp.hash_encode(jnp.asarray(x), table, res)
    out = tngp.hash_encode(_t(x), _t(table), _t(res))
    assert out.shape == (2, 97, 12)
    _close(ref, out, 1e-6)


def test_sh_rodrigues_contract_match_jax():
    rng = np.random.default_rng(2)
    _, d = _rays(rng, 33)
    _close(jngp.sh_encode(jnp.asarray(d)), tngp.sh_encode(_t(d)), 1e-6)
    w = (rng.normal(size=(16, 3)) * 0.7).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-7, 0, 0]
    _close(jngp.rodrigues(jnp.asarray(w)), tngp.rodrigues(_t(w)), 1e-6)
    # the double-where guard: a finite gradient at exactly w = 0
    v = np.array([1.0, 2.0, 3.0], np.float32)
    gj = jax.grad(lambda w: jnp.sum(jngp.rodrigues(w) @ jnp.asarray(v)))(
        jnp.zeros(3))
    w0 = torch.zeros(3, requires_grad=True)
    (tngp.rodrigues(w0) @ _t(v)).sum().backward()
    assert torch.isfinite(w0.grad).all()
    _close(gj, w0.grad, 1e-6)
    x = np.concatenate([rng.normal(size=(20, 3)) * 0.4,
                        rng.normal(size=(20, 3)) * 30]).astype(np.float32)
    _close(jngp.contract(jnp.asarray(x)), tngp.contract(_t(x)), 1e-6)


@pytest.mark.parametrize("convention", ["opencv", "opengl"])
def test_camera_rays_and_normalize_scene_equal_jax(convention):
    rng = np.random.default_rng(3)
    c2w = np.eye(4)
    c2w[:3, :3] = np.asarray(jngp.rodrigues(jnp.asarray([0.3, -0.2, 0.5])))
    c2w[:3, 3] = [0.4, -1.0, 2.0]
    intr = [30.0, 31.0, 16.5, 12.0]
    oj, dj = jngp.camera_rays(c2w, intr, (24, 32), convention)
    ot, dt = tngp.camera_rays(c2w, intr, (24, 32), convention)
    np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    pts = rng.uniform(-4, 9, (50, 3))
    for a, b in zip(jngp.normalize_scene(pts, 0.2),
                    tngp.normalize_scene(pts, 0.2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("app_dim", [0, 4])
def test_field_query_and_composite_match_jax(app_dim):
    params, static, field = jax_field(levels=3, table_size=2 ** 10,
                                      max_res=64, app_dim=app_dim)
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (6, 9, 3)).astype(np.float32)
    _, d = _rays(rng, 54)
    d = d.reshape(6, 9, 3)
    app = rng.normal(size=(6, 9, app_dim)).astype(np.float32) \
        if app_dim else None
    sj, cj = jngp.field_query(params, static, jnp.asarray(x), jnp.asarray(d),
                              None if app is None else jnp.asarray(app))
    st, ct = tngp.field_query(field, _t(x), _t(d),
                              None if app is None else _t(app))
    _close(sj, st, 1e-6)
    _close(cj, ct, 1e-6)
    t = np.sort(rng.uniform(0.05, 2.0, (6, 9)), -1).astype(np.float32)
    sig = rng.uniform(0, 20, (6, 9)).astype(np.float32)
    rgb = rng.uniform(0, 1, (6, 9, 3)).astype(np.float32)
    for a, b in zip(jngp._composite(jnp.asarray(sig), jnp.asarray(rgb),
                                    jnp.asarray(t), 1.95, 0.7),
                    tngp._composite(_t(sig), _t(rgb), _t(t), 1.95, 0.7)):
        _close(a, b, 1e-6)


def test_sample_pdf_matches_jax():
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0.02, 1.8, (40, 12)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (40, 12)).astype(np.float32) ** 4
    key = jax.random.PRNGKey(3)
    ref = jngp._sample_pdf(key, jnp.asarray(t), jnp.asarray(w), 10)
    u = np.asarray(jax.random.uniform(key, (40, 10)))
    out = tngp._sample_pdf(_t(t), _t(w), 10, u=u)
    _close(ref, out, 1e-4)


@pytest.mark.parametrize("stratified", [True, False])
def test_render_rays_matches_jax(stratified):
    params, static, field = jax_field(levels=3, table_size=2 ** 10,
                                      max_res=64)
    o, d = _rays(np.random.default_rng(6), 32)
    key = jax.random.PRNGKey(7)
    ref = jngp.render_rays(params, static, jnp.asarray(o), jnp.asarray(d),
                           key, n_samples=16, near=0.02, far=1.8,
                           stratified=stratified)
    u = np.asarray(jax.random.uniform(key, (32, 16)))
    out = tngp.render_rays(field, _t(o), _t(d), n_samples=16, near=0.02,
                           far=1.8, stratified=stratified, jitter=u)
    for a, b in zip(ref, out):
        _close(a, b, 1e-5)


@pytest.mark.parametrize("contraction,app_dim,stratified",
                         [(False, 0, True), (False, 4, True),
                          (True, 4, True), (True, 0, False)])
def test_render_rays_hier_matches_jax(contraction, app_dim, stratified):
    params, static, field = jax_field(levels=4, table_size=2 ** 11,
                                      max_res=128, app_dim=app_dim)
    rng = np.random.default_rng(8)
    o, d = _rays(rng, 48, *((-0.4, 0.4) if contraction else (0.3, 0.7)))
    app = rng.normal(size=(48, app_dim)).astype(np.float32) \
        if app_dim else None
    far = 64.0 if contraction else 1.8
    key = jax.random.PRNGKey(9)
    ref = jngp.render_rays_hier(
        params, static, jnp.asarray(o), jnp.asarray(d), key, n_coarse=12,
        n_fine=8, near=0.02, far=far,
        app=None if app is None else jnp.asarray(app),
        contraction=contraction, stratified=stratified)
    u_c, u_f = jax_hier_draws(key, 48, 12, 8)
    out = tngp.render_rays_hier(
        field, _t(o), _t(d), n_coarse=12, n_fine=8, near=0.02, far=far,
        app=None if app is None else _t(app), contraction=contraction,
        stratified=stratified, u_coarse=u_c, u_fine=u_f)
    for a, b in zip(ref, out):
        _close(a, b, 1e-5)


def test_gradients_through_render_rays_hier_match_jax():
    """d loss / d every field tensor, app and the ray origins, 1e-4 of
    each tensor's largest |gradient|."""
    params, static, field = jax_field(levels=4, table_size=2 ** 10,
                                      max_res=64, app_dim=4)
    rng = np.random.default_rng(10)
    o, d = _rays(rng, 64)
    app = rng.normal(size=(64, 4)).astype(np.float32)
    target = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    u_c, u_f = jax_hier_draws(key, 64, 10, 6)

    def jloss(p, o, a):
        rgb, _, _ = jngp.render_rays_hier(p, static, o, jnp.asarray(d), key,
                                          n_coarse=10, n_fine=6, near=0.02,
                                          far=1.8, app=a)
        return jnp.mean((rgb - jnp.asarray(target)) ** 2)

    gp, go, ga = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        params, jnp.asarray(o), jnp.asarray(app))
    ot = _t(o).requires_grad_()
    at = _t(app).requires_grad_()
    rgb, _, _ = tngp.render_rays_hier(field, ot, _t(d), n_coarse=10,
                                      n_fine=6, near=0.02, far=1.8, app=at,
                                      u_coarse=u_c, u_fine=u_f)
    torch.mean((rgb - _t(target)) ** 2).backward()
    pairs = [(gp["table"], field.table.grad), (go, ot.grad), (ga, at.grad)]
    for k in ("sigma1", "sigma2", "rgb1", "rgb2", "rgb3"):
        layer = getattr(field, k)
        pairs += [(gp[k]["w"], layer.w.grad), (gp[k]["b"], layer.b.grad)]
    for ref, out in pairs:
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                                   atol=1e-4 * scale)


# ---------------------------------------------------------------------------
# the optimizer


def test_adam_and_pose_schedule_match_optax():
    """The refined trainer's optimizer (table / mlp / pose groups) against
    optax's multi_transform over 5 updates with the same gradients; the
    pose schedule at steps = 30 (warmup 3) sees counts 0..4, so updates 3
    (warmup - 1: lr 0), 4 (warmup: pose_lr) and 5 (warmup + 1: cosine)
    cross optax's join_schedules boundary."""
    rng = np.random.default_rng(12)
    shapes = {"table": (3, 16, 2), "w": (5, 4), "app": (6, 4),
              "pose_w": (6, 3), "pose_t": (6, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) * 0.1
          for k, s in shapes.items()}
    grads = [{k: (rng.normal(size=s) * 10.0 ** rng.uniform(-8, 0, s))
              .astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    steps, lr, pose_lr = 30, 1e-2, 3e-4
    warmup = max(steps // 10, 1)
    sched = optax.join_schedules(
        [optax.constant_schedule(0.0),
         optax.cosine_decay_schedule(pose_lr, max(steps - warmup, 1),
                                     alpha=0.1)], [warmup])
    ours = tngp.pose_schedule(pose_lr, steps)
    for c in (0, warmup - 1, warmup, warmup + 1, steps - 1, steps + 5):
        np.testing.assert_allclose(ours(c), float(sched(c)), rtol=1e-6,
                                   atol=0)
    assert ours(warmup - 1) == 0.0 and ours(warmup) > 0.0
    label = {"table": "table", "w": "mlp", "app": "mlp", "pose_w": "pose",
             "pose_t": "pose"}
    tx = optax.multi_transform(
        {"table": optax.adam(lr, b1=0.9, b2=0.99, eps=1e-15),
         "mlp": optax.adam(lr * 0.3, b1=0.9, b2=0.99, eps=1e-15),
         "pose": optax.adam(sched)}, label)
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(pj)
    pt = {k: torch.tensor(v) for k, v in p0.items()}
    opt = tngp.Adam([([pt["table"]], lr, 0.9, 0.99, 1e-15),
                     ([pt["w"], pt["app"]], lr * 0.3, 0.9, 0.99, 1e-15),
                     ([pt["pose_w"], pt["pose_t"]], ours, 0.9, 0.999,
                      1e-8)])
    for g in grads:
        up, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                              state, pj)
        pj = optax.apply_updates(pj, up)
        for k, v in g.items():
            pt[k].grad = torch.tensor(v)
        opt.step()
        for k in shapes:
            np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                       rtol=1e-6, atol=1e-9)
    # the plain trainer's split (make_optimizer) is the first two groups
    field = tngp.NGPField(2, 16, max_res=8)
    groups = tngp.make_optimizer(field, 1e-2).groups
    assert groups[0][0] == [field.table] and groups[0][1:] == (
        1e-2, 0.9, 0.99, 1e-15)
    assert len(groups[1][0]) == 10 and groups[1][1] == pytest.approx(3e-3)


# ---------------------------------------------------------------------------
# the trainers, 3 steps with the JAX draws


def _log_values(lines, key):
    out = []
    for line in lines:
        for part in line.split():
            if part.startswith(key + "="):
                out.append(float(part.split("=")[1]))
    return out


def _table_close(ref_before, ref_after, out_after, lr, steps):
    """The table after `steps` Adam updates of eps 1e-15. Every touched
    entry's update is about lr whatever its gradient's size, so an entry
    whose gradient is rounding noise in one package, or that one package
    touches with a near-zero trilinear weight (a sample on a cell face)
    and the other does not, lands up to 2 lr a step apart. All but at
    most 1% of the entries agree within 1e-2 lr; none is more than
    2 lr * steps apart. Returns how many entries the 1e-2 lr leaves out."""
    err = np.abs(out_after - ref_after)
    left_out = int((err > 1e-2 * lr).sum())
    assert left_out <= 0.01 * err.size, (left_out, err.size)
    assert err.max() <= 2 * lr * steps, err.max()
    assert np.any(ref_after != ref_before)
    return left_out


def _params_close(ref_before, ref_after, module):
    """Every dense tensor within 1e-2 of the largest move the JAX run
    made in it (a share of its Adam steps)."""
    for k in ("sigma1", "sigma2", "rgb1", "rgb2", "rgb3"):
        for part in ("w", "b"):
            a = np.asarray(ref_after[k][part])
            moved = np.abs(a - np.asarray(ref_before[k][part])).max()
            b = getattr(getattr(module, k), part).detach().numpy()
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-2 * moved)


def test_train_three_steps_matches_jax():
    images, c2ws, intrs, conv = jtn.synth_scene(seed=5, frames=5, ht=16,
                                                wd=20)
    kw = dict(steps=3, batch=256, n_samples=12, levels=4,
              table_size=2 ** 10, max_res=64, eval_every=1, holdout=5)
    jlog, tlog = [], []
    jp, _, jrep = jtn.train(images, c2ws, intrs, conv, log=jlog.append, **kw)
    jp0, _, field0 = jax_field(levels=4, table_size=2 ** 10, max_res=64)
    before = field0.table.detach().numpy().copy()
    draws = jax_train_draws(0, 3, 256, 4 * 16 * 20, 12)
    field, trep = ttn.train(images, c2ws, intrs, conv, log=tlog.append,
                            device="cpu", field=field0, draws=draws, **kw)
    lj, lt = _log_values(jlog, "loss"), _log_values(tlog, "loss")
    assert len(lj) == len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-5)
    for k in ("psnr_init", "psnr"):
        assert abs(trep[k] - jrep[k]) <= 5e-3, (k, trep[k], jrep[k])
    for k in ("center", "scale", "near", "far", "train_views",
              "eval_views"):
        np.testing.assert_array_equal(trep[k], jrep[k])
    _params_close(jp0, jp, field)
    _table_close(before, np.asarray(jp["table"]),
                 field.table.detach().numpy(), 1e-2, 3)


def test_train_refine_three_steps_and_eval_align_match_jax():
    images, c2ws, intrs, conv = jtn.synth_scene(seed=6, frames=8, ht=16,
                                                wd=20)
    kw = dict(steps=3, batch=256, n_coarse=8, n_fine=6, levels=4,
              table_size=2 ** 10, max_res=64, eval_every=1, holdout=4,
              app_dim=4, eval_align=True, align_steps=2)
    jlog, tlog = [], []
    jp, _, jrep = jtn.train_refine(images, c2ws, intrs, conv,
                                   log=jlog.append, **kw)
    jp0, _, field0 = jax_field(levels=4, table_size=2 ** 10, max_res=64,
                               app_dim=4)
    before = field0.table.detach().numpy().copy()
    params, trep = ttn.train_refine(
        images, c2ws, intrs, conv, log=tlog.append, device="cpu",
        field=field0, draws=jax_refine_draws(0, 3, 256, 6 * 16 * 20, 8, 6),
        align_draws=jax_align_draws(0, 2, 2, 16 * 20, 8, 6),
        fine_u=jax_render_u(6), **kw)
    lj, lt = _log_values(jlog, "mse"), _log_values(tlog, "mse")
    assert len(lj) == len(lt) == 3
    np.testing.assert_allclose(lt, lj, rtol=0, atol=2e-5)
    for k in ("psnr_init", "psnr", "psnr_aligned"):
        assert abs(trep[k] - jrep[k]) <= 5e-3, (k, trep[k], jrep[k])
    assert abs(trep["pose_delta_rms"] - jrep["pose_delta_rms"]) <= 1e-5
    assert trep["pose_delta_rms"] > 0    # warmup 1: updates 2 and 3
    _params_close(jp0, jp["field"], params.field)
    for k in ("app", "pose_w", "pose_t"):           # they start at 0
        a = np.asarray(jp[k])
        np.testing.assert_allclose(getattr(params, k).detach().numpy(), a,
                                   rtol=0, atol=1e-2 * np.abs(a).max())
    _table_close(before, np.asarray(jp["field"]["table"]),
                 params.field.table.detach().numpy(), 1e-2, 3)
