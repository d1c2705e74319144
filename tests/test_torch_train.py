"""Port parity: VONet training on one device.

The port's training path on CPU tensors against the JAX package on the
same seeded inputs, at a tiny size (frames 4, patches 4, steps 2, 32x48,
batch 2; the patch centres and initial depths injected, edge dropout 0,
since the two packages' random draws differ: ROADMAP R18):

* `gradient_clip` / `gradient_zero`: backward equal to `jax.vjp`'s;
* `make_world_batch`: bitwise;
* `gather_patches(disp=)`: within 1e-6;
* the BA with `depth_clamp="train"`: within 1e-5 of the largest value;
* `total_loss` over `vonet_training_forward`: within 1e-5 relative;
* every parameter tensor's gradient against `jax.grad` of the same
  composed loss: within 1e-4 of its norm plus 1e-6 of the global norm
  (the gradients that are zero by symmetry, of the biases before an
  instance norm and of the SoftAgg gates, are rounding noise on both
  sides);
* the parameters after two steps of `make_optimizer` (schedule, clipping,
  AdamW) against optax's: the displacements within 5e-3 of their norm;
* `make_optimizer` over 100 steps of a fixed gradient against optax's
  chain: within 1e-6;
* a `.pth` the port writes loads in the JAX package's
  `load_torch_checkpoint` equal, and in the port;
* `trainer.train` on `make_synthetic_batch` batches logs and checkpoints.

The JAX loss and gradient are compiled once per module (`jax_run`);
torch runs on one thread beside the other test workers.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import threadpoolctl
import torch

from wild_video_3d_reconstruction_torch.ba import gauss_newton as tba
from wild_video_3d_reconstruction_torch.models import layers as tlayers
from wild_video_3d_reconstruction_torch.models import vonet as tvonet
from wild_video_3d_reconstruction_torch.models.convert import \
    load_reference_checkpoint
from wild_video_3d_reconstruction_torch.parallel import train_step as tts
from wild_video_3d_reconstruction_torch.train import forward as tfwd
from wild_video_3d_reconstruction_torch.train import synth as tsynth
from wild_video_3d_reconstruction_torch.train import trainer as ttrainer
from wild_video_3d_reconstruction_tpu.ba import gauss_newton as jba
from wild_video_3d_reconstruction_tpu.models import convert as jconvert
from wild_video_3d_reconstruction_tpu.models import layers as jlayers
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.parallel import train_step as jts
from wild_video_3d_reconstruction_tpu.train import forward as jfwd
from wild_video_3d_reconstruction_tpu.train import loss as jloss
from wild_video_3d_reconstruction_tpu.train import synth as jsynth

TC = tfwd.TrainConfig(frames=4, patches=4, steps=2, edge_dropout=0.0)
JTC = jfwd.TrainConfig(frames=4, patches=4, steps=2, edge_dropout=0.0)
HT, WD, B = 32, 48, 2
LR, OPT_STEPS = 3e-4, 10
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_GRAD_GLOBAL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _draws(seed=5):
    """Injected patch centres [B, T, M, 2] and initial depths [B, T*M]."""
    rng = np.random.default_rng(seed)
    T, M = TC.frames, TC.patches
    h4, w4 = HT // 4, WD // 4
    coords = np.stack([rng.integers(1, w4 - 1, (B, T, M)),
                       rng.integers(1, h4 - 1, (B, T, M))], -1)
    d0 = rng.uniform(0.2, 1.0, (B, T * M))
    return coords.astype(np.float32), d0.astype(np.float32)


def _jax_params(net):
    """The port network as the JAX package's tree, through the port's
    checkpoint layout and the JAX package's own converter."""
    sd = ttrainer.reference_state_dict(net)
    return jax.tree.map(jnp.asarray, jconvert.convert_state_dict(sd))


def _torch_grads(net):
    return {n: p.grad.detach().numpy().copy()
            for n, p in net.named_parameters()}


def _flat_jax(tree):
    """JAX tree -> {port parameter name: array in the port's layout}."""
    return {name: np.asarray(a)
            for name, a in jconvert.params_to_state_dict(tree).items()}


@pytest.fixture(scope="module")
def jax_run():
    return jax_reference()


def jax_reference():
    """One batch, the port network from seed 0, and the JAX side's loss,
    metrics, gradients and its parameters after two optimizer steps."""
    batch = tsynth.make_world_batch(3, B, TC, ht=HT, wd=WD)
    coords, d0 = _draws()
    net = tvonet.init_vonet(0)
    params = _jax_params(net)

    def loss_fn(params, batch):
        # the clips vmapped, as the JAX package's clip_loss_fn does
        def one(images, poses, disps, intr, c, d):
            traj = jfwd.vonet_training_forward(
                params, images, poses, disps, intr, jax.random.PRNGKey(0),
                JTC, patch_coords=c, init_depths=d)
            return jloss.total_loss(traj)

        losses, metrics = jax.vmap(one)(
            batch["images"], batch["poses"], batch["disps"],
            batch["intrinsics"], jnp.asarray(coords), jnp.asarray(d0))
        return jnp.mean(losses), jax.tree.map(jnp.mean, metrics)

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    (loss, metrics), grads = vg(params, jbatch)
    opt = jts.make_optimizer(lr=LR, steps=OPT_STEPS)
    state = opt.init(params)
    p = params
    for _ in range(2):
        _, g = vg(p, jbatch)
        upd, state = opt.update(g, state, p)
        p = optax.apply_updates(p, upd)
    return dict(batch=batch, coords=coords, d0=d0, loss=float(loss),
                metrics={k: float(v) for k, v in metrics.items()},
                grads=_flat_jax(grads), params0=_flat_jax(params),
                params2=_flat_jax(p))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------

def test_gradient_hooks_backward_match_jax():
    rng = np.random.default_rng(0)
    g = rng.normal(0.0, 0.2, (64, 5)).astype(np.float32)
    g[0, :3] = (np.nan, 0.1, -0.1)
    g[1, :4] = (0.01, -0.01, 0.10001, -1e9)
    x = rng.normal(size=g.shape).astype(np.float32)
    for tf, jf in ((tlayers.gradient_clip, jlayers.gradient_clip),
                   (tlayers.gradient_zero, jlayers.gradient_zero)):
        xt = torch.from_numpy(x).requires_grad_()
        y = tf(xt)
        assert torch.equal(y, xt.detach())
        y.backward(torch.from_numpy(g))
        _, vjp = jax.vjp(jf, jnp.asarray(x))
        np.testing.assert_array_equal(xt.grad.numpy(),
                                      np.asarray(vjp(jnp.asarray(g))[0]))


def test_update_heads_clip_their_gradients():
    """The delta and weight heads backpropagate at most 0.01 per output."""
    upd = tvonet.init_vonet(1).update
    x = torch.randn(6, 384)
    big = torch.full((6, 2), 5.0)
    for head in (upd.d, upd.w):
        lin = head[1]
        lin.weight.grad = None
        head(x).backward(big)
        expect = 0.01 * torch.relu(x).sum(0)
        torch.testing.assert_close(lin.weight.grad,
                                   expect[None].expand(2, -1), rtol=1e-6,
                                   atol=0)


def test_make_world_batch_bitwise():
    a = tsynth.make_world_batch(11, 2, TC, ht=HT, wd=WD, harden=True)
    b = jsynth.make_world_batch(11, 2, JTC, ht=HT, wd=WD, harden=True)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_gather_patches_with_disp_matches_jax():
    rng = np.random.default_rng(2)
    h4, w4, M = 12, 16, 24
    fmap = rng.normal(size=(h4, w4, 128)).astype(np.float32)
    imap = rng.normal(size=(h4, w4, 384)).astype(np.float32)
    image = rng.integers(0, 256, (4 * h4, 4 * w4, 3), dtype=np.uint8)
    disp = rng.uniform(0.1, 2.0, (h4, w4)).astype(np.float32)
    coords = np.stack([rng.uniform(-1, w4, M), rng.uniform(-1, h4, M)],
                      -1).astype(np.float32)
    out_t = tvonet.gather_patches(
        tvonet.FrameFeatures(torch.from_numpy(fmap), torch.from_numpy(imap)),
        torch.from_numpy(image), torch.from_numpy(coords),
        torch.from_numpy(disp))
    out_j = jvonet.gather_patches(
        jvonet.FrameFeatures(jnp.asarray(fmap), jnp.asarray(imap)),
        jnp.asarray(image), jnp.asarray(coords), jnp.asarray(disp))
    for t, j in zip(out_t, out_j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-6 * max(1.0, np.abs(j).max()))


def test_ba_train_clamp_matches_jax():
    """The training BA (depth_clamp="train", ep 10, +-64 px) on a clip's
    all-pairs edges with depths started near both clamps."""
    T, M = 4, 6
    clip = tsynth.make_world_batch(4, 1, tfwd.TrainConfig(frames=T), ht=HT,
                                   wd=WD)
    rng = np.random.default_rng(8)
    poses_gt = clip["poses"][0]
    px = rng.uniform(1, WD // 4 - 2, (T * M, 1, 1)) + np.arange(3) - 1
    py = rng.uniform(1, HT // 4 - 2, (T * M, 1, 1)) + \
        (np.arange(3) - 1)[:, None]
    d_gt = rng.uniform(0.3, 1.5, (T * M, 1, 1))
    patches = np.stack(np.broadcast_arrays(px, py, d_gt), 1) \
        .astype(np.float32)
    ii, jj, kk, keep = (t.numpy() for t in tfwd.all_pairs_edges(T, M))
    intr4 = clip["intrinsics"][0] / 4
    tgt = _np_project(poses_gt, patches, intr4, ii, jj, kk)
    tgt = tgt + rng.normal(0, 0.3, tgt.shape).astype(np.float32)
    weight = rng.uniform(0.1, 1.0, (ii.shape[0], 2)).astype(np.float32)
    start = patches.copy()
    start[:, 2] = rng.choice([2e-3, 9.9, 0.5], (T * M, 1, 1))
    poses0 = np.zeros((T, 7), np.float32)
    poses0[:, 6] = 1.0
    valid = keep.astype(np.float32)
    cfg_t = tba.BAConfig(window=T, patch_slots=T * M, bounds_margin=64.0,
                         per_patch_cap=T, ep=10.0, depth_clamp="train")
    cfg_j = jba.BAConfig(window=T, patch_slots=T * M, bounds_margin=64.0,
                         per_patch_cap=T, ep=10.0, depth_clamp="train")
    pt, zt = tba._bundle_adjust_impl(
        torch.from_numpy(poses0), torch.from_numpy(start),
        torch.from_numpy(intr4), torch.from_numpy(tgt),
        torch.from_numpy(weight), 1e-4, torch.from_numpy(ii),
        torch.from_numpy(jj), torch.from_numpy(kk), torch.from_numpy(valid),
        1, T, 0, cfg_t)
    pj, zj = jba.bundle_adjust(
        jnp.asarray(poses0), jnp.asarray(start), jnp.asarray(intr4),
        jnp.asarray(tgt), jnp.asarray(weight), 1e-4, jnp.asarray(ii),
        jnp.asarray(jj), jnp.asarray(kk), jnp.asarray(valid), 1, T, 0,
        cfg_j)
    d = zt[:, 2, 0, 0].numpy()
    assert d.max() <= 10.0 and d.min() >= 1e-3
    assert (d == 10.0).any() or (d == 1e-3).any()  # a clamp took effect
    for t, j in ((pt, pj), (zt, zj)):
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


def _np_project(poses, patches, intr, ii, jj, kk):
    """Centre-pixel reprojection through the port's transform."""
    from wild_video_3d_reconstruction_torch.ops import projective
    T = poses.shape[0]
    c = projective.transform(
        torch.from_numpy(poses), torch.from_numpy(patches),
        torch.from_numpy(np.tile(intr, (T, 1))), torch.from_numpy(ii),
        torch.from_numpy(jj), torch.from_numpy(kk))
    return c[:, 1, 1].numpy()


# ---------------------------------------------------------------------------
# the composed training step
# ---------------------------------------------------------------------------

def _port_loss(net, run):
    batch = tts.batch_to(run["batch"], "cpu")
    return tts.clip_loss_fn(net, batch, torch.Generator(), TC,
                            patch_coords=run["coords"],
                            init_depths=run["d0"])


def test_training_loss_and_gradients_match_jax(jax_run):
    net = tvonet.init_vonet(0)
    loss, metrics = _port_loss(net, jax_run)
    assert abs(loss.item() - jax_run["loss"]) <= \
        TOL_LOSS * abs(jax_run["loss"])
    for k, v in metrics.items():
        assert abs(v.item() - jax_run["metrics"][k]) <= \
            TOL_LOSS * abs(jax_run["metrics"][k]), k
    loss.backward()
    grads = _torch_grads(net)
    ref = jax_run["grads"]
    assert grads.keys() == ref.keys() and len(grads) == 94
    total = np.sqrt(sum((r * r).sum() for r in ref.values()))
    for name, g in grads.items():
        err = np.linalg.norm(g - ref[name])
        assert err <= TOL_GRAD * np.linalg.norm(ref[name]) + \
            TOL_GRAD_GLOBAL * total, (name, err)


def test_two_optimizer_steps_match_optax(jax_run):
    """Two steps of `build_train_step` (the same batch twice) against two
    of the JAX package's optax chain: all displacements within 5e-3 of
    their global norm, each tensor's within 5e-2 of its norm. The
    gradients agree to 2e-5, but Adam's second step divides its first
    moment, 0.1 g2 + 0.09 g1, by the root of its second: an element where
    the two nearly cancel moves by anything up to lr on a difference of
    rounding. Readings: 1.4e-3 global, at most 1.9e-2 per tensor
    (inet.layer1.1.conv1.weight), 6.3e-5 outside the context encoder's
    first layers. A tensor whose gradient is rounding noise (zero by
    symmetry, below 1e-6 of the global norm) moves by about lr whatever
    its sign, so it is held only to that bound. The optimizer's own
    arithmetic is held to 1e-6 below, on fixed gradients."""
    net = tvonet.init_vonet(0)
    opt = tts.make_optimizer(net.parameters(), lr=LR, steps=OPT_STEPS)
    step = tts.build_train_step(net, TC, opt, "cpu")
    for _ in range(2):
        step(jax_run["batch"], torch.Generator(),
             patch_coords=jax_run["coords"], init_depths=jax_run["d0"])
    p0, p2 = jax_run["params0"], jax_run["params2"]
    grads = jax_run["grads"]
    total = np.sqrt(sum((g * g).sum() for g in grads.values()))
    lr_sum = sum(opt.schedule(i) for i in range(2))
    sq_err = sq_norm = 0.0
    for name, p in net.named_parameters():
        moved_t = p.detach().numpy() - p0[name]
        moved_j = p2[name] - p0[name]
        if np.linalg.norm(grads[name]) < TOL_GRAD_GLOBAL * total:
            assert np.abs(moved_t).max() <= 1.01 * lr_sum, name
            continue
        err = np.linalg.norm(moved_t - moved_j)
        assert err <= 5e-2 * np.linalg.norm(moved_j), (name, err)
        sq_err += err * err
        sq_norm += (moved_j * moved_j).sum()
    assert np.sqrt(sq_err) <= 5e-3 * np.sqrt(sq_norm)


@pytest.mark.parametrize("grad_scale", [0.1, 50.0])
def test_make_optimizer_matches_optax_over_100_steps(grad_scale):
    """Fixed gradients, 100 steps of the warm-up + cosine schedule, weight
    decay 1e-2; grad_scale 50 puts the global norm above the clip every
    step, 0.1 below it."""
    rng = np.random.default_rng(1)
    shapes = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}
    p0 = {k: rng.normal(size=s).astype(np.float32)
          for k, s in shapes.items()}
    g = {k: (grad_scale * rng.normal(size=s)).astype(np.float32)
         for k, s in shapes.items()}
    jopt = jts.make_optimizer(lr=1e-2, wd=1e-2, clip=10.0, steps=100)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    state = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = tts.make_optimizer(tp.values(), lr=1e-2, wd=1e-2, clip=10.0,
                              steps=100)
    for _ in range(100):
        upd, state = jopt.update(jg, state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)


def test_checkpoint_loads_in_jax_and_in_the_port(tmp_path):
    net = tvonet.init_vonet(3)
    path = ttrainer.save_checkpoint(net, tmp_path, 7)
    assert path.name == "step_7.pth"
    tree = jconvert.load_torch_checkpoint(str(path))
    init = jvonet.init_vonet(jax.random.PRNGKey(0))
    assert jax.tree.structure(tree) == jax.tree.structure(init)
    flat = _flat_jax(tree)
    assert len(flat) == 94
    for name, t in net.state_dict().items():
        assert np.array_equal(flat[name], t.numpy()), name
    back = load_reference_checkpoint(path)
    for (n, a), (_, b) in zip(net.state_dict().items(),
                              back.state_dict().items()):
        assert torch.equal(a, b), n


def test_trainer_trains_logs_and_checkpoints(tmp_path, monkeypatch):
    """`train` on a dataset of `make_synthetic_batch` batches: two steps on
    the CPU, a JSONL log line (tensorboard blocked: the Logger goes on
    without it), a checkpoint per step that loads back."""
    tc = tfwd.TrainConfig(frames=3, patches=2, steps=1)

    class Synthetic:
        def batches(self, batch_size, steps):
            g = torch.Generator().manual_seed(0)
            for _ in range(steps):
                yield tts.make_synthetic_batch(g, batch_size, tc, ht=32,
                                               wd=32)

    b = tts.make_synthetic_batch(torch.Generator().manual_seed(0), 2, tc,
                                 ht=32, wd=32)
    assert b["images"].shape == (2, 3, 32, 32, 3)
    assert b["images"].dtype == torch.uint8 and b["poses"].shape == (2, 3, 7)
    assert b["disps"].shape == (2, 3, 8, 8) and b["intrinsics"].shape == (2, 4)
    monkeypatch.setattr(ttrainer.Logger, "SUM_FREQ", 2)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    net = ttrainer.train(Synthetic(), steps=2, batch_size=1, name="t",
                         checkpoint_every=1, logdir=tmp_path / "runs",
                         ckptdir=tmp_path / "ckpt", tc=tc, device="cpu")
    lines = (tmp_path / "runs" / "t" / "metrics.jsonl").read_text() \
        .splitlines()
    assert len(lines) == 1 and "loss" in lines[0]
    for step in (1, 2):
        back = ttrainer.load_checkpoint(tmp_path / "ckpt" / f"step_{step}.pth")
        assert len(back.state_dict()) == 94
    for (n, a), b_ in zip(net.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b_), n
