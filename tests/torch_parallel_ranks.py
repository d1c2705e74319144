"""What each rank of `tests/test_torch_parallel.py`'s gloo groups runs.

Imported by the ranks that `parallel.dryrun.launch` starts (torch, numpy
and the port only; the JAX side runs in the test process). `run(inputs)`
takes the test's inputs (numpy) and returns, on every rank, the readings
the test compares: the sharded train step (every world size), the
edge-sharded correlation, `sharded_update_op`, `sharded_frame_step` and
NeRF `train(mesh=)` (world 8), BA's all-reduce hook, the dry run and the
sharded trainer (world 2).
"""

import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from wild_video_3d_reconstruction_torch.ba import gauss_newton as tba
from wild_video_3d_reconstruction_torch.models.convert import \
    jax_params_to_torch
from wild_video_3d_reconstruction_torch.models.vonet import init_vonet
from wild_video_3d_reconstruction_torch.nerf import ngp as tngp
from wild_video_3d_reconstruction_torch.nerf import train_native as ttn
from wild_video_3d_reconstruction_torch.parallel import dryrun
from wild_video_3d_reconstruction_torch.parallel import infer_shard
from wild_video_3d_reconstruction_torch.parallel import mesh as tmesh
from wild_video_3d_reconstruction_torch.parallel import train_step as tts
from wild_video_3d_reconstruction_torch.slam import state as tstate
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.train import forward as tfwd
from wild_video_3d_reconstruction_torch.train import trainer as ttrainer
from wild_video_3d_reconstruction_torch.utils.config import DPVOConfig

EDGE_KEYS = ("ii", "jj", "kk", "valid", "net", "target", "weight")


def full_params(net):
    """{name: numpy} of net's parameters, gathered from their shards."""
    out = {}
    for name, p in net.named_parameters():
        t = p.full_tensor() if hasattr(p, "full_tensor") else p
        out[name] = t.detach().numpy().copy()
    return out


def train_steps(inp, mesh):
    """Two steps of the (sharded when mesh) train step on the test's
    batch and injected draws: step metrics, the first step's gradients
    (the ranks' reduced ones, before clipping) and the parameters
    after."""
    tc = tfwd.TrainConfig(**inp["tc"])
    net = init_vonet(0)
    opt = tts.make_optimizer(net.parameters(), lr=inp["lr"],
                             steps=inp["opt_steps"])
    step = tts.build_train_step(net, tc, opt, "cpu", mesh=mesh)
    names = [n for n, _ in net.named_parameters()]
    grads = {}
    clip = opt.clip_grads

    def recorded():
        if not grads:
            for n, p in zip(names, opt.params):
                g = p.grad.full_tensor() if hasattr(p.grad, "full_tensor") \
                    else p.grad
                grads[n] = g.detach().numpy().copy()
        return clip()

    opt.clip_grads = recorded
    metrics = []
    for _ in range(2):
        m = step(inp["batch"], torch.Generator(),
                 patch_coords=inp["coords"], init_depths=inp["d0"])
        metrics.append({k: float(v) for k, v in m.items()})
    shard_dims = {n: p.placements[-1].dim for n, p in net.named_parameters()
                  if hasattr(p, "placements")}
    return dict(metrics=metrics, grads=grads, params=full_params(net),
                shard_dims=shard_dims)


def port_state(snap, cfg):
    """A JAX state snapshot (numpy, fp32 features) as the port's state,
    the edge table at the snapshot's size."""
    st = tstate.init_state(cfg, 48, 64, feat_dtype=torch.float32)
    for f in dataclasses.fields(st):
        if f.name in EDGE_KEYS:
            dst = getattr(st, f.name)
            setattr(st, f.name,
                    torch.from_numpy(np.array(snap[f.name])).to(dst.dtype))
        elif f.name in snap and f.name not in ("rng", "desc_log"):
            dst = getattr(st, f.name)
            src = torch.from_numpy(np.array(snap[f.name]))
            dst[:src.shape[0]] = src.to(dst.dtype)
    st.counts.zero_()
    st.n_frames = int(snap["n_frames"])
    st.n_edges = int(snap["n_edges"])
    st.log_idx = int(snap["log_idx"])
    return st


def frame_inputs(cfg, st, fr):
    c, given, d, j = tsteps.draw_inputs(cfg, st, 48, 64, coords=fr["coords"],
                                        inv_depths=fr["inv_depths"])
    return tsteps.FrameInputs(torch.from_numpy(fr["image"]),
                              torch.from_numpy(fr["intr"]),
                              torch.tensor(1.0), c, given, d, j)


def state_arrays(st):
    return {k: getattr(st, k).numpy().copy()
            for k in ("poses", "patches", "net", "target", "weight", "log",
                      "ii", "jj", "kk", "valid", "counts")}


def slam_checks(inp, emesh):
    """sharded_update_op and sharded_frame_step on the test's state."""
    cfg = DPVOConfig(**inp["cfg"])
    net = jax_params_to_torch(inp["params"])
    st = port_state(inp["state"], cfg)
    E = st.ii.shape[0]
    upd = infer_shard.sharded_update_op(emesh, cfg, net, st,
                                        inp["t0"], E)
    update = [getattr(upd, k).numpy().copy()
              for k in ("net", "target", "weight", "poses", "patches")]
    st = port_state(inp["state"], cfg)
    frame = infer_shard.sharded_frame_step(
        emesh, cfg, net, st, frame_inputs(cfg, st, inp["frame"]), E)
    return dict(update=update, frame=state_arrays(frame))


def nerf_run(inp, mesh):
    """NeRF `train` (data parallel over mesh) on the test's scene, field
    and draws: its losses and field after."""
    losses = []
    field = tngp.field_from_numpy(inp["field"], inp["static"], "cpu")
    field, rep = ttn.train(*inp["scene"], device="cpu", field=field,
                           draws=inp["draws"], mesh=mesh,
                           step_hook=lambda s, loss: losses.append(
                               float(loss)),
                           log=lambda *a: None, **inp["kw"])
    return dict(losses=losses, psnr=rep["psnr"],
                state={k: v.detach().numpy().copy()
                       for k, v in field.state_dict().items()})


def nerf_refine_run(inp, mesh):
    """NeRF `train_refine` (data parallel over mesh) on the test's scene
    with its own draws (seed 0; the mesh path draws the global batch's
    uniforms as one device does): its losses and parameters after."""
    losses = []
    params, _ = ttn.train_refine(
        *inp["scene"], device="cpu", mesh=mesh,
        step_hook=lambda s, mse: losses.append(float(mse)),
        log=lambda *a: None, **inp["refine_kw"])
    return dict(losses=losses,
                state={k: v.detach().numpy().copy()
                       for k, v in params.state_dict().items()})


def ba_hook(inp):
    """BA over the test's edges: this rank's half with the all-reduce
    hook, and all of them on one rank."""
    group = dist.group.WORLD
    rank, world = dist.get_rank(), dist.get_world_size()
    a = {k: torch.from_numpy(v) for k, v in inp["ba"].items()}
    E = a["ii"].shape[0]
    sl = slice(rank * E // world, (rank + 1) * E // world)

    def solve(cfg, rows, ar=None):
        return [t.numpy() for t in tba._bundle_adjust_impl(
            a["poses"], a["patches"], a["intr"], a["target"][rows],
            a["weight"][rows], 1e-4, a["ii"][rows], a["jj"][rows],
            a["kk"][rows], a["valid"][rows], 1, inp["ba_t1"], 0, cfg,
            ar=ar)]

    def ar(x):
        x = x.contiguous()
        dist.all_reduce(x, group=group)
        return x

    out = []
    for dtype in (torch.float32, torch.float64):
        a["poses"] = a["poses"].to(dtype)
        for kw in inp["ba_cfgs"]:
            cfg = tba.BAConfig(**kw)
            out.append(dict(sharded=solve(cfg, sl, ar),
                            whole=solve(cfg, slice(0, E))))
    return out


def run_state_check():
    """A tiny DPVO run (sync mode, 12 frames of the wild walk at 48x64, on
    rank 0) whose state holds the warm-up's duplicate edges (ROADMAP R1),
    stepped once more with its last frame through `sharded_frame_step` and
    `frame_step`: the largest difference of each output over its largest
    value, the duplicate (kk, jj) pairs among the live edges."""
    from wild_video_3d_reconstruction_torch.eval import synth_ate
    from wild_video_3d_reconstruction_torch.slam import DPVO
    from wild_video_3d_reconstruction_torch.utils.config import load_config

    images, _, intr, _, _ = synth_ate.wild_sequence(0, frames=12, ht=48,
                                                    wd=64, fx=40.0, fy=40.0)
    cfg = load_config("configs/fast.yaml", BUFFER_SIZE=32,
                      PATCHES_PER_FRAME=8, MIXED_PRECISION=False,
                      MOTION_PROBE_THRESH=-1.0, PATCH_LIFETIME=3,
                      REMOVAL_WINDOW=6, OPTIMIZATION_WINDOW=4, MEM=12)
    # rank 0 runs the tracker; every rank steps its state and network
    run_ = [None]
    if dist.get_rank() == 0:
        slam = DPVO(cfg, None, 48, 64, device="cpu", sync_mode=True)
        for t in range(12):
            slam(t, images[t], intr)
        run_ = [(slam.state, slam.net)]
    dist.broadcast_object_list(run_, src=0)
    st, net = run_[0]
    ne = int(st.n_edges)
    live = st.valid[:ne]
    pairs = (st.kk[:ne] * 4096 + st.jj[:ne])[live]
    dup = int(pairs.numel() - torch.unique(pairs).numel())
    c, given, d, j = tsteps.draw_inputs(cfg, st, 48, 64)
    inputs = tsteps.FrameInputs(torch.from_numpy(images[11]),
                                torch.tensor(intr, dtype=torch.float32),
                                torch.tensor(1.0), c, given, d, j)
    E = st.ii.shape[0]
    emesh = infer_shard.make_edge_mesh(dist.get_world_size(), "cpu")
    shd = infer_shard.sharded_frame_step(emesh, cfg, net,
                                         dryrun.clone_state(st), inputs, E)
    with torch.no_grad():
        ref = tsteps.frame_step(cfg, net, dryrun.clone_state(st),
                                inputs, E)
    rel = {k: dryrun._rel(getattr(shd, k), getattr(ref, k))
           for k in ("poses", "patches", "net", "target", "weight", "log")}
    return dict(rel=rel, duplicates=dup, live=int(live.sum()),
                counts_equal=bool(torch.equal(shd.counts, ref.counts)))


def trainer_run(inp):
    """`trainer.train(n_devices=world)` for two steps, a checkpoint each
    step, on the test's synthetic batches."""
    tc = tfwd.TrainConfig(frames=3, patches=2, steps=1)

    class Synthetic:
        def batches(self, batch_size, steps):
            g = torch.Generator().manual_seed(0)
            for _ in range(steps):
                yield tts.make_synthetic_batch(g, batch_size, tc, ht=32,
                                               wd=32)

    # the test reads the JSONL log: the Logger's tensorboard import would
    # load TensorFlow where that is installed (~15 s a rank)
    sys.modules["torch.utils.tensorboard"] = None
    ttrainer.Logger.SUM_FREQ = 2
    root = inp["trainer_dir"]
    net = ttrainer.train(Synthetic(), steps=2, batch_size=2, name="t",
                         checkpoint_every=1, logdir=os.path.join(root, "runs"),
                         ckptdir=os.path.join(root, "ckpt"), tc=tc,
                         device="cpu", n_devices=dist.get_world_size())
    return dict(params=full_params(net))


def run(inp):
    """Every check of this world size, in order (each rank the same)."""
    world = dist.get_world_size()
    out = dict(world=world, rank=dist.get_rank(),
               mesh_shape=tuple(tmesh.make_mesh(world, "cpu").shape))
    out["train"] = train_steps(inp["train"], tmesh.make_mesh(world, "cpu"))
    if world == 8:
        emesh = infer_shard.make_edge_mesh(world, "cpu")
        c = {k: torch.from_numpy(v) for k, v in inp["corr"].items()}
        out["corr"] = infer_shard.sharded_patch_corr(
            emesh, c["gmap"], (c["f1"], c["f2"]), c["coords"], c["kk"],
            c["jj"], c["valid"], chunk=32).numpy()
        out["corr_local"] = infer_shard.sharded_patch_corr(
            emesh, c["gmap"], (c["f1"], c["f2"]), c["coords"], c["kk"],
            c["jj"], c["valid"], chunk=32, gather=False).numpy()
        out["slam"] = slam_checks(inp["slam"], emesh)
        dp = torch.distributed.device_mesh.init_device_mesh(
            "cpu", (world,), mesh_dim_names=("dp",))
        out["nerf"] = nerf_run(inp["nerf"], dp)
        out["nerf_refine"] = nerf_refine_run(inp["nerf"], dp)
    if world == 2:
        out["ba"] = ba_hook(inp)
        out["run_state"] = run_state_check()
        out["dryrun"] = dryrun.run_checks("cpu")
        with tempfile.TemporaryDirectory() as tmp:
            paths = [tmp]
            dist.broadcast_object_list(paths, src=0)
            out["trainer"] = trainer_run(dict(inp, trainer_dir=paths[0]))
            dist.barrier()
            if dist.get_rank() == 0:
                out["trainer"]["log"] = open(os.path.join(
                    paths[0], "runs", "t", "metrics.jsonl")).read()
                out["trainer"]["ckpt"] = {
                    s: {k: v.numpy() for k, v in torch.load(os.path.join(
                        paths[0], "ckpt", f"step_{s}.pth")).items()}
                    for s in (1, 2)}
            dist.barrier()
    return out
