"""Port parity: multi-device training and inference, on gloo ranks.

The port's `parallel/` (mesh, FSDP train step, edge-sharded correlation
and frame step, BA's all-reduce hook, the dry run) and NeRF's data
parallel trainer against the JAX package's GSPMD / `shard_map` versions
on the conftest's 8 CPU devices, and against the port's own one-device
counterparts. The port's side runs as two groups of gloo processes, one
rank a process on one thread (`parallel.dryrun.launch`,
`tests/torch_parallel_ranks.py`): world 8, the JAX dry run's (2, 2, 2)
mesh, and world 2; a module-scoped fixture starts both and a process for
the JAX sharded train step, computes the rest of the JAX side and the
one-device runs meanwhile, and reads their results.

Tolerances (all readings are this build box's, torch 2.13 on the CPU):

* the train step (frames 4, patches 4, 1 unrolled step, 32x48, batch 8,
  the draws injected, edge dropout 0, 2 steps of `make_optimizer`): the
  first step's metrics within 1e-5 relative of the JAX sharded step's
  and 1e-6 of the port's one-device step's, the second's within 1e-4 of
  both (after one update in which Adam amplifies rounding, below); the
  first step's reduced gradient within `tests/test_torch_train.py`'s
  1e-4 of each tensor's norm plus 1e-6 of the global norm of JAX's, and
  within 1e-6 plus 1e-8 of the one-device step's; the parameters after
  the two steps as `tests/test_torch_train.py` holds the one-device step
  to optax (displacements within 5e-3 of their global norm, 5e-2 of each
  tensor's), against JAX's and the one-device step's alike: where a
  tensor's two gradients nearly cancel in Adam's second moment, its
  displacement moves by up to lr on a difference of rounding;
* the edge-sharded correlation equal to the unsharded lookup (each row
  is computed alone) and within 1e-5 of JAX `sharded_patch_corr`;
* `sharded_update_op` / `sharded_frame_step` on `__graft_entry__.py`'s
  populated state (fp32): within TOL_STEP absolute of JAX's sharded
  versions and of the port's unsharded steps (the JAX dry run holds its
  own to 2e-2 relative);
* NeRF `train(mesh=)`, 3 steps: the losses within 2e-5 of JAX's (as the
  one-device parity test) and 1e-6 of the port's one-device run, the
  parameters as in `tests/test_torch_nerf.py`; `train_refine(mesh=)` on
  its own draws within 1e-6 of the one-device run;
* a tiny DPVO run's state with the warm-up's duplicate edges (R1):
  `sharded_frame_step` on 2 ranks equal to `frame_step` (ROADMAP R28);
* BA with each of 2 ranks holding half the edges and the all-reduce hook
  equal to one rank holding them all within 1e-5 of the largest value,
  on both accumulation routes (patch table and one-hot).
"""

import importlib.util
import json
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wild_video_3d_reconstruction_torch.models import vonet as tvonet
from wild_video_3d_reconstruction_torch.models.convert import \
    jax_params_to_torch
from wild_video_3d_reconstruction_torch.parallel import dryrun as tdryrun
from wild_video_3d_reconstruction_torch.parallel import mesh as tmesh
from wild_video_3d_reconstruction_torch.parallel import train_step as tts
from wild_video_3d_reconstruction_torch.slam import steps as tsteps
from wild_video_3d_reconstruction_torch.train import forward as tfwd
from wild_video_3d_reconstruction_torch.train import synth as tsynth
from wild_video_3d_reconstruction_torch.utils.config import \
    DPVOConfig as TConfig
from wild_video_3d_reconstruction_tpu.models import convert as jconvert
from wild_video_3d_reconstruction_tpu.models import vonet as jvonet
from wild_video_3d_reconstruction_tpu.nerf import train_native as jtn
from wild_video_3d_reconstruction_tpu.parallel import infer_shard as jshard
from wild_video_3d_reconstruction_tpu.parallel import mesh as jmesh
from wild_video_3d_reconstruction_tpu.parallel import train_step as jts
from wild_video_3d_reconstruction_tpu.train import forward as jfwd
from wild_video_3d_reconstruction_tpu.train import loss as jloss
from wild_video_3d_reconstruction_tpu.utils.config import \
    DPVOConfig as JConfig

import torch_parallel_ranks as ranks
from test_torch_nerf import (_params_close, _table_close, jax_field,
                             jax_train_draws)

ROOT = Path(__file__).resolve().parent.parent
HERE = str(Path(__file__).resolve().parent)
TC = dict(frames=4, patches=4, steps=1, edge_dropout=0.0)
HT, WD, B = 32, 48, 8
LR, OPT_STEPS = 3e-4, 10
TOL_LOSS = 1e-5
TOL_LOSS_PORT = 1e-6
TOL_GRAD = 1e-4
TOL_GRAD_GLOBAL = 1e-6
TOL_GRAD_PORT = 1e-6
TOL_STEP = 1e-4
TOL_NERF_LOSS = 2e-5
TOL_NERF_PORT = 1e-6
TOL_BA = 1e-5
TINY = dict(BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
            OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
            MEM=12, GRADIENT_BIAS=False, CORR_CHUNK=512, PALLAS_CORR=False,
            MIXED_PRECISION=False)
NERF_KW = dict(steps=3, batch=256, n_samples=12, levels=4,
               table_size=2 ** 10, max_res=64, eval_every=1, holdout=5)
REFINE_KW = dict(steps=3, batch=256, n_coarse=8, n_fine=6, levels=4,
                 table_size=2 ** 10, max_res=64, eval_every=3, holdout=5,
                 app_dim=4)


def _graft():
    spec = importlib.util.spec_from_file_location(
        "graft_entry", ROOT / "__graft_entry__.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _draws(seed=5):
    rng = np.random.default_rng(seed)
    T, M = TC["frames"], TC["patches"]
    coords = np.stack([rng.integers(1, WD // 4 - 1, (B, T, M)),
                       rng.integers(1, HT // 4 - 1, (B, T, M))], -1)
    d0 = rng.uniform(0.2, 1.0, (B, T * M))
    return coords.astype(np.float32), d0.astype(np.float32)


def _jax_tree(net):
    from wild_video_3d_reconstruction_torch.train import trainer
    sd = trainer.reference_state_dict(net)
    return jax.tree.map(jnp.asarray, jconvert.convert_state_dict(sd))


def _flat(tree):
    return {k: np.asarray(v)
            for k, v in jconvert.params_to_state_dict(tree).items()}


# ---------------------------------------------------------------------------
# the inputs and the JAX side

def train_inputs():
    batch = tsynth.make_world_batch(3, B, tfwd.TrainConfig(**TC), ht=HT,
                                    wd=WD)
    coords, d0 = _draws()
    return dict(tc=TC, lr=LR, opt_steps=OPT_STEPS, batch=batch,
                coords=coords, d0=d0)


def make_inputs(train):
    rng = np.random.default_rng(0)            # the JAX dry run's inputs
    F, H, W, C = 3, 16, 24, 16
    E = 8 * 8
    corr = dict(gmap=rng.normal(size=(6, C, 3, 3)),
                f1=rng.normal(size=(F, H, W, C)),
                f2=rng.normal(size=(F, H // 4, W // 4, C)),
                coords=rng.uniform(3, 12, size=(E, 3, 3, 2)))
    corr = {k: v.astype(np.float32) for k, v in corr.items()}
    corr.update(kk=rng.integers(0, 6, E), jj=rng.integers(0, F, E),
                valid=np.ones(E, bool))

    jcfg = JConfig(**TINY)
    # __graft_entry__.py's JAX-initialised weights (~9 s of op-by-op init
    # here): on the port's init_vonet(0) weights this state amplifies
    # rounding (a 1e-7 relative change of its features moves the log's
    # flow metric by 1.5e-4 of its largest value), past TOL_STEP for any
    # two builds
    state, params = _graft()._populated_state(jcfg)
    state = state._replace(**{k: getattr(state, k).astype(jnp.float32)
                              for k in ("imap", "gmap", "fmap1", "fmap2",
                                        "net")})
    img = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    intr = np.array([40.0, 40.0, 32.0, 24.0], np.float32)
    _, k_sel, k_depth = jax.random.split(state.rng, 3)
    frame = dict(image=img, intr=intr,
                 coords=np.asarray(jvonet.select_patches(
                     k_sel, jcfg.PATCHES_PER_FRAME, 12, 16)),
                 inv_depths=np.asarray(jax.random.uniform(
                     k_depth, (jcfg.PATCHES_PER_FRAME,))))
    n = int(state.n_frames)
    snap = {k: np.asarray(v) for k, v in state._asdict().items()
            if k not in ("rng", "desc_log")}
    slam = dict(cfg=TINY, params=jax.tree.map(np.asarray, params),
                state=snap, frame=frame,
                t0=max(n - jcfg.OPTIMIZATION_WINDOW, 1))

    scene = jtn.synth_scene(seed=5, frames=5, ht=16, wd=20)
    jp0, static, _ = jax_field(levels=4, table_size=2 ** 10, max_res=64)
    nerf = dict(scene=scene, kw=NERF_KW, refine_kw=REFINE_KW,
                field=jax.tree.map(np.asarray, jp0),
                static={"level_res": np.asarray(static["level_res"])},
                draws=jax_train_draws(0, 3, 256, 4 * 16 * 20, 12))

    ba = _ba_inputs()
    return dict(train=train, corr=corr, slam=slam, nerf=nerf, **ba), \
        (state, params)


def _ba_inputs():
    """A clip's all-pairs edges with noisy targets (4 frames, 6 patches a
    frame, 96 edges: 48 a rank)."""
    T, M = 4, 6
    clip = tsynth.make_world_batch(4, 1, tfwd.TrainConfig(frames=T),
                                   ht=HT, wd=WD)
    rng = np.random.default_rng(8)
    px = rng.uniform(1, WD // 4 - 2, (T * M, 1, 1)) + np.arange(3) - 1
    py = rng.uniform(1, HT // 4 - 2, (T * M, 1, 1)) + \
        (np.arange(3) - 1)[:, None]
    d = rng.uniform(0.3, 1.5, (T * M, 1, 1))
    patches = np.stack(np.broadcast_arrays(px, py, d), 1).astype(np.float32)
    ii, jj, kk, keep = (t.numpy() for t in tfwd.all_pairs_edges(T, M))
    intr = (clip["intrinsics"][0] / 4).astype(np.float32)
    poses = np.zeros((T, 7), np.float32)
    poses[:, 6] = 1.0
    target = _project(clip["poses"][0], patches, intr, ii, jj, kk)
    target = target + rng.normal(0, 0.3, target.shape).astype(np.float32)
    weight = rng.uniform(0.1, 1.0, (ii.shape[0], 2)).astype(np.float32)
    ba = dict(poses=poses, patches=patches, intr=intr, target=target,
              weight=weight, ii=ii, jj=jj, kk=kk,
              valid=keep.astype(np.float32))
    return dict(ba=ba, ba_t1=T,
                ba_cfgs=[dict(window=T, patch_slots=T * M,
                              per_patch_cap=cap) for cap in (T, None)])


def _project(poses, patches, intr, ii, jj, kk):
    """Centre-pixel reprojection through the port's transform."""
    from wild_video_3d_reconstruction_torch.ops import projective
    T = poses.shape[0]
    c = projective.transform(
        torch.from_numpy(poses), torch.from_numpy(patches),
        torch.from_numpy(np.tile(intr, (T, 1))), torch.from_numpy(ii),
        torch.from_numpy(jj), torch.from_numpy(kk))
    return c[:, 1, 1].numpy()


def jax_train(inp, mesh):
    """The JAX package's sharded step (`build_train_step`'s shardings over
    mesh) on the injected draws: two steps' metrics and parameters."""
    net = tvonet.init_vonet(0)
    params = _jax_tree(net)
    jtc = jfwd.TrainConfig(**TC)

    def loss_fn(params, batch, coords, d0):
        def one(images, poses, disps, intr, c, d):
            traj = jfwd.vonet_training_forward(
                params, images, poses, disps, intr, jax.random.PRNGKey(0),
                jtc, patch_coords=c, init_depths=d)
            return jloss.total_loss(traj)

        losses, metrics = jax.vmap(one)(
            batch["images"], batch["poses"], batch["disps"],
            batch["intrinsics"], coords, d0)
        return jnp.mean(losses), jax.tree.map(jnp.mean, metrics)

    opt = jts.make_optimizer(lr=LR, steps=OPT_STEPS)
    p_shard = jmesh.param_sharding(mesh, params)
    params = jax.device_put(params, p_shard)
    o_shard = jmesh.param_sharding(mesh, jax.eval_shape(opt.init, params))
    opt_state = jax.jit(opt.init, out_shardings=o_shard)(params)
    b_shard = jmesh.batch_sharding(mesh)
    r_shard = jmesh.replicated(mesh)

    @partial(jax.jit, in_shardings=(p_shard, o_shard, b_shard, b_shard,
                                    b_shard),
             out_shardings=(p_shard, o_shard, r_shard))
    def step(params, opt_state, batch, coords, d0):
        (_, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            params, batch, coords, d0)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, \
            (metrics, grads)

    batch = {k: jnp.asarray(v) for k, v in inp["batch"].items()}
    p0 = _flat(params)
    out, grads = [], None
    p = params
    for _ in range(2):
        p, opt_state, (m, g) = step(p, opt_state, batch,
                                    jnp.asarray(inp["coords"]),
                                    jnp.asarray(inp["d0"]))
        out.append({k: float(v) for k, v in m.items()})
        grads = grads or _flat(g)
    return dict(metrics=out, params=_flat(p), params0=p0, grads=grads)


def jax_train_process(inp):
    """`jax_train` over the 8-device mesh in a process of its own (started
    by `parallel.dryrun.launch`, so a one-rank gloo group it does not use;
    tests/conftest.py's XLA flags are in its environment)."""
    jax.config.update("jax_platforms", "cpu")
    return jax_train(inp, jmesh.make_mesh(8))


@pytest.fixture(scope="module")
def run():
    """The ranks' readings, the JAX side's and the port's one-device
    runs'. The JAX sharded train step (~35 s of tracing and compiling)
    runs in a process of its own meanwhile."""
    train = train_inputs()
    groups = {"jax_train": tdryrun.launch(
        1, "test_torch_parallel:jax_train_process", train, device="cpu",
        timeout=600, pythonpath=(HERE,))}
    try:
        inp, (jstate_, jparams) = make_inputs(train)
        groups.update({w: tdryrun.launch(w, "torch_parallel_ranks:run", inp,
                                         device="cpu", timeout=600,
                                         pythonpath=(HERE,))
                       for w in (8, 2)})
        ref = {}
        emesh = jshard.make_edge_mesh(8)
        c = inp["corr"]
        ref["corr"] = np.asarray(jshard.sharded_patch_corr(
            emesh, jnp.asarray(c["gmap"]), (jnp.asarray(c["f1"]),
                                            jnp.asarray(c["f2"])),
            jnp.asarray(c["coords"]), jnp.asarray(c["kk"], jnp.int32),
            jnp.asarray(c["jj"], jnp.int32), jnp.asarray(c["valid"]),
            chunk=32))
        jcfg = JConfig(**TINY)
        t0 = inp["slam"]["t0"]
        ref["update"] = [np.asarray(a) for a in jax.jit(
            lambda s: jshard.sharded_update_op(emesh, jcfg, jparams, s,
                                               t0))(jstate_)]
        fr = inp["slam"]["frame"]
        frame = jax.jit(lambda s: jshard.sharded_frame_step(
            emesh, jcfg, jparams, s, jnp.asarray(fr["image"]),
            jnp.asarray(fr["intr"]), jnp.float32(1.0)))(jstate_)
        ref["frame"] = {k: np.asarray(getattr(frame, k))
                        for k in ("poses", "patches", "net", "target",
                                  "weight", "log", "n_frames", "n_edges",
                                  "log_idx")}
        jlog = []
        dp = jax.sharding.Mesh(np.asarray(jax.devices()[:8]), ("dp",))
        ref["nerf_params"], _, ref["nerf_rep"] = jtn.train(
            *inp["nerf"]["scene"], log=jlog.append, mesh=dp, **NERF_KW)
        ref["nerf_log"] = jlog

        # the port's one-device counterparts
        with torch.no_grad():
            n = torch.get_num_threads()
            torch.set_num_threads(1)
        try:
            one = {"train": ranks.train_steps(inp["train"], None),
                   "nerf": ranks.nerf_run(inp["nerf"], None),
                   "nerf_refine": ranks.nerf_refine_run(inp["nerf"], None)}
            one.update(_port_slam(inp["slam"]))
        finally:
            torch.set_num_threads(n)
        out = {w: g.wait() for w, g in groups.items()}
        ref["train"] = out.pop("jax_train")[0]
    finally:
        for g in groups.values():
            for p in g.procs:
                if p.poll() is None:
                    p.kill()
    return dict(inp=inp, ref=ref, one=one, out=out)


def _port_slam(inp):
    """The port's unsharded `update_op` and `frame_step` on the state."""
    cfg = TConfig(**inp["cfg"])
    net = jax_params_to_torch(inp["params"])
    st = ranks.port_state(inp["state"], cfg)
    E = st.ii.shape[0]
    with torch.no_grad():
        tsteps.update_op(cfg, net, st, inp["t0"], n_rows=E)
        update = [st.net.numpy().copy(), st.target.numpy().copy(),
                  st.weight.numpy().copy(), st.poses.numpy().copy(),
                  st.patches.numpy().copy()]
        st = ranks.port_state(inp["state"], cfg)
        frame = tsteps.frame_step(cfg, net, st,
                                  ranks.frame_inputs(cfg, st, inp["frame"]),
                                  E)
    return dict(update=update, frame=ranks.state_arrays(frame))


# ---------------------------------------------------------------------------
# the mesh, with no process group


@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    assert tmesh.mesh_shape(n) == \
        jmesh.make_mesh(devices=jax.devices()[:n]).devices.shape


def test_param_sharding_matches_jax_on_the_logical_dims():
    """Every parameter sharded on the same logical dims as JAX
    `param_sharding(make_mesh(8), params)`: the JAX spec read through the
    layout map (linear [in, out] <-> [out, in], HWIO <-> OIHW)."""
    net = tvonet.init_vonet(0)
    specs = tmesh.param_sharding(net)
    jspecs = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, name)
            else:
                jspecs[name] = tuple(v.spec)

    walk(jmesh.param_sharding(jmesh.make_mesh(8), _jax_tree(net)), "")
    assert specs.keys() == jspecs.keys() and len(specs) == 94
    sharded = 0
    for name, p in net.named_parameters():
        _, dims = tmesh.jax_layout(name, p.shape)
        want = [None] * p.dim()
        for jax_dim, axis in enumerate(jspecs[name]):
            want[dims[jax_dim]] = axis
        assert specs[name] == (tuple(want) if jspecs[name] else ()), name
        sharded += bool(specs[name])
    assert sharded == 21          # wide linears, 128+ channel convs
    assert specs["update.c1.0.weight"] == ("tp", "fsdp")
    assert specs["update.corr.0.weight"] == ("tp", "fsdp")      # 882 -> 384
    assert specs["update.d.1.weight"] == ()                      # 384 -> 2
    assert specs["fnet.conv2.weight"] == ("tp", None, None, None)
    # the FSDP step's shard dims: the fsdp axis's where it divides evenly
    for size, corr_dim in ((4, 0), (2, 1)):       # 882 inputs
        dims = tmesh.shard_dims(net, size)
        assert dims["update.c1.0.weight"] == 1
        assert dims["update.corr.0.weight"] == corr_dim
        assert dims["fnet.conv2.weight"] == dims["update.d.1.weight"] == 0
        assert sum(dims.values()) == 18 + corr_dim    # 19 big linears


def test_batch_sharding_and_no_fallback():
    batch = {"a": np.arange(8), "b": torch.arange(16).reshape(8, 2)}
    parts = [tmesh.batch_sharding(batch, rank=r, world=4) for r in range(4)]
    assert np.array_equal(np.concatenate([p["a"] for p in parts]),
                          batch["a"])
    assert torch.equal(parts[2]["b"], batch["b"][4:6])
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.batch_sharding(batch, rank=0, world=3)
    # no card here: the card's backend raises, it does not fall back
    with pytest.raises(RuntimeError, match="cuda"):
        tmesh.init_distributed("cuda", 0, 1, "file:///nonexistent")
    with pytest.raises(ValueError, match="one rank per card"):
        tdryrun.launch(1, "torch_parallel_ranks:run", device="cuda")


# ---------------------------------------------------------------------------
# the multi-rank checks


def _rank0(run, world):
    out = run["out"][world]
    assert [o["rank"] for o in out] == list(range(world))
    assert all(o["world"] == world for o in out)
    return out[0]


@pytest.mark.parametrize("world", [8, 2])
def test_sharded_train_step_matches_jax_and_one_device(run, world):
    """Two FSDP steps over make_mesh(world) against the JAX sharded step
    on 8 devices and the port's one-device step, the same batch and
    draws. Readings (world 8 / 2): step 1's metrics 3.0e-7 / 4.0e-7 from
    JAX's, 9.9e-8 / 7.6e-8 from the one-device step's; step 2's 2.7e-6 /
    2.5e-6 from JAX's, 4.6e-6 / 4.9e-6 from the one-device step's; the
    FSDP shard dims those of `mesh.shard_dims`; the gradient within 1.7e-6
    of JAX's (past the global term) and 1.2e-7 of the one-device step's;
    the displacements 2.1e-3 / 2.2e-3 of their global norm from JAX's,
    2.3e-3 / 1.7e-3 from the one-device step's, at most 1.9e-2 of a
    tensor's. Every rank holds the same parameters."""
    o = _rank0(run, world)
    assert o["mesh_shape"] == tmesh.mesh_shape(world)
    _, fsdp, tp = o["mesh_shape"]
    assert o["train"]["shard_dims"] == tmesh.shard_dims(
        tvonet.init_vonet(0), fsdp * tp)
    for r in run["out"][world][1:]:
        for name, v in r["train"]["params"].items():
            assert np.array_equal(v, o["train"]["params"][name]), name
    ref, one = run["ref"]["train"], run["one"]["train"]
    for s in range(2):
        for k, v in o["train"]["metrics"][s].items():
            tol = (TOL_LOSS, TOL_LOSS_PORT) if s == 0 else (1e-4, 1e-4)
            if k in ref["metrics"][s]:
                assert abs(v - ref["metrics"][s][k]) <= \
                    tol[0] * abs(ref["metrics"][s][k]), (s, k)
            assert abs(v - one["metrics"][s][k]) <= \
                tol[1] * abs(one["metrics"][s][k]), (s, k)
    p0, p2, grads = ref["params0"], ref["params"], ref["grads"]
    total = np.sqrt(sum((g * g).sum() for g in grads.values()))
    schedule = tts.make_optimizer([torch.zeros(1)], lr=LR,
                                  steps=OPT_STEPS).schedule
    lr_sum = schedule(0) + schedule(1)
    sq_err = sq_norm = sq_one = sq_one_norm = 0.0
    for name, p in o["train"]["params"].items():
        moved = p - p0[name]
        moved_j = p2[name] - p0[name]
        moved_one = one["params"][name] - p0[name]
        if np.linalg.norm(grads[name]) < 1e-6 * total:
            assert np.abs(moved).max() <= 1.01 * lr_sum, name
            continue
        err = np.linalg.norm(moved - moved_j)
        assert err <= 5e-2 * np.linalg.norm(moved_j), (name, err)
        sq_err += err * err
        sq_norm += (moved_j * moved_j).sum()
        err_one = np.linalg.norm(moved - moved_one)
        assert err_one <= 5e-2 * np.linalg.norm(moved_one), name
        sq_one += err_one * err_one
        sq_one_norm += (moved_one * moved_one).sum()
    assert np.sqrt(sq_err) <= 5e-3 * np.sqrt(sq_norm)
    assert np.sqrt(sq_one) <= 5e-3 * np.sqrt(sq_one_norm)
    # the first step's reduced gradient, before clipping
    g1, g_one = o["train"]["grads"], one["grads"]
    assert g1.keys() == grads.keys() == g_one.keys()
    for name, g in g1.items():
        err = np.linalg.norm(g - grads[name])
        assert err <= TOL_GRAD * np.linalg.norm(grads[name]) + \
            TOL_GRAD_GLOBAL * total, (name, err)
        err = np.linalg.norm(g - g_one[name])
        assert err <= TOL_GRAD_PORT * np.linalg.norm(g_one[name]) + \
            1e-2 * TOL_GRAD_GLOBAL * total, (name, err)


def test_edge_sharded_correlation_matches_jax_and_unsharded(run):
    """The JAX dry run's inputs (E = 64 on 8 ranks): equal to the
    unsharded lookup row for row, within 1e-5 of JAX `sharded_patch_corr`
    (reading: 0); gather=False gives the rank's 8 rows."""
    o = _rank0(run, 8)
    c = {k: torch.from_numpy(v) for k, v in run["inp"]["corr"].items()}
    from wild_video_3d_reconstruction_torch.ops.corr import corr_lookup
    one = corr_lookup(c["gmap"], (c["f1"], c["f2"]), c["coords"], c["kk"],
                      c["jj"], c["valid"], chunk=32).numpy()
    assert np.array_equal(o["corr"], one)
    np.testing.assert_allclose(o["corr"], run["ref"]["corr"], rtol=0,
                               atol=1e-5)
    for r, out in enumerate(run["out"][8]):
        assert np.array_equal(out["corr_local"], one[8 * r:8 * (r + 1)])


def _close_rel(a, b, tol, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = np.abs(a - b).max()
    assert err <= tol * np.abs(b).max(), (what, err, np.abs(b).max())


def test_sharded_update_op_matches_jax_and_unsharded(run):
    """`sharded_update_op` on 8 ranks over `__graft_entry__.py`'s
    populated state (fp32, 1024 rows, 64 live edges): (net, target, weight, poses,
    patches) within TOL_STEP of each one's largest value from JAX's
    `sharded_update_op` on 8 devices and from the port's `update_op`.
    Readings: at most 1.4e-5 (patches) and 1.0e-5."""
    o = _rank0(run, 8)
    names = ("net", "target", "weight", "poses", "patches")
    for r in run["out"][8][1:]:
        for a, b in zip(r["slam"]["update"], o["slam"]["update"]):
            assert np.array_equal(a, b)
    for name, a, j, t in zip(names, o["slam"]["update"],
                             run["ref"]["update"], run["one"]["update"]):
        _close_rel(a, j, TOL_STEP, name)
        _close_rel(a, t[:a.shape[0]], TOL_STEP, name)


def test_sharded_frame_step_matches_jax_and_unsharded(run):
    """`sharded_frame_step` on 8 ranks (insert with the JAX state key's
    draws, append, the sharded update, keyframe, log, retire) against JAX
    `sharded_frame_step` and the port's `frame_step`: the counters and the
    edge table equal, poses / patches / net / target / weight / log within
    TOL_STEP of their largest value (readings: at most 6.4e-5, the log's
    flow metric)."""
    o = _rank0(run, 8)["slam"]["frame"]
    ref, one = run["ref"]["frame"], run["one"]["frame"]
    assert o["counts"][:3].tolist() == [int(ref["n_frames"]),
                                        int(ref["n_edges"]),
                                        int(ref["log_idx"])]
    assert np.array_equal(o["counts"], one["counts"])
    for k in ("ii", "jj", "kk", "valid"):
        assert np.array_equal(o[k], one[k]), k
    for name in ("poses", "patches", "net", "target", "weight", "log"):
        _close_rel(o[name], ref[name], TOL_STEP, name)
        _close_rel(o[name], one[name], TOL_STEP, name)


def test_sharded_frame_step_on_a_run_state_with_r1_duplicates(run):
    """A tiny DPVO run's own state (sync mode, 12 frames of the wild walk),
    whose edge table holds the warm-up's duplicate edges (ROADMAP R1),
    stepped on 2 ranks: `sharded_frame_step` equals `frame_step` within
    TOL_STEP of each output's largest value (readings: at most 1.4e-5,
    the poses and the log's flow metric). The JAX
    sharded path's `neighbors()` would link the duplicates in another
    order than `update_op`'s sort (ROADMAP R28); the port's sharded step
    takes the sort."""
    o = _rank0(run, 2)["run_state"]
    assert o["duplicates"] > 0 and o["live"] > 0 and o["counts_equal"]
    assert max(o["rel"].values()) <= TOL_STEP, o["rel"]


def test_nerf_train_mesh_matches_jax_and_one_device(run):
    """NeRF `train(mesh=)` on an 8-rank "dp" mesh, 3 steps of 256 rays
    (32 a rank) on the JAX draws: the losses within 2e-5 of JAX
    `train(mesh=Mesh(8 devices, "dp"))`'s logged ones (5 digits) and the
    field as `tests/test_torch_nerf.py` holds the one-device trainer; the
    losses within TOL_NERF_PORT and every tensor within 1e-6 of the
    port's one-device run (readings: 2e-9, 9e-8)."""
    from wild_video_3d_reconstruction_torch.nerf import ngp as tngp
    from test_torch_nerf import _log_values

    o = _rank0(run, 8)["nerf"]
    one = run["one"]["nerf"]
    ref = run["ref"]
    lj = _log_values(ref["nerf_log"], "loss")
    assert len(lj) == len(o["losses"]) == 3
    np.testing.assert_allclose(o["losses"], lj, rtol=0, atol=TOL_NERF_LOSS)
    np.testing.assert_allclose(o["losses"], one["losses"], rtol=0,
                               atol=TOL_NERF_PORT)
    assert abs(o["psnr"] - ref["nerf_rep"]["psnr"]) <= 5e-3
    for k, v in o["state"].items():
        np.testing.assert_allclose(v, one["state"][k], rtol=0, atol=1e-6)
    inp = run["inp"]["nerf"]
    field = tngp.field_from_numpy(inp["field"], inp["static"], "cpu")
    before = field.table.detach().numpy().copy()
    field.load_state_dict({k: torch.from_numpy(v)
                           for k, v in o["state"].items()})
    _params_close(inp["field"], ref["nerf_params"], field)
    _table_close(before, np.asarray(ref["nerf_params"]["table"]),
                 field.table.detach().numpy(), 1e-2, 3)


def test_nerf_train_refine_mesh_matches_one_device(run):
    """`train_refine(mesh=)` on the 8-rank "dp" mesh with its own draws
    (seed 0) against the one-device run: the mesh path draws the global
    batch's pixels and uniforms as one device draws them, so the losses
    agree within TOL_NERF_PORT and every parameter within 1e-6."""
    o = _rank0(run, 8)["nerf_refine"]
    one = run["one"]["nerf_refine"]
    assert len(o["losses"]) == REFINE_KW["steps"]
    np.testing.assert_allclose(o["losses"], one["losses"], rtol=0,
                               atol=TOL_NERF_PORT)
    assert o["state"].keys() == one["state"].keys()
    for k, v in o["state"].items():
        np.testing.assert_allclose(v, one["state"][k], rtol=0, atol=1e-6)


def test_ba_allreduce_hook_two_ranks_equal_one(run):
    """BA over a clip's 96 all-pairs edges: each of 2 ranks holding 48
    with `ar=` an all-reduce SUM equals one rank holding all 96, on the
    patch-table route and on the one-hot route, within 5e-5 of the
    largest value in fp32 (readings: 8.9e-6) and 1e-10 in fp64."""
    o = _rank0(run, 2)
    assert len(o["ba"]) == 2 * len(run["inp"]["ba_cfgs"])
    for case in o["ba"]:
        tol = 1e-10 if case["sharded"][0].dtype == np.float64 else 5e-5
        for a, b in zip(case["sharded"], case["whole"]):
            _close_rel(a, b, tol, case["sharded"][0].dtype)
    for a, b in zip(o["ba"], run["out"][2][1]["ba"]):
        for x, y in zip(a["sharded"], b["sharded"]):
            assert np.array_equal(x, y)


def test_dryrun_multichip_checks_pass(run):
    """`parallel.dryrun`'s four checks on 2 ranks (`__graft_entry__.py`'s tiny
    config, bf16 features): each within the JAX dry run's 2e-2."""
    d = _rank0(run, 2)["dryrun"]
    assert np.isfinite(d["train_loss"]) and d["corr_rel"] < 1e-5
    rels = {k: v for k, v in d.items() if k.startswith(("update_", "frame_"))}
    assert len(rels) == 11
    assert max(rels.values()) < tdryrun.TOL_SHARDED_REL, rels


def test_sharded_trainer_logs_and_checkpoints(run):
    """`trainer.train(n_devices=2)`: rank 0 logs the running means, the
    checkpoints hold the gathered parameters in the one-device layout
    (94 tensors, the reference names), equal to what every rank holds."""
    o = _rank0(run, 2)["trainer"]
    lines = o["log"].strip().splitlines()
    assert len(lines) == 1 and np.isfinite(json.loads(lines[0])["loss"])
    ck = o["ckpt"][2]
    assert len(ck) == 94 and "patchify.fnet.conv1.weight" in ck
    params = run["out"][2][1]["trainer"]["params"]
    for name, v in params.items():
        key = ("patchify." + name if name.startswith(("fnet.", "inet."))
               else name).replace("downsample.", "downsample.0.")
        assert np.array_equal(ck[key], v), name
    assert not np.array_equal(o["ckpt"][1]["update.c1.0.weight"],
                              ck["update.c1.0.weight"])
