"""Multi-rank dry run of the port, and the launcher behind it.

The counterpart of the JAX package's `dryrun_multichip` (its entry
runs it on 8 forced CPU devices). Here each device is a rank of a
`torch.distributed` process group, one process each:

    python -m wild_video_3d_reconstruction_torch.parallel.dryrun 8 --device cpu
    python -m wild_video_3d_reconstruction_torch.parallel.dryrun 1   # a card

`launch(n, "module:function", *args, device=)` starts n processes of
this module that join one group (`gloo` on the CPU through a `file://`
store in a fresh directory, so concurrent launches never share a port;
`nccl` on the card, one rank per card), each calling function(*args);
`Ranks.wait()` returns every rank's return value and raises if a rank
failed. `dryrun_multichip(n)` runs the JAX package's four checks in
order, one line each (`CHECKS`, `run_checks`):

  1. one FSDP train step over `make_mesh(n)`, with a finite loss;
  2. the edge-sharded correlation, equal to the unsharded lookup;
  3. `sharded_update_op` against `steps.update_op` on a populated
     post-initialization state (`__graft_entry__.py`'s recipe);
  4. `sharded_frame_step` against `steps.frame_step` on that state.

The card's machine has one card, so there it shows world size 1 only.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MODULE = "wild_video_3d_reconstruction_torch.parallel.dryrun"
TOL_SHARDED_REL = 2e-2     # __graft_entry__.py's: psum reordering in bf16


class Ranks:
    """The processes of one launch; `wait` collects their results."""

    def __init__(self, procs, workdir, timeout):
        self.procs, self.workdir, self.timeout = procs, workdir, timeout

    def wait(self):
        """[rank r's return value for r in range(n)]; raises RuntimeError
        with the failed ranks' error output if any exits non-zero or the
        launch outlives its timeout (every process is stopped either
        way)."""
        deadline = time.monotonic() + self.timeout
        late = ""
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            late = f" (stopped at its {self.timeout} s timeout)"
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        try:
            bad = [r for r, p in enumerate(self.procs) if p.returncode]
            if bad:
                errs = []
                for r in bad:
                    with open(os.path.join(self.workdir, f"err{r}.txt"),
                              encoding="utf-8", errors="replace") as f:
                        errs.append(f"rank {r} (exit "
                                    f"{self.procs[r].returncode}):\n"
                                    f"{f.read()[-3000:]}")
                raise RuntimeError(f"launch failed{late}:\n"
                                   + "\n".join(errs))
            return [torch.load(os.path.join(self.workdir, f"out{r}.pt"),
                               weights_only=False)
                    for r in range(len(self.procs))]
        finally:
            shutil.rmtree(self.workdir, ignore_errors=True)


def launch(n, target, *args, device="cpu", timeout=900, pythonpath=(),
           backend=None):
    """Start n ranks calling target ("module:function") with args (saved
    with torch.save, loaded in every rank); returns their `Ranks`.
    pythonpath: more directories the ranks import from. A rank's stdout
    is this process's; its stderr goes to the launch's directory.
    backend: "gloo" with device="cuda" puts every rank on card 0 (gloo's
    collectives on CUDA tensors); by default the device's backend."""
    kind = torch.device(device).type
    cards = torch.cuda.device_count() if kind == "cuda" else 0
    if kind == "cuda" and backend in (None, "nccl") and n > cards:
        raise ValueError(f"launch: {n} ranks on {cards} card(s); NCCL "
                         f"takes one rank per card")
    workdir = tempfile.mkdtemp(prefix="ranks_")
    torch.save(args, os.path.join(workdir, "args.pt"))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT, *pythonpath] + ([env["PYTHONPATH"]]
                               if env.get("PYTHONPATH") else []))
    procs = []
    for r in range(n):
        with open(os.path.join(workdir, f"err{r}.txt"), "w") as err:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, "--rank", str(r),
                 "--world", str(n), "--device", device, "--dir", workdir,
                 "--target", target, "--backend", backend or ""],
                cwd=ROOT, env=dict(env, LOCAL_RANK=str(
                    r if backend in (None, "nccl") else 0)), stderr=err))
    return Ranks(procs, workdir, timeout)


def _rank_main(a):
    from .mesh import init_distributed

    if torch.device(a.device).type == "cpu":
        torch.set_num_threads(1)
    init_distributed(a.device, a.rank, a.world,
                     "file://" + os.path.join(a.dir, "store"),
                     backend=a.backend or None)
    args = torch.load(os.path.join(a.dir, "args.pt"), weights_only=False)
    module, name = a.target.split(":")
    out = getattr(importlib.import_module(module), name)(*args)
    torch.save(out, os.path.join(a.dir, f"out{a.rank}.pt"))
    torch.distributed.destroy_process_group()


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def tiny_config():
    """`__graft_entry__.py`'s tiny config (`_tiny_cfg`)."""
    from ..utils.config import DPVOConfig

    return DPVOConfig(
        BUFFER_SIZE=64, PATCHES_PER_FRAME=8, REMOVAL_WINDOW=6,
        OPTIMIZATION_WINDOW=4, PATCH_LIFETIME=3, KEYFRAME_INDEX=2,
        MEM=12, GRADIENT_BIAS=False, CORR_CHUNK=512, PALLAS_CORR=False)


def populated_state(cfg, device, ht=48, wd=64):
    """A plausible post-initialization state: 12 frames, the live edges
    of the last 4 frames from their 2 predecessors, random features; the
    `__graft_entry__.py`'s `_populated_state` recipe (numpy seed 0)."""
    from ..slam import steps
    from ..slam.state import init_state

    st = init_state(cfg, ht, wd, feat_dtype=steps.feat_dtype(cfg),
                    device=device)
    rng = np.random.default_rng(0)
    n, M, N = 12, cfg.PATCHES_PER_FRAME, cfg.BUFFER_SIZE
    h4, w4 = ht // 4, wd // 4
    poses = np.zeros((N, 7), np.float32)
    poses[:, 6] = 1.0
    poses[:n, 0] = 0.01 * np.arange(n)
    patches = st.patches.cpu().numpy()
    px = rng.uniform(2, w4 - 2, size=(N * M, 1, 1))
    py = rng.uniform(2, h4 - 2, size=(N * M, 1, 1))
    offs = np.arange(3) - 1
    patches[:, 0] = px + offs[None, None, :]
    patches[:, 1] = py + offs[None, :, None]
    patches[:, 2] = 1.0
    intr = np.tile(np.asarray([[40.0, 40.0, wd / 2, ht / 2]], np.float32)
                   / 4, (N, 1))

    def put(dst, a):
        dst.copy_(torch.as_tensor(np.asarray(a)).to(dst.dtype))

    put(st.poses, poses)
    put(st.patches, patches)
    put(st.intrinsics, intr)
    for name in ("imap", "gmap", "fmap1", "fmap2"):
        dst = getattr(st, name)
        put(dst, rng.normal(size=tuple(dst.shape)))
    ii, jj, kk = [], [], []
    for j in range(n - 4, n):
        for i in range(max(0, j - 2), j):
            for p in range(M):
                ii.append(i), jj.append(j), kk.append(i * M + p)
    E = len(ii)
    for name, vals in (("ii", ii), ("jj", jj), ("kk", kk)):
        getattr(st, name)[:E] = torch.as_tensor(vals)
    st.valid[:E] = True
    st.n_frames = n
    st.n_edges = E
    return st


def clone_state(st):
    """A copy of a SLAM state with every tensor cloned (the generator
    shared)."""
    return dataclasses.replace(st, **{
        f.name: getattr(st, f.name).clone()
        for f in dataclasses.fields(st)
        if isinstance(getattr(st, f.name), torch.Tensor)})


def _rel(a, b):
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / (1e-6 + b.abs().max()))


def _say(*a):
    import torch.distributed as dist

    if dist.get_rank() == 0:
        print(*a, flush=True)


def check_train(device):
    """1. One FSDP train step over make_mesh(n): a finite loss."""
    import torch.distributed as dist

    from ..models.vonet import init_vonet
    from ..train.forward import TrainConfig
    from .mesh import make_mesh
    from .train_step import (build_train_step, make_optimizer,
                             make_synthetic_batch, rank_seed)

    rank, n = dist.get_rank(), dist.get_world_size()
    tc = TrainConfig(frames=4, patches=4, steps=2)
    mesh = make_mesh(n, device)
    net = init_vonet(0).to(device)
    step = build_train_step(net, tc, make_optimizer(net.parameters()),
                            device, mesh=mesh)
    B = n * -(-4 // n)                   # >= 4 clips, a whole share each
    batch = make_synthetic_batch(torch.Generator().manual_seed(1), B, tc,
                                 ht=32, wd=32)
    m = step(batch, torch.Generator().manual_seed(rank_seed(2, rank)))
    loss = float(m["loss"])
    assert np.isfinite(loss), loss
    _say(f"dryrun_multichip({n}): one sharded train step OK, "
         f"loss={loss:.4f}, "
         f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    return {"train_loss": loss}


def check_corr(device):
    """2. The edge-sharded correlation on `__graft_entry__.py`'s inputs
    (with 128 channels, the card kernel's), equal to the unsharded
    lookup."""
    import torch.distributed as dist

    from ..ops.corr import corr_lookup
    from .infer_shard import make_edge_mesh, sharded_patch_corr

    n = dist.get_world_size()
    rng = np.random.default_rng(0)
    F, H, W, C = 3, 16, 24, 128         # the kernel's 128 channels
    E = 8 * n

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    gmap = dev(rng.normal(size=(6, C, 3, 3)))
    pyr = (dev(rng.normal(size=(F, H, W, C))),
           dev(rng.normal(size=(F, H // 4, W // 4, C))))
    coords = dev(rng.uniform(3, 12, size=(E, 3, 3, 2)))
    kk = dev(rng.integers(0, 6, E), torch.long)
    jj = dev(rng.integers(0, F, E), torch.long)
    valid = torch.ones(E, dtype=torch.bool, device=device)
    corr = sharded_patch_corr(make_edge_mesh(n, device), gmap, pyr, coords,
                              kk, jj, valid, chunk=32)
    ref = corr_lookup(gmap, pyr, coords, kk, jj, valid, chunk=32)
    assert torch.isfinite(corr).all()
    err = _rel(corr, ref)
    assert err < 1e-5, err
    _say(f"dryrun_multichip({n}): edge-sharded correlation OK, "
         f"corr={tuple(corr.shape)}, against unsharded {err:.1e}")
    return {"corr_rel": err}


def _slam_case(device):
    from ..models.vonet import init_vonet

    cfg = tiny_config()
    return cfg, init_vonet(0).to(device).eval(), populated_state(cfg, device)


def check_update(device):
    """3. `sharded_update_op` against `steps.update_op` on the populated
    state, within `__graft_entry__.py`'s 2e-2."""
    import torch.distributed as dist

    from ..slam import steps
    from .infer_shard import make_edge_mesh, sharded_update_op

    n = dist.get_world_size()
    cfg, net, state = _slam_case(device)
    t0 = max(int(state.n_frames) - cfg.OPTIMIZATION_WINDOW, 1)
    E = state.ii.shape[0]
    got = sharded_update_op(make_edge_mesh(n, device), cfg, net,
                            clone_state(state), t0, E)
    ref = steps.update_op(cfg, net, clone_state(state), t0, n_rows=E)
    out = {}
    for name in ("net", "target", "weight", "poses", "patches"):
        out[f"update_{name}_rel"] = err = _rel(getattr(got, name),
                                               getattr(ref, name))
        assert err < TOL_SHARDED_REL, (name, err)
    _say(f"dryrun_multichip({n}): edge-sharded tracked step matches "
         f"unsharded update_op (poses/patches/net/target/weight)")
    return out


def check_frame(device):
    """4. `sharded_frame_step` against `steps.frame_step` on the populated
    state and one new frame, within 2e-2."""
    import torch.distributed as dist

    from ..slam import steps
    from .infer_shard import make_edge_mesh, sharded_frame_step

    n = dist.get_world_size()
    cfg, net, state = _slam_case(device)
    E = state.ii.shape[0]
    rng = np.random.default_rng(1)
    img = torch.as_tensor(rng.integers(0, 255, (48, 64, 3)),
                          dtype=torch.uint8, device=device)
    c, given, d, j = steps.draw_inputs(cfg, state, 48, 64)
    inputs = steps.FrameInputs(
        img, torch.tensor([40.0, 40.0, 32.0, 24.0], device=device),
        torch.tensor(1.0, device=device), c.to(device), given.to(device),
        d.to(device), None if j is None else j.to(device))
    shd = sharded_frame_step(make_edge_mesh(n, device), cfg, net,
                             clone_state(state), inputs, E)
    with torch.no_grad():
        ref = steps.frame_step(cfg, net, clone_state(state), inputs, E)
    assert int(ref.n_frames) == int(shd.n_frames)
    assert int(ref.log_idx) == int(shd.log_idx)
    out = {}
    for name in ("poses", "patches", "net", "target", "weight", "log"):
        out[f"frame_{name}_rel"] = err = _rel(getattr(shd, name),
                                              getattr(ref, name))
        assert err < TOL_SHARDED_REL, (name, err)
    _say(f"dryrun_multichip({n}): FULL sharded frame_step "
         f"(insert+track+keyframe+log+retire) matches unsharded")
    return out


CHECKS = {"train": check_train, "corr": check_corr, "update": check_update,
          "frame": check_frame}


def run_checks(device, names=tuple(CHECKS)):
    """The named checks in order on one rank of the group; returns their
    readings."""
    out = {}
    for name in names:
        out.update(CHECKS[name](device))
    return out


def dryrun_multichip(n_devices, device="cuda", timeout=900, backend=None):
    """The four checks on n_devices ranks (gloo processes with
    device="cpu"); returns rank 0's readings."""
    return launch(n_devices, f"{MODULE}:run_checks", device, device=device,
                  timeout=timeout, backend=backend).wait()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=None,
                    help="ranks of the dry run")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--dir", default=None)
    ap.add_argument("--target", default=None)
    ap.add_argument("--backend", default="")
    a = ap.parse_args(argv)
    if a.target is not None:
        _rank_main(a)
    else:
        print(dryrun_multichip(a.n or 1, a.device))


if __name__ == "__main__":
    main()
