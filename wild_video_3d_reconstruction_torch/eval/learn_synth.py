"""Learning on rendered synthetic clips, before and after training.

Counterpart of the JAX package's `eval/learn_synth.py`: train a VONet for
some steps on rendered slanted-plane clips (`train/synth.py`) through the
one-device training step, and compare the flow end-point error and the
pose errors of the training forward's last step on held-out clips
before and after.

    python -m wild_video_3d_reconstruction_torch.eval.learn_synth \\
        [--steps 200] [--batch 4] [--eval_clips 8] [--device cuda] \\
        [--resume weights/vonet_synth_tpu_r3_step2000.pth] [--save DIR]

Prints one JSON line with the metrics before and after. Each held-out
clip draws its patches, depths and dropout from a generator seeded
1234 + its index in its batch, in place of the JAX package's
`PRNGKey(1234 + i)` (ROADMAP R18: the draws differ from the JAX
package's).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..models.convert import load_reference_checkpoint
from ..models.vonet import init_vonet
from ..ops import lie
from ..parallel.train_step import batch_to, build_train_step, make_optimizer
from ..train.forward import TrainConfig, vonet_training_forward
from ..train.synth import make_world_batch


def clip_errors(out):
    """(flow EPE in px at 1/4 scale, t_err, r_err) of one step's output:
    the EPE over the supervised edges; the poses aligned to their first
    and compared as relative poses."""
    v = out["valid"]
    epe = ((out["coords"] - out["coords_gt"])[:, 1, 1, :].norm(dim=-1)
           * v).sum() / torch.clamp(v.sum(), min=1.0)

    def rel(poses):
        return lie.se3_mul(poses, lie.se3_inv(poses[:1]))

    dP = lie.se3_mul(rel(out["poses"]), lie.se3_inv(rel(out["poses_gt"])))
    t_err = dP[:, :3].norm(dim=-1).mean()
    w = dP[:, 6].abs().clamp(0.0, 1.0)
    r_err = (2 * torch.arccos(w)).mean()
    return epe, t_err, r_err


@torch.no_grad()
def evaluate(net, batches, tc, device="cuda"):
    """Mean final-step flow EPE, t_err and r_err of the training forward
    over the held-out clips of `batches` (numpy batches)."""
    errs = []
    for b in batches:
        bd = batch_to(b, device)
        for i in range(bd["images"].shape[0]):
            traj = vonet_training_forward(
                net, bd["images"][i], bd["poses"][i], bd["disps"][i],
                bd["intrinsics"][i], torch.Generator().manual_seed(1234 + i),
                tc)
            errs.append(torch.stack(clip_errors(traj[-1])))
    epe, t_err, r_err = torch.stack(errs).mean(0).tolist()
    return {"epe": epe, "t_err": t_err, "r_err": r_err}


def held_out_batches(tc, eval_clips=8, ht=48, wd=64):
    return [make_world_batch(10_000 + i, 1, tc, ht=ht, wd=wd)
            for i in range(eval_clips)]


def main(steps=200, batch=4, eval_clips=8, lr=3e-4, seed=0, frames=6,
         patches=8, ht=48, wd=64, log_every=20, save=None, resume=None,
         harden=False, device="cuda"):
    from ..train.trainer import save_checkpoint

    tc = TrainConfig(frames=frames, patches=patches, steps=3)
    net = load_reference_checkpoint(resume, device) if resume else \
        init_vonet(seed).to(device)
    if resume:
        print("resumed params from", resume, flush=True)

    held_out = held_out_batches(tc, eval_clips, ht, wd)
    print("evaluating the starting network ...", flush=True)
    before = evaluate(net, held_out, tc, device)
    print("before:", before, flush=True)

    step_fn = build_train_step(
        net, tc, make_optimizer(net.parameters(), lr=lr, steps=steps),
        device)
    generator = torch.Generator().manual_seed(seed)
    losses = []
    t0 = time.time()
    for s in range(steps):
        b = make_world_batch(seed * 1000 + s, batch, tc, ht=ht, wd=wd,
                             harden=(s % 2 == 0) if harden == "mix"
                             else harden)
        metrics = step_fn(b, generator)
        losses.append(metrics["loss"])
        if s % log_every == 0 or s == steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            print(f"step {s}: loss={m['loss']:.4f} "
                  f"flow={m['flow_loss']:.4f} pose={m['pose_loss']:.4f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        if save and s and s % 100 == 0:
            save_checkpoint(net, save, s)
    losses = torch.stack(losses).tolist()
    seconds = time.time() - t0
    if save:
        print("saved trained params to", save_checkpoint(net, save, steps),
              flush=True)

    after = evaluate(net, held_out, tc, device)
    print("after:", after, flush=True)
    result = {"metric": "synth_learning", "before": before, "after": after,
              "steps": steps, "train_s": seconds,
              "epe_ratio": after["epe"] / max(before["epe"], 1e-9)}
    print(json.dumps(result), flush=True)
    result["losses"] = losses           # every step's loss
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--eval_clips", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--save", type=str, default=None,
                    help="directory for the trained network's .pth")
    ap.add_argument("--resume", type=str, default=None,
                    help=".pth checkpoint to continue from")
    ap.add_argument("--harden", nargs="?", const=True, default=False,
                    help="train on hardened worlds; 'mix' alternates clean "
                         "and hardened batches; the held-out clips stay "
                         "clean")
    args = ap.parse_args()
    main(steps=args.steps, batch=args.batch, eval_clips=args.eval_clips,
         lr=args.lr, save=args.save, resume=args.resume,
         harden=args.harden, device=args.device)
