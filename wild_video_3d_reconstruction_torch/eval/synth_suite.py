"""Multi-scene SLAM accuracy table on rendered sequences.

The port's copy of the JAX package's `eval/synth_suite.py`. The
reference's correctness oracle is a per-scene ATE table over 9 TUM fr1 /
7 EuRoC scenes with median-of-trials aggregation
(`evaluation/dpvo_eva_tum.py:144-197`, `dpvo_eva_euroc.py:145-216`);
here a fixed registry of world seeds x camera paths stands in for the
scene list, each scene is tracked `--trials` times with different SLAM
seeds (patch selection is the stochastic element, as in the reference)
by `eval/synth_ate.run`, and the table reports the per-scene median ATE
of each weight configuration beside the identity-trajectory floor.

Run (from the repository root):

    python -u -m wild_video_3d_reconstruction_torch.eval.synth_suite \
        [--network weights/vonet_synth_tpu_r3_step2000.pth] [--trials 3] \
        [--quick] [--markdown PATH] [--device cpu]

`--network` adds a "trained" column from a DPVO-layout `.pth` beside the
"random" one (weights drawn from seed 0). Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import synth_ate

# the "dataset": world seed x camera path, named like scenes
SCENES = [
    ("walk_s0", dict(path="walk", seed=0)),
    ("walk_s1", dict(path="walk", seed=1)),
    ("walk_s2", dict(path="walk", seed=2)),
    ("walk_s3", dict(path="walk", seed=3)),
    ("orbit_s0", dict(path="orbit", seed=0)),
    ("orbit_s1", dict(path="orbit", seed=1)),
]


def run_suite(param_sets, frames=60, trials=3, scenes=SCENES, log=print,
              device="cuda", draws=None, **run_kw):
    """{config_name: network} -> per-scene medians + overall means.
    network: as `DPVO` takes it. draws(slam_seed): per frame, the keyword
    arguments of `DPVO.__call__` that replace the run's draws (the parity
    tests feed the JAX runs'); run_kw: more arguments of
    `synth_ate.run`."""
    table = {}
    for sname, skw in scenes:
        row = {}
        for cname, params in param_sets.items():
            t0 = time.time()
            runs = [synth_ate.run(params, frames=frames, slam_seed=s,
                                  device=device,
                                  draws=draws(s) if draws else None,
                                  **skw, **run_kw)
                    for s in range(trials)]
            med = float(np.median([r["ate_rmse"] for r in runs]))
            row[cname] = {
                "ate_median": med,
                "ate_all": [round(r["ate_rmse"], 4) for r in runs],
                "floor": runs[0]["ate_floor_identity"],
            }
            log(f"{sname:10s} {cname:8s} median {med:.4f} "
                f"(floor {runs[0]['ate_floor_identity']:.4f}, "
                f"{time.time() - t0:.0f}s)")
        table[sname] = row
    out = {"metric": "synth_suite", "frames": frames, "trials": trials,
           "scenes": table}
    for cname in param_sets:
        out[f"mean_{cname}"] = float(np.mean(
            [table[s][cname]["ate_median"] for s, _ in scenes]))
    out["mean_floor"] = float(np.mean(
        [table[s][next(iter(param_sets))]["floor"] for s, _ in scenes]))
    return out


def to_markdown(out, param_names):
    lines = ["| scene | " + " | ".join(param_names) + " | identity floor |",
             "|---|" + "---|" * (len(param_names) + 1)]
    for sname, row in out["scenes"].items():
        cells = [f"{row[c]['ate_median']:.4f}" for c in param_names]
        lines.append(f"| {sname} | " + " | ".join(cells)
                     + f" | {row[param_names[0]]['floor']:.4f} |")
    means = [f"**{out[f'mean_{c}']:.4f}**" for c in param_names]
    lines.append("| **mean** | " + " | ".join(means)
                 + f" | **{out['mean_floor']:.4f}** |")
    return "\n".join(lines)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--network", type=str, default=None,
                    help="DPVO-layout .pth (adds a 'trained' column)")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="2 scenes, 1 trial (smoke)")
    ap.add_argument("--markdown", type=str, default=None)
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device; cuda unless 'cpu' is asked for")
    args = ap.parse_args(argv)

    from ..models.convert import as_vonet

    param_sets = {"random": None}
    if args.network:
        param_sets["trained"] = as_vonet(args.network)

    scenes = SCENES[:2] if args.quick else SCENES
    trials = 1 if args.quick else args.trials
    out = run_suite(param_sets, frames=args.frames, trials=trials,
                    scenes=scenes, device=args.device)
    if args.markdown:
        with open(args.markdown, "w", encoding="utf-8") as f:
            f.write(to_markdown(out, list(param_sets)) + "\n")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
