"""Configuration: the `DPVOConfig` dataclass and a flat YAML loader.

Same knob names, defaults and derived capacities as the JAX package's
config, so `configs/*.yaml` load unchanged. The files are flat
`KEY: value` lines with `#` comments, so a small parser of our own reads
them and the port needs no YAML library.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from pathlib import Path


@dataclass(frozen=True)
class DPVOConfig:
    # max number of keyframes (buffer capacity)
    BUFFER_SIZE: int = 2048
    # bias patch selection towards high gradient regions
    GRADIENT_BIAS: bool = True
    PATCHES_PER_FRAME: int = 80
    REMOVAL_WINDOW: int = 20
    OPTIMIZATION_WINDOW: int = 12
    PATCH_LIFETIME: int = 12
    KEYFRAME_INDEX: int = 4
    KEYFRAME_THRESH: float = 12.5
    MOTION_MODEL: str = "DAMPED_LINEAR"
    MOTION_DAMPING: float = 0.5
    # warm-up frame-acceptance gate in px of probed flow; <0 disables it
    MOTION_PROBE_THRESH: float = 2.0
    MIXED_PRECISION: bool = True
    loop_enabled: bool = False
    LOOP_CLOSE_WINDOW_SIZE: int = 3
    LOOP_RETR_THRESH: float = 0.50
    ENABLE_GLOBAL_BA: bool = False
    DISTANCE_THRESH: float = 3.0
    USE_DISTANCE_EDGES: bool = True
    # ring-buffer depth for feature memory
    MEM: int = 36
    # edge chunk of the unfused plain correlation (`corr_lookup`)
    CORR_CHUNK: int = 4096
    # Correlation route, as in the JAX package's `slam/steps.py`. Both
    # routes launch the one exact correlation body (`csrc/corr_box.cu`);
    # PALLAS_FUSED also returns the spill flags of PALLAS_VARIANT's region
    # (x32 = 16x32 regions with the x origin aligned to 16, x16 = 16x16
    # regions at the exact origin). PALLAS_CORR and PALLAS_HYBRID_BUDGET are
    # accepted and change nothing: the port has no gather-free TPU path
    # to switch off, and the body computes the pixels that do not fit the
    # region exactly, so no clipped edges are left for a hybrid pass to
    # recompute.
    PALLAS_CORR: bool = True
    PALLAS_FUSED: bool = False
    PALLAS_VARIANT: str = "x32"
    PALLAS_HYBRID_BUDGET: int = 0
    LOG_CAP: int = 8192
    PIPELINE_CHUNK: int = 1
    DESC_DIM: int = 2048
    LC_INTERVAL: int = 16
    # steady-state patch inverse-depth init: "random" or "median"
    DEPTH_INIT: str = "random"
    PATCH_SELECTOR: str = "random"
    RETRIEVAL_BACKEND: str = "vlad"
    EDGE_TIERS: int = 2
    # per-GN-iteration trust region on the inverse-depth step; 0 disables
    DEPTH_STEP_CLAMP: float = 1.0
    # initial depth damping of the 12-iteration bootstrap (0.35^k decay,
    # floored at 1e-4)
    BOOT_LAM0: float = 1e-4
    NETVLAD_CHECKPOINT: str = ""
    LOOP_SKIP_WINDOW: int = 50
    LOOP_MIN_INLIERS: int = 30
    LOOP_KP_STRIDE: int = 1
    LOOP_RESID_THRESH: float = 2.0
    LOOP_DRIFT_GATE: float = 0.02

    def merge_from_file(self, path):
        return self.merge_from_dict(parse_flat_yaml(Path(path).read_text()))

    def merge_from_dict(self, overrides):
        valid = {f.name for f in dataclasses.fields(self)}
        for k in overrides:
            if k not in valid:
                raise KeyError(f"unknown config key: {k}")
        return dataclasses.replace(self, **overrides)

    def merge_from_list(self, opts):
        """yacs-style ["KEY", value, "KEY", value, ...] CLI overrides."""
        overrides = {}
        for k, v in zip(opts[::2], opts[1::2]):
            cur = getattr(self, k)  # raises on unknown key
            if isinstance(cur, bool):
                v = v in (True, "True", "true", "1", 1)
            elif isinstance(cur, int):
                v = int(v)
            elif isinstance(cur, float):
                v = float(v)
            overrides[k] = v
        return self.merge_from_dict(overrides)

    def dump(self):
        return "".join(f"{k}: {_format(v)}\n"
                       for k, v in sorted(dataclasses.asdict(self).items()))

    # ---- derived static capacities --------------------------------------

    @property
    def pmem(self):
        return self.BUFFER_SIZE if self.ENABLE_GLOBAL_BA else self.MEM

    @property
    def edge_capacity(self):
        """Edge-table size: worst case of the edge lifecycle with no
        keyframe drops, plus one frame of appends, rounded up to 1024."""
        M, r, w = self.PATCHES_PER_FRAME, self.PATCH_LIFETIME, \
            self.REMOVAL_WINDOW
        per_frame = []
        max_active = 0
        for n in range(1, 4 * (r + w)):
            forw = M * (min(n - 1, r - 1))
            back = M * min(r, n)
            per_frame.append((n - 1, forw + back))
            per_frame = [(s, c) for (s, c) in per_frame if s >= n - w]
            max_active = max(max_active, sum(c for _, c in per_frame))
        cap = max_active + M * (2 * r - 1)
        return ((cap + 1023) // 1024) * 1024

    @property
    def ba_window(self):
        # also covers the whole bootstrap window (t0=1 at n=warmup=10)
        return max(self.OPTIMIZATION_WINDOW + 2, 10)

    @property
    def patch_window_frames(self):
        """Frames whose patches can appear in live edges / BA."""
        return self.REMOVAL_WINDOW + 3

    @property
    def patch_slots(self):
        return self.patch_window_frames * self.PATCHES_PER_FRAME

    @property
    def frame_window(self):
        """Frames that can be touched by live edges (ii or jj)."""
        return self.REMOVAL_WINDOW + 3


def _format(v):
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return repr(v) if v == "" else v
    return repr(v)


def _scalar(text):
    low = text.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if low in ("null", "none", "~"):
        return None
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_flat_yaml(text):
    """Parse `KEY: value` lines with `#` comments into a dict.

    Values become bool, int, float or str as YAML would read them. Any
    other YAML construct (nesting, lists, block scalars) raises, so a file
    this parser cannot read is never read wrongly.
    """
    out = {}
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if raw[:1].isspace() or ":" not in line:
            raise ValueError(f"line {lineno}: not a flat 'KEY: value' line:"
                             f" {raw!r}")
        key, value = line.split(":", 1)
        value = value.strip()
        if value.startswith(("'", '"')):
            end = value.find(value[0], 1)
            value = value[:end + 1] if end > 0 else value
        elif " #" in value:
            value = value.split(" #", 1)[0].strip()
        if value == "" or value[0] in "[{|>&*!":
            raise ValueError(f"line {lineno}: unsupported YAML value "
                             f"{value!r}")
        out[key.strip()] = _scalar(value)
    return out


_REPO_ROOT = Path(__file__).resolve().parent.parent.parent


def resource_path(rel):
    """Resolve `rel` against the CWD, then the repo root, then $WV3D_ROOT;
    returns it unchanged when nothing exists."""
    if rel is None:
        return rel
    p = Path(rel)
    if p.is_absolute() or p.exists():
        return str(rel)
    cand = _REPO_ROOT / p
    if cand.exists():
        return str(cand)
    env = os.environ.get("WV3D_ROOT")
    if env and (Path(env) / p).exists():
        return str(Path(env) / p)
    return str(rel)


def load_config(yaml_path=None, **overrides):
    cfg = DPVOConfig()
    if yaml_path:
        cfg = cfg.merge_from_file(resource_path(yaml_path))
    if overrides:
        cfg = cfg.merge_from_dict(overrides)
    return cfg
