"""Named dataset registry for in-the-wild sequences.

The port's copy of the JAX package's `utils/datasets.py`, the reference's
`data_config/dataset_config.py:11-68`: a dataclass registry mapping
sequence names to image directories, calibration files and frame
ranges, so batch drivers and the demo can be pointed at a sequence by
name. The entries here are examples: register your own with `register()`
or a `datasets.yaml` beside your data root (`load_registry_yaml`, read by
`utils/config.py:parse_two_level_yaml`, no YAML library).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Optional

from .config import load_config, parse_two_level_yaml, resource_path


@dataclass
class Dataset:
    name: str
    imagedir: str
    calib: Optional[str] = None          # None -> auto-calibration
    depthdir: Optional[str] = None
    maskdir: Optional[str] = None
    skip: int = 0
    end: Optional[int] = None
    stride: int = 1
    config: str = "configs/default.yaml"
    notes: str = ""
    # [start, end) frame ranges for per-clip NeRF training
    # (`nerf_prepare_batch.py` Datasets[...]["clips"])
    clips: Optional[list] = None


DATASETS: dict[str, Dataset] = {}


def register(ds: Dataset):
    DATASETS[ds.name] = ds
    return ds


def get(name: str) -> Dataset:
    """The entry `name`, its imagedir with environment variables
    expanded."""
    if name not in DATASETS:
        raise KeyError(f"unknown dataset '{name}'; known: "
                       f"{sorted(DATASETS)}")
    ds = DATASETS[name]
    return replace(ds, imagedir=os.path.expandvars(ds.imagedir))


def load_registry_yaml(path):
    """Load additional entries from a YAML file: {name: {imagedir: ...}}."""
    entries = parse_two_level_yaml(Path(path).read_text())
    for name, kw in entries.items():
        register(Dataset(name=name, **kw))
    return DATASETS


# ---- example entries (datasets used by the reference paper) ---------------
register(Dataset(
    name="euroc_mh01",
    imagedir="/data/euroc/MH_01_easy/mav0/cam0/data",
    calib="calib/euroc.txt",
    config="configs/fast.yaml",
    notes="EuRoC machine hall, easy"))
register(Dataset(
    name="tum_fr1_desk",
    imagedir="/data/tum/rgbd_dataset_freiburg1_desk/rgb",
    calib="calib/tum3.txt",
    config="configs/tum.yaml"))
register(Dataset(
    name="wild_512_example",
    imagedir="/data/wild/clip_512/images",
    calib=None,                          # run auto-calibration
    stride=1,
    config="configs/default.yaml",
    notes="512x384 @ 5 FPS in-the-wild clip (reference regime)"))

# in-the-wild scenes of the reference paper (`dataset_config.py:34-68`);
# point WILD_DATA_ROOT at your download location
register(Dataset(
    name="he_01",
    imagedir="${WILD_DATA_ROOT}/HELSINGBORG_wUZ_zslH3vY/clip0/512/images",
    calib="calib/helsingborgw_UZ_zslH3vY_512.txt",
    end=2700,
    config="configs/default.yaml",
    notes="Helsingborg walking tour, first 2700 frames"))
register(Dataset(
    name="he_02",
    imagedir="${WILD_DATA_ROOT}/HELSINGBORG_wUZ_zslH3vY/clip0/512/images",
    calib="calib/helsingborgw_UZ_zslH3vY_512.txt",
    skip=2700,
    config="configs/default.yaml",
    notes="Helsingborg walking tour, remainder"))
register(Dataset(
    name="lund",
    imagedir="${WILD_DATA_ROOT}/lund_Nhc5BNlfDms/images/512/images",
    calib="calib/lund_Nhc5BNlfDms.txt",
    config="configs/default.yaml"))
register(Dataset(
    name="uppsala",
    imagedir="${WILD_DATA_ROOT}/upplasa_aVh_jTIP2cE/image/512/images",
    calib="calib/upplasa_aVh_jTIP2cE.txt",
    config="configs/default.yaml"))


def run_multi_scenes(names, network=None, out_root="./outputs", **overrides):
    """Batch driver over registered sequences (the reference's
    `test_scripts/run_multi_scenes.py`): `demo.run` on each, with the
    trajectory and the COLMAP model written under out_root/<name>;
    overrides: more keyword arguments of `demo.run` (device=, ...).
    Returns {name: what `demo.run` returns}."""
    from ..demo import run

    results = {}
    for name in names:
        ds = get(name)
        cfg = load_config(ds.config if Path(resource_path(ds.config))
                          .exists() else None)
        results[name] = run(
            cfg, network, ds.imagedir, ds.calib, stride=ds.stride,
            skip=ds.skip, end=ds.end, path=f"{out_root}/{name}",
            save_trajectory=True, export_colmap=True, depthdir=ds.depthdir,
            maskdir=ds.maskdir, **overrides)
    return results
