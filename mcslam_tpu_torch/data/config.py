"""Configuration system: app .cfg files + frontend/backend parameter YAMLs
(counterpart of mcslam_tpu/data/config.py: the same host code, so a .cfg
or a parameter YAML gives the same settings, SlamConfig and extraction
settings in both packages).

Parity (WHAT): the reference's three config tiers
(MCApps/src/ParseSettings.cpp:10-88 defines the .cfg option
set via boost::program_options; OpenCV FileStorage YAMLs carry frontend and
backend parameters, read in FrontEnd.h:124-199 and Backend.cpp:24-106).
The .cfg grammar here matches boost::program_options config files
(`key=value`, `#` comments), with relative paths resolved against
`data_path` as the reference does (ParseSettings.cpp:100-160).
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path

import yaml


# Full option set of the reference .cfg (ParseSettings.cpp:10-79), with the
# reference defaults.
_CFG_DEFAULTS = {
    "data_path": "",
    "images_path": "",
    "calib_file_path": "",
    "frontend_params_file": "",
    "backend_params_file": "",
    "vocabulary": "",
    "fbow_vocabulary": "",
    "traj_file": "trajectory.txt",
    "log_file": "",
    "logs_dir": "",
    "database_path": "",
    "map_path": "",
    "ros": "false",
    "parse_bag": "false",
    "bag_path": "",
    "camera_topics": "",
    "imu_topic": "",
    "gps_topic": "",
    "use_imu": "false",
    "use_gps": "false",
    "relocalization": "false",
    "navability": "false",
    "fast_tracking": "false",
    "segmentation": "false",
    "segmasks_path": "",
    "kalibr": "true",
    "undistort": "true",
    "radtan": "true",
    "num_cams": "1",
    "frames": "",
    "shifts": "",
    "imu_map_frame": "false",
    "video_streams": "",
    "debug_mode": "false",
    # dense depth reconstruction (reference calc_depth/depth_est,
    # ParseSettings.cpp:39-45); depth maps saved per keyframe
    "calc_depth": "false",
    "depth_dir": "",
    "depth_max_disp": "64",
    # multi-chip: shard window-BA solves across this many devices
    # (0 = single chip)
    "mesh_devices": "0",
}

_BOOL_KEYS = {
    "ros", "parse_bag", "use_imu", "use_gps", "relocalization", "navability",
    "fast_tracking", "segmentation", "kalibr", "undistort", "radtan",
    "imu_map_frame", "debug_mode", "calc_depth",
}
_PATH_KEYS = {
    "images_path", "calib_file_path", "frontend_params_file",
    "backend_params_file", "vocabulary", "fbow_vocabulary", "traj_file",
    "log_file", "logs_dir", "database_path", "map_path", "bag_path",
    "segmasks_path", "video_streams", "depth_dir",
}


@dataclasses.dataclass
class AppSettings:
    """Parsed .cfg settings (reference MCDataUtilParams equivalent,
    MCDataUtils/include/MCDataUtils/MCDataUtilParams.h)."""

    raw: dict

    def __getattr__(self, k):
        try:
            return self.raw[k]
        except KeyError as e:
            raise AttributeError(k) from e

    @property
    def frames_range(self):
        """'start,end' or 'start,end,step' CSV -> tuple or None."""
        s = self.raw.get("frames", "")
        if not s:
            return None
        parts = [int(x) for x in s.split(",")]
        return tuple(parts)

    @property
    def shifts(self):
        s = self.raw.get("shifts", "")
        if not s:
            return None
        return [int(x) for x in s.split(",")]


def parse_cfg(path) -> AppSettings:
    """Parse a boost::program_options-style config file."""
    values = dict(_CFG_DEFAULTS)
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("["):
                continue
            if "=" not in line:
                continue
            k, v = line.split("=", 1)
            k = k.strip()
            v = v.split("#", 1)[0].strip()
            values[k] = v
    # bools
    out = {}
    for k, v in values.items():
        if k in _BOOL_KEYS:
            out[k] = str(v).lower() in ("1", "true", "yes", "on")
        else:
            out[k] = v
    # resolve relative paths against data_path (reference semantics)
    base = out.get("data_path", "")
    if base:
        for k in _PATH_KEYS:
            v = out.get(k, "")
            if v and not os.path.isabs(v):
                out[k] = str(Path(base) / v)
    out["num_cams"] = int(out["num_cams"])
    return AppSettings(raw=out)


# Frontend / backend parameter YAML keys (reference spec, SURVEY §5):
_FRONTEND_DEFAULTS = {
    "Vocabulary": "",
    "FBOWVocabulary": "",
    "ORBextractor.nFeatures": 1000,
    "ORBextractor.scaleFactor": 1.2,
    "ORBextractor.nLevels": 8,
    "ORBextractor.iniThFAST": 20,
    "ORBextractor.minThFAST": 7,
    "InitCondition": "RANSAC_FILTER",
    "PoseEstimation": "SEVENTEEN_PT",
    "InterMatch": "BoW",
    "KFBaselineThresholdTranslation": 0.12,
    "KFBaselineThresholdRotation": 0.12,
    "LogDir": "",
}

_BACKEND_DEFAULTS = {
    "CamID": 0,
    "MeasurementNoiseSigma": 1.0,
    "Optimization": 2,  # 0=ISAM2-equiv incremental, 1=LM batch, 2=fixed-lag
    "ISAMRelinearizeThreshold": 0.01,
    "ISAMRelinearizeSkip": 1,
    "WindowBad": 6,
    "AngleThresh": 1.0,
    "BackEndType": "MULTI_RIGID",
}


def _load_opencv_yaml(path):
    """OpenCV FileStorage YAML: strip the %YAML directive, parse the rest."""
    text = Path(path).read_text()
    lines = [
        l for l in text.splitlines()
        if not l.startswith("%YAML") and not l.startswith("---")
    ]
    return yaml.safe_load("\n".join(lines)) or {}


def load_frontend_params(path=None) -> dict:
    out = dict(_FRONTEND_DEFAULTS)
    if path and Path(path).exists():
        out.update(_load_opencv_yaml(path))
    return out


def load_backend_params(path=None) -> dict:
    out = dict(_BACKEND_DEFAULTS)
    if path and Path(path).exists():
        out.update(_load_opencv_yaml(path))
    return out


# Enum value tables of the reference frontend YAML. The reference casts the
# YAML int straight onto the enum (FrontEnd.h:159-161); the enums live at
# MCSlam/include/MCSlam/FrontEnd.h:94-105. Symbolic names are
# accepted too since our shipped YAMLs use them.
_INIT_COND = {"MIN_FEATS": 0, "RANSAC_FILTER": 1}
_POSEST_ALGO = {"PC_ALIGN": 0, "SEVENTEEN_PT": 1, "G_P3P": 2}
_INTER_MATCH = {"BF_MATCH": 0, "BF": 0, "BoW_MATCH": 1, "BoW": 1}


def _enum_value(raw, table, key):
    """Reference YAML enum -> int, rejecting values the reference's enum
    does not define (no silent ignores for a carried-over YAML)."""
    if isinstance(raw, str) and not raw.lstrip("-").isdigit():
        if raw in table:
            return table[raw]
        raise ValueError(
            f"{key}={raw!r}: expected one of {sorted(table)} or an integer "
            f"in {sorted(set(table.values()))}"
        )
    v = int(raw)
    if v not in set(table.values()):
        raise ValueError(
            f"{key}={raw!r}: valid values are {sorted(set(table.values()))} "
            f"({', '.join(f'{n}={i}' for n, i in sorted(table.items(), key=lambda kv: kv[1]))})"
        )
    return v


def slam_config_from_params(frontend: dict, backend: dict):
    """Map reference parameter names onto SlamConfig.

    Every reference YAML key either changes behavior here or raises on a
    value the reference does not define:

    - ``InitCondition`` (FrontEnd.cpp:2485): MIN_FEATS initializes directly
      from the first frame whose intra-match triangulation yields >150
      landmarks; RANSAC_FILTER (default) additionally allows the two-view
      bootstrap paths (essential / 17-pt) when intra depth is thin.
    - ``PoseEstimation`` (FrontEnd.cpp:4421 dispatch): validated; the fused
      tracking portfolio runs PC_ALIGN (Kabsch), G_P3P (PnP) and the 17-pt
      solver TOGETHER and keeps the best-inlier candidate — a superset of
      any single dispatch choice, so all three values select the same
      (stronger) program.
    - ``InterMatch`` (FrontEnd.cpp:6015): validated; both BF_MATCH and
      BoW_MATCH select the popcount-matmul brute-force matcher — the
      reference's BoW bucketing is a CPU approximation of exactly this
      (SURVEY §7 stage 4), so BF semantics are the superset.
    - ``MeasurementNoiseSigma`` (Backend.cpp:24-106): pixel sigma of the
      BA reprojection noise model -> SlamConfig.px_sigma.
    - ``Optimization`` (Backend.cpp:3060-3402): 0 (ISAM2 incremental) and
      2 (fixed-lag) select the production windowed solver with marginal
      carry + post-loop global BA; 1 (LM batch) additionally re-solves the
      full accumulated graph once at finalize() (the reference LM path
      re-solves everything each update).
    - ``WindowBad`` -> sliding-window size.
    """
    from mcslam_tpu_torch.slam import SlamConfig

    init_cond = _enum_value(frontend["InitCondition"], _INIT_COND,
                            "InitCondition")
    _enum_value(frontend["PoseEstimation"], _POSEST_ALGO, "PoseEstimation")
    _enum_value(frontend["InterMatch"], _INTER_MATCH, "InterMatch")
    opt_mode = int(backend["Optimization"])
    if opt_mode not in (0, 1, 2):
        raise ValueError(
            f"Optimization={opt_mode!r}: valid values are 0 (ISAM2), "
            "1 (LM batch), 2 (fixed-lag) — Backend.cpp:3060-3402"
        )

    return SlamConfig(
        kf_translation=float(frontend["KFBaselineThresholdTranslation"]),
        kf_rotation=float(frontend["KFBaselineThresholdRotation"]),
        window_size=int(backend["WindowBad"]),
        px_sigma=float(backend["MeasurementNoiseSigma"]),
        init_min_feats=(init_cond == _INIT_COND["MIN_FEATS"]),
        final_global_ba=(opt_mode == 1),
    ), {
        "num_points": int(frontend["ORBextractor.nFeatures"]),
        "num_levels": int(frontend["ORBextractor.nLevels"]),
        "fast_threshold": float(frontend["ORBextractor.iniThFAST"]) / 255.0,
        "min_threshold": float(frontend["ORBextractor.minThFAST"]) / 255.0,
    }
