"""EuRoC MAV dataset (ASL layout) calibration + ground-truth loaders
(counterpart of mcslam_tpu/data/euroc.py: the same host numpy; the rig is
the port's, built on `device`, the card unless the caller asks for the
CPU).

Parity (WHAT): the reference evaluates on real rigs via its Kalibr camchain
reader and the evo-based TUM workflow (evaluation.md:1-27,
DatasetReader::read_kalibr_data DatasetReader.cpp:169-273). EuRoC ships ASL
sensor.yaml files instead of a camchain; this module maps them onto the same
CameraRig / ImuParams structures so `python -m
mcslam_tpu_torch.apps.run_euroc <seq_dir>` is one command from raw
sequence to ATE numbers.

Layout handled (standard EuRoC):
  <seq>/mav0/cam0/{sensor.yaml,data/<ns>.png}
  <seq>/mav0/cam1/...
  <seq>/mav0/imu0/{sensor.yaml,data.csv}
  <seq>/mav0/state_groundtruth_estimate0/data.csv
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import yaml

import torch

from mcslam_tpu_torch.geometry import camera as cam_ops


_DIST_MODELS = {
    "radial-tangential": cam_ops.DIST_RADTAN,
    "radtan": cam_ops.DIST_RADTAN,
    "equidistant": cam_ops.DIST_EQUIDISTANT,
}


def find_mav0(seq_dir) -> Path:
    """Accept either the sequence root or the mav0 directory itself."""
    p = Path(seq_dir)
    if (p / "mav0").is_dir():
        return p / "mav0"
    if p.name == "mav0" or (p / "cam0").is_dir():
        return p
    raise FileNotFoundError(f"no EuRoC mav0 layout under {seq_dir}")


def _read_T_BS(block) -> np.ndarray:
    return np.asarray(block["data"], np.float64).reshape(
        int(block["rows"]), int(block["cols"])
    )


def load_euroc_rig(seq_dir, cam_dirs=None, device="cuda"):
    """-> (CameraRig, ImuParams | None, cam_dirs). Extrinsics: EuRoC T_BS is
    body-from-sensor; cam_T_ref[i] = inv(T_BS_i) @ T_BS_0 (cam0 = reference),
    body_T_cam[i] = T_BS_i."""
    mav0 = find_mav0(seq_dir)
    if cam_dirs is None:
        cam_dirs = sorted(
            d.name for d in mav0.iterdir()
            if d.is_dir() and d.name.startswith("cam")
            and (d / "sensor.yaml").exists()
        )
    if not cam_dirs:
        raise FileNotFoundError(f"no cam*/sensor.yaml under {mav0}")

    n = len(cam_dirs)
    fxycxy = np.zeros((n, 4), np.float32)
    dist = np.zeros((n, 5), np.float32)
    T_BS = np.zeros((n, 4, 4))
    model = cam_ops.DIST_RADTAN
    image_size = (752, 480)
    for i, d in enumerate(cam_dirs):
        with open(mav0 / d / "sensor.yaml") as f:
            y = yaml.safe_load(f)
        fxycxy[i] = np.asarray(y["intrinsics"], np.float32)
        dc = np.asarray(y.get("distortion_coefficients", []), np.float32)
        dist[i, : len(dc)] = dc
        model = _DIST_MODELS.get(
            y.get("distortion_model", "radial-tangential"), model
        )
        if "resolution" in y:
            image_size = tuple(int(v) for v in y["resolution"])
        T_BS[i] = _read_T_BS(y["T_BS"])

    cam_T_ref = np.stack(
        [np.linalg.inv(T_BS[i]) @ T_BS[0] for i in range(n)]
    ).astype(np.float32)
    body_T_cam = T_BS.astype(np.float32)

    imu_params = None
    imu_yaml = mav0 / "imu0" / "sensor.yaml"
    if imu_yaml.exists():
        from mcslam_tpu_torch.backend.imu import ImuParams

        with open(imu_yaml) as f:
            y = yaml.safe_load(f)
        imu_params = ImuParams(
            accel_noise=float(y.get("accelerometer_noise_density", 2e-3)),
            gyro_noise=float(y.get("gyroscope_noise_density", 1.7e-4)),
            accel_walk=float(y.get("accelerometer_random_walk", 3e-3)),
            gyro_walk=float(y.get("gyroscope_random_walk", 2e-5)),
        )
        # re-root the camera chain in the IMU body frame if imu0 carries a
        # non-identity T_BS (EuRoC's is identity: body == imu frame)
        T_BI = _read_T_BS(y["T_BS"]) if "T_BS" in y else np.eye(4)
        if not np.allclose(T_BI, np.eye(4)):
            body_T_cam = np.stack(
                [np.linalg.inv(T_BI) @ T_BS[i] for i in range(n)]
            ).astype(np.float32)

    rig = cam_ops.make_rig(
        fxycxy, dist, cam_T_ref, body_T_cam, image_size=image_size,
        dist_model=model, device=device,
    )
    return rig, imu_params, cam_dirs


def load_groundtruth_tum(seq_dir):
    """state_groundtruth_estimate0/data.csv -> (ts [s], poses (N, 4, 4)).
    CSV columns: ns, p_xyz (world), q_wxyz, [velocity, biases...]."""
    mav0 = find_mav0(seq_dir)
    csv = mav0 / "state_groundtruth_estimate0" / "data.csv"
    if not csv.exists():
        # some sequences name it differently
        cands = list(mav0.glob("*groundtruth*/data.csv"))
        if not cands:
            raise FileNotFoundError(f"no ground-truth csv under {mav0}")
        csv = cands[0]
    data = np.loadtxt(csv, delimiter=",", comments="#", usecols=range(8))
    ts = data[:, 0] * 1e-9
    pos = data[:, 1:4]
    qwxyz = data[:, 4:8]
    from mcslam_tpu_torch.geometry import lie

    # TUM / our convention: quaternion xyzw
    qxyzw = np.concatenate([qwxyz[:, 1:4], qwxyz[:, 0:1]], axis=1)
    poses = np.tile(np.eye(4, dtype=np.float32), (len(ts), 1, 1))
    poses[:, :3, :3] = lie.rot_from_quat(
        torch.as_tensor(np.asarray(qxyzw, np.float32))).numpy()
    poses[:, :3, 3] = pos
    return ts, poses


def write_groundtruth_tum(seq_dir, out_path):
    from mcslam_tpu_torch.utils import tum

    ts, poses = load_groundtruth_tum(seq_dir)
    tum.write_tum(out_path, ts, poses)
    return len(ts)
