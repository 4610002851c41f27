"""Calibration readers: Kalibr camchain YAML and plain VO YAML
(counterpart of mcslam_tpu/data/calib.py: the same host numpy; the rig is
the port's, built on `device`, the card unless the caller asks for the
CPU).

Parity (WHAT): DatasetReader::read_kalibr_data
(MCDataUtils/src/DatasetReader.cpp:169-273) — chains the
pairwise T_cn_cnm1 extrinsics into camera-from-reference transforms and
keeps the raw pairwise mats; reads per-camera intrinsics/distortion; and the
imu block {acc_noise, gyr_noise, acc_walk, gyr_walk, g_norm, Tbc} + gps
{Tbg} (FrontEnd.h:263-407, MCApps/params/nuance_calib/nuance.yaml).
"""

from __future__ import annotations

import numpy as np
import yaml

from mcslam_tpu_torch.geometry import camera as cam_ops


_DIST_MODELS = {
    "radtan": cam_ops.DIST_RADTAN,
    "plumb_bob": cam_ops.DIST_RADTAN,
    "equidistant": cam_ops.DIST_EQUIDISTANT,
    "none": cam_ops.DIST_NONE,
}


def load_kalibr(path, device="cuda"):
    """Kalibr camchain yaml -> (CameraRig, imu_params dict | None,
    gps_params dict | None).

    Chains T_cn_cnm1 (camera n from camera n-1) into cam_T_ref where ref is
    cam0, exactly as the reference does.
    """
    with open(path) as f:
        data = yaml.safe_load(f)

    cams = sorted(k for k in data if k.startswith("cam"))
    n = len(cams)
    fxycxy = np.zeros((n, 4), np.float32)
    dist = np.zeros((n, 5), np.float32)
    cam_T_ref = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    model = cam_ops.DIST_RADTAN
    image_size = (640, 480)
    prev = np.eye(4)
    for i, key in enumerate(cams):
        c = data[key]
        fxycxy[i] = np.asarray(c["intrinsics"], np.float32)
        d = np.asarray(c.get("distortion_coeffs", []), np.float32)
        dist[i, : len(d)] = d
        model = _DIST_MODELS.get(c.get("distortion_model", "radtan"), model)
        if "resolution" in c:
            image_size = tuple(int(v) for v in c["resolution"])
        if i == 0:
            prev = np.eye(4)
        else:
            T = np.asarray(c["T_cn_cnm1"], np.float64).reshape(4, 4)
            prev = T @ prev  # cam_i <- cam0 chain
        cam_T_ref[i] = prev.astype(np.float32)

    body_T_cam = None
    imu_params = None
    if "imu" in data:
        imu = data["imu"]
        imu_params = {
            "acc_noise": float(imu.get("acc_noise", 0.01)),
            "gyr_noise": float(imu.get("gyr_noise", 0.001)),
            "acc_walk": float(imu.get("acc_walk", 1e-4)),
            "gyr_walk": float(imu.get("gyr_walk", 1e-5)),
            "g_norm": float(imu.get("g_norm", 9.81)),
        }
        if "Tbc" in imu:
            Tbc = np.asarray(imu["Tbc"], np.float64).reshape(4, 4).astype(np.float32)
            # body_T_cam for each camera: Tbc chains through cam_T_ref
            body_T_cam = np.stack(
                [Tbc @ np.linalg.inv(cam_T_ref[i]) for i in range(n)]
            )
            imu_params["Tbc"] = Tbc

    gps_params = None
    if "gps" in data and data["gps"]:
        g = data["gps"]
        gps_params = {}
        if "Tbg" in g:
            gps_params["Tbg"] = (
                np.asarray(g["Tbg"], np.float64).reshape(4, 4).astype(np.float32)
            )

    rig = cam_ops.make_rig(
        fxycxy, dist, cam_T_ref, body_T_cam, image_size=image_size,
        dist_model=model, device=device,
    )
    return rig, imu_params, gps_params


def load_plain_vo_yaml(path, device="cuda"):
    """Plain VO-style yaml (reference DatasetReader.cpp:77-167): per-camera
    K (3x3), dist, R, t arrays under cam0..camN keys."""
    with open(path) as f:
        data = yaml.safe_load(f)
    cams = sorted(k for k in data if k.startswith("cam"))
    n = len(cams)
    fxycxy = np.zeros((n, 4), np.float32)
    dist = np.zeros((n, 5), np.float32)
    cam_T_ref = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    image_size = (640, 480)
    for i, key in enumerate(cams):
        c = data[key]
        K = np.asarray(c["K"], np.float64).reshape(3, 3)
        fxycxy[i] = [K[0, 0], K[1, 1], K[0, 2], K[1, 2]]
        d = np.asarray(c.get("dist", []), np.float64)
        dist[i, : len(d)] = d
        if "R" in c:
            cam_T_ref[i, :3, :3] = np.asarray(c["R"], np.float64).reshape(3, 3)
        if "t" in c:
            cam_T_ref[i, :3, 3] = np.asarray(c["t"], np.float64).reshape(3)
        if "resolution" in c:
            image_size = tuple(int(v) for v in c["resolution"])
    return cam_ops.make_rig(fxycxy, dist, cam_T_ref, image_size=image_size,
                            device=device)
