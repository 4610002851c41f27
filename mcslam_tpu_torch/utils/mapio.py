"""Session artifact I/O: the JSON map and the graph-log stream
(counterpart of mcslam_tpu/utils/mapio.py, the same host numpy and json
code, so a map or a graph log written by either package loads in the
other).

  * JSON map ("mcslam_tpu_map_v1"): one entry per keyframe with its id,
    timestamp, pose and landmarks (id, 3D point, descriptor words, the
    keyframe's uv and anchor camera);
  * the "navability" two-file JSON map (features + poses), loaded into
    the same structure;
  * graph_logs text records: 'x' kfID ts + 4x4 pose, 'l' lid + 3D, 'e'
    kfID camID lid u v, 'g' GPS ENU + reference lat/lon/alt, 'k' loop
    relative pose, 'm' loop measurements, 'imu_raw'.

Keyframes and maps are the host records of either driver (numpy fields:
lm_id, im_uv, im_anchor_cam, world_T_ref; pos, desc (uint32), valid).
"""

from __future__ import annotations

import json

import numpy as np


def save_map_json(path, keyframes, lm_map) -> None:
    """Write the session map: one entry per keyframe."""
    out = []
    for kf in keyframes:
        sel = np.nonzero(kf.lm_id >= 0)[0]
        lids = kf.lm_id[sel]
        ok = lm_map.valid[lids]
        sel, lids = sel[ok], lids[ok]
        entry = {
            "kfID": int(kf.kf_id),
            "timestamp": float(kf.timestamp),
            "pose": [float(v) for v in kf.world_T_ref.reshape(-1)],
            "landmarks": [
                {
                    "lid": int(l),
                    "pt3D": [float(v) for v in lm_map.pos[l]],
                    "desc": [int(v) for v in lm_map.desc[l]],
                    "uv": [float(v) for v in kf.im_uv[s]],
                    "cam": int(kf.im_anchor_cam[s]),
                }
                for s, l in zip(sel, lids)
            ],
        }
        out.append(entry)
    with open(path, "w") as f:
        json.dump({"format": "mcslam_tpu_map_v1", "keyframes": out}, f)


def load_map_json(path):
    """-> (kf_entries list of dicts with numpy fields, lm dict id->(pos, desc))."""
    with open(path) as f:
        data = json.load(f)
    kfs = []
    lms = {}
    for e in data["keyframes"]:
        pose = np.array(e["pose"], np.float32).reshape(4, 4)
        lids = np.array([l["lid"] for l in e["landmarks"]], np.int32)
        uv = np.array([l["uv"] for l in e["landmarks"]], np.float32).reshape(-1, 2)
        cams = np.array([l["cam"] for l in e["landmarks"]], np.int32)
        descs = np.array([l["desc"] for l in e["landmarks"]], np.uint32).reshape(-1, 8)
        for l in e["landmarks"]:
            lms[int(l["lid"])] = (
                np.array(l["pt3D"], np.float32),
                np.array(l["desc"], np.uint32),
            )
        kfs.append(
            {
                "kfID": int(e["kfID"]),
                "timestamp": float(e["timestamp"]),
                "pose": pose,
                "lids": lids,
                "uv": uv,
                "cams": cams,
                "descs": descs,
            }
        )
    return kfs, lms


def load_map_navability(features_path, poses_path):
    """Load an external 'navability' two-file JSON map into the SAME
    structure as load_map_json, so the relocalizer consumes either format.

    Parity (WHAT): Relocalization::checkRelocalizationNavability +
    getLandmarkDescriptors (the reference system's relocalization.cpp:44,
    707-860):
      * `<name>_features.json`: object of landmark entries; each value has
        "pos" [x,y,z], "descriptor" [32 uint8], "adj_cams" [camera-pose
        keys]; the entry key embeds its anchor camera pose as
        "_<camera_pose>_". A camera pose's landmark set is every feature
        anchored at it or listing it in adj_cams.
      * `<name>_poses.json`: object keyed by camera-pose id with
        "timestamp" (ISO-8601 or epoch float), "pos" [x,y,z] and "quat"
        [w,x,y,z].
    2D observations don't exist in this schema — uv is the projection of
    the point through the stored pose (the reference does the same,
    project3DTo2D, relocalization.cpp:843)."""
    with open(features_path) as f:
        feats = json.load(f)
    with open(poses_path) as f:
        pose_entries = json.load(f)

    def _quat_to_R(q):
        w, x, y, z = [float(v) for v in q]
        n = max((w * w + x * x + y * y + z * z) ** 0.5, 1e-12)
        w, x, y, z = w / n, x / n, y / n, z / n
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x),
                 1 - 2 * (x * x + y * y)],
            ],
            np.float32,
        )

    def _parse_ts(v):
        if isinstance(v, (int, float)):
            return float(v)
        try:
            return float(v)
        except (TypeError, ValueError):
            from datetime import datetime

            try:
                return datetime.fromisoformat(str(v)).timestamp()
            except ValueError:
                return 0.0

    # per-camera-pose landmark sets (anchored-at or adjacent-to)
    cam_lms: dict[str, list[int]] = {k: [] for k in pose_entries}
    lms = {}
    for lid, (key, val) in enumerate(feats.items()):
        pos = np.array(val["pos"], np.float32)
        desc = np.array(val["descriptor"], np.uint8)
        # 32 bytes -> 8 uint32 words (our descriptor layout)
        desc = desc.view(np.uint32) if desc.size == 32 else np.zeros(
            8, np.uint32
        )
        lms[lid] = (pos, desc.astype(np.uint32))
        owners = set()
        for cam_pose in pose_entries:
            if f"_{cam_pose}_" in key:
                owners.add(cam_pose)
        for cam_pose in val.get("adj_cams", []):
            if cam_pose in cam_lms:
                owners.add(cam_pose)
        for cam_pose in owners:
            cam_lms[cam_pose].append(lid)

    kfs = []
    for i, (cam_pose, pv) in enumerate(sorted(pose_entries.items())):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _quat_to_R(pv["quat"])
        T[:3, 3] = np.array(pv["pos"], np.float32)
        lids = np.array(cam_lms.get(cam_pose, []), np.int32)
        if len(lids):
            pts = np.stack([lms[int(l)][0] for l in lids])
            descs = np.stack([lms[int(l)][1] for l in lids])
            # project through the stored pose (fx=fy=1, principal point 0:
            # normalized-plane uv; the relocalizer only uses descriptors +
            # 3D, matching the reference's use of this map)
            Tinv = np.linalg.inv(T)
            pc = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
            z = np.maximum(pc[:, 2:3], 1e-3)
            uv = (pc[:, :2] / z).astype(np.float32)
        else:
            descs = np.zeros((0, 8), np.uint32)
            uv = np.zeros((0, 2), np.float32)
        kfs.append(
            {
                "kfID": i,
                "timestamp": _parse_ts(pv.get("timestamp", 0.0)),
                "pose": T,
                "lids": lids,
                "uv": uv,
                "cams": np.zeros(len(lids), np.int32),
                "descs": descs,
            }
        )
    return kfs, lms


class GraphLogWriter:
    """Streaming graph_logs writer (reference record grammar)."""

    def __init__(self, path):
        self._f = open(path, "w")

    def close(self):
        self._f.close()

    def pose(self, kf_id: int, world_T_body: np.ndarray,
             timestamp: float = 0.0):
        """'x kfID ts p00..p33' (reference FrontEnd.cpp:7442 — the
        timestamp is what lets the replay harness segment imu_raw records
        into per-keyframe preintegration spans)."""
        vals = " ".join(f"{v:.9f}" for v in np.asarray(world_T_body).reshape(-1))
        self._f.write(f"x {kf_id} {timestamp:.9f} {vals}\n")

    def landmark(self, lid: int, pt: np.ndarray):
        self._f.write(f"l {lid} {pt[0]:.9f} {pt[1]:.9f} {pt[2]:.9f}\n")

    def edge(self, kf_id: int, cam_id: int, lid: int, u: float, v: float):
        self._f.write(f"e {kf_id} {cam_id} {lid} {u:.4f} {v:.4f}\n")

    def imu_raw(self, t: float, gyro, accel):
        g, a = np.asarray(gyro), np.asarray(accel)
        self._f.write(
            f"imu_raw {t:.9f} {g[0]:.9f} {g[1]:.9f} {g[2]:.9f} "
            f"{a[0]:.9f} {a[1]:.9f} {a[2]:.9f}\n"
        )

    def gps(self, kf_id: int, enu, ref_lla):
        e = np.asarray(enu)
        r = np.asarray(ref_lla)
        self._f.write(
            f"g {kf_id} {e[0]:.9f} {e[1]:.9f} {e[2]:.9f} "
            f"{r[0]:.9f} {r[1]:.9f} {r[2]:.9f}\n"
        )

    def loop_pose(self, kf_query: int, kf_match: int, rel: np.ndarray):
        vals = " ".join(f"{v:.9f}" for v in np.asarray(rel).reshape(-1))
        self._f.write(f"k {kf_query} {kf_match} {vals}\n")

    def loop_measurement(self, kf_query: int, cam_id: int, lid: int, u, v):
        self._f.write(f"m {kf_query} {cam_id} {lid} {u:.4f} {v:.4f}\n")


def read_graph_logs(path):
    """Parse graph_logs into dict-of-lists per record type (replay input)."""
    out = {"x": [], "l": [], "e": [], "imu_raw": [], "g": [], "k": [], "m": []}
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag, vals = parts[0], parts[1:]
            if tag == "x":
                if len(vals) >= 18:  # kfID ts pose16 (reference grammar)
                    out["x"].append(
                        (int(vals[0]), float(vals[1]),
                         np.array(vals[2:18], np.float64).reshape(4, 4))
                    )
                else:  # legacy: kfID pose16 (no timestamp)
                    out["x"].append(
                        (int(vals[0]), 0.0,
                         np.array(vals[1:17], np.float64).reshape(4, 4))
                    )
            elif tag == "l":
                out["l"].append((int(vals[0]), np.array(vals[1:4], np.float64)))
            elif tag == "e":
                out["e"].append(
                    (int(vals[0]), int(vals[1]), int(vals[2]),
                     float(vals[3]), float(vals[4]))
                )
            elif tag == "imu_raw":
                out["imu_raw"].append(
                    (float(vals[0]), np.array(vals[1:4], np.float64),
                     np.array(vals[4:7], np.float64))
                )
            elif tag == "g":
                out["g"].append(
                    (int(vals[0]), np.array(vals[1:4], np.float64),
                     np.array(vals[4:7], np.float64))
                )
            elif tag == "k":
                out["k"].append(
                    (int(vals[0]), int(vals[1]),
                     np.array(vals[2:18], np.float64).reshape(4, 4))
                )
            elif tag == "m":
                out["m"].append(
                    (int(vals[0]), int(vals[1]), int(vals[2]),
                     float(vals[3]), float(vals[4]))
                )
    return out
