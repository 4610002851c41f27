"""Offline backend replay: rebuild and re-optimize the factor graph from a
recorded graph_logs stream (counterpart of mcslam_tpu/utils/replay.py).

The log file is the backend's input, so the multi-sensor fusion is
testable without sensors and reruns are deterministic. Input: graph_logs
records (x, l, e, imu_raw, g, k, m; utils/mapio). Output: the optimized
poses / landmarks and the costs before and after. The observation table
of a log is not kf-blocked, so both replays solve the generic layout
(backend/ba, backend/ba_vio with kf_blocked=False) on `device`, the card
unless the caller asks for the CPU. The IMU is re-preintegrated on the
host (CPU tensors, as the driver does).
"""

from __future__ import annotations

import numpy as np
import torch

from mcslam_tpu_torch.backend import ba
from mcslam_tpu_torch.utils import mapio


def _obs_table(edges, obs_capacity: int):
    """(BAObservations of numpy arrays with `obs_capacity` slots, n used)
    from (kf, cam, lm, u, v) edges in window / slot indices."""
    O = obs_capacity
    n = min(len(edges), O)
    e = np.asarray(edges[:n], np.float64).reshape(n, 5)
    kf, cam, lm = (np.zeros(O, np.int32) for _ in range(3))
    uv = np.zeros((O, 2), np.float32)
    kf[:n], cam[:n], lm[:n] = e[:, 0], e[:, 1], e[:, 2]
    uv[:n] = e[:, 3:5]
    return ba.BAObservations(kf=kf, cam=cam, lm=lm, uv=uv,
                             sigma2=np.ones(O, np.float32),
                             valid=np.arange(O) < n), n


def replay_graph_logs(path, cam_T_ref, fxycxy, iters: int = 15,
                      huber_px: float = 2.5, obs_capacity: int = 65536,
                      device="cuda"):
    """Re-optimize the logged vision graph with batch LM + Schur (gauge
    on the first keyframe).

    Returns dict with kf_ids, poses_in, poses_out, lm_ids, lms_in,
    lms_out, cost_in, cost_out, n_obs, inliers."""
    logs = mapio.read_graph_logs(path)
    kf_ids = [k for k, _, _ in logs["x"]]
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    poses = np.stack([p for _, _, p in logs["x"]]).astype(np.float32)
    lm_ids = [l for l, _ in logs["l"]]
    lm_index = {l: i for i, l in enumerate(lm_ids)}
    lms = np.stack([p for _, p in logs["l"]]).astype(np.float32)

    K, L = len(kf_ids), len(lm_ids)
    edges = [(kf_index[k], c, lm_index[l], u, v)
             for (k, c, l, u, v) in logs["e"]
             if k in kf_index and l in lm_index]
    obs, n = _obs_table(edges, obs_capacity)
    prior_H = np.zeros((K * 6, K * 6), np.float32)
    prior_H[:6, :6] = np.eye(6) * 1e6
    problem = ba.problem_from_numpy(
        poses, lms, np.ones(L, bool), obs, cam_T_ref, fxycxy, prior_H,
        np.zeros(K * 6, np.float32), np.ones(K, bool), device=device)
    cost_in = ba._total_cost(problem, huber_px)
    result = ba.ba_solve(problem, iters=iters, huber_px=huber_px)
    # one fetch
    v = torch.cat([result.poses.reshape(-1), result.landmarks.reshape(-1),
                   cost_in.reshape(1), result.cost.reshape(1),
                   result.num_inliers.reshape(1).to(torch.float32)]
                  ).cpu().numpy()
    return {
        "kf_ids": kf_ids,
        "poses_in": poses,
        "poses_out": v[:K * 16].reshape(K, 4, 4),
        "lm_ids": lm_ids,
        "lms_in": lms,
        "lms_out": v[K * 16:K * 16 + L * 3].reshape(L, 3),
        "cost_in": float(v[-3]),
        "cost_out": float(v[-2]),
        "n_obs": n,
        "inliers": int(v[-1]),
    }


def _imu_factors(logs, kf_ts, imu_params, device):
    """IMU factors between consecutive keyframes from the raw samples
    (re-preintegrated per gap, >= 3 samples each, the reference's
    imu_message_empty gate) -> (ImuFactors or None)."""
    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.backend import imu as imu_mod

    samples = sorted(logs["imu_raw"], key=lambda s: s[0])
    s_ts = np.array([s[0] for s in samples])
    preints, pairs = [], []
    for i in range(len(kf_ts) - 1):
        t0, t1 = kf_ts[i], kf_ts[i + 1]
        sel = np.nonzero((s_ts > t0) & (s_ts <= t1))[0]
        if len(sel) < 3:
            continue
        dts = np.clip(np.diff(s_ts[sel], prepend=t0), 1e-4, 0.1)
        gyro = np.stack([samples[s][1] for s in sel])
        accel = np.stack([samples[s][2] for s in sel])
        f32 = dict(dtype=torch.float32)
        preints.append(imu_mod.preintegrate(
            torch.tensor(dts, **f32), torch.tensor(gyro, **f32),
            torch.tensor(accel, **f32), torch.ones(len(sel), dtype=bool),
            torch.zeros(6), imu_params))
        pairs.append((i, i + 1))
    if not preints:
        return None
    return ba_vio.make_imu_factors(preints, pairs, capacity=len(preints),
                                   params=imu_params, device=device)


def replay_graph_logs_vio(path, cam_T_body, fxycxy, body_T_cam0=None,
                          imu_params=None, iters: int = 10,
                          huber_px: float = 2.5, obs_capacity: int = 65536,
                          gps_sigma: float = 0.5,
                          loop_sigma_rot: float = 0.05,
                          loop_sigma_trans: float = 0.05,
                          g_norm: float = 9.81, device="cuda"):
    """Rebuild the whole multi-sensor backend graph from graph_logs and
    re-optimize: vision ('x' / 'l' / 'e', plus the 'm' loop measurements
    as extra observations of the query keyframe), IMU ('imu_raw'
    re-preintegrated per keyframe gap), GPS ('g') and loop closures ('k'
    SE(3) between factors).

    Logged 'x' poses are world_T_ref (camera-0 frame); `body_T_cam0`
    converts to the body states the IMU / GPS factors constrain (identity
    by default)."""
    from mcslam_tpu_torch.backend import ba_vio
    from mcslam_tpu_torch.backend import imu as imu_mod

    if imu_params is None:
        imu_params = imu_mod.ImuParams(g_norm=g_norm)
    if body_T_cam0 is None:
        body_T_cam0 = np.eye(4, dtype=np.float32)
    body_T_cam0 = np.asarray(body_T_cam0)
    inv_btc0 = np.linalg.inv(body_T_cam0)

    logs = mapio.read_graph_logs(path)
    kf_ids = [k for k, _, _ in logs["x"]]
    kf_ts = np.array([t for _, t, _ in logs["x"]])
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    # states are world_T_body = world_T_ref @ inv(body_T_cam0)
    poses_ref = np.stack([p for _, _, p in logs["x"]]).astype(np.float32)
    poses_body = np.einsum("nij,jk->nik", poses_ref,
                           inv_btc0).astype(np.float32)
    lm_ids = [l for l, _ in logs["l"]]
    lm_index = {l: i for i, l in enumerate(lm_ids)}
    lms = (np.stack([p for _, p in logs["l"]]).astype(np.float32)
           if lm_ids else np.zeros((1, 3), np.float32))
    K, L = len(kf_ids), max(len(lm_ids), 1)

    edges = [(kf_index[k], c, lm_index[l], u, v)
             for (k, c, l, u, v) in logs["e"] + logs["m"]
             if k in kf_index and l in lm_index]
    obs, n = _obs_table(edges, obs_capacity)

    imu_factors = None
    vels = np.zeros((K, 3), np.float32)
    if logs["imu_raw"] and np.any(np.diff(kf_ts) > 0):
        imu_factors = _imu_factors(logs, kf_ts, imu_params, device)
        if imu_factors is not None:
            # seed velocities by finite differences of logged positions
            v = (np.diff(poses_body[:, :3, 3], axis=0)
                 / np.maximum(np.diff(kf_ts), 1e-3)[:, None])
            vels[:-1] = v
            vels[-1] = v[-1]

    gps_factors = None
    g_recs = [(k, e) for (k, e, _) in logs["g"] if k in kf_index]
    if g_recs:
        G = len(g_recs)
        gps_factors = ba_vio.factor_table(
            ba_vio.GpsFactors, device,
            kf=[kf_index[k] for k, _ in g_recs],
            enu=np.stack([e for _, e in g_recs]).astype(np.float32),
            t_bg=np.zeros(3, np.float32),
            sigma=np.full(G, gps_sigma, np.float32), valid=np.ones(G, bool))

    # loop relative poses -> between factors, conjugated from the ref-cam
    # frame into body (b_T_b' = Tbc c_T_c' Tbc^-1); 'k' records store
    # match_T_query, so the factor is i = match, j = query
    between = None
    k_recs = [(kf_index[q], kf_index[m], rel) for (q, m, rel) in logs["k"]
              if q in kf_index and m in kf_index]
    if k_recs:
        B = len(k_recs)
        between = ba_vio.factor_table(
            ba_vio.BetweenFactors, device,
            i=[m for (_, m, _) in k_recs], j=[q for (q, _, _) in k_recs],
            rel=np.stack([body_T_cam0 @ rel @ inv_btc0
                          for (_, _, rel) in k_recs]).astype(np.float32),
            sigma_rot=np.full(B, loop_sigma_rot, np.float32),
            sigma_trans=np.full(B, loop_sigma_trans, np.float32),
            valid=np.ones(B, bool))

    D = ba_vio.D
    N = K * D + 6
    prior_H = np.zeros((N, N), np.float32)
    prior_H[:6, :6] = np.eye(6) * 1e6  # gauge anchor on kf0's pose
    for i in range(K):
        if imu_factors is None:
            # no IMU: clamp the velocity and bias blocks (unobserved)
            prior_H[i * D + 6:i * D + 15, i * D + 6:i * D + 15] = \
                np.eye(9) * 1e6
        else:
            # weak bias prior (reference insert_priors_smartFactor)
            prior_H[i * D + 9:i * D + 15, i * D + 9:i * D + 15] = \
                np.eye(6) * 1e2
    if gps_factors is None:
        prior_H[K * D:, K * D:] = np.eye(6) * 1e6  # E_T_V unobserved

    problem = ba_vio.problem_from_numpy(
        poses_body, vels, np.zeros((K, 6), np.float32), lms,
        np.arange(L) < len(lm_ids), obs, cam_T_body, fxycxy,
        np.eye(4, dtype=np.float32), prior_H, np.zeros(N, np.float32),
        np.ones(K, bool), imu=imu_factors, gps=gps_factors, between=between,
        g_norm=imu_params.g_norm, device=device)
    cost_in = ba_vio._vio_cost(problem, huber_px)
    res = ba_vio.vio_solve(problem, iters=iters, huber_px=huber_px)
    # one fetch
    sizes = (K * 16, K * 3, L * 3, 16, 1, 1)
    v = torch.cat([res.poses.reshape(-1), res.vels.reshape(-1),
                   res.landmarks.reshape(-1), res.E_T_V.reshape(-1),
                   cost_in.reshape(1), res.cost.reshape(1)]).cpu().numpy()
    parts = np.split(v, np.cumsum(sizes)[:-1])
    poses_body_out = parts[0].reshape(K, 4, 4)
    return {
        "kf_ids": kf_ids,
        "kf_ts": kf_ts,
        "poses_in": poses_ref,
        "poses_out": np.einsum("nij,jk->nik", poses_body_out,
                               body_T_cam0).astype(np.float32),
        "poses_body_out": poses_body_out,
        "vels_out": parts[1].reshape(K, 3),
        "lm_ids": lm_ids,
        "lms_out": parts[2].reshape(L, 3),
        "E_T_V": parts[3].reshape(4, 4),
        "cost_in": float(parts[4][0]),
        "cost_out": float(parts[5][0]),
        "n_obs": n,
        "n_imu": 0 if imu_factors is None else len(imu_factors.i),
        "n_gps": 0 if gps_factors is None else len(g_recs),
        "n_loop": 0 if between is None else len(k_recs),
    }
