"""The generic (non-kf-blocked) BA layout and graph-log replay of the
port (backend/ba._assemble, ba_solve / vio_solve with kf_blocked=False,
utils/replay) against the JAX package on the CPU, on the same numpy
inputs and the same log files.

Tolerances:
- the assembled generic system (Hpp, gp, Hll, gl, Wc) within 1e-5 of each
  one's largest magnitude of JAX's generic assembly, and of the port's
  kf-blocked assembly of the same observations (tests/test_backend.py's
  bound between the two routes, 1e-5 relative / 1e-4 absolute);
- the replays, on one synthetic log file written here (a 6-keyframe
  circle with two cameras, 0.5 px noise, perturbed logged poses and
  landmarks, raw IMU, three GPS fixes and a loop record): n_obs and the
  factor counts equal, cost_in and cost_out within 1e-4 relative, the
  tests/test_replay_and_utils.py gates (cost_out <= 1.05 cost_in; the
  VIO poses within 0.5 m of the logged ones), and two port replays
  bit-equal. The poses are held to the truth, not to JAX's: JAX solves
  the damped step in float32, where the 1e6 gauge prior on keyframe 0
  does not hold (its replay rotates keyframe 0 by ~5e-3 rad and the whole
  map with it, at the same cost), and the port in float64 (ROADMAP Queue
  3, deliberate deviations). So the port's keyframe 0 stays within 1e-5
  of the logged pose, and its error to the truth is below the logged
  poses' and below JAX's.
"""

import numpy as np
import pytest
import torch

from mcslam_tpu.backend import ba as jba
from mcslam_tpu.backend.imu import ImuParams as JImuParams
from mcslam_tpu.utils import replay as jreplay
from mcslam_tpu_torch.backend import ba as tba
from mcslam_tpu_torch.backend.imu import ImuParams as TImuParams
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.geometry import lie as tlie
from mcslam_tpu_torch.utils import mapio
from mcslam_tpu_torch.utils import replay as treplay
from test_backend import _make_ba_problem
from test_torch_ba import _blocked, _rel_err

IMU = dict(accel_noise=2e-3, gyro_noise=2e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_generic_assemble_matches_jax_and_blocked():
    """tests/test_backend.py's scene (K=4, L=200) in its own observation
    order: the port's generic assembly against JAX's, then the same
    observations re-laid kf-blocked through the port's blocked route."""
    jp = _make_ba_problem()[0]
    r, Jp, Jl, w = jba._residuals_and_jacobians(jp, 2.5)
    jsys = jba._assemble(jp, r, Jp, Jl, w)
    tp = tba.problem_from_numpy(*jp, device="cpu")
    tsys = tba._assemble(tp, *tba._residuals_and_jacobians(tp, 2.5))
    for name, a, b in zip(("Hpp", "gp", "Hll", "gl", "Wc"), tsys, jsys):
        assert a.shape == b.shape, name
        assert _rel_err(a.numpy(), b) <= 1e-5, (name, _rel_err(a.numpy(), b))
    jb, _ = _blocked(jp)
    bp = tba.problem_from_numpy(*jb, device="cpu")
    bsys = tba._blocked_system(bp, 2.5)((bp.poses, bp.landmarks),
                                        bp.obs.valid)[0]
    for name, a, b in zip(("Hpp", "gp", "Hll", "gl", "Wc"), tsys, bsys):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-4, err_msg=name)


def test_generic_solve_is_deterministic_and_layout_free():
    """Two generic solves give the same bits; shuffling the observation
    rows moves the solution only by f32 summation order (poses 1e-4)."""
    problem = _make_ba_problem(K=4, L=64)[0]
    tp = tba.problem_from_numpy(*problem, device="cpu")
    a = tba.ba_solve(tp, iters=4)
    b = tba.ba_solve(tp, iters=4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    perm = torch.from_numpy(np.random.RandomState(0).permutation(
        tp.obs.kf.shape[0]))
    c = tba.ba_solve(tp._replace(obs=tba.BAObservations(
        *(f[perm] for f in tp.obs))), iters=4)
    np.testing.assert_allclose(c.poses.numpy(), a.poses.numpy(), atol=1e-4)
    assert int(c.num_inliers) == int(a.num_inliers)


def _write_log(path, vio: bool, seed=0):
    """A graph log of a 6-keyframe circle (every 4th frame at 20 fps of
    analytic_circle_imu) seen by a 2-camera rig: 'x' poses and 'l'
    landmarks perturbed from the truth, 'e' edges with 0.5 px noise; with
    vio, the raw IMU stream, three GPS fixes (ENU = VIO world) and one
    loop record (match_T_query of the last and first keyframes) ->
    (rig, true keyframe poses)."""
    rng = np.random.RandomState(seed)
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(num_cams=2),
                                  device="cpu")
    poses, imu_ts, gyro, accel = tsyn.analytic_circle_imu(
        21, fps=20.0, radius=4.0, omega=0.35)
    kf = poses[::4].astype(np.float64)
    K = len(kf)
    lms = np.stack([rng.uniform(-2.5, 2.5, 300), rng.uniform(-1, 1, 300),
                    rng.uniform(-2.5, 2.5, 300)], axis=1)
    cTr = rig.cam_T_ref.numpy().astype(np.float64)
    f = rig.fxycxy.numpy().astype(np.float64)
    w, h = rig.image_size
    log = mapio.GraphLogWriter(path)
    for k in range(K):
        xi = np.concatenate([rng.randn(3) * 0.003, rng.randn(3) * 0.01])
        noisy = kf[k] @ _se3_exp(xi) if k else kf[k]
        log.pose(k, noisy, k * 0.2)
        for c in range(2):
            cTw = cTr[c] @ np.linalg.inv(kf[k])
            p = lms @ cTw[:3, :3].T + cTw[:3, 3]
            uv = p[:, :2] / p[:, 2:] * f[c, :2] + f[c, 2:]
            vis = ((p[:, 2] > 0.5) & (uv[:, 0] > 0) & (uv[:, 0] < w)
                   & (uv[:, 1] > 0) & (uv[:, 1] < h))
            for lid in np.flatnonzero(vis):
                u, v = uv[lid] + rng.randn(2) * 0.5
                log.edge(k, c, int(lid), float(u), float(v))
    for lid, X in enumerate(lms + rng.randn(*lms.shape) * 0.02):
        log.landmark(lid, X)
    if vio:
        for t, g, a in zip(imu_ts, gyro, accel):
            log.imu_raw(float(t), g, a)
        for k in (1, 3, 5):
            log.gps(k, kf[k][:3, 3] + rng.randn(3) * 0.05, np.zeros(3))
        log.loop_pose(K - 1, 0, np.linalg.inv(kf[0]) @ kf[K - 1])
    log.close()
    return rig, kf


def _se3_exp(xi):
    return tlie.se3_exp(torch.from_numpy(xi)).numpy()


def _assert_against(t, j, kf):
    """The cost gates against JAX and the pose gates against the truth
    (module docstring)."""
    assert abs(t["cost_in"] - j["cost_in"]) <= 1e-4 * j["cost_in"]
    assert t["cost_out"] <= t["cost_in"] * 1.05
    assert abs(t["cost_out"] - j["cost_out"]) <= 1e-4 * j["cost_out"]
    np.testing.assert_allclose(t["poses_out"][0], t["poses_in"][0],
                               atol=1e-3, rtol=0)

    def err(p):
        return np.abs(p[:, :3, 3] - kf[:, :3, 3]).max()

    assert err(t["poses_out"]) < err(t["poses_in"])
    assert err(t["poses_out"]) <= err(j["poses_out"])


def test_replay_graph_logs_matches_jax(tmp_path):
    path = tmp_path / "graph_logs.txt"
    rig, kf = _write_log(path, vio=False)
    cTr, f = rig.cam_T_ref.numpy(), rig.fxycxy.numpy()
    j = jreplay.replay_graph_logs(path, cTr, f, obs_capacity=4096)
    t = treplay.replay_graph_logs(path, cTr, f, obs_capacity=4096,
                                  device="cpu")
    t2 = treplay.replay_graph_logs(path, cTr, f, obs_capacity=4096,
                                   device="cpu")
    assert t["n_obs"] == j["n_obs"] > 1000
    assert t["kf_ids"] == j["kf_ids"] and t["lm_ids"] == j["lm_ids"]
    _assert_against(t, j, kf)
    assert abs(t["inliers"] - j["inliers"]) <= 2
    np.testing.assert_array_equal(t["poses_out"], t2["poses_out"])
    np.testing.assert_array_equal(t["lms_out"], t2["lms_out"])


def test_replay_graph_logs_vio_matches_jax(tmp_path):
    path = tmp_path / "graph_logs.txt"
    rig, kf = _write_log(path, vio=True)
    # the body is the reference camera's frame: cam_T_body = cam_T_ref
    ctb, f = rig.cam_T_ref.numpy(), rig.fxycxy.numpy()
    kw = dict(obs_capacity=4096)
    j = jreplay.replay_graph_logs_vio(path, ctb, f,
                                      imu_params=JImuParams(**IMU), **kw)
    t = treplay.replay_graph_logs_vio(path, ctb, f,
                                      imu_params=TImuParams(**IMU),
                                      device="cpu", **kw)
    t2 = treplay.replay_graph_logs_vio(path, ctb, f,
                                       imu_params=TImuParams(**IMU),
                                       device="cpu", **kw)
    for key in ("n_obs", "n_imu", "n_gps", "n_loop"):
        assert t[key] == j[key], key
    assert t["n_imu"] == 5 and t["n_gps"] == 3 and t["n_loop"] == 1
    _assert_against(t, j, kf)
    dt = np.linalg.norm(t["poses_out"][:, :3, 3] - t["poses_in"][:, :3, 3],
                        axis=-1)
    assert dt.max() < 0.5, dt.max()
    np.testing.assert_array_equal(t["poses_out"], t2["poses_out"])
