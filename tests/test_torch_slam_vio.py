"""The port's visual-inertial and GPS-fused driver on the CPU: the
counterparts of the four tests of tests/test_slam_vio.py on the same
scenes (feature-level frames of analytic_circle_imu's circle with exact
IMU plus noise and biases) and with the same gates, a parity drive
against the JAX package, and process_image with IMU, GPS and
segmentation masks.

Gates: the JAX tests' own (median over 3 seeds of the ATE after the
IMU-init prefix < 0.11 m; the GPS-fused run beating VIO-only on the
median seed; dummy keyframes at non-vision timestamps, each carrying a
fix). Per-frame poses are not compared with the JAX package: equivalent
float orders move these small noisy scenes' ATE by up to ~30 %
(ROADMAP.md Queue 3, "float class"). The parity drive holds what is
discrete or exact: the frame the IMU initializes on, the bias after
gravity initialization (1e-6) and the final state."""

import jax.numpy as jnp
import numpy as np
import torch

from mcslam_tpu.backend.imu import ImuParams as JImuParams
from mcslam_tpu.frontend import frame as jframe
from mcslam_tpu.slam import INITIALIZED as J_INIT
from mcslam_tpu.slam import MultiCameraSLAM as JSLAM
from mcslam_tpu.slam import SlamConfig as JConfig
from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu_torch.backend.imu import ImuParams
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame as frame_mod
from mcslam_tpu_torch.geometry.geodesy import EnuConverter
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.slam import INITIALIZED, MultiCameraSLAM, SlamConfig
from mcslam_tpu_torch.utils import metrics

FPS = 20.0
IMU = dict(accel_noise=2e-3, gyro_noise=2e-4)
CFG = dict(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
           local_map_landmarks=1024, imu_init_samples=40)
LLA0 = (42.36, -71.06, 10.0)


def _lla(p):
    """Geodetic fix of an ENU position (the small-offset inverse of
    tests/test_slam_vio.py)."""
    lat = LLA0[0] + p[1] / 110_900.0
    lon = LLA0[1] + p[0] / (110_900.0 * np.cos(np.radians(LLA0[0])))
    return lat, lon, LLA0[2] + p[2]


def _vio_sequence(num_frames=10, with_gps=False, seed=0, px_noise=0.3):
    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=3, baseline=0.2), device="cpu")
    poses, imu_ts, gyro, accel = synthetic.analytic_circle_imu(
        num_frames, fps=FPS, radius=4.0, omega=0.35, accel_noise=2e-3,
        gyro_noise=2e-4, accel_bias=(0.02, -0.01, 0.015),
        gyro_bias=(0.001, -0.0005, 0.002), stationary_s=0.3, ramp_s=0.3,
        seed=seed)
    lms = synthetic.make_landmarks(900, seed=seed + 1, depth_range=(5.0, 16.0))
    descs = synthetic.make_descriptors(900, seed=seed + 2)
    frames = synthetic.render_feature_frames(
        rig, poses, lms, descs, kps_per_cam=320, px_noise=px_noise,
        desc_bit_noise=5, fps=FPS, seed=seed + 3)
    gps = None
    if with_gps:
        gps = (np.arange(num_frames) / FPS,
               np.array([_lla(poses[k][:3, 3]) for k in range(num_frames)]))
    return rig, poses, imu_ts, gyro, accel, frames, gps


def _frame(f, rig):
    return frame_mod.build_frame_from_keypoints(
        torch.from_numpy(f.uv), hamming.desc_to_torch(f.desc, "cpu"),
        torch.from_numpy(f.valid), rig, max_intra=1024)


def _span(ts, t_prev, t):
    return (ts > t_prev) & (ts <= t)


def _run_vio_session(seed, num_frames=16):
    rig, poses, imu_ts, gyro, accel, frames, _ = _vio_sequence(
        num_frames, seed=seed)
    cfg = SlamConfig(kf_translation=0.15, kf_rotation=0.1, **CFG)
    slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**IMU))
    for k, f in enumerate(frames):
        sel = _span(imu_ts, (k - 1) / FPS if k else -1.0, k / FPS)
        slam.process_frame(_frame(f, rig), f.timestamp,
                           imu=(imu_ts[sel], gyro[sel], accel[sel]))
    assert slam.imu_initialized and slam.state == INITIALIZED
    assert slam.stats["keyframes"] >= 2 and slam.stats["window_ba_vio"] >= 1
    _, est = slam.trajectory_arrays()
    k0 = 6  # skip the IMU gravity-gate prefix
    return metrics.ate_rmse(est[k0:], poses[k0:]), slam


def test_vio_pipeline_runs_and_tracks():
    ates = []
    for seed in (0, 11, 22):
        ate, slam = _run_vio_session(seed)
        ates.append(ate)
        assert np.linalg.norm(slam.bias) > 1e-4  # the bias was estimated
    assert float(np.median(ates)) < 0.11, ates


def _run_gps_session(seed):
    rig, poses, imu_ts, gyro, accel, frames, gps = _vio_sequence(
        18, with_gps=True, seed=seed)
    cfg = SlamConfig(kf_translation=0.1, kf_rotation=0.08, **CFG)
    slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**IMU),
                           gps_lever_arm=np.zeros(3))
    gps_t, gps_lla = gps
    for k, f in enumerate(frames):
        t_prev = (k - 1) / FPS if k else -1.0
        sel = _span(imu_ts, t_prev, k / FPS)
        gsel = _span(gps_t, t_prev, k / FPS)
        slam.process_frame(_frame(f, rig), f.timestamp,
                           imu=(imu_ts[sel], gyro[sel], accel[sel]),
                           gps=(gps_t[gsel], gps_lla[gsel]))
    assert slam.state == INITIALIZED
    assert slam.enu_converter is not None and len(slam.kf_gps) >= 1
    _, est = slam.trajectory_arrays()
    return metrics.ate_rmse(est[6:], poses[6:])


def test_gps_fused_pipeline():
    ates = [_run_gps_session(seed) for seed in (5, 16, 27)]
    assert float(np.median(ates)) < 0.11, ates


def _run_gps_dummy_pair(seed, num_frames=30, check_structure=False):
    """One degraded-vision (1.6 px) low-rate session (every 3rd frame)
    with GPS fixes at 1/3 and 2/3 of each frame gap, with and without GPS
    -> (ate_gps, ate_vio)."""
    rig, poses, imu_ts, gyro, accel, frames, _ = _vio_sequence(
        num_frames, seed=seed, px_noise=1.6)
    fixes_t, fixes_lla = [], []
    for k in range(num_frames - 1):
        for frac in (1.0 / 3.0, 2.0 / 3.0):
            fixes_t.append((k + frac) / FPS)
            fixes_lla.append(_lla((1 - frac) * poses[k][:3, 3]
                                  + frac * poses[k + 1][:3, 3]))
    gps_t, gps_lla = np.array(fixes_t), np.array(fixes_lla)
    vision_ks = list(range(0, num_frames, 3))

    def run(with_gps):
        cfg = SlamConfig(kf_translation=0.1, kf_rotation=0.08, gps_sigma=0.1,
                         gps_min_move=0.02, **CFG)
        slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**IMU),
                               gps_lever_arm=np.zeros(3) if with_gps
                               else None)
        t_prev = -1.0
        for k in vision_ks:
            f, t = frames[k], k / FPS
            sel = _span(imu_ts, t_prev, t)
            kw = {}
            if with_gps:
                gsel = _span(gps_t, t_prev, t)
                kw["gps"] = (gps_t[gsel], gps_lla[gsel])
            slam.process_frame(_frame(f, rig), f.timestamp,
                               imu=(imu_ts[sel], gyro[sel], accel[sel]), **kw)
            t_prev = t
        return slam

    slam_gps = run(True)
    assert slam_gps.state == INITIALIZED
    if check_structure:
        assert slam_gps.stats.get("gps_dummy_kfs", 0) >= 1
        dummies = [k for k in slam_gps.keyframes if k.is_dummy]
        assert dummies
        vision_ts = {k.timestamp for k in slam_gps.keyframes
                     if not k.is_dummy}
        for d in dummies:
            assert d.timestamp not in vision_ts
            assert d.kf_id in slam_gps.kf_gps  # carries a GPS factor
            assert d.d_desc is None  # no device copy
    slam_vio = run(False)
    gt = poses[vision_ks]
    k0 = 3  # skip the IMU-init prefix
    ates = [metrics.ate_rmse(s.trajectory_arrays()[1][k0:], gt[k0:])
            for s in (slam_gps, slam_vio)]
    return tuple(ates)


def test_gps_dummy_keyframes_between_vision_kfs():
    deltas, pairs = [], []
    for i, seed in enumerate((7, 18, 29)):
        ate_g, ate_v = _run_gps_dummy_pair(seed, check_structure=(i == 0))
        deltas.append(ate_v - ate_g)
        pairs.append((ate_g, ate_v))
    assert float(np.median(deltas)) > 0.0, pairs


def test_gps_duplicate_timestamps_and_bounded_buffer():
    """(a) duplicated GPS timestamps do not break the dummy-keyframe scan;
    (b) a vision + GPS session without IMU keeps the fix buffer bounded."""
    rig, poses, imu_ts, gyro, accel, frames, gps = _vio_sequence(
        16, with_gps=True, seed=11)
    gps_t, gps_lla = gps
    gps_t2 = np.concatenate([gps_t, gps_t])
    gps_lla2 = np.concatenate([gps_lla, gps_lla + 1e-7])
    order = np.argsort(gps_t2, kind="stable")
    gps_t2, gps_lla2 = gps_t2[order], gps_lla2[order]
    cfg = SlamConfig(kf_translation=0.1, kf_rotation=0.08, **CFG)
    slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**IMU),
                           gps_lever_arm=np.zeros(3))
    slam2 = MultiCameraSLAM(rig, cfg, gps_lever_arm=np.zeros(3))
    for k, f in enumerate(frames):
        t_prev = (k - 1) / FPS if k else -1.0
        sel = _span(imu_ts, t_prev, k / FPS)
        gsel = _span(gps_t2, t_prev, k / FPS)
        ff = _frame(f, rig)
        slam.process_frame(ff, f.timestamp,
                           imu=(imu_ts[sel], gyro[sel], accel[sel]),
                           gps=(gps_t2[gsel], gps_lla2[gsel]))
        slam2.process_frame(ff, f.timestamp,
                            gps=(gps_t2[gsel], gps_lla2[gsel]))
    assert slam.state == INITIALIZED
    if slam2.gps_initialized:
        assert len(slam2._gps_buf) <= 60, len(slam2._gps_buf)


def test_vio_session_parity_with_jax():
    """Seed 0 of the VIO scene through both drivers: the IMU initializes
    on the same frame with the same bias, and both end INITIALIZED."""
    rig, poses, imu_ts, gyro, accel, frames, _ = _vio_sequence(16, seed=0)
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(num_cams=3,
                                                         baseline=0.2))
    kw = dict(kf_translation=0.15, kf_rotation=0.1, **CFG)
    t_slam = MultiCameraSLAM(rig, SlamConfig(**kw),
                             imu_params=ImuParams(**IMU))
    j_slam = JSLAM(jrig, JConfig(**kw), imu_params=JImuParams(**IMU))
    init_at = {}
    for k, f in enumerate(frames):
        sel = _span(imu_ts, (k - 1) / FPS if k else -1.0, k / FPS)
        imu = (imu_ts[sel], gyro[sel], accel[sel])
        t_slam.process_frame(_frame(f, rig), f.timestamp, imu=imu)
        j_slam.process_frame(jframe.build_frame_from_keypoints(
            jnp.asarray(f.uv), jnp.asarray(f.desc), jnp.asarray(f.valid),
            jrig, max_intra=1024), f.timestamp, imu=imu)
        for name, s in (("port", t_slam), ("jax", j_slam)):
            if s.imu_initialized and name not in init_at:
                init_at[name] = (k, np.array(s.bias))
    assert init_at["port"][0] == init_at["jax"][0]
    np.testing.assert_allclose(init_at["port"][1], init_at["jax"][1],
                               atol=1e-6)
    assert t_slam.state == INITIALIZED and j_slam.state == J_INIT
    assert t_slam.stats["window_ba_vio"] >= 1


def test_process_image_takes_sensors_and_masks():
    """process_image with imu=, gps= and seg_masks= on the CPU: a
    2-camera blob scene along the circle, GPS every frame, the IMU
    initialized on frame 2, a mask that keeps all but a border strip on
    the first frames (the split path), then the fused path."""
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(320, 240), focal=260.0, baseline=0.2),
        device="cpu")
    n = 10
    poses, imu_ts, gyro, accel = synthetic.analytic_circle_imu(
        n, fps=FPS, radius=4.0, omega=0.35, stationary_s=0.3, ramp_s=0.3)
    lms = synthetic.make_landmarks(1500, seed=1, depth_range=(4.0, 12.0))
    imgs = synthetic.render_blob_images(rig, poses, lms, seed=2)
    conv = EnuConverter(*LLA0)
    assert np.allclose(conv.to_enu(*LLA0), 0.0)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=4096, ba_lm_capacity=512,
                     local_map_landmarks=1024, imu_init_samples=20,
                     gps_min_move=0.01)
    slam = MultiCameraSLAM(rig, cfg, imu_params=ImuParams(**IMU),
                           gps_lever_arm=np.zeros(3))
    masks = np.ones((2, 240, 320), np.float32)
    masks[:, :, :4] = 0.0
    ecfg = dict(num_points=384, num_levels=2, max_intra=512)
    for k in range(n):
        t = k / FPS
        t_prev = (k - 1) / FPS if k else -1.0
        sel = _span(imu_ts, t_prev, t)
        info = slam.process_image(
            imgs[k], t, imu=(imu_ts[sel], gyro[sel], accel[sel]),
            gps=(np.array([t]), np.array([_lla(poses[k][:3, 3])])),
            seg_masks=masks if k < 3 else None, extract_cfg=ecfg)
        assert info["state"] in (0, 1)
    assert slam.imu_initialized and slam.state == INITIALIZED
    assert slam.stats["failures"] == 0 and slam.enu_converter is not None
    assert slam.stats["track_dispatch"] >= n - 3  # frames 3.. tracked
    _, est = slam.trajectory_arrays()
    assert np.all(np.isfinite(est))
