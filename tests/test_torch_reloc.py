"""Port driver runs of the loop-closure, global-BA and map-reuse scenes on
the CPU (the plain versions of the kernels), each held to the gates of the
JAX test it mirrors; the RANSAC streams differ between torch and
jax.random, so the runs are held to those gates and not to JAX's
trajectories (ROADMAP Queue 3):

- tests/test_loop_pipeline.py: a loop fires in the driver, PGO bends,
  the loop ATE beats the VO ATE on the same stream and stays < 0.30 m,
  and every keyframe reference points at a live landmark (> 200 live);
- tests/test_global_ba.py: global BA runs after a closure and beats the
  PGO-only trajectory, ATE < 0.25 m; `mesh=` raises NotImplementedError;
- tests/test_loop_reloc.py: relocalization against a saved JSON map and
  BoW database, and against a navability map, within 0.1 m; fast
  tracking from a perturbed prediction within 0.05 m; IMU-predicted fast
  tracking holds through the pan shake (>= 10 frames) where constant
  velocity loses it (at least 4 frames fewer);
- tests/test_config_knobs.py: final_global_ba runs once at finalize().
"""

import json

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import slam as tslam
from mcslam_tpu_torch.backend.imu import ImuParams
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame as frame_mod
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.loop import vocab as vocab_mod
from mcslam_tpu_torch.loop.detector import LoopConfig
from mcslam_tpu_torch.loop.reloc import Relocalizer
from mcslam_tpu_torch.loop.tracking import FastTracker
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.utils import mapio, metrics

INIT = tslam.INITIALIZED


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These driver runs are many small ops: one intra-op thread runs them
    faster than a pool that the suite's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RIG = dict(num_cams=3, baseline=0.2)


def _rig(**kw):
    return synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(**dict(RIG, **kw)), device="cpu")


def _ff(rig, f):
    return frame_mod.build_frame_from_keypoints(
        torch.as_tensor(f.uv), hamming.desc_to_torch(f.desc, "cpu"),
        torch.as_tensor(f.valid), rig, max_intra=1024)


def _drive(slam, rig, frames, **kw):
    for f in frames:
        slam.process_frame(_ff(rig, f), f.timestamp, **kw)
    return slam


# -- loop closure in the driver (tests/test_loop_pipeline.py) ----------------


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """Clean tracking at the start and the revisit, heavy noise through
    the middle; the same stream with and without loop closure (the loop
    run streams its graph log)."""
    rig = _rig()
    n, revisit = 60, 8
    poses = synthetic.loop_trajectory(n, radius=5.0, revisit_frames=revisit,
                                      seed=0)
    lms = synthetic.make_ring_landmarks(1400, radius=11.0, seed=1)
    descs = synthetic.make_descriptors(1400, seed=2)
    kw = dict(kps_per_cam=320, desc_bit_noise=4, seed=3, max_depth=9.0)
    clean = synthetic.render_feature_frames(rig, poses, lms, descs,
                                            px_noise=0.4, **kw)
    noisy = synthetic.render_feature_frames(rig, poses, lms, descs,
                                            px_noise=1.8, **kw)
    frames = [noisy[i] if 10 <= i < n - revisit - 4 else clean[i]
              for i in range(n)]
    cfg = tslam.SlamConfig(window_size=4, ba_obs_capacity=8192,
                           ba_lm_capacity=1024, local_map_landmarks=2048,
                           kf_translation=0.3, kf_rotation=0.2)
    vocab = vocab_mod.Vocabulary.train(descs, k=6, depth=3, iters=3)
    loop = tslam.MultiCameraSLAM(
        rig, cfg, vocab=vocab, loop_config=LoopConfig(
            dislocal=12, k_consistency=2, min_nss=0.02, alpha=0.15,
            min_matches=15, min_inliers=10))
    log_path = tmp_path_factory.mktemp("log") / "graph_logs.txt"
    writer = mapio.GraphLogWriter(log_path)
    loop.attach_graph_log(writer)
    _drive(loop, rig, frames)
    writer.close()
    vo = _drive(tslam.MultiCameraSLAM(rig, cfg), rig, frames)
    return poses, loop, vo, mapio.read_graph_logs(log_path)


def test_loop_closure_fires_in_driver(loop_runs):
    _, loop, _, logs = loop_runs
    assert loop.state == INIT
    assert loop.stats["loops"] >= 1 and loop.stats.get("pgo", 0) >= 1
    # each closure streamed its 'k' record and its 'm' measurements
    assert len(logs["k"]) == loop.stats["loops"]
    assert len(logs["m"]) >= 10


def test_loop_closure_improves_ate(loop_runs):
    poses, loop, vo, _ = loop_runs
    ate_loop = metrics.ate_rmse(loop.trajectory_arrays()[1], poses)
    ate_vo = metrics.ate_rmse(vo.trajectory_arrays()[1], poses)
    assert ate_loop < ate_vo, (ate_loop, ate_vo)
    assert ate_loop < 0.30, ate_loop


def test_loop_closure_map_stays_consistent(loop_runs):
    _, loop, _, _ = loop_runs
    for kf in loop.keyframes:
        assert np.all(loop.map.valid[kf.lm_id[kf.lm_id >= 0]])
    assert loop.map.num_valid > 200
    v = np.flatnonzero(loop.map.valid)
    np.testing.assert_array_equal(loop.dmap.valid.numpy(), loop.map.valid)
    np.testing.assert_allclose(loop.dmap.pos.numpy()[v], loop.map.pos[v])


# -- global BA (tests/test_global_ba.py) -------------------------------------


def _global_ba_session(global_ba: bool):
    rig = _rig(image_size=(320, 240), focal=260.0)
    poses = synthetic.loop_trajectory(38, radius=4.0, revisit_frames=18,
                                      seed=0)
    lms = synthetic.make_ring_landmarks(800, radius=9.0, seed=1)
    descs = synthetic.make_descriptors(800, seed=2)
    frames = synthetic.render_feature_frames(
        rig, poses, lms, descs, kps_per_cam=320, px_noise=0.6,
        desc_bit_noise=5, seed=3)
    cfg = tslam.SlamConfig(
        window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
        local_map_landmarks=1024, kf_translation=0.25, kf_rotation=0.15,
        min_inter_matches=40, global_ba=global_ba, loop_pgo_min_trans=0.05,
        loop_pgo_min_rot=0.02, global_ba_lm_capacity=2048,
        global_ba_obs_per_kf=256)
    slam = tslam.MultiCameraSLAM(
        rig, cfg, vocab=vocab_mod.Vocabulary.train(descs, k=6, depth=3,
                                                   iters=3),
        loop_config=LoopConfig(dislocal=8, k_consistency=1, min_nss=0.01,
                               alpha=0.1, min_matches=12, min_inliers=10))
    _drive(slam, rig, frames)
    assert slam.state == INIT
    slam.finalize()
    return slam, metrics.ate_rmse(slam.trajectory_arrays()[1], poses)


def test_global_ba_beats_pgo_only():
    slam_off, ate_off = _global_ba_session(False)
    slam_on, ate_on = _global_ba_session(True)
    assert slam_off.stats["loops"] >= 1 and slam_on.stats["loops"] >= 1
    assert slam_on.stats.get("global_ba", 0) >= 1
    assert slam_off.stats.get("global_ba", 0) == 0
    assert ate_on < ate_off, (ate_on, ate_off)
    assert ate_on < 0.25, ate_on
    # the global BA over a mesh is ported (tests/test_torch_parallel.py
    # drives it): a CPU mesh constructs, anything else is refused
    from mcslam_tpu_torch.parallel import mesh as tmesh

    with pytest.raises(TypeError, match="Mesh"):
        tslam.MultiCameraSLAM(_rig(), tslam.SlamConfig(), mesh=object())
    assert tslam.MultiCameraSLAM(_rig(), tslam.SlamConfig(),
                                 mesh=tmesh.make_mesh(2, "cpu")).mesh.size == 2


# -- map reuse (tests/test_loop_reloc.py) ------------------------------------


@pytest.fixture(scope="module")
def small_vocab():
    return vocab_mod.Vocabulary.train(
        synthetic.make_descriptors(2000, seed=11), k=6, depth=3, iters=3)


def _session_scene(num_frames=10, seed=0):
    rig = _rig()
    poses = synthetic.smooth_trajectory(num_frames, radius=5.0,
                                        step_angle=0.03, seed=seed)
    lms = synthetic.make_landmarks(900, seed=seed + 1,
                                   depth_range=(5.0, 16.0))
    descs = synthetic.make_descriptors(900, seed=seed + 2)
    frames = synthetic.render_feature_frames(
        rig, poses, lms, descs, kps_per_cam=320, px_noise=0.3,
        desc_bit_noise=5, seed=seed + 3)
    return rig, poses, frames


CFG = dict(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
           local_map_landmarks=1024, kf_translation=0.2, kf_rotation=0.12)


@pytest.fixture(scope="module")
def saved_session(small_vocab, tmp_path_factory):
    """A 10-frame session with a vocabulary, its map and BoW database
    saved, and its frames."""
    rig, poses, frames = _session_scene()
    slam = tslam.MultiCameraSLAM(rig, tslam.SlamConfig(**CFG),
                                 vocab=small_vocab)
    ffs = [_ff(rig, f) for f in frames]
    for f, ff in zip(frames, ffs):
        slam.process_frame(ff, f.timestamp)
    assert slam.state == INIT
    d = tmp_path_factory.mktemp("map")
    mapio.save_map_json(d / "map.json", slam.keyframes, slam.map)
    slam.looper.save_database(d / "db.npz")
    return slam, poses, rig, ffs, d


def _err(pose, poses, k):
    expected = np.linalg.inv(poses[0]) @ poses[k]  # SLAM world = frame 0
    return float(np.linalg.norm(pose[:3, 3] - expected[:3, 3]))


def test_relocalization_against_saved_map(saved_session, small_vocab):
    slam, poses, rig, ffs, d = saved_session
    reloc = Relocalizer(small_vocab, rig, d / "map.json", d / "db.npz")
    pose = reloc.relocalize(ffs[5])
    assert pose is not None
    assert _err(pose, poses, 5) < 0.1


def test_relocalization_navability_map(saved_session, small_vocab, tmp_path):
    """The live session exported in the navability two-file schema, loaded
    through from_navability (BoW scoring from the stored descriptors)."""
    slam, poses, rig, ffs, _ = saved_session
    features, pose_obj = {}, {}
    for kf in slam.keyframes:
        cam_pose = f"p{kf.kf_id:04d}"
        T = kf.world_T_ref
        q = lie.quat_from_rot(torch.as_tensor(T[:3, :3])).numpy()
        pose_obj[cam_pose] = {
            "timestamp": float(kf.timestamp),
            "pos": [float(v) for v in T[:3, 3]],
            # quat_from_rot is (x, y, z, w); the schema is [w, x, y, z]
            "quat": [float(q[3]), float(q[0]), float(q[1]), float(q[2])]}
        for m in np.nonzero(kf.lm_id >= 0)[0]:
            lid = int(kf.lm_id[m])
            key = f"lm{lid:05d}_{cam_pose}_"
            if not slam.map.valid[lid] or key in features:
                continue
            features[key] = {
                "pos": [float(v) for v in slam.map.pos[lid]],
                "descriptor": [int(b) for b in
                               slam.map.desc[lid].view(np.uint8)],
                "adj_cams": []}
    fpath, ppath = tmp_path / "f.json", tmp_path / "p.json"
    fpath.write_text(json.dumps(features))
    ppath.write_text(json.dumps(pose_obj))
    reloc = Relocalizer.from_navability(small_vocab, rig, fpath, ppath)
    assert len(reloc.db_bows) > 0
    pose = reloc.relocalize(ffs[5])
    assert pose is not None
    assert _err(pose, poses, 5) < 0.1


def test_fast_tracking_after_reloc(saved_session, small_vocab):
    slam, poses, rig, ffs, d = saved_session
    tracker = FastTracker(Relocalizer(small_vocab, rig, d / "map.json",
                                      d / "db.npz"))
    pred = (np.linalg.inv(poses[0]) @ poses[6]).astype(np.float32)
    pred[:3, 3] += np.array([0.05, -0.03, 0.04], np.float32)
    refined = tracker.track(ffs[6], pred)
    assert refined is not None
    assert _err(refined, poses, 6) < 0.05


def test_final_global_ba_runs_at_finalize():
    rig, _, frames = _session_scene()
    slam = tslam.MultiCameraSLAM(rig, tslam.SlamConfig(
        window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
        local_map_landmarks=1024, kf_translation=0.25, kf_rotation=0.15,
        final_global_ba=True))
    _drive(slam, rig, frames)
    assert slam.stats.get("global_ba", 0) == 0
    before = np.stack([p for _, p in slam.trajectory])
    slam.finalize()
    assert slam.stats.get("global_ba", 0) == 1 and slam._final_gba_done
    after = np.stack([p for _, p in slam.trajectory])
    assert np.abs(after - before).max() > 0  # retro-corrected
    slam.finalize()  # idempotent
    assert slam.stats["global_ba"] == 1


def test_imu_predicted_fast_tracking_survives_shake(small_vocab, tmp_path):
    """Aggressive pan reversals break the constant-velocity prediction
    (the rotation error passes the fast tracker's 20 px radius); the
    preintegrated-IMU prediction follows them."""
    rig = _rig()
    lms = synthetic.make_landmarks(900, seed=31, depth_range=(5.0, 16.0))
    descs = synthetic.make_descriptors(900, seed=32)

    def roty4(a):
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        T[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        return T

    # session 1: the map of a slow pan sweep from the identity (the map
    # frame is the gravity-aligned world frame)
    sweep = [0.0, -0.07, -0.14, -0.2, -0.12, -0.04, 0.05, 0.13, 0.2, 0.1]
    map_frames = synthetic.render_feature_frames(
        rig, np.stack([roty4(a) for a in sweep]), lms, descs,
        kps_per_cam=320, px_noise=0.3, desc_bit_noise=5, fps=10.0, seed=33)
    slam = tslam.MultiCameraSLAM(rig, tslam.SlamConfig(**dict(
        CFG, kf_rotation=0.04)), vocab=small_vocab)
    _drive(slam, rig, map_frames)
    assert slam.state == INIT and slam.stats["keyframes"] >= 3
    slam.finalize()
    map_path, db_path = tmp_path / "shake_map.json", tmp_path / "db.npz"
    mapio.save_map_json(map_path, slam.keyframes, slam.map)
    slam.looper.save_database(db_path)

    # session 2: the pan shake with exact IMU
    fps = 10.0
    shake_poses, imu_ts, gyro, accel = synthetic.pan_shake_imu(
        num_frames=16, fps=fps, amp=0.2, shake_hz=1.7, stationary_s=0.5,
        accel_noise=2e-3, gyro_noise=2e-4, seed=34)
    shake = synthetic.render_feature_frames(
        rig, shake_poses, lms, descs, kps_per_cam=320, px_noise=0.3,
        desc_bit_noise=5, fps=fps, seed=35)
    ffs = [_ff(rig, f) for f in shake]

    def run(with_imu):
        s2 = tslam.MultiCameraSLAM(
            rig, tslam.SlamConfig(**dict(CFG, imu_init_samples=40)),
            imu_params=ImuParams(accel_noise=2e-3, gyro_noise=2e-4)
            if with_imu else None)
        s2.enable_relocalization(
            Relocalizer(small_vocab, rig, map_path, db_path),
            FastTracker(Relocalizer(small_vocab, rig, map_path, db_path)))
        for k, (f, ff) in enumerate(zip(shake, ffs)):
            t_prev = (k - 1) / fps if k else -1.0
            sel = (imu_ts > t_prev) & (imu_ts <= f.timestamp)
            s2.process_frame(ff, f.timestamp, imu=(
                imu_ts[sel], gyro[sel], accel[sel]) if with_imu else None)
        return s2.stats

    stats_imu, stats_cv = run(True), run(False)
    assert stats_imu["fast_tracked"] >= 10, stats_imu
    assert stats_cv["fast_tracked"] <= stats_imu["fast_tracked"] - 4, (
        stats_cv, stats_imu)
