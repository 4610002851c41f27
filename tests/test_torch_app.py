"""The port's app path on the CPU (--device cpu): the SLAM app
(mcslam_tpu_torch.apps.mc_slam_app) on tests/test_app_cli.py's 2-camera
320x240 6-frame dataset, and the EuRoC runner (apps.run_euroc) with its
loaders on tests/test_euroc.py's ASL fixture, each held to the JAX tests'
gates; the JAX package's loaders read the port's outputs, and both apps
wire the same IMU / GPS parameters from the same calibration."""

import dataclasses
import json
import textwrap

import numpy as np
import pytest
import torch

from mcslam_tpu_torch.data import synthetic

FPS = 20.0
T0_NS = 10**18  # EuRoC-style 19-digit ns stamps


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """The session is many small ops: one intra-op thread runs them
    faster than a pool that the suite's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scene():
    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=2, baseline=0.2,
                                   image_size=(320, 240), focal=260.0),
        device="cpu")
    poses = synthetic.smooth_trajectory(6, radius=5.0, step_angle=0.03)
    lms = synthetic.make_landmarks(600, seed=1, depth_range=(4.0, 12.0),
                                   spread=(10.0, 6.0))
    return rig, poses, synthetic.render_blob_images(rig, poses, lms, seed=2)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """tests/test_app_cli.py's dataset, camchain, frontend YAML,
    vocabulary and cfg, written by the port's generator (the same
    images)."""
    import cv2

    from mcslam_tpu_torch.loop import vocab as vocab_mod

    root = tmp_path_factory.mktemp("ds")
    _, poses, imgs = _scene()
    for c in range(2):
        d = root / f"cam{c}" / "data"
        d.mkdir(parents=True)
        for k in range(len(poses)):
            ts_ns = int(k / FPS * 1e9) + T0_NS
            cv2.imwrite(str(d / f"{ts_ns}.png"),
                        (imgs[k, c] * 255).astype(np.uint8))
    (root / "camchain.yaml").write_text(textwrap.dedent("""
        cam0:
          intrinsics: [260.0, 260.0, 160.0, 120.0]
          distortion_coeffs: [0.0, 0.0, 0.0, 0.0]
          distortion_model: radtan
          resolution: [320, 240]
        cam1:
          intrinsics: [260.0, 260.0, 160.0, 120.0]
          distortion_coeffs: [0.0, 0.0, 0.0, 0.0]
          distortion_model: radtan
          resolution: [320, 240]
          T_cn_cnm1:
            - [1.0, 0.0, 0.0, -0.2]
            - [0.0, 1.0, 0.0, 0.0]
            - [0.0, 0.0, 1.0, 0.0]
            - [0.0, 0.0, 0.0, 1.0]
    """))
    (root / "frontend.yaml").write_text(textwrap.dedent("""
        ORBextractor.nFeatures: 512
        ORBextractor.nLevels: 3
        KFBaselineThresholdTranslation: 0.2
        KFBaselineThresholdRotation: 0.1
    """))
    voc = vocab_mod.Vocabulary.train(
        synthetic.make_descriptors(2000, seed=21), k=6, depth=3, iters=3)
    voc.save(root / "vocab.npz")
    (root / "app.cfg").write_text(_cfg(root, root))
    return root, poses


def _cfg(root, out):
    """The session cfg; its outputs go to the directory `out`."""
    return textwrap.dedent(f"""
        data_path={root}
        images_path={root}
        calib_file_path=camchain.yaml
        frontend_params_file=frontend.yaml
        kalibr=true
        num_cams=2
        traj_file={out}/traj.txt
        map_path={out}/map.json
        vocabulary=vocab.npz
        database_path={out}/db.npz
        calc_depth=true
        depth_dir={out}/depth
        dense_cloud_path={out}/cloud.ply
        log_file={out}/graph.log
    """)


def _run(root, cfg, traj):
    from mcslam_tpu_torch.apps import mc_slam_app

    return mc_slam_app.main(["--config_file", str(cfg), "--traj_file",
                             str(traj), "--device", "cpu"])


@pytest.fixture(scope="module")
def session_a(dataset):
    root, _ = dataset
    assert _run(root, root / "app.cfg", root / "traj.txt") == 0
    return root


def test_app_runs_end_to_end(dataset, session_a):
    root, poses = dataset
    from mcslam_tpu_torch.utils import metrics, tum

    ts, est = tum.read_tum(root / "traj.txt")
    assert len(ts) == 6
    ate = metrics.ate_rmse(est, poses)
    assert ate < 0.2, ate
    assert (root / "map.json").exists() and (root / "db.npz").exists()
    depth_files = sorted((root / "depth").glob("depth_*.npy"))
    assert depth_files, "calc_depth=true produced no depth maps"
    for p in depth_files:
        d = np.load(p)
        assert d.shape == (240, 320) and np.isfinite(d).all()
        assert (d > 0).mean() > 0.05
    head = (root / "cloud.ply").read_text().splitlines()[:3]
    assert head[0] == "ply" and int(head[2].split()[-1]) > 0
    # one map per keyframe that tracking inserted (the init keyframe has
    # none, as in the JAX app)
    kf_ids = {e["kfID"] for e in
              json.loads((root / "map.json").read_text())["keyframes"]}
    assert {int(p.stem.split("_")[1]) for p in depth_files} <= kf_ids


def test_jax_loaders_read_the_port_outputs(dataset, session_a):
    """The JAX package's TUM, map and graph-log readers load what the port
    app wrote, and see what the port's readers see."""
    from mcslam_tpu.utils import mapio as jmapio
    from mcslam_tpu.utils import tum as jtum
    from mcslam_tpu_torch.utils import mapio as tmapio
    from mcslam_tpu_torch.utils import tum as ttum

    root, _ = dataset
    ts_j, p_j = jtum.read_tum(root / "traj.txt")
    ts_t, p_t = ttum.read_tum(root / "traj.txt")
    np.testing.assert_array_equal(ts_j, ts_t)
    np.testing.assert_allclose(p_j, p_t, rtol=0, atol=1e-6)
    (kj, lmj), (kt, lmt) = (jmapio.load_map_json(root / "map.json"),
                            tmapio.load_map_json(root / "map.json"))
    assert len(kj) == len(kt) > 0 and lmj.keys() == lmt.keys()
    for a, b in zip(kj, kt):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    lj = jmapio.read_graph_logs(root / "graph.log")
    assert len(lj["x"]) == len(kj) and len(lj["l"]) > 0 and len(lj["e"]) > 0
    assert [r[0] for r in lj["x"]] == [e["kfID"] for e in kj]


def test_app_relocalization_fast_tracking_round_trip(dataset, session_a):
    """Map-reuse session: relocalization=true + fast_tracking=true
    localizes every frame against session A's map and database without
    overwriting them."""
    root, poses = dataset
    from mcslam_tpu_torch.utils import metrics, tum

    before = (root / "map.json").read_text()
    cfg_b = root / "reuse.cfg"
    cfg_b.write_text(textwrap.dedent(f"""
        data_path={root}
        images_path={root}
        calib_file_path=camchain.yaml
        frontend_params_file=frontend.yaml
        kalibr=true
        num_cams=2
        map_path=map.json
        vocabulary=vocab.npz
        database_path=db.npz
        relocalization=true
        fast_tracking=true
    """))
    assert _run(root, cfg_b, root / "traj_reloc.txt") == 0
    ts, est = tum.read_tum(root / "traj_reloc.txt")
    assert len(ts) == 6
    ate = metrics.ate_rmse(est, poses)
    assert ate < 0.25, ate
    assert (root / "map.json").read_text() == before


def test_split_frontend_matches_fused(dataset, session_a, tmp_path):
    """fused_frontend=false (build_frame + process_frame, the next frame
    built before this one is tracked) gives the fused loop's trajectory."""
    root, _ = dataset
    from mcslam_tpu_torch.utils import tum

    split = tmp_path / "split.cfg"
    split.write_text(_cfg(root, tmp_path) + "\nfused_frontend=false\n")
    assert _run(root, split, tmp_path / "traj_split.txt") == 0
    ts_s, p_s = tum.read_tum(tmp_path / "traj_split.txt")
    ts_f, p_f = tum.read_tum(root / "traj.txt")
    np.testing.assert_array_equal(ts_s, ts_f)
    np.testing.assert_allclose(p_s, p_f, rtol=0, atol=1e-4)
    assert len(list((tmp_path / "depth").glob("depth_*.npy"))) == len(
        list((root / "depth").glob("depth_*.npy")))


def test_app_mesh_devices_matches_single_device(dataset, session_a,
                                                tmp_path):
    """mesh_devices=2 on the CPU: a 2-shard mesh of the CPU, the
    camera-sharded frame build (one camera per shard, bit-exact) in the
    split loop and the observation-sharded window solves give the
    single-device trajectory within 1e-3. The frame builds and tracking
    are the same bits; the solves differ in summation order (the generic
    layout's one-hot products per shard against the kf-blocked kernel's
    payload), which tests/test_backend.py bounds by 1e-3 between the JAX
    package's own two layouts' full solves (2.2e-4 measured here)."""
    root, _ = dataset
    from mcslam_tpu_torch.apps import mc_slam_app
    from mcslam_tpu_torch.parallel import sharded_ba, sharded_frame
    from mcslam_tpu_torch.utils import tum

    calls = {"frame": 0, "ba": 0}
    build, solve = sharded_frame.sharded_build_frame, \
        sharded_ba.sharded_ba_solve

    def counted(name, fn):
        def wrap(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrap

    cfg = tmp_path / "mesh.cfg"
    cfg.write_text(_cfg(root, tmp_path) + "\nmesh_devices=2\n")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sharded_frame, "sharded_build_frame",
                   counted("frame", build))
        mp.setattr(sharded_ba, "sharded_ba_solve", counted("ba", solve))
        assert mc_slam_app.main(["--config_file", str(cfg), "--traj_file",
                                 str(tmp_path / "t.txt"),
                                 "--device", "cpu"]) == 0
    assert calls["frame"] == 6 and calls["ba"] >= 1, calls
    ts_m, p_m = tum.read_tum(tmp_path / "t.txt")
    ts_f, p_f = tum.read_tum(root / "traj.txt")
    np.testing.assert_array_equal(ts_m, ts_f)
    np.testing.assert_allclose(p_m, p_f, rtol=0, atol=1e-3)


@pytest.mark.parametrize("extra,flag", [
    ("mcraw_path=seq.mcraw", None), ("", "live_view.png")])
def test_unported_options_raise(dataset, session_a, tmp_path, monkeypatch,
                                extra, flag):
    """The two options that raised NotImplementedError before the native
    loader and the viewer were ported now run and change nothing in the
    session: mcraw_path replays the dataset converted by
    apps.convert_to_mcraw (needs g++, libpng and libjpeg) and gives the
    PGM-folder run's TUM rows; --live_view writes the PNG and its HTML
    page, renders during the session, and gives the same trajectory as
    the run without it (its snapshot never finalizes the session)."""
    root, _ = dataset
    from mcslam_tpu_torch.apps import mc_slam_app
    from mcslam_tpu_torch.utils import tum
    from mcslam_tpu_torch.viz import viewer

    cfg = tmp_path / "x.cfg"
    text = _cfg(root, tmp_path)
    if extra:
        from mcslam_tpu_torch.apps import convert_to_mcraw
        from mcslam_tpu_torch.data import native_loader

        tc = native_loader.toolchain()
        if not all(tc[k] for k in ("g++", "png.h", "jpeglib.h")):
            pytest.skip(f"no toolchain for the native loader: {tc}")
        seq = tmp_path / "seq.mcraw"
        assert convert_to_mcraw.main([str(root), str(seq)]) == 0
        text += f"\nmcraw_path={seq}\n"
    else:
        text += "\nlive_view_hz=1\n"
    cfg.write_text(text)
    argv = ["--config_file", str(cfg), "--device", "cpu",
            "--traj_file", str(tmp_path / "t.txt")]
    live = []
    if flag:
        argv += ["--live_view", str(tmp_path / flag)]

        class Recorded(viewer.LiveViewer):
            def stop(self, final_render=True):
                live.append(self._frames_rendered)
                super().stop(final_render)

        monkeypatch.setattr(viewer, "LiveViewer", Recorded)
    assert mc_slam_app.main(argv) == 0
    ts, p = tum.read_tum(tmp_path / "t.txt")
    ts_f, p_f = tum.read_tum(root / "traj.txt")
    np.testing.assert_array_equal(ts, ts_f)
    np.testing.assert_array_equal(p, p_f)
    if flag:
        import matplotlib.image

        assert live and live[0] >= 1, live  # rendered during the session
        png = matplotlib.image.imread(tmp_path / flag)
        assert png.ndim == 3 and png.shape[:2] == (600, 800)
        html = (tmp_path / "live_view.html").read_text()
        assert "src='live_view.png'" in html


def test_live_view_without_matplotlib_fails_before_the_session(
        dataset, tmp_path, monkeypatch):
    """--live_view on a host without matplotlib raises ImportError before
    the first frame is read, not after the session (whose trajectory,
    map and cloud would then be lost)."""
    import sys

    from mcslam_tpu_torch.apps import mc_slam_app
    from mcslam_tpu_torch.slam import MultiCameraSLAM

    root, _ = dataset
    cfg = tmp_path / "x.cfg"
    cfg.write_text(_cfg(root, tmp_path))
    frames = []
    monkeypatch.setattr(MultiCameraSLAM, "process_image",
                        lambda self, *a, **kw: frames.append(1))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError):
        mc_slam_app.main(["--config_file", str(cfg), "--device", "cpu",
                          "--live_view", str(tmp_path / "live.png")])
    assert not frames and not (tmp_path / "traj.txt").exists()


def test_app_wires_imu_gps_params_like_jax(dataset, tmp_path, monkeypatch):
    """use_imu / use_gps hand the calibration's imu and gps blocks to the
    SLAM constructor, in both apps alike (test_app_cli.py:130)."""
    root, _ = dataset
    calib = tmp_path / "camchain_imu.yaml"
    calib.write_text((root / "camchain.yaml").read_text() + textwrap.dedent("""
        imu:
          acc_noise: 0.0123
          gyr_noise: 0.00045
          acc_walk: 0.0002
          gyr_walk: 0.00003
          g_norm: 9.805
        gps:
          Tbg:
            - [1.0, 0.0, 0.0, 0.25]
            - [0.0, 1.0, 0.0, -0.1]
            - [0.0, 0.0, 1.0, 0.05]
            - [0.0, 0.0, 0.0, 1.0]
    """))
    cfg = tmp_path / "imu.cfg"
    cfg.write_text(textwrap.dedent(f"""
        data_path={root}
        images_path={root}
        calib_file_path={calib}
        frontend_params_file=frontend.yaml
        kalibr=true
        num_cams=2
        use_imu=true
        use_gps=true
        traj_file={tmp_path}/traj.txt
    """))

    class _Stop(Exception):
        pass

    captured = {}
    for pkg in ("mcslam_tpu", "mcslam_tpu_torch"):
        def fake_slam(*a, _pkg=pkg, **kw):
            captured[_pkg] = (a, kw)
            raise _Stop

        monkeypatch.setattr(f"{pkg}.slam.MultiCameraSLAM", fake_slam)
    from mcslam_tpu.apps import mc_slam_app as japp
    from mcslam_tpu_torch.apps import mc_slam_app as tapp

    with pytest.raises(_Stop):
        japp.main(["--config_file", str(cfg)])
    with pytest.raises(_Stop):
        tapp.main(["--config_file", str(cfg), "--device", "cpu"])
    (ja, jkw), (ta, tkw) = captured["mcslam_tpu"], captured["mcslam_tpu_torch"]
    assert tuple(tkw["imu_params"]) == tuple(jkw["imu_params"])
    np.testing.assert_allclose(tkw["imu_params"].accel_noise, 0.0123)
    np.testing.assert_array_equal(tkw["gps_lever_arm"], jkw["gps_lever_arm"])
    np.testing.assert_allclose(tkw["gps_lever_arm"], [0.25, -0.1, 0.05])
    assert dataclasses.asdict(ta[1]) == dataclasses.asdict(ja[1])
    assert ta[0].device.type == "cpu"


def test_app_defaults_to_the_card(dataset, euroc_seq, tmp_path):
    """Without --device the rig, and so the session, goes to the card:
    with no card that raises torch's error instead of running on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default would run there")
    root, _ = dataset
    from mcslam_tpu_torch.apps import mc_slam_app, run_euroc

    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        mc_slam_app.main(["--config_file", str(root / "app.cfg"),
                          "--traj_file", str(tmp_path / "t.txt")])
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        run_euroc.main([str(euroc_seq[0]), "--out_dir", str(tmp_path)])
    from mcslam_tpu_torch.apps import train_vocabulary

    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        train_vocabulary.main([str(root), str(tmp_path / "v.npz")])
    assert not (tmp_path / "t.txt").exists()
    assert not (tmp_path / "v.npz").exists()


# -- EuRoC (ASL layout) --------------------------------------------------------

@pytest.fixture(scope="module")
def euroc_seq(tmp_path_factory):
    """tests/test_euroc.py's sequence: mav0/cam{0,1}/{sensor.yaml,
    data/<ns>.png}, imu0/{sensor.yaml,data.csv},
    state_groundtruth_estimate0/data.csv."""
    import cv2

    from mcslam_tpu_torch.geometry import lie

    seq = tmp_path_factory.mktemp("euroc_seq")
    mav0 = seq / "mav0"
    rig, poses, imgs = _scene()
    for c in range(2):
        d = mav0 / f"cam{c}" / "data"
        d.mkdir(parents=True)
        for k in range(len(poses)):
            ts_ns = int(k / FPS * 1e9) + T0_NS
            cv2.imwrite(str(d / f"{ts_ns}.png"),
                        (imgs[k, c] * 255).astype(np.uint8))
        T_BS = np.linalg.inv(rig.cam_T_ref[c].numpy().astype(np.float64))
        rows = ", ".join("[" + ", ".join(f"{v:.9f}" for v in T_BS[r]) + "]"
                         for r in range(4))
        (mav0 / f"cam{c}" / "sensor.yaml").write_text(textwrap.dedent(f"""
            sensor_type: camera
            T_BS:
              rows: 4
              cols: 4
              data: [{rows}]
            rate_hz: 20
            resolution: [320, 240]
            camera_model: pinhole
            intrinsics: [260.0, 260.0, 160.0, 120.0]
            distortion_model: radial-tangential
            distortion_coefficients: [0.0, 0.0, 0.0, 0.0]
        """))
    imu_dir = mav0 / "imu0"
    imu_dir.mkdir()
    (imu_dir / "sensor.yaml").write_text(textwrap.dedent("""
        sensor_type: imu
        T_BS:
          rows: 4
          cols: 4
          data: [1.0, 0.0, 0.0, 0.0,
                 0.0, 1.0, 0.0, 0.0,
                 0.0, 0.0, 1.0, 0.0,
                 0.0, 0.0, 0.0, 1.0]
        rate_hz: 200
        gyroscope_noise_density: 1.6968e-04
        gyroscope_random_walk: 1.9393e-05
        accelerometer_noise_density: 2.0000e-3
        accelerometer_random_walk: 3.0000e-3
    """))
    (imu_dir / "data.csv").write_text(
        "#timestamp [ns],w_RS_S_x,w_RS_S_y,w_RS_S_z,a_RS_S_x,a_RS_S_y,"
        "a_RS_S_z\n" + "\n".join(
            f"{int(k * 5e6) + T0_NS},0.001,-0.002,0.0005,0.03,-0.02,9.80"
            for k in range(60)) + "\n")
    q = lie.quat_from_rot(torch.as_tensor(poses[:, :3, :3])).numpy()
    gt_dir = mav0 / "state_groundtruth_estimate0"
    gt_dir.mkdir()
    lines = ["#timestamp,p_x,p_y,p_z,q_w,q_x,q_y,q_z"]
    for k in range(len(poses)):
        p = poses[k, :3, 3]
        lines.append(f"{int(k / FPS * 1e9) + T0_NS},{p[0]:.9f},{p[1]:.9f},"
                     f"{p[2]:.9f},{q[k, 3]:.9f},{q[k, 0]:.9f},{q[k, 1]:.9f},"
                     f"{q[k, 2]:.9f}")
    (gt_dir / "data.csv").write_text("\n".join(lines) + "\n")
    return seq, poses


def test_euroc_loaders_match_jax(euroc_seq, tmp_path):
    from mcslam_tpu.data import euroc as jeuroc
    from mcslam_tpu_torch.data import euroc as teuroc

    seq, poses = euroc_seq
    rj, ij, cj = jeuroc.load_euroc_rig(seq)
    rt, it, ct = teuroc.load_euroc_rig(seq / "mav0", device="cpu")
    assert ct == cj == ["cam0", "cam1"]
    for f in ("fxycxy", "dist", "cam_T_ref", "body_T_cam"):
        np.testing.assert_allclose(getattr(rt, f).numpy(),
                                   np.asarray(getattr(rj, f)), rtol=0,
                                   atol=1e-7, err_msg=f)
    assert rt.image_size == tuple(rj.image_size) == (320, 240)
    assert rt.dist_model == rj.dist_model
    assert tuple(it) == tuple(ij)
    np.testing.assert_allclose(rt.cam_T_ref[1, :3, 3].numpy(), [-0.2, 0, 0],
                               atol=1e-6)
    ts_j, gt_j = jeuroc.load_groundtruth_tum(seq)
    ts_t, gt_t = teuroc.load_groundtruth_tum(seq)
    np.testing.assert_array_equal(ts_t, ts_j)
    np.testing.assert_allclose(gt_t, gt_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(gt_t[:, :3, 3], poses[:, :3, 3], atol=1e-6)
    assert teuroc.write_groundtruth_tum(seq, tmp_path / "gt.txt") == 6
    jeuroc.write_groundtruth_tum(seq, tmp_path / "gt_j.txt")
    assert (tmp_path / "gt.txt").read_text() == \
        (tmp_path / "gt_j.txt").read_text()
    with pytest.raises(FileNotFoundError):
        teuroc.find_mav0(tmp_path)


def test_run_euroc_end_to_end(euroc_seq, tmp_path, capsys):
    """The one-command runner: raw ASL folder -> trajectory -> ATE vs GT
    (tests/test_euroc.py's gates), then the evaluation CLI alone."""
    from mcslam_tpu_torch.apps import evaluate_trajectory, run_euroc
    from mcslam_tpu_torch.utils import metrics, tum

    seq, _ = euroc_seq
    out = tmp_path / "out"
    rc = run_euroc.main([str(seq), "--out_dir", str(out), "--num_points",
                         "512", "--num_levels", "3", "--device", "cpu"])
    assert rc == 0
    assert "ATE RMSE [m]" in capsys.readouterr().out
    ts_e, est = tum.read_tum(out / "trajectory_tum.txt")
    ts_g, gt = tum.read_tum(out / "groundtruth_tum.txt")
    assert len(ts_e) == 6
    ie, ig = metrics.associate(ts_e, ts_g, 0.02)
    assert len(ie) == 6
    ate = metrics.ate_rmse(est[ie], gt[ig])
    assert ate < 0.2, ate
    assert evaluate_trajectory.main([str(out / "trajectory_tum.txt"),
                                     str(out / "groundtruth_tum.txt"),
                                     "--plot", str(tmp_path / "p.png")]) == 0
    import matplotlib.image

    assert matplotlib.image.imread(tmp_path / "p.png").ndim == 3
