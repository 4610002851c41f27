"""Parity of the port's data path (mcslam_tpu_torch.data: config, calib,
readers, live) with the JAX package: both get the same files, written to
tmp_path from a seed, and must turn them into the same settings, the same
SlamConfig and extraction settings, the same rig (exact, or 1e-7 where
float32 products round), the same parameter dicts, the same errors, and
bitwise the same frames and sensor slices. Also the port's PGM decoder,
its Prefetcher and the top-level exports."""

import dataclasses
import subprocess
import sys
import textwrap
import threading

import numpy as np
import pytest

from mcslam_tpu.data import calib as jcalib
from mcslam_tpu.data import config as jconfig
from mcslam_tpu.data import live as jlive
from mcslam_tpu.data import readers as jreaders
from mcslam_tpu_torch.data import calib as tcalib
from mcslam_tpu_torch.data import config as tconfig
from mcslam_tpu_torch.data import live as tlive
from mcslam_tpu_torch.data import readers as treaders

APP_CFG = """
    data_path={root}
    images_path={root}
    calib_file_path=camchain.yaml
    frontend_params_file=frontend.yaml
    kalibr=true
    num_cams=2
    traj_file=traj.txt
    map_path=map.json
    vocabulary=vocab.npz
    database_path=db.npz
    calc_depth=true
    depth_dir=depth
"""
PARSING_CFG = """
    # comment
    data_path={root}
    images_path=imgs
    use_imu=true
    num_cams=3
    frames=10,100,2
    shifts=0,3,5
    traj_file=out.txt
    [section]
    depth_max_disp=48  # trailing comment
    dense_cloud_path=/abs/cloud.ply
"""

CAMCHAIN_2 = """
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
"""
CAMCHAIN_IMU_GPS = """
    cam0:
      intrinsics: [400.0, 401.0, 320.0, 240.0]
      distortion_coeffs: [-0.1, 0.01, 0.001, -0.001]
      distortion_model: radtan
      resolution: [640, 480]
    cam1:
      intrinsics: [402.0, 403.0, 321.0, 241.0]
      distortion_coeffs: [-0.11, 0.012, 0.0, 0.0]
      distortion_model: radtan
      resolution: [640, 480]
      T_cn_cnm1:
        - [1.0, 0.0, 0.0, -0.2]
        - [0.0, 1.0, 0.0, 0.0]
        - [0.0, 0.0, 1.0, 0.0]
        - [0.0, 0.0, 0.0, 1.0]
    imu:
      acc_noise: 0.02
      gyr_noise: 0.002
      g_norm: 9.803
      Tbc:
        - [0.0, -1.0, 0.0, 0.1]
        - [1.0, 0.0, 0.0, 0.0]
        - [0.0, 0.0, 1.0, -0.05]
        - [0.0, 0.0, 0.0, 1.0]
    gps:
      Tbg:
        - [1.0, 0.0, 0.0, 0.3]
        - [0.0, 1.0, 0.0, 0.0]
        - [0.0, 0.0, 1.0, 0.6]
        - [0.0, 0.0, 0.0, 1.0]
"""


def _yaw(deg, t):
    a = np.radians(deg)
    T = np.eye(4)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                 [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = t
    return T


def _rows(T):
    return "\n".join("        - [" + ", ".join(f"{v:.12f}" for v in r) + "]"
                     for r in T)


# a 3-camera fisheye chain with rotations between neighbours
CAMCHAIN_3_EQUI = f"""
    cam0:
      intrinsics: [300.0, 301.0, 330.0, 250.0]
      distortion_coeffs: [0.02, -0.01, 0.003, -0.001]
      distortion_model: equidistant
      resolution: [640, 480]
    cam1:
      intrinsics: [302.0, 303.0, 321.0, 241.0]
      distortion_coeffs: [0.021, -0.011, 0.002, -0.0005]
      distortion_model: equidistant
      resolution: [640, 480]
      T_cn_cnm1:
{_rows(_yaw(20.0, [-0.1, 0.01, 0.02]))}
    cam2:
      intrinsics: [299.0, 298.0, 318.0, 239.0]
      distortion_coeffs: [0.019, -0.012, 0.001, -0.0007]
      distortion_model: equidistant
      resolution: [640, 480]
      T_cn_cnm1:
{_rows(_yaw(-35.0, [-0.12, -0.02, 0.0]))}
"""

PLAIN_VO = """
    cam0:
      K: [400.0, 0.0, 320.0, 0.0, 401.0, 240.0, 0.0, 0.0, 1.0]
      dist: [-0.1, 0.01, 0.0, 0.0]
      resolution: [640, 480]
    cam1:
      K: [402.0, 0.0, 321.0, 0.0, 403.0, 241.0, 0.0, 0.0, 1.0]
      dist: [-0.11, 0.012, 0.001, 0.0, 0.0005]
      R: [0.9998, 0.0, 0.0199987, 0.0, 1.0, 0.0, -0.0199987, 0.0, 0.9998]
      t: [-0.2, 0.0, 0.01]
      resolution: [640, 480]
"""


def _write(path, text):
    path.write_text(textwrap.dedent(text))
    return path


def _rig_equal(jrig, trig):
    for f in ("fxycxy", "dist", "cam_T_ref", "body_T_cam"):
        np.testing.assert_allclose(getattr(trig, f).numpy(),
                                   np.asarray(getattr(jrig, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    assert trig.image_size == tuple(jrig.image_size)
    assert trig.dist_model == jrig.dist_model
    assert trig.device.type == "cpu"


def _params_equal(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


# -- config -------------------------------------------------------------------

@pytest.mark.parametrize("text", [APP_CFG, PARSING_CFG],
                         ids=["app_cli", "cfg_parsing"])
def test_parse_cfg_matches_jax(tmp_path, text):
    cfg = _write(tmp_path / "app.cfg", text.format(root=tmp_path))
    sj, st = jconfig.parse_cfg(cfg), tconfig.parse_cfg(cfg)
    assert st.raw == sj.raw
    assert st.frames_range == sj.frames_range
    assert st.shifts == sj.shifts
    for k in ("num_cams", "use_imu", "calc_depth", "kalibr", "traj_file"):
        assert getattr(st, k) == getattr(sj, k)
    with pytest.raises(AttributeError):
        st.no_such_option


FRONTEND_YAMLS = {
    "app_cli": """
        ORBextractor.nFeatures: 512
        ORBextractor.nLevels: 3
        KFBaselineThresholdTranslation: 0.2
        KFBaselineThresholdRotation: 0.1
    """,
    "opencv_symbolic": """%YAML:1.0
---
# reference frontend parameters
ORBextractor.nFeatures: 768
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: 4
ORBextractor.iniThFAST: 18
ORBextractor.minThFAST: 6
InitCondition: MIN_FEATS
PoseEstimation: G_P3P
InterMatch: BF_MATCH
LogDir: logs
""",
    "opencv_ints": """%YAML:1.0
---
InitCondition: 1
PoseEstimation: 0
InterMatch: 1
KFBaselineThresholdTranslation: 0.3
""",
}
BACKEND_YAMLS = {
    "knobs": "%YAML:1.0\n---\nMeasurementNoiseSigma: 4.0\nOptimization: 1\n"
             "WindowBad: 9\n",
    "defaults": None,
}


@pytest.mark.parametrize("be", sorted(BACKEND_YAMLS))
@pytest.mark.parametrize("fe", sorted(FRONTEND_YAMLS))
def test_params_and_slam_config_match_jax(tmp_path, fe, be):
    fe_path = _write(tmp_path / "fe.yaml", FRONTEND_YAMLS[fe])
    be_path = (None if BACKEND_YAMLS[be] is None
               else _write(tmp_path / "be.yaml", BACKEND_YAMLS[be]))
    fj, ft = (jconfig.load_frontend_params(fe_path),
              tconfig.load_frontend_params(fe_path))
    bj, bt = (jconfig.load_backend_params(be_path),
              tconfig.load_backend_params(be_path))
    assert ft == fj and bt == bj
    cj, ej = jconfig.slam_config_from_params(fj, bj)
    ct, et = tconfig.slam_config_from_params(ft, bt)
    assert et == ej
    dj, dt = dataclasses.asdict(cj), dataclasses.asdict(ct)
    assert dt.keys() == dj.keys()
    assert dt == dj


@pytest.mark.parametrize("fe,be", [
    ({"InitCondition": 2}, {}), ({"InitCondition": "FOO"}, {}),
    ({"InterMatch": 5}, {}), ({"PoseEstimation": "EPNP"}, {}),
    ({}, {"Optimization": 3}),
])
def test_bad_enums_raise_like_jax(fe, be):
    def params(cfg):
        f, b = dict(cfg._FRONTEND_DEFAULTS), dict(cfg._BACKEND_DEFAULTS)
        f.update(fe)
        b.update(be)
        return f, b

    with pytest.raises(ValueError) as ej:
        jconfig.slam_config_from_params(*params(jconfig))
    with pytest.raises(ValueError) as et:
        tconfig.slam_config_from_params(*params(tconfig))
    assert str(et.value) == str(ej.value)


# -- calibration -------------------------------------------------------------

@pytest.mark.parametrize("text", [CAMCHAIN_2, CAMCHAIN_IMU_GPS,
                                  CAMCHAIN_3_EQUI],
                         ids=["app_cli", "imu_gps", "equidistant_chain"])
def test_load_kalibr_matches_jax(tmp_path, text):
    y = _write(tmp_path / "camchain.yaml", text)
    rj, ij, gj = jcalib.load_kalibr(y)
    rt, it, gt = tcalib.load_kalibr(y, device="cpu")
    _rig_equal(rj, rt)
    _params_equal(ij, it)
    _params_equal(gj, gt)


def test_load_plain_vo_yaml_matches_jax(tmp_path):
    y = _write(tmp_path / "vo.yaml", PLAIN_VO)
    _rig_equal(jcalib.load_plain_vo_yaml(y),
               tcalib.load_plain_vo_yaml(y, device="cpu"))


# -- readers -----------------------------------------------------------------

T0_NS = 10**18  # EuRoC-style 19-digit ns stamps


def _image_folders(root, ext, euroc_layout):
    """Two cameras; cam1 starts 2 frames late and is 3 ms behind cam0,
    and one of its frames is missing (that group cannot sync)."""
    import cv2

    rng = np.random.RandomState(5)
    for c in range(2):
        d = root / f"cam{c}" / ("data" if euroc_layout else "")
        d.mkdir(parents=True, exist_ok=True)
        for k in range(8):
            if c == 1 and (k < 2 or k == 5):
                continue
            ts_ns = T0_NS + k * 50_000_000 + c * 3_000_000
            img = rng.randint(0, 256, (24, 32)).astype(np.uint8)
            cv2.imwrite(str(d / f"{ts_ns}{ext}"), img)
    (root / "depth_out").mkdir()  # an output dir, not a camera
    np.save(root / "depth_out" / "depth_000000.npy", np.zeros(2))


@pytest.mark.parametrize("frame_range", [None, (1, 5), (0, 6, 2)])
@pytest.mark.parametrize("ext,euroc_layout", [(".pgm", True),
                                              (".png", False)])
def test_image_folder_reader_matches_jax(tmp_path, ext, euroc_layout,
                                         frame_range):
    _image_folders(tmp_path, ext, euroc_layout)
    rj = jreaders.ImageFolderReader(tmp_path, frame_range=frame_range)
    rt = treaders.ImageFolderReader(tmp_path, frame_range=frame_range)
    assert rt.cam_dirs == rj.cam_dirs == ["cam0", "cam1"]
    assert len(rt) == len(rj) > 0
    while True:
        a, b = rj.get_next(), rt.get_next()
        assert (a is None) == (b is None)
        if a is None:
            break
        assert b[1] == a[1]
        assert b[0].dtype == np.float32 and b[0].shape == (2, 24, 32)
        np.testing.assert_array_equal(b[0], a[0])


def test_pgm_decoder(tmp_path):
    import cv2

    img = np.random.RandomState(1).randint(0, 256, (5, 7)).astype(np.uint8)
    p = tmp_path / "commented.pgm"
    # whitespace-separated header fields with a comment between them
    p.write_bytes(b"P5\n# a comment\n7 5\n255\n" + img.tobytes())
    np.testing.assert_array_equal(treaders._read_pgm(p), img)
    np.testing.assert_array_equal(
        treaders._read_pgm(p), cv2.imread(str(p), cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(treaders._load_gray(p),
                                  jreaders._load_gray(p))
    bad = {
        "ascii.pgm": b"P2\n2 1\n255\n1 2\n",
        "deep.pgm": b"P5\n2 1\n65535\n" + bytes(4),
        "short.pgm": b"P5\n4 4\n255\n" + bytes(10),
        "header.pgm": b"P5\n4",
    }
    for name, data in bad.items():
        (tmp_path / name).write_bytes(data)
        with pytest.raises(ValueError):
            treaders._read_pgm(tmp_path / name)


def test_video_reader_matches_jax(tmp_path):
    """Per-camera video files with frame shifts (MJPG, one gray and one
    color stream): the same count, frames and timestamps."""
    import cv2

    rng = np.random.RandomState(4)
    paths = []
    for c, color in enumerate((False, True)):
        p = tmp_path / f"cam{c}.avi"
        w = cv2.VideoWriter(str(p), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                            (32, 24), isColor=color)
        assert w.isOpened()
        for k in range(6):
            img = rng.randint(0, 256, (24, 32, 3) if color else (24, 32))
            w.write(img.astype(np.uint8))
        w.release()
        paths.append(p)
    rj = jreaders.VideoReader(paths, shifts=[0, 2])
    rt = treaders.VideoReader(paths, shifts=[0, 2])
    assert len(rt) == len(rj) == 4 and rt.fps == rj.fps == 10.0
    while True:
        a, b = rj.get_next(), rt.get_next()
        assert (a is None) == (b is None)
        if a is None:
            break
        assert b[1] == a[1] and b[0].shape == (2, 24, 32)
        np.testing.assert_array_equal(b[0], a[0])
    with pytest.raises(IOError):
        treaders.VideoReader([tmp_path / "missing.avi"])


def test_imu_gps_streams_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    ts = T0_NS + np.arange(40) * 5_000_000
    imu = tmp_path / "imu.csv"
    imu.write_text("#timestamp [ns],wx,wy,wz,ax,ay,az\n" + "\n".join(
        f"{t}," + ",".join(f"{v:.9f}" for v in rng.randn(6)) for t in ts))
    gps = tmp_path / "gps.csv"
    gps.write_text("\n".join(
        f"{0.05 * k:.6f},{42.36 + 1e-5 * k:.9f},{-71.06:.9f},{10.0 + k:.3f}"
        for k in range(10)))
    ij, it = jreaders.ImuStream.from_csv(imu), treaders.ImuStream.from_csv(imu)
    gj, gt = jreaders.GpsStream.from_csv(gps), treaders.GpsStream.from_csv(gps)
    np.testing.assert_array_equal(it.ts, ij.ts)
    for t in (T0_NS * 1e-9 - 1.0, T0_NS * 1e-9 + 0.05, T0_NS * 1e-9 + 0.05,
              T0_NS * 1e-9 + 0.1234, T0_NS * 1e-9 + 9.0):
        for a, b in zip(ij.until(t), it.until(t)):
            np.testing.assert_array_equal(b, a)
    for t in (0.0, 0.12, 0.3, 1.0):
        for a, b in zip(gj.until(t), gt.until(t)):
            np.testing.assert_array_equal(b, a)


class _ListReader(treaders.DatasetReaderBase):
    def __init__(self, n, fail_at=None):
        self.k, self.n, self.fail_at = 0, n, fail_at

    def get_next(self):
        if self.k == self.fail_at:
            raise IOError("failed to read image k")
        if self.k >= self.n:
            return None
        self.k += 1
        return np.full((1, 2, 2), self.k, np.float32), float(self.k)


def test_prefetcher_order_and_errors():
    got = [t for _, t in treaders.Prefetcher(_ListReader(7), depth=2)]
    assert got == [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]
    got = [img[0, 0, 0] for img, _ in treaders.Prefetcher(
        _ListReader(5), transform=lambda it: (it[0] * 2, it[1]))]
    assert got == [2.0, 4.0, 6.0, 8.0, 10.0]
    # a reader error reaches the consumer after the frames before it
    seen = []
    with pytest.raises(IOError, match="failed to read"):
        for _, t in treaders.Prefetcher(_ListReader(9, fail_at=3)):
            seen.append(t)
    assert seen == [1.0, 2.0, 3.0]


def _live_frames(mod):
    """tests/test_live_segmask.py's producer against `mod`.LiveRig."""
    rig = mod.LiveRig(num_cams=2, sync_tol=0.005)

    def producer():
        for k in range(5):
            t = k * 0.1
            img = np.full((24, 32), k / 10.0, np.float32)
            rig.push_image(0, t, img)
            rig.push_image(1, t + 0.002, img + 0.01)
            for j in range(10):
                rig.push_imu(t - 0.09 + j * 0.01, [0.1, 0, 0], [0, 0, 9.8])
            if k % 2 == 0:
                rig.push_gps(t - 0.01, 42.0, -71.0, 10.0)
        rig.push_image(1, 0.9, (np.ones((24, 32)) * 255).astype(np.uint8))
        rig.stop()

    th = threading.Thread(target=producer)
    th.start()
    frames = []
    while True:
        out = rig.get_next(timeout=2.0)
        if out is None:
            break
        frames.append(out)
    th.join(timeout=10.0)
    assert not th.is_alive()
    return frames


def test_live_rig_sync_matches_jax():
    fj, ft = _live_frames(jlive), _live_frames(tlive)
    assert len(ft) == len(fj) == 5
    for a, b in zip(fj, ft):
        np.testing.assert_array_equal(b[0], a[0])
        assert b[1] == a[1]
        for x, y in zip(a[2] + a[3], b[2] + b[3]):
            np.testing.assert_array_equal(y, x)
    imgs, t0, imu, _ = ft[2]
    assert imgs.shape == (2, 24, 32) and abs(t0 - 0.2) < 1e-9
    assert len(imu[0]) > 0 and imu[0].max() <= t0 + 1e-9
    all_ts = np.concatenate([f[2][0] for f in ft])
    assert len(np.unique(all_ts)) == len(all_ts)


# -- the package -------------------------------------------------------------

@pytest.mark.parametrize("name", ["MultiCameraSLAM", "SlamConfig",
                                  "build_frame", "CameraRig", "load_kalibr",
                                  "load_euroc_rig", "ate_rmse"])
def test_top_level_exports(name):
    import importlib

    import mcslam_tpu
    import mcslam_tpu_torch

    obj = getattr(mcslam_tpu_torch, name)
    target = mcslam_tpu_torch._EXPORTS[name]
    assert obj is getattr(importlib.import_module(target), name)
    assert target.replace("mcslam_tpu_torch", "mcslam_tpu") == \
        mcslam_tpu._EXPORTS[name]
    assert name in dir(mcslam_tpu_torch)
    with pytest.raises(AttributeError):
        mcslam_tpu_torch.no_such_export


def test_app_modules_import_no_jax():
    code = ("import sys, mcslam_tpu_torch as m; "
            "import mcslam_tpu_torch.apps.mc_slam_app, "
            "mcslam_tpu_torch.apps.run_euroc, "
            "mcslam_tpu_torch.apps.evaluate_trajectory, "
            "mcslam_tpu_torch.data.live, mcslam_tpu_torch.data.euroc, "
            "mcslam_tpu_torch.mapping.dense_fusion; "
            "[getattr(m, n) for n in m._EXPORTS]; "
            "bad = [k for k in sys.modules if k == 'jax' "
            "or k.startswith('mcslam_tpu.') or k == 'mcslam_tpu']; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
