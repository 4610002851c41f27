"""The port's per-frame slice against the JAX package on the CPU: build_frame
and the fused frame-build + tracking step (_build_and_track_step), at a
small size — 2 cameras, 192x144 pixels, 128 keypoints per camera,
max_intra 256, 256 local-map candidates, 64 RANSAC hypotheses, a map
mirror of 1024 rows seeded from frame 0 as bench.py seeds it.

Tolerances: keypoint fields and intra-rig groups exact, descriptors
equal on >= 99.5 % of valid keypoints, triangulated bearings 1e-5 and
depths 1 %; packed tracking pose 1e-3 and its counts within 2 % on
the fast path; with the portfolio forced (fastpath_frac=2.0) RANSAC draws
differ between torch and jax.random, so only the outcome is held: pose
within 1e-2. The full-pyramid frame build (2 levels) is compared on the
same tracking inputs, since the two pyramids agree to 1e-6 only (see
tests/test_torch_ops.py)."""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcslam_tpu import tracking_kernels as jtk
from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.frontend import frame as jframe
from mcslam_tpu_torch import tracking_kernels as ttk
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.geometry import camera as tcam
from mcslam_tpu_torch.ops import hamming as tham

REPO = pathlib.Path(__file__).resolve().parents[1]
CAP, LML = 1024, 256
KW = dict(num_points=128, max_intra=256, angle_bins=16)
STEP = dict(num_points=128, fast_threshold=20 / 255, min_threshold=7 / 255,
            max_intra=256, min_z=0.5, max_z=40.0, angle_bins=16, num_hyp=64,
            px=5.0, max_dist=64, ratio=0.85, lm_radius=18.0, lm_max_dist=60,
            gate_px=100.0, fastpath_min=30)


@pytest.fixture(scope="module")
def scene():
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0))
    trig = tcam.rig_from_numpy(jrig.fxycxy, jrig.dist, jrig.cam_T_ref,
                               jrig.body_T_cam, jrig.image_size,
                               jrig.dist_model)
    poses = jsyn.smooth_trajectory(2, step_angle=0.02)
    lms = jsyn.make_landmarks(600, depth_range=(4.0, 15.0))
    return jrig, trig, poses, jsyn.render_blob_images(jrig, poses, lms)


def _seed_map(jf):
    """bench.py's map mirror seeding from frame 0, with the driver's
    viewing-normal sign (rig centre -> point, slam.py)."""
    M = jf.im_valid.shape[0]
    valid0 = np.asarray(jf.im_valid) & np.asarray(jf.im_has_depth)
    prev_lm = np.where(valid0, np.arange(M, dtype=np.int32), -1)
    pos = np.zeros((CAP, 3), np.float32)
    pos[:M] = np.asarray(jf.im_point3d)
    mvalid = np.zeros(CAP, bool)
    mvalid[:M] = valid0
    mdesc = np.zeros((CAP, 8), np.uint32)
    mdesc[:M] = np.asarray(jf.im_desc)
    nrm = np.zeros((CAP, 3), np.float32)
    nrm[:M] = pos[:M] / np.maximum(
        np.linalg.norm(pos[:M], axis=1, keepdims=True), 1e-6)
    cand = np.flatnonzero(mvalid)[:LML]
    cand_ids = np.zeros(LML, np.int32)
    cand_ids[:len(cand)] = cand
    return prev_lm, pos, mvalid, mdesc, nrm, cand_ids, np.arange(LML) < len(
        cand)


def _jax_inputs(jf, mp):
    prev_lm, pos, mvalid, mdesc, nrm, cand_ids, cand_valid = mp
    return (jf.im_desc, jf.im_valid, jnp.asarray(prev_lm), jnp.asarray(pos),
            jnp.asarray(mvalid), jnp.asarray(mdesc), jnp.asarray(nrm),
            jnp.asarray(cand_ids), jnp.asarray(cand_valid))


def _torch_inputs(jf, mp):
    prev_lm, pos, mvalid, mdesc, nrm, cand_ids, cand_valid = mp
    tf = tframe.frame_from_numpy(jf)
    return (tf.im_desc, tf.im_valid, torch.from_numpy(prev_lm),
            *ttk.map_mirror_from_numpy(pos, mvalid, mdesc, nrm),
            torch.from_numpy(cand_ids), torch.from_numpy(cand_valid))


def _assert_packed_close(jp, tp, M, pose_atol, counts=True):
    off = 21 + 3 * M
    np.testing.assert_allclose(tp[:16], jp[:16], atol=pose_atol, rtol=0)
    np.testing.assert_allclose(tp[off:off + 16], jp[off:off + 16],
                               atol=pose_atol, rtol=0)
    if counts:
        np.testing.assert_allclose(tp[16:19], jp[16:19], rtol=0.02, atol=0)
        assert tp[19:21].tolist() == jp[19:21].tolist()  # rr_ok, fast path
        n_lm = (jp[off + 16 + M:] > 0.5).sum()
        assert abs((tp[off + 16 + M:] > 0.5).sum() - n_lm) <= 0.02 * n_lm


def test_port_imports_no_jax():
    code = ("import importlib, pkgutil, sys, mcslam_tpu_torch\n"
            "for m in pkgutil.walk_packages(mcslam_tpu_torch.__path__,"
            " 'mcslam_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "import chip_smoke\n"
            "for m in ('slam', 'driver_window', 'keyframe', 'backend.ba',\n"
            "          'ops.ba_cuda', 'mapping.landmarks', 'mapping.device_map',\n"
            "          'utils.metrics', 'utils.tum', 'utils.profiling'):\n"
            "    assert 'mcslam_tpu_torch.' + m in sys.modules, m\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or"
            " k.startswith(('jax.', 'mcslam_tpu.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_build_frame_matches_jax(scene):
    jrig, trig, _, imgs = scene
    jf = jframe.build_frame(jnp.asarray(imgs[0]), jrig, num_levels=1, **KW)
    tf = tframe.build_frame(torch.from_numpy(imgs[0]), trig, num_levels=1,
                            **KW)
    for name in ("kp_xy", "kp_response", "kp_octave", "kp_sigma2",
                 "kp_valid"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
    v = np.asarray(jf.kp_valid)
    same = np.all(tham.desc_to_numpy_u32(tf.kp_desc) == np.asarray(
        jf.kp_desc), axis=-1)
    assert same[v].mean() >= 0.995
    np.testing.assert_allclose(tf.kp_xy_ud.numpy(), np.asarray(jf.kp_xy_ud),
                               atol=1e-4, rtol=0)
    # intra-rig groups and their triangulation follow from the above
    for name in ("im_ray_idx", "im_anchor_cam", "im_n_rays", "im_valid",
                 "im_has_depth"):
        np.testing.assert_array_equal(getattr(tf, name).numpy(),
                                      np.asarray(getattr(jf, name)))
    # depth from a 0.12 m baseline at up to 15 m moves ~15 m per pixel of
    # disparity, so the f32 rounding of the 5-step GN refine shows in
    # depth; bearings are tight
    d = np.asarray(jf.im_has_depth)
    Xj, Xt = np.asarray(jf.im_point3d)[d], tf.im_point3d.numpy()[d]
    np.testing.assert_allclose(Xt[:, :2] / Xt[:, 2:], Xj[:, :2] / Xj[:, 2:],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(Xt[:, 2], Xj[:, 2], rtol=1e-2, atol=0)


@pytest.mark.parametrize("frac", [0.6, 2.0], ids=["fast_path", "portfolio"])
def test_build_and_track_step_matches_jax(scene, frac):
    jrig, trig, poses, imgs = scene
    jf0 = jframe.build_frame(jnp.asarray(imgs[0]), jrig, num_levels=1, **KW)
    mp = _seed_map(jf0)
    *_, jp = jtk._build_and_track_step(
        jax.random.PRNGKey(0), jnp.asarray(imgs[1]), jrig,
        *_jax_inputs(jf0, mp), jnp.eye(4, dtype=jnp.float32), num_levels=1,
        approx_topk=True, image_wh=jrig.image_size, fastpath_frac=frac,
        **STEP)
    kps, xy_ud, groups, tri, tp = ttk._build_and_track_step(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs[1]), trig,
        *_torch_inputs(jf0, mp), torch.eye(4), num_levels=1,
        image_wh=trig.image_size, fastpath_frac=frac, **STEP)
    jp, tp = np.asarray(jp), tp.numpy()
    M = KW["max_intra"]
    assert tp.shape == jp.shape == (21 + 3 * M + 16 + 2 * M,)
    assert tp[20] == (1.0 if frac < 1.0 else 0.0)
    if frac < 1.0:
        _assert_packed_close(jp, tp, M, 1e-3)
    else:
        _assert_packed_close(jp, tp, M, 1e-2, counts=False)
    gt = np.linalg.inv(poses[0]) @ poses[1]
    off = 21 + 3 * M
    assert np.abs(tp[off:off + 16].reshape(4, 4) - gt).max() < 0.1
    ff = tframe.assemble_frame(kps, xy_ud, groups, tri)
    assert ff.im_valid.shape == (M,) and ff.kp_desc.dtype == torch.int32


def test_track_and_map_step_on_pyramid_frames_matches_jax(scene):
    """Two-level frames built by JAX, tracked by both packages."""
    jrig, trig, _, imgs = scene
    jf0, jf1 = (jframe.build_frame(jnp.asarray(im), jrig, num_levels=2, **KW)
                for im in imgs[:2])
    mp = _seed_map(jf0)
    tf1 = tframe.frame_from_numpy(jf1)
    fields = ("im_desc", "im_valid", "im_uv_ref", "im_anchor_cam",
              "im_sigma2", "im_point3d", "im_has_depth")
    args = dict(num_hyp=64, px=5.0, max_dist=64, ratio=0.85, lm_radius=18.0,
                lm_max_dist=60, gate_px=100.0, fastpath_frac=0.6,
                fastpath_min=30)
    jp = np.asarray(jtk._track_and_map_step(
        jax.random.PRNGKey(0), *(getattr(jf1, f) for f in fields),
        *_jax_inputs(jf0, mp), jrig.cam_T_ref, jrig.fxycxy,
        jnp.eye(4, dtype=jnp.float32), image_wh=jrig.image_size, **args))
    tp = ttk._track_and_map_step(
        torch.Generator().manual_seed(0), *(getattr(tf1, f) for f in fields),
        *_torch_inputs(jf0, mp), trig.cam_T_ref, trig.fxycxy, torch.eye(4),
        image_wh=trig.image_size, **args).numpy()
    _assert_packed_close(jp, tp, KW["max_intra"], 1e-3)
