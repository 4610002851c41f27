"""Parity of the port's dense-depth modules (mcslam_tpu_torch.ops.image's
_sep_conv, ops.stereo, ops.rectify, mapping.dense_fusion) with the JAX
package on the same numpy inputs, on the CPU, and the JAX tests' own
gates (tests/test_stereo.py) on the port alone at 160x120 or less.

Tolerances: _sep_conv and cost_volume 1e-6 (both sum the taps in f32);
sgm_aggregate 1e-5 relative (the same recursion in the same order);
disparity: >= 99 % equal integer winners, and where they agree the
sub-pixel value within 1e-4 and equal valid masks (a last-bit cost
difference can flip a near-tie); stereo_rectify 1e-9 (host float64 in
both); rectify_maps 1e-4 px; remap_bilinear 1e-6; depth 1e-4 relative
where the winners agree; DenseFuser: >= 99 % of the voxel keys shared,
and >= 99 % of those with the same count, centroid (1e-4 m) and
intensity (1e-5): a pixel whose winner flips moves its voxel's centroid."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.geometry import camera as jcam
from mcslam_tpu.mapping import dense_fusion as jfusion
from mcslam_tpu.ops import image as jimage
from mcslam_tpu.ops import rectify as jrect
from mcslam_tpu.ops import stereo as jstereo
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.geometry import camera as tcam
from mcslam_tpu_torch.mapping import dense_fusion as tfusion
from mcslam_tpu_torch.ops import image as timage
from mcslam_tpu_torch.ops import rectify as trect
from mcslam_tpu_torch.ops import stereo as tstereo

W, H, F = 160, 120, 130.0


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Many small ops (the SGM steps): one intra-op thread runs them
    faster than a pool that the suite's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _blob_pair(frame=0):
    """The 2-camera parallel blob scene of tests/test_stereo.py at
    160x120: (imgs (2, H, W), numpy rig fields)."""
    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, baseline=0.2, image_size=(W, H), focal=F))
    poses = jsyn.smooth_trajectory(frame + 1)
    lms = jsyn.make_landmarks(250, seed=1, depth_range=(4.0, 8.0),
                              spread=(4.0, 3.0))
    imgs = np.asarray(jsyn.render_blob_images(rig, poses, lms, seed=2))
    return imgs[frame], rig, poses, lms


def _rotated_rigs(deg=3.0, dist=(-0.05, 0.01, 0.001, -0.001, 0.0),
                  model=jcam.DIST_RADTAN):
    """A 2-camera pair whose cam 1 sits 0.2 m along +x and is yawed by
    `deg` degrees: (JAX rig, port rig on the CPU)."""
    ang = np.radians(deg)
    R_b = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                    [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    cam_T_ref = np.stack([np.eye(4, dtype=np.float32)] * 2)
    cam_T_ref[1, :3, :3] = R_b.T
    cam_T_ref[1, :3, 3] = -(R_b.T @ np.array([0.2, 0.0, 0.0]))
    fx = np.array([[F, F, W / 2, H / 2]] * 2, np.float32)
    d = np.array([dist] * 2, np.float32)
    return (jcam.make_rig(fx, d, cam_T_ref, image_size=(W, H),
                          dist_model=model),
            tcam.make_rig(fx, d, cam_T_ref, image_size=(W, H),
                          dist_model=model, device="cpu"))


def _plane_images(rig_np, Z0=5.0):
    """Both cameras of a rig looking at a textured plane z = Z0 in the
    reference frame (tests/test_stereo.py's procedural texture)."""
    fxycxy = np.asarray(rig_np.fxycxy)
    cam_T_ref = np.asarray(rig_np.cam_T_ref)
    imgs = np.zeros((2, H, W), np.float32)
    for c in range(2):
        T = np.linalg.inv(cam_T_ref[c])
        u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                           np.arange(H, dtype=np.float64))
        rays = np.stack([(u - fxycxy[c, 2]) / fxycxy[c, 0],
                         (v - fxycxy[c, 3]) / fxycxy[c, 1],
                         np.ones_like(u)], -1) @ T[:3, :3].T
        s = (Z0 - T[2, 3]) / np.maximum(rays[..., 2], 1e-9)
        X, Y = T[0, 3] + s * rays[..., 0], T[1, 3] + s * rays[..., 1]
        imgs[c] = (0.5 + 0.2 * np.sin(3.0 * X) * np.cos(2.5 * Y)
                   + 0.15 * np.sin(7.1 * X + 1.3) * np.sin(5.3 * Y + 0.7)
                   + 0.1 * np.sin(13.7 * X * 0.7 + 11.9 * Y))
    return imgs


def _winners(cv_j, cv_t):
    return np.asarray(jnp.argmin(cv_j, axis=0)), torch.argmin(cv_t, 0).numpy()


# -- the parts ---------------------------------------------------------------

@pytest.mark.parametrize("ksize", [5, 7])
def test_sep_conv_matches_jax(ksize):
    imgs, *_ = _blob_pair()
    k = np.random.RandomState(ksize).rand(ksize)
    k = (k / k.sum()).astype(np.float32)  # unit-sum taps, as a blur's
    a = np.asarray(jimage._sep_conv(jnp.asarray(imgs), jnp.asarray(k)))
    b = timage._sep_conv(_t(imgs), _t(k)).numpy()
    assert b.shape == imgs.shape
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_cost_volume_matches_jax():
    imgs, *_ = _blob_pair()
    for window in (5, 7):
        a = np.asarray(jstereo.cost_volume(
            jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), 32, window))
        b = tstereo.cost_volume(_t(imgs[0]), _t(imgs[1]), 32, window)
        assert b.shape == (32, H, W)
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-6)
    for d in (0, 5):
        np.testing.assert_array_equal(
            tstereo._shift_x(_t(imgs[1]), d).numpy(),
            np.asarray(jstereo._shift_x(jnp.asarray(imgs[1]), d)))


def test_sgm_aggregate_matches_jax():
    imgs, *_ = _blob_pair()
    cv = np.asarray(jstereo.cost_volume(
        jnp.asarray(imgs[0]), jnp.asarray(imgs[1]), 24))
    a = np.asarray(jax.jit(jstereo.sgm_aggregate)(jnp.asarray(cv)))
    b = tstereo.sgm_aggregate(_t(cv)).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("algo", ["box", "sgm"])
@pytest.mark.parametrize("scene", ["blobs", "plane"])
def test_disparity_matches_jax(algo, scene):
    if scene == "blobs":
        imgs, *_ = _blob_pair()
    else:  # a parallel pair (the rotated rig's geometry without the yaw)
        jrig, _ = _rotated_rigs(deg=0.0, dist=(0.0,) * 5,
                                model=jcam.DIST_NONE)
        imgs = _plane_images(jrig)
    L, R = imgs
    D = 32
    dj, vj = jstereo.disparity(jnp.asarray(L), jnp.asarray(R), max_disp=D,
                               algo=algo)
    dt, vt = tstereo.disparity(_t(L), _t(R), max_disp=D, algo=algo)
    cvj = jstereo.cost_volume(jnp.asarray(L), jnp.asarray(R), D)
    cvt = tstereo.cost_volume(_t(L), _t(R), D)
    if algo == "sgm":
        cvj = jax.jit(jstereo.sgm_aggregate)(cvj)
        cvt = tstereo.sgm_aggregate(cvt)
    wj, wt = _winners(cvj, cvt)
    same = wj == wt
    assert same.mean() >= 0.99, same.mean()
    dj, vj, dt, vt = (np.asarray(dj), np.asarray(vj), dt.numpy(),
                      vt.numpy())
    np.testing.assert_allclose(dt[same], dj[same], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(vt[same], vj[same])
    assert vt.mean() > 0.2, vt.mean()  # the comparison covers real depth


def test_stereo_rectify_matches_jax():
    jrig, _ = _rotated_rigs()
    cam_T_ref = np.asarray(jrig.cam_T_ref, np.float64)
    T = cam_T_ref[1] @ np.linalg.inv(cam_T_ref[0])
    fx = np.asarray(jrig.fxycxy)
    a = jrect.stereo_rectify(fx[0], fx[1], T[:3, :3], T[:3, 3], (W, H))
    b = trect.stereo_rectify(fx[0], fx[1], T[:3, :3], T[:3, 3], (W, H))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y, x, rtol=0, atol=1e-9)
    w = np.array([0.01, -0.03, 0.02])
    np.testing.assert_allclose(trect._rodrigues(w), jrect._rodrigues(w),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(trect._log_so3(trect._rodrigues(w)), w,
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("model", [jcam.DIST_RADTAN, jcam.DIST_EQUIDISTANT,
                                   jcam.DIST_NONE])
def test_rectify_maps_match_jax(model):
    dist = {jcam.DIST_RADTAN: (-0.05, 0.01, 0.001, -0.001, 0.0),
            jcam.DIST_EQUIDISTANT: (0.02, -0.01, 0.003, -0.001, 0.0),
            jcam.DIST_NONE: (0.0,) * 5}[model]
    jrig, trig = _rotated_rigs(dist=dist, model=model)
    rj, rt = jrect.RigRectifier(jrig), trect.RigRectifier(trig)
    assert not rj.is_identity and not rt.is_identity
    for mj, mt in ((rj.map_a, rt.map_a), (rj.map_b, rt.map_b)):
        for x, y in zip(mj, mt):
            assert y.shape == (H, W)
            np.testing.assert_allclose(y.numpy(), x, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(rt.fxycxy_new, rj.fxycxy_new)
    assert rt.baseline == rj.baseline


def test_remap_bilinear_matches_jax():
    imgs, *_ = _blob_pair()
    rng = np.random.RandomState(3)
    # maps reaching past every border exercise the clamped neighbours
    mx = rng.uniform(-3.0, W + 2.0, (H, W)).astype(np.float32)
    my = rng.uniform(-3.0, H + 2.0, (H, W)).astype(np.float32)
    a = np.asarray(jrect.remap_bilinear(jnp.asarray(imgs[0]),
                                        jnp.asarray(mx), jnp.asarray(my)))
    b = trect.remap_bilinear(_t(imgs[0]), _t(mx), _t(my)).numpy()
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


@pytest.mark.parametrize("pair", ["parallel", "rotated"])
def test_depth_from_rig_pair_matches_jax(pair):
    if pair == "parallel":
        imgs, jrig, *_ = _blob_pair()
        trig = tcam.rig_from_numpy(jrig.fxycxy, jrig.dist, jrig.cam_T_ref,
                                   jrig.body_T_cam, jrig.image_size,
                                   jrig.dist_model, device="cpu")
    else:
        jrig, trig = _rotated_rigs()
        imgs = _plane_images(jrig)
    for algo in ("box", "sgm"):
        zj, vj = jstereo.depth_from_rig_pair(jnp.asarray(imgs), jrig, 0, 1,
                                             max_disp=32, algo=algo)
        zt, vt = tstereo.depth_from_rig_pair(_t(imgs), trig, 0, 1,
                                             max_disp=32, algo=algo)
        zj, vj, zt, vt = (np.asarray(zj), np.asarray(vj), zt.numpy(),
                          vt.numpy())
        assert (vt == vj).mean() >= 0.99
        ok = vt & vj
        assert ok.mean() > 0.2, ok.mean()
        np.testing.assert_allclose(zt[ok], zj[ok], rtol=1e-4, atol=0)


def test_dense_fuser_matches_jax():
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, baseline=0.3, image_size=(W, H), focal=F))
    trig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, baseline=0.3, image_size=(W, H), focal=F), device="cpu")
    poses = jsyn.loop_trajectory(3, radius=3.0, revisit_frames=0, seed=0)
    imgs = np.asarray(jsyn.render_textured_world(jrig, poses, radius=10.0,
                                                 seed=11))
    kw = dict(voxel=0.25, max_depth=25.0, stride=2, algo="sgm", max_disp=32)
    fj, ft = jfusion.DenseFuser(jrig, **kw), tfusion.DenseFuser(trig, **kw)
    for k in range(2):
        nj = fj.add_keyframe(jnp.asarray(imgs[k]), poses[k])
        nt = ft.add_keyframe(imgs[k], poses[k])
        assert nt > 50 and abs(nt - nj) <= 0.01 * nj
    pj, ij, cj = fj.finalize()
    pt, it, ct = ft.finalize()
    off = 1 << 20

    def keys(p):
        k = np.floor(p / 0.25).astype(np.int64) + off
        return k[:, 0] + (k[:, 1] << 21) + (k[:, 2] << 42)

    kj, kt = keys(pj), keys(pt)
    shared, ia, ib = np.intersect1d(kj, kt, return_indices=True)
    assert len(shared) >= 0.99 * max(len(kj), len(kt))
    close = (np.abs(pt[ib] - pj[ia]).max(axis=1) <= 1e-4) \
        & (np.abs(it[ib] - ij[ia]) <= 1e-5) & (ct[ib] == cj[ia])
    assert close.mean() >= 0.99, close.mean()


# -- the JAX tests' gates on the port alone (tests/test_stereo.py) -----------

def test_port_disparity_constant_shift():
    import cv2

    rng = np.random.RandomState(0)
    left = (rng.rand(60, 120) * 255).astype(np.uint8)
    left = cv2.GaussianBlur(left, (5, 5), 1.0).astype(np.float32) / 255.0
    d_true = 7
    right = np.roll(left, -d_true, axis=1)
    disp, valid = tstereo.disparity(_t(left), _t(right), max_disp=16,
                                    window=5)
    disp, valid = disp.numpy(), valid.numpy()
    core = valid[10:-10, 20:-20]
    err = np.abs(disp[10:-10, 20:-20] - d_true)[core]
    assert core.mean() > 0.7
    assert np.median(err) < 0.6, np.median(err)


def test_port_depth_from_rig_pair_scene():
    """The blob scene cut to 160x120 at the JAX test's focal 260 (its
    disparities, over the central quarter of its view): depth at the blob
    centres."""
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, baseline=0.2, image_size=(W, H), focal=260.0),
        device="cpu")
    poses = tsyn.smooth_trajectory(1)
    lms = tsyn.make_landmarks(250, seed=1, depth_range=(4.0, 8.0),
                              spread=(4.0, 3.0))
    imgs = tsyn.render_blob_images(rig, poses, lms, seed=2)[0]
    depth, valid = tstereo.depth_from_rig_pair(_t(imgs), rig, 0, 1,
                                               max_disp=32)
    depth, valid = depth.numpy(), valid.numpy()
    f = rig.fxycxy[0].numpy()
    rTw = np.linalg.inv(poses[0])
    p = lms @ rTw[:3, :3].T + rTw[:3, 3]
    uv = p[:, :2] / p[:, 2:] * f[:2] + f[2:]
    errs = []
    for i in range(len(lms)):
        x, y = int(round(uv[i, 0])), int(round(uv[i, 1]))
        if 20 <= x < 140 and 5 <= y < 115 and valid[y, x]:
            errs.append(abs(depth[y, x] - p[i, 2]) / p[i, 2])
    assert len(errs) > 30
    assert np.median(errs) < 0.08, np.median(errs)


def test_port_sgm_beats_box_on_weak_texture():
    import cv2

    rng = np.random.RandomState(3)
    Hs, Ws = 80, 160
    f, B = 150.0, 0.2
    x = np.arange(Ws, dtype=np.float32)
    Z = 4.0 + 2.0 * x / Ws
    d_true = np.broadcast_to(f * B / Z, (Hs, Ws))
    left = np.full((Hs, Ws), 0.5, np.float32)
    ys, xs = rng.randint(0, Hs, 250), rng.randint(0, Ws, 250)
    left[ys, xs] = rng.rand(250).astype(np.float32)
    left = cv2.GaussianBlur(left, (5, 5), 1.0)
    xs_src = np.clip(x[None, :] + d_true, 0, Ws - 1)
    x0 = np.floor(xs_src).astype(int)
    fr = xs_src - x0
    x1 = np.minimum(x0 + 1, Ws - 1)
    rows = np.arange(Hs)[:, None]
    right = (left[rows, x0] * (1 - fr) + left[rows, x1] * fr).astype(
        np.float32)
    errs = {}
    for algo in ("box", "sgm"):
        disp, _ = tstereo.disparity(_t(left), _t(right), max_disp=16,
                                    window=5, algo=algo)
        core = np.s_[10:-10, 20:-20]
        errs[algo] = float(np.mean(np.abs(disp.numpy()[core]
                                          - d_true[core])))
    assert errs["sgm"] < errs["box"], errs
    assert errs["sgm"] < 1.0, errs


def test_port_rectified_nonparallel_rig_depth():
    """The verged rig of the JAX test (4 degrees, no distortion) at
    160x120: the rectified path recovers the plane's metric depth."""
    jrig, trig = _rotated_rigs(deg=4.0, dist=(0.0,) * 5,
                               model=jcam.DIST_NONE)
    imgs = _plane_images(jrig)
    depth, valid = tstereo.depth_from_rig_pair(_t(imgs), trig, 0, 1,
                                               max_disp=16, algo="sgm")
    depth, valid = depth.numpy(), valid.numpy()
    core = np.zeros_like(valid)
    core[12:-12, 20:-20] = True
    sel = valid & core
    assert sel.mean() > 0.3, sel.mean()
    rel_err = np.abs(depth[sel] - 5.0) / 5.0
    assert np.median(rel_err) < 0.08, np.median(rel_err)


def test_port_dense_fusion_world_cloud_geometry():
    """The ray-cast cylinder world at 160x120 (focal 130, max_disp 32):
    wall voxels on the radius-10 cylinder, fused across keyframes. The
    count gates are the JAX test's scaled by the pixel count (1/4)."""
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, baseline=0.3, image_size=(W, H), focal=F), device="cpu")
    poses = tsyn.loop_trajectory(3, radius=3.0, revisit_frames=0, seed=0)
    imgs = tsyn.render_textured_world(rig, poses, radius=10.0, seed=11)
    fuser = tfusion.DenseFuser(rig, voxel=0.25, max_depth=25.0, stride=2,
                               algo="sgm", max_disp=32)
    for k in range(len(poses)):
        assert fuser.add_keyframe(_t(imgs[k]), poses[k]) > 25
    pts, inten, cnt = fuser.finalize()
    assert len(pts) > 250
    wall = np.abs(pts[:, 1]) < 1.8
    assert wall.sum() > 75
    r = np.sqrt(pts[wall, 0] ** 2 + pts[wall, 2] ** 2)
    assert np.median(np.abs(r - 10.0)) < 0.5
    assert (cnt > 1).mean() > 0.05
