"""Parity of the port's geometry and synthetic-scene modules
(mcslam_tpu_torch.geometry.*, mcslam_tpu_torch.data.synthetic) with the
JAX package on the same numpy inputs, on the CPU.

Tolerances: lie / camera 1e-5 (f32 in a different op order);
triangulated points 2e-5 m (see the test); kabsch_quat 1e-4 (Newton
iterations on a quartic amplify the ordering noise); rendered images
1e-4 (f32 projection)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.geometry import alignment as jalign
from mcslam_tpu.geometry import camera as jcam
from mcslam_tpu.geometry import lie as jlie
from mcslam_tpu.geometry import linalg3 as jlin
from mcslam_tpu.geometry import triangulation as jtri
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.geometry import alignment as talign
from mcslam_tpu_torch.geometry import camera as tcam
from mcslam_tpu_torch.geometry import lie as tlie
from mcslam_tpu_torch.geometry import linalg3 as tlin
from mcslam_tpu_torch.geometry import triangulation as ttri

ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _tangents(seed, n=64):
    """Random rotation tangents incl. tiny (series branch) and ~pi ones."""
    rng = np.random.RandomState(seed)
    w = rng.randn(n, 3).astype(np.float32)
    w[: n // 4] *= 1e-5
    w[n // 4: n // 2] *= 0.5
    axis = rng.randn(8, 3)
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w[-8:] = (axis * (np.pi - 1e-2)).astype(np.float32)
    return w


@pytest.mark.parametrize("fn", ["so3_exp", "so3_left_jacobian",
                                "so3_left_jacobian_inv", "so3_hat"])
def test_so3_maps_match_jax(fn):
    w = _tangents(0)
    ref = np.asarray(getattr(jlie, fn)(jnp.asarray(w)))
    got = getattr(tlie, fn)(_t(w)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)


def test_so3_log_matches_jax():
    R = np.asarray(jlie.so3_exp(jnp.asarray(_tangents(1))))
    np.testing.assert_allclose(tlie.so3_log(_t(R)).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R))),
                               atol=ATOL, rtol=0)


def test_se3_ops_match_jax():
    rng = np.random.RandomState(2)
    xi = np.concatenate([_tangents(2, 32), rng.randn(32, 3).astype(
        np.float32)], axis=1)
    T = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    np.testing.assert_allclose(tlie.se3_exp(_t(xi)).numpy(), T,
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlie.se3_inverse(_t(T)).numpy(),
                               np.asarray(jlie.se3_inverse(jnp.asarray(T))),
                               atol=ATOL, rtol=0)
    p = rng.randn(32, 3).astype(np.float32)
    np.testing.assert_allclose(
        tlie.se3_apply(_t(T), _t(p)).numpy(),
        np.asarray(jlie.se3_apply(jnp.asarray(T), jnp.asarray(p))),
        atol=ATOL, rtol=0)
    d = (0.1 * rng.randn(32, 6)).astype(np.float32)
    np.testing.assert_allclose(
        tlie.se3_retract(_t(T), _t(d)).numpy(),
        np.asarray(jlie.se3_retract(jnp.asarray(T), jnp.asarray(d))),
        atol=ATOL, rtol=0)
    small = T.copy()
    small[:, :3, :3] = np.asarray(jlie.so3_exp(jnp.asarray(
        (0.5 * rng.randn(32, 3)).astype(np.float32))))
    np.testing.assert_allclose(tlie.se3_log(_t(small)).numpy(),
                               np.asarray(jlie.se3_log(jnp.asarray(small))),
                               atol=1e-4, rtol=0)


def test_linalg3_matches_jax():
    rng = np.random.RandomState(3)
    A = rng.randn(64, 3, 3).astype(np.float32) + 2 * np.eye(3, dtype=np.float32)
    b = rng.randn(64, 3).astype(np.float32)
    np.testing.assert_allclose(tlin.det3(_t(A)).numpy(),
                               np.asarray(jlin.det3(jnp.asarray(A))),
                               atol=ATOL, rtol=1e-6)
    np.testing.assert_allclose(tlin.inv3(_t(A)).numpy(),
                               np.asarray(jlin.inv3(jnp.asarray(A))),
                               atol=1e-4, rtol=1e-5)
    np.testing.assert_allclose(
        tlin.solve3(_t(A), _t(b)).numpy(),
        np.asarray(jlin.solve3(jnp.asarray(A), jnp.asarray(b))),
        atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("model,dist", [
    (jcam.DIST_RADTAN, (0.05, -0.02, 0.001, -0.002, 0.003)),
    (jcam.DIST_EQUIDISTANT, (0.02, -0.01, 0.003, -0.001, 0.0)),
])
def test_camera_project_backproject_match_jax(model, dist):
    rng = np.random.RandomState(4)
    f = np.array([400.0, 390.0, 320.0, 240.0], np.float32)
    d = np.asarray(dist, np.float32)
    p = np.concatenate([rng.uniform(-2, 2, (200, 2)),
                        rng.uniform(2, 10, (200, 1))], 1).astype(np.float32)
    uv_j, val_j = jcam.project(jnp.asarray(p), jnp.asarray(f),
                               jnp.asarray(d), model)
    uv_t, val_t = tcam.project(_t(p), _t(f), _t(d), model)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), atol=1e-3,
                               rtol=1e-6)
    np.testing.assert_array_equal(val_t.numpy(), np.asarray(val_j))
    uv = np.asarray(uv_j)
    xn_j = np.asarray(jcam.backproject(jnp.asarray(uv), jnp.asarray(f),
                                       jnp.asarray(d), model))
    xn_t = tcam.backproject(_t(uv), _t(f), _t(d), model).numpy()
    np.testing.assert_allclose(xn_t, xn_j, atol=ATOL, rtol=0)


def test_rig_from_numpy_matches_jax_rig():
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(num_cams=3))
    trig = tcam.rig_from_numpy(jrig.fxycxy, jrig.dist, jrig.cam_T_ref,
                               jrig.body_T_cam, jrig.image_size,
                               jrig.dist_model, device="cpu")
    own = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(num_cams=3),
                                  device="cpu")
    for r in (trig, own):
        for name in ("fxycxy", "dist", "cam_T_ref", "body_T_cam"):
            np.testing.assert_array_equal(getattr(r, name).numpy(),
                                          np.asarray(getattr(jrig, name)))
        assert r.image_size == tuple(jrig.image_size)
        assert r.dist_model == jrig.dist_model


def test_triangulation_matches_jax():
    rng = np.random.RandomState(5)
    M, R = 300, 4
    X = np.concatenate([rng.uniform(-3, 3, (M, 2)), rng.uniform(2, 4, (M, 1))],
                       1).astype(np.float32)
    wTc = np.tile(np.eye(4, dtype=np.float32), (M, R, 1, 1))
    wTc[..., 0, 3] = 0.12 * np.arange(R)
    f = np.tile(np.array([400, 400, 320, 240], np.float32), (M, R, 1))
    p = X[:, None, :] - wTc[..., :3, 3]
    uv = (p[..., :2] / p[..., 2:] * f[..., :2] + f[..., 2:]).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)
    mask = rng.rand(M, R) < 0.8
    sig = (1.2 ** rng.randint(0, 3, (M, R))).astype(np.float32)
    Xj, okj = jtri.triangulate_and_refine(
        jnp.asarray(wTc), jnp.asarray(uv), jnp.asarray(f), jnp.asarray(mask),
        sigma=jnp.asarray(sig), min_z=0.5, max_z=40.0)
    Xt, okt = ttri.triangulate_and_refine(_t(wTc), _t(uv), _t(f), _t(mask),
                                          sigma=_t(sig), min_z=0.5, max_z=40.0)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    ok = np.asarray(okj)
    # the GN fixed point moves with the f32 rounding of the residuals
    # (~1e-5 px) times Z^2 / (f * baseline): ~1e-5 m at 4 m depth
    np.testing.assert_allclose(Xt.numpy()[ok], np.asarray(Xj)[ok],
                               atol=2e-5, rtol=0)


def test_kabsch_quat_matches_jax():
    rng = np.random.RandomState(6)
    # 6-point sets: on minimal 3-point sets the f32 closed form (quartic
    # root + adjugate) is itself ill-conditioned, in both packages alike
    src = rng.randn(128, 6, 3).astype(np.float32) * 3
    R = np.asarray(jlie.so3_exp(jnp.asarray(
        rng.randn(128, 3).astype(np.float32))))
    dst = (np.einsum("kij,knj->kni", R, src) + rng.randn(128, 1, 3)
           + 0.01 * rng.randn(128, 6, 3)).astype(np.float32)
    Rj, tj = jalign.kabsch_quat(jnp.asarray(src), jnp.asarray(dst))
    Rt, tt = talign.kabsch_quat(_t(src), _t(dst))
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), atol=1e-4, rtol=0)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), atol=1e-4, rtol=0)


def test_synthetic_generators_match_jax():
    np.testing.assert_array_equal(tsyn.smooth_trajectory(6, step_angle=0.03),
                                  jsyn.smooth_trajectory(6, step_angle=0.03))
    np.testing.assert_array_equal(tsyn.make_landmarks(500, seed=3),
                                  jsyn.make_landmarks(500, seed=3))


@pytest.mark.parametrize("dist", [None, (0.05, -0.02, 0.001, -0.002, 0.0)])
def test_render_blob_images_matches_jax(dist):
    spec = dict(num_cams=2, image_size=(160, 120), focal=110.0, dist=dist)
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(**spec))
    trig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(**spec),
                                   device="cpu")
    poses = jsyn.smooth_trajectory(2)
    lms = jsyn.make_landmarks(400, depth_range=(4.0, 15.0))
    np.testing.assert_allclose(tsyn.render_blob_images(trig, poses, lms),
                               jsyn.render_blob_images(jrig, poses, lms),
                               atol=1e-4, rtol=0)
