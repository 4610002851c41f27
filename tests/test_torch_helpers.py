"""Parity of the port's public geometry and profiling helpers with the JAX
package's functions of the same names, on the same numpy inputs (CPU):
geometry/lie, camera, triangulation, linalg3, alignment and
utils/profiling. One parametrised test, one case per helper.

Tolerances (absolute unless said): integer and boolean outputs, slices
and constructors exact; float32 outputs of a few products 1e-6 (rounding
order: XLA may contract a multiply-add that torch rounds twice); pixel
outputs (hundreds of px) 1e-4 px; the unrolled Cholesky solves and the
Gauss-Newton refine 1e-5 relative to the solution's size; Umeyama's SVD
1e-5. se3_interpolate is also checked at a relative rotation within 1e-3
rad of pi, where so3_log takes its diagonal branch."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from mcslam_tpu.geometry import alignment as jalign
from mcslam_tpu.geometry import camera as jcam
from mcslam_tpu.geometry import lie as jlie
from mcslam_tpu.geometry import linalg3 as jlin
from mcslam_tpu.geometry import triangulation as jtri
from mcslam_tpu.utils import profiling as jprof
from mcslam_tpu_torch.geometry import alignment as talign
from mcslam_tpu_torch.geometry import camera as tcam
from mcslam_tpu_torch.geometry import lie as tlie
from mcslam_tpu_torch.geometry import linalg3 as tlin
from mcslam_tpu_torch.geometry import triangulation as ttri
from mcslam_tpu_torch.utils import profiling as tprof


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol, rtol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=rtol)


def _rot(axis, ang):
    a = np.asarray(axis, np.float64)
    a = a / np.linalg.norm(a)
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * K + (1 - np.cos(ang)) * K @ K


def _poses(rng, n, ang=0.4):
    T = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        T[i, :3, :3] = _rot(rng.randn(3), ang * rng.rand())
        T[i, :3, 3] = rng.randn(3)
    return T.astype(np.float32)


# -- geometry/lie ------------------------------------------------------------


def case_se3_rotation_translation_identity():
    T = _poses(np.random.RandomState(0), 5)
    np.testing.assert_array_equal(tlie.se3_rotation(_t(T)).numpy(),
                                  np.asarray(jlie.se3_rotation(jnp.asarray(T))))
    np.testing.assert_array_equal(
        tlie.se3_translation(_t(T)).numpy(),
        np.asarray(jlie.se3_translation(jnp.asarray(T))))
    for batch in ((), (3,), (2, 4)):
        got = tlie.se3_identity(batch, device="cpu")
        ref = jlie.se3_identity(batch)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    got = tlie.se3_identity((2,), dtype=torch.float64, device="cpu")
    assert got.dtype == torch.float64 and got.shape == (2, 4, 4)


def case_se3_adjoint():
    T = _poses(np.random.RandomState(1), 6)
    got = tlie.se3_adjoint(_t(T))
    ref = jlie.se3_adjoint(jnp.asarray(T))
    assert got.shape == (6, 6, 6)
    _close(got, ref, 1e-6)


@pytest.mark.parametrize("ang", [0.7, np.pi - 5e-4])
def test_se3_interpolate(ang):
    """Geodesic interpolation at alpha 0, 0.3, 1 and a per-pose alpha
    tensor; ang = pi - 5e-4 puts the relative rotation within 1e-3 of
    pi (so3_log's diagonal branch)."""
    rng = np.random.RandomState(2)
    T0 = _poses(rng, 3)
    d = np.eye(4)
    d[:3, :3] = _rot([0.6, 0.8, 0.1], ang)
    d[:3, 3] = [0.5, -0.2, 0.3]
    T1 = (T0.astype(np.float64) @ d).astype(np.float32)
    w = tlie.so3_log(_t(np.linalg.inv(T0) @ T1)[:, :3, :3])
    assert torch.linalg.vector_norm(w, dim=-1).min() > (
        3.0 if ang > 3 else 0.5)
    for a in (0.0, 0.3, 1.0, np.array([0.1, 0.5, 0.9], np.float32)):
        got = tlie.se3_interpolate(_t(T0), _t(T1), a)
        ref = jlie.se3_interpolate(jnp.asarray(T0), jnp.asarray(T1), a)
        _close(got, ref, 1e-6)
    _close(tlie.se3_interpolate(_t(T0), _t(T1), 1.0), T1, 1e-4)


# -- geometry/camera ---------------------------------------------------------

_FX = np.array([[260.0, 255.0, 161.0, 119.0], [250.0, 250.0, 158.0, 121.0]],
               np.float32)
_DIST = np.array([[-0.05, 0.01, 1e-4, -2e-4, 0.0]] * 2, np.float32)
_EXT = np.stack([np.eye(4), np.eye(4)]).astype(np.float32)
_EXT[1, :3, :3] = _rot([0.1, 1.0, 0.0], 0.2)
_EXT[1, :3, 3] = [-0.2, 0.01, 0.02]


def _cam_rigs():
    kw = dict(image_size=(320, 240), dist_model=jcam.DIST_RADTAN)
    return (jcam.make_rig(_FX, _DIST, _EXT, **kw),
            tcam.make_rig(_FX, _DIST, _EXT, device="cpu", **kw))


def _pixels(rng, n):
    return np.stack([rng.uniform(0, 320, (2, n)), rng.uniform(0, 240, (2, n))],
                    -1).astype(np.float32)


def case_camera_rig_K():
    jrig, trig = _cam_rigs()
    np.testing.assert_array_equal(trig.K().numpy(), np.asarray(jrig.K()))


def case_bearing():
    jrig, trig = _cam_rigs()
    uv = _pixels(np.random.RandomState(3), 50)
    got = tcam.bearing(_t(uv), trig.fxycxy[:, None], trig.dist[:, None],
                       trig.dist_model)
    ref = jcam.bearing(jnp.asarray(uv), jrig.fxycxy[:, None],
                       jrig.dist[:, None], jrig.dist_model)
    _close(got, ref, 1e-6)


def case_project_rig():
    jrig, trig = _cam_rigs()
    rng = np.random.RandomState(4)
    p = np.concatenate([rng.uniform(-3, 3, (60, 2)), rng.uniform(-2, 9, (60, 1))],
                       -1).astype(np.float32)
    uv, valid = tcam.project_rig(_t(p), trig)
    uv_r, valid_r = jcam.project_rig(jnp.asarray(p), jrig)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_r))
    assert 0 < valid.sum() < valid.numel()
    v = np.asarray(valid_r)
    _close(uv.numpy()[v], np.asarray(uv_r)[v], 1e-4)


def case_rig_bearings():
    jrig, trig = _cam_rigs()
    uv = _pixels(np.random.RandomState(5), 40)
    _close(tcam.rig_bearings(_t(uv), trig),
           jcam.rig_bearings(jnp.asarray(uv), jrig), 1e-6)


# -- geometry/triangulation --------------------------------------------------


def _views(seed, M=40, R=4):
    """M points seen by R cameras around them: world_T_cam (M, R, 4, 4),
    uv (M, R, 2) with 0.5 px noise, fxycxy, mask (ray 3 of every other
    point off), the true points and the ray origins / unit directions."""
    rng = np.random.RandomState(seed)
    X = rng.uniform(-1, 1, (M, 3)) + [0, 0, 6.0]
    Twc = np.tile(np.eye(4), (M, R, 1, 1))
    for r in range(R):
        Twc[:, r, :3, :3] = _rot([0, 1, 0], 0.05 * (r - 1.5))
        Twc[:, r, :3, 3] = [0.3 * (r - 1.5), 0.05 * r, 0]
    f = np.array([300.0, 300.0, 160.0, 120.0])
    Tcw = np.linalg.inv(Twc)
    pc = np.einsum("mrij,mj->mri", Tcw[..., :3, :3], X) + Tcw[..., :3, 3]
    uv = pc[..., :2] / pc[..., 2:] * f[:2] + f[2:] + rng.randn(M, R, 2) * 0.5
    mask = np.ones((M, R), bool)
    mask[::2, 3] = False
    d = np.einsum("mrij,mrj->mri", Twc[..., :3, :3],
                  np.concatenate([(uv - f[2:]) / f[:2], np.ones((M, R, 1))], -1))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    f32 = np.float32
    return dict(Twc=Twc.astype(f32), uv=uv.astype(f32), mask=mask,
                fx=np.broadcast_to(f, (M, R, 4)).astype(f32), X=X.astype(f32),
                o=Twc[..., :3, 3].astype(f32), d=d.astype(f32))


def case_triangulate_rays():
    v = _views(6)
    mask = v["mask"].copy()
    mask[5, 1:] = False  # one ray: not ok
    X, ok = ttri.triangulate_rays(_t(v["o"]), _t(v["d"]), _t(mask))
    Xr, okr = jtri.triangulate_rays(jnp.asarray(v["o"]), jnp.asarray(v["d"]),
                                    jnp.asarray(mask))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(okr))
    assert not ok[5] and ok.sum() == len(ok) - 1
    _close(X[ok], np.asarray(Xr)[np.asarray(okr)], 1e-4)


def case_reprojection_residuals():
    v = _views(7)
    got = ttri.reprojection_residuals(_t(v["X"]), _t(v["Twc"]), _t(v["uv"]),
                                      _t(v["fx"]))
    ref = jtri.reprojection_residuals(jnp.asarray(v["X"]),
                                      jnp.asarray(v["Twc"]),
                                      jnp.asarray(v["uv"]), jnp.asarray(v["fx"]))
    _close(got, ref, 1e-4)


def case_refine_points_gn():
    v = _views(8)
    X0 = v["X"] + np.random.RandomState(9).randn(*v["X"].shape).astype(
        np.float32) * 0.05
    args = [v["Twc"], v["uv"], v["fx"], v["mask"]]
    got = ttri.refine_points_gn(_t(X0), *map(_t, args))
    ref = jtri.refine_points_gn(jnp.asarray(X0), *map(jnp.asarray, args))
    _close(got, ref, 1e-5 * 7.0)

    def rms(X):  # reprojection error over the valid rays
        r = ttri.reprojection_residuals(X, _t(v["Twc"]), _t(v["uv"]),
                                        _t(v["fx"]))
        return float(r[_t(v["mask"])].square().mean().sqrt())
    assert rms(got) < 0.5 * rms(_t(X0))


def case_chi2_gate():
    v = _views(10)
    uv = v["uv"].copy()
    uv[::3, 0] += 40.0  # gross outliers on ray 0
    sigma = np.full(v["mask"].shape, 1.2, np.float32)
    args = [v["Twc"], uv, v["fx"], v["mask"], sigma]
    got = ttri.chi2_gate(_t(v["X"]), *map(_t, args))
    ref = jtri.chi2_gate(jnp.asarray(v["X"]), *map(jnp.asarray, args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < got.sum() < got.numel()


def case_parallax_cosine():
    v = _views(11)
    got = ttri.parallax_cosine(_t(v["X"]), _t(v["o"]), _t(v["mask"]))
    ref = jtri.parallax_cosine(jnp.asarray(v["X"]), jnp.asarray(v["o"]),
                               jnp.asarray(v["mask"]))
    _close(got, ref, 1e-6)
    assert (got < 1.0).all()


# -- geometry/linalg3, alignment ---------------------------------------------


def _spd(rng, batch, n):
    A = rng.randn(*batch, n, n)
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)


def case_chol_solve_nn():
    rng = np.random.RandomState(12)
    for n in (3, 5, 8):
        H, g = _spd(rng, (7,), n), rng.randn(7, n).astype(np.float32)
        got = tlin.chol_solve_nn(_t(H), _t(g), n)
        ref = jlin.chol_solve_nn(jnp.asarray(H), jnp.asarray(g), n)
        _close(got, ref, 1e-5 * np.abs(np.asarray(ref)).max())
        _close(got, np.linalg.solve(H.astype(np.float64), g[..., None])[..., 0],
               1e-4 * np.abs(np.asarray(ref)).max())


def case_chol_solve6():
    rng = np.random.RandomState(13)
    H, g = _spd(rng, (2, 5), 6), rng.randn(2, 5, 6).astype(np.float32)
    got = tlin.chol_solve6(_t(H), _t(g))
    ref = jlin.chol_solve6(jnp.asarray(H), jnp.asarray(g))
    _close(got, ref, 1e-5 * np.abs(np.asarray(ref)).max())


def case_umeyama():
    rng = np.random.RandomState(14)
    src = rng.randn(4, 30, 3).astype(np.float32)
    R = np.stack([_rot(rng.randn(3), 1.0) for _ in range(4)])
    dst = (2.5 * np.einsum("bij,bmj->bmi", R, src) + [1.0, -2.0, 0.5]
           + rng.randn(4, 30, 3) * 0.01).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (4, 30)).astype(np.float32)
    for weights in (None, w):
        got = talign.umeyama(_t(src), _t(dst),
                             None if weights is None else _t(weights))
        ref = jalign.umeyama(jnp.asarray(src), jnp.asarray(dst),
                             None if weights is None else jnp.asarray(weights))
        for a, b in zip(got, ref):
            _close(a, b, 1e-5 * max(1.0, np.abs(np.asarray(b)).max()))
        _close(got[2], np.full(4, 2.5), 1e-2)


# -- utils/profiling ---------------------------------------------------------


def case_sync():
    """A fence on CPU tensors and containers of them returns None, as the
    JAX one does on host arrays."""
    x = np.arange(6, dtype=np.float32)
    assert jprof.sync({"a": [jnp.asarray(x)]}) is None
    assert tprof.sync({"a": [_t(x)]}) is None
    assert tprof.sync((None, [torch.ones(2)])) is None
    assert tprof.sync([]) is None


def case_device_trace(tmp_path):
    """Both write a trace into logdir; the port's Chrome trace names the
    ops run inside the block."""
    x = np.random.RandomState(15).randn(64, 64).astype(np.float32)
    with jprof.device_trace(str(tmp_path / "jax")):
        jax.block_until_ready(jnp.asarray(x) @ jnp.asarray(x))
    assert any(p.is_file() and p.stat().st_size > 0
               for p in (tmp_path / "jax").rglob("*"))
    with tprof.device_trace(str(tmp_path / "torch")):
        torch.mm(_t(x), _t(x))
    trace = (tmp_path / "torch" / "trace.json").read_text()
    assert "aten::mm" in trace


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name, tmp_path):
    fn = CASES[name]
    if fn.__code__.co_argcount:
        fn(tmp_path)
    else:
        fn()
