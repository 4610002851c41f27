"""The port's vision-only bootstraps (frontend/seventeen.py, the essential
RANSAC of frontend/ransac.py, build_frame_from_keypoints, the feature-level
scene generators and the driver's mono / 17-point initialization) against
the JAX package on the CPU, on the same numpy inputs.

Tolerances:
- plucker_rays, is_noncentral, rig_lever, the feature-level frames and
  the descriptor matches: exact (rays to 1 ulp of their unit length,
  1e-7). build_frame_from_keypoints: integer and bool fields exact, float
  fields within 4e-6 relative (undistorted pixels round ~1 ulp apart), the
  rig-triangulated points within 1e-3 relative (depths of 6-30 m over
  0.3 m baselines amplify those ulps ~100x).
- Far pair triangulation at 30-50 m over 1-3 m baselines: ok equal, X
  within 1e-4 + 1e-4 |X| (f32 refines of a depth conditioned ~15x worse
  than at _triangulate_pairs' 9 m; at 150 m both packages land ~10 m
  from the truth and ~2 m apart, so the test stays nearer).
- _decompose_E of the same essential (the true one and JAX's 8-point
  ones): the chosen pose atol 1e-4 (the SVD's signs may differ; the
  decomposition is sign-invariant). _eight_point on nine noise-free
  samples: each essential no farther from the true one than twice JAX's
  distance or 0.02 (max-abs, up to sign). Both packages' f32 inverse
  iteration on the shifted normal matrix (condition ~1e7) leaves 1e-3 to
  1e-1 of error in a minimal sample's essential, and the two errors differ
  (ROADMAP, minimal-sample conditioning).
- ransac_essential and ransac_seventeen, the same sample indices handed to
  both packages, on the close (5-15 m) and distant (40-80 m) scenes of
  tests/test_seventeen.py: inlier sets equal away from the threshold
  (errors within 2 % of it on either side excluded), rotations within
  0.05 deg of JAX's and 0.6 deg of the truth; the essential's unit
  translation within 1 deg of JAX's; the 17-point translation to
  tests/test_seventeen.py's own bounds against the truth (the MSAC valley
  in |t| and its direction is flat). The
  essential's pool is drawn with seed 4: on the distant scene one camera's
  0.58 m baseline over 40-80 m makes an 8-point sample so ill-conditioned
  that ~half of the 512 hypotheses score differently in the two
  packages' f32, and for 4 of the seeds 3-9 the winner differs.
- _geo_lm's Jacobian (torch.func.jacfwd in float64) against jax.jacfwd's:
  atol 1e-3 of its largest entry.
- Three driver sessions on both packages, with the gates of the JAX tests:
  (i) a 4-camera scene fed 3 blank frames, then textured ones, through
  process_image: both stay NOT_INITIALIZED with no exception, initialize
  on the same frame and end INITIALIZED with no failure; (ii) the mono
  session of tests/test_slam_mono.py; (iii) the distant-scene 17-point
  session of tests/test_seventeen.py, init_17pt >= 1. The RANSAC streams
  differ between the packages (jax.random against torch.Generator), so
  sessions (ii) and (iii) hold each package to the gates, not to the
  other's trajectory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcslam_tpu import tracking_kernels as jtk
from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.frontend import frame as jframe
from mcslam_tpu.frontend import ransac as jransac
from mcslam_tpu.frontend import seventeen as jseventeen
from mcslam_tpu.slam import INITIALIZED as J_INIT
from mcslam_tpu.slam import NOT_INITIALIZED as J_NOT
from mcslam_tpu.slam import MultiCameraSLAM as JSLAM
from mcslam_tpu.slam import SlamConfig as JConfig
from mcslam_tpu.utils import metrics as jmetrics
from mcslam_tpu_torch import slam as tslam
from mcslam_tpu_torch import tracking_kernels as ttk
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.frontend import ransac as transac
from mcslam_tpu_torch.frontend import seventeen as tseventeen
from mcslam_tpu_torch.geometry import camera as tcam
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.utils import metrics as tmetrics

ROT_DEG = 0.05  # rotation of the port's RANSAC winner against JAX's
T_DIR_DEG = 1.0  # the essential winner's unit translation against JAX's
EDGE = 0.02  # relative band around a threshold left out of inlier checks
# undistortion (the port's camera model) rounds ~1 ulp apart from JAX's
FRAME_RTOL = 4e-6
E_TOL = 0.02  # see the module docstring
POINT_RTOL = 1e-3  # rig depth at 6-30 m over 0.3 m baselines amplifies it


def _rigs(num_cams=4, baseline=0.3, image_size=(320, 240), focal=260.0):
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=num_cams, baseline=baseline, image_size=image_size,
        focal=focal))
    trig = tcam.rig_from_numpy(jrig.fxycxy, jrig.dist, jrig.cam_T_ref,
                               jrig.body_T_cam, jrig.image_size,
                               jrig.dist_model, device="cpu")
    return jrig, trig


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot_deg(Ra, Rb):
    dR = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))))


def _scene_rays(jrig, depth, noise=0.3, outfrac=0.15, seed=1, Np=260):
    """tests/test_seventeen.py's two-frame scene: (uv1, uv2, cams, T2)
    with the outliers' second observations scrambled."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-depth[1] * 0.5, depth[1] * 0.5, Np),
                  rng.uniform(-depth[1] * 0.3, depth[1] * 0.3, Np),
                  rng.uniform(depth[0], depth[1], Np)], axis=1)
    ang = 0.05
    T2 = np.eye(4)
    T2[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                  [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
    T2[:3, 3] = [0.5, 0.1, 0.3]
    cams = (np.arange(Np) % jrig.num_cams).astype(np.int32)
    cam_T_ref = np.asarray(jrig.cam_T_ref, np.float64)[cams]
    fxy = np.asarray(jrig.fxycxy, np.float64)[cams]
    uvs = []
    for T in (np.eye(4), T2):
        rTw = np.linalg.inv(T)
        pr = X @ rTw[:3, :3].T + rTw[:3, 3]
        pc = np.einsum("mij,mj->mi", cam_T_ref[:, :3, :3], pr) \
            + cam_T_ref[:, :3, 3]
        uv = pc[:, :2] / pc[:, 2:3] * fxy[:, :2] + fxy[:, 2:]
        uvs.append((uv + rng.normal(0, noise, uv.shape)).astype(np.float32))
    out = rng.random(Np) < outfrac
    uvs[1][out] = uvs[1][rng.permutation(np.nonzero(out)[0])]
    return uvs[0], uvs[1], cams, T2


def _midpoint_err(R, t, f1, o1, f2, o2):
    """numpy (1 - cos) + (1 - cos) of both rays to their midpoint, and
    whether both midpoint depths are positive (float64)."""
    f2w, o2w = f2 @ R.T, o2 @ R.T + t
    b = o2w - o1
    dd = np.sum(f1 * f2w, -1)
    den = np.maximum(1 - dd * dd, 1e-9)
    bd0, bd1 = np.sum(b * f1, -1), np.sum(b * f2w, -1)
    s, u = (bd0 - dd * bd1) / den, (dd * bd0 - bd1) / den
    X = 0.5 * (o1 + s[:, None] * f1 + o2w + u[:, None] * f2w)
    v1, v2 = X - o1, X - o2w
    c1 = np.sum(v1 * f1, -1) / np.sqrt(np.sum(v1 * v1, -1) + 1e-12)
    c2 = np.sum(v2 * f2w, -1) / np.sqrt(np.sum(v2 * v2, -1) + 1e-12)
    return (1 - c1) + (1 - c2), (s > 0) & (u > 0)


@pytest.fixture(scope="module")
def rigs():
    return _rigs()


def test_plucker_rays_and_lever_match_jax(rigs):
    jrig, trig = rigs
    rng = np.random.RandomState(0)
    uv = (rng.rand(300, 2) * [320, 240]).astype(np.float32)
    cams = rng.randint(0, 4, 300).astype(np.int32)
    jf, jo = jseventeen.plucker_rays(jnp.asarray(uv), jnp.asarray(cams), jrig)
    tf, to = tseventeen.plucker_rays(_t(uv), _t(cams), trig)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-7, rtol=0)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    assert tseventeen.is_noncentral(trig) is jseventeen.is_noncentral(jrig)
    assert tseventeen.rig_lever(trig) == pytest.approx(
        jseventeen.rig_lever(jrig), abs=1e-7)
    jmono, tmono = _rigs(num_cams=1)
    assert not tseventeen.is_noncentral(tmono)
    assert not jseventeen.is_noncentral(jmono)


def test_feature_frames_and_frame_from_keypoints_match_jax():
    jrig, trig = _rigs()
    poses = jsyn.smooth_trajectory(2, radius=5.0, step_angle=0.02)
    lms = jsyn.make_landmarks(700, seed=5, depth_range=(6.0, 30.0))
    desc = tsyn.make_descriptors(700, seed=6)
    np.testing.assert_array_equal(desc, jsyn.make_descriptors(700, seed=6))
    jf = jsyn.render_feature_frames(jrig, poses, lms, desc, kps_per_cam=320,
                                    px_noise=0.3, desc_bit_noise=4, seed=7)
    tf = tsyn.render_feature_frames(trig, poses, lms, desc, kps_per_cam=320,
                                    px_noise=0.3, desc_bit_noise=4, seed=7)
    for a, b in zip(jf, tf):
        for name in ("uv", "desc", "lm_id", "valid", "world_T_ref"):
            np.testing.assert_array_equal(getattr(b, name), getattr(a, name))
        assert a.timestamp == b.timestamp
    f = tf[0]
    jff = jframe.build_frame_from_keypoints(
        jnp.asarray(f.uv), jnp.asarray(f.desc), jnp.asarray(f.valid), jrig,
        max_intra=1024, max_z=60.0)
    tff = tframe.build_frame_from_keypoints(
        _t(f.uv), hamming.desc_to_torch(f.desc, "cpu"), _t(f.valid), trig,
        max_intra=1024, max_z=60.0)
    assert int(tff.im_has_depth.sum()) > 30  # the depth path has work
    for name in tframe.FrameFeatures._fields:
        a, b = np.asarray(getattr(jff, name)), getattr(tff, name)
        b = (hamming.desc_to_numpy_u32(b) if name in ("kp_desc", "im_desc")
             else b.numpy())
        if name == "im_point3d":  # defined where there is depth
            dep = np.asarray(jff.im_has_depth)
            a, b = a[dep], b[dep]
        if a.dtype.kind == "f":
            rtol = POINT_RTOL if name == "im_point3d" else FRAME_RTOL
            np.testing.assert_allclose(b, a, rtol=rtol, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)

    # the bootstraps' matching and far triangulation on these frames
    jg = jframe.build_frame_from_keypoints(
        jnp.asarray(tf[1].uv), jnp.asarray(tf[1].desc),
        jnp.asarray(tf[1].valid), jrig, max_intra=1024, max_z=60.0)
    tg = tframe.build_frame_from_keypoints(
        _t(tf[1].uv), hamming.desc_to_torch(tf[1].desc, "cpu"),
        _t(tf[1].valid), trig, max_intra=1024, max_z=60.0)
    jd = jtk._match_descriptors(jg.im_desc, jg.im_valid, jff.im_desc,
                                jff.im_valid)
    td = ttk._match_descriptors(tg.im_desc, tg.im_valid, tff.im_desc,
                                tff.im_valid)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jm = jtk._mutual_match(jd, jg.im_valid, jff.im_valid, 64, 0.85)
    tm = ttk._mutual_match(td, tg.im_valid, tff.im_valid, 64, 0.85)
    ok = tm.ok.numpy()
    np.testing.assert_array_equal(ok, np.asarray(jm.ok))
    np.testing.assert_array_equal(tm.idx.numpy()[ok], np.asarray(jm.idx)[ok])
    assert ok.sum() > 100


def test_triangulate_pairs_far_matches_jax():
    rng = np.random.RandomState(4)
    M = 300
    X = (rng.uniform(-10, 10, (M, 3)) + [0, 0, 40]).astype(np.float64)
    wTc = np.tile(np.eye(4), (M, 2, 1, 1))
    wTc[:, 1, 0, 3] = rng.uniform(1.0, 3.0, M)
    f = np.tile([260.0, 260.0, 160.0, 120.0], (M, 2, 1))
    uv = np.zeros((M, 2, 2))
    for v in range(2):
        p = X - wTc[:, v, :3, 3]
        uv[:, v] = p[:, :2] / p[:, 2:] * 260.0 + [160.0, 120.0]
    uv += rng.randn(M, 2, 2) * 0.2
    X[-10:, 2] = 900.0  # beyond the ceiling
    mask = rng.rand(M, 2) > 0.05
    args = [a.astype(np.float32) if a.dtype != bool else a
            for a in (wTc, uv, f, mask, np.ones((M, 2)))]
    jX, jok = jtk._triangulate_pairs_far(*(jnp.asarray(a) for a in args),
                                         0.5, 400.0)
    tX, tok = ttk._triangulate_pairs_far(*(_t(a) for a in args), 0.5, 400.0)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = np.asarray(jok)
    assert 0 < ok.sum() < M
    np.testing.assert_allclose(tX.numpy()[ok], np.asarray(jX)[ok], atol=1e-4,
                               rtol=1e-4)


def _essential_scene(depth, seed=1, Np=260, noise=0.3, outfrac=0.15):
    """Camera 0's normalized coordinates of the close / distant scene."""
    jrig, _ = _rigs(num_cams=1)
    uv0, uv1, _, T2 = _scene_rays(jrig, depth, noise=noise, outfrac=outfrac,
                                  seed=seed, Np=Np)
    f = np.asarray(jrig.fxycxy)[0]
    return ((uv0 - f[2:]) / f[:2], (uv1 - f[2:]) / f[:2], T2)


def _skew(t):
    return np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])


def _e_dist(a, b):
    """Max-abs distance of two essentials, up to their sign."""
    return min(np.abs(a - b).max(), np.abs(a + b).max())


def test_eight_point_and_decompose_match_jax():
    xn0, xn1, T2 = _essential_scene((5.0, 15.0), noise=0.0, outfrac=0.0)
    true = np.linalg.inv(T2)  # cam1_T_cam0
    E_true = _skew(true[:3, 3]) @ true[:3, :3]
    E_true *= np.sqrt(2) / np.linalg.norm(E_true)  # singular values (1, 1)
    rng = np.random.RandomState(0)
    idx = np.concatenate([rng.choice(260, 8, replace=False)[None],
                          np.arange(8)[None] + np.arange(0, 64, 8)[:, None]])
    jE = np.asarray(jransac._eight_point(jnp.asarray(xn0[idx]),
                                         jnp.asarray(xn1[idx])))
    tE = transac._eight_point(_t(xn0[idx]), _t(xn1[idx])).numpy()
    for k in range(len(idx)):
        assert (_e_dist(tE[k], E_true)
                <= max(2 * _e_dist(jE[k], E_true), E_TOL)), k
    mask = jnp.ones(260, bool)
    for E in (E_true.astype(np.float32), *jE):
        jT = jransac._decompose_E(jnp.asarray(E), jnp.asarray(xn0),
                                  jnp.asarray(xn1), mask)
        tT = transac._decompose_E(_t(E), _t(xn0), _t(xn1),
                                  torch.ones(260, dtype=torch.bool))
        np.testing.assert_allclose(tT.numpy(), np.asarray(jT), atol=1e-4,
                                   rtol=0)


def _sampson(E, xn0, xn1):
    h0 = np.concatenate([xn0, np.ones((len(xn0), 1))], 1)
    h1 = np.concatenate([xn1, np.ones((len(xn1), 1))], 1)
    Ex0, Eth1 = h0 @ E.T, h1 @ E
    num = np.sum(h1 * Ex0, 1) ** 2
    return num / np.maximum(Ex0[:, 0] ** 2 + Ex0[:, 1] ** 2 + Eth1[:, 0] ** 2
                            + Eth1[:, 1] ** 2, 1e-12)


@pytest.mark.parametrize("depth", [(5.0, 15.0), (40.0, 80.0)],
                         ids=["close", "distant"])
def test_ransac_essential_matches_jax(depth, monkeypatch):
    xn0, xn1, T2 = _essential_scene(depth)
    M = len(xn0)
    # seed 4: a pool whose winner is the same in both packages on both
    # scenes (see the module docstring)
    idx = np.random.RandomState(4).randint(0, M, (512, 8)).astype(np.int32)
    monkeypatch.setattr(jransac, "_sample_idx",
                        lambda *a, **k: jnp.asarray(idx))
    jfn = jax.jit(jransac.ransac_essential.__wrapped__,
                  static_argnames=("num_hyp",))
    thr = 2.0 / 260.0
    mask = np.ones(M, bool)
    jr = jfn(jax.random.PRNGKey(0), jnp.asarray(xn0), jnp.asarray(xn1),
             jnp.asarray(mask), thresh_n=thr, min_inliers=30)
    tr = transac.ransac_essential(None, _t(xn0), _t(xn1), _t(mask),
                                  thresh_n=thr, min_inliers=30,
                                  idx=_t(idx).long())
    assert bool(jr.ok) and bool(tr.ok)
    d2 = [_sampson(np.asarray(E, np.float64), xn0, xn1)
          for E in (np.asarray(jr.E), tr.E.numpy())]
    far = np.all([np.abs(d - thr ** 2) > EDGE * thr ** 2 for d in d2], 0)
    np.testing.assert_array_equal(tr.inliers.numpy()[far],
                                  np.asarray(jr.inliers)[far])
    jT, tT = np.asarray(jr.rel_T), tr.rel_T.numpy()
    assert _rot_deg(jT[:3, :3], tT[:3, :3]) < ROT_DEG
    # the unit translations (the same winner, so nearly the same E)
    cos = np.dot(tT[:3, 3], jT[:3, 3])
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < T_DIR_DEG
    # cam1_T_cam0's rotation against the truth inv(T2), to
    # tests/test_seventeen.py's bound
    assert _rot_deg(tT[:3, :3], np.linalg.inv(T2)[:3, :3]) < 0.6


@pytest.mark.parametrize("depth", [(5.0, 15.0), (40.0, 80.0)],
                         ids=["close", "distant"])
def test_ransac_seventeen_matches_jax(rigs, depth, monkeypatch):
    jrig, trig = rigs
    uv1, uv2, cams, T2 = _scene_rays(jrig, depth)
    M = len(uv1)
    rays = [jseventeen.plucker_rays(jnp.asarray(u), jnp.asarray(cams), jrig)
            for u in (uv1, uv2)]
    f1, o1, f2, o2 = (np.asarray(a) for r in rays for a in r)
    idx = np.random.RandomState(5).randint(0, M, (96, 20)).astype(np.int32)
    monkeypatch.setattr(jransac, "_sample_idx",
                        lambda *a, **k: jnp.asarray(idx))
    jfn = jax.jit(jseventeen.ransac_seventeen.__wrapped__, static_argnames=(
        "num_hyp", "sample_size", "num_scales", "refine_iters"))
    thr = float(2 * (1 - np.cos((0.3 * 3 + 1) / 260.0)))
    mask = np.ones(M, bool)
    jr = jfn(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in
                                      (f1, o1, f2, o2, mask)),
             angle_thresh=thr, scale_hi=3.0)
    tr = tseventeen.ransac_seventeen(None, *(_t(a) for a in
                                             (f1, o1, f2, o2, mask)),
                                     angle_thresh=thr, scale_hi=3.0,
                                     idx=_t(idx).long())
    assert bool(jr.ok) and bool(tr.ok)
    jT, tT = np.asarray(jr.rel_T, np.float64), tr.rel_T.numpy().astype(
        np.float64)
    errs = [_midpoint_err(T[:3, :3], T[:3, 3], *(a.astype(np.float64) for a in
                                                  (f1, o1, f2, o2)))
            for T in (jT, tT)]
    far = np.all([np.abs(e - thr) > EDGE * thr for e, _ in errs], 0)
    np.testing.assert_array_equal(tr.inliers.numpy()[far],
                                  np.asarray(jr.inliers)[far])
    assert _rot_deg(jT[:3, :3], tT[:3, :3]) < ROT_DEG
    # tests/test_seventeen.py's bounds against the truth
    tt, tn = np.linalg.norm(T2[:3, 3]), np.linalg.norm(tT[:3, 3])
    assert _rot_deg(tT[:3, :3], T2[:3, :3]) < 0.6
    cos = np.dot(tT[:3, 3], T2[:3, 3]) / max(tn * tt, 1e-9)
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 45.0
    assert 0.2 * tt < tn < 5.0 * tt


def test_geo_lm_jacobian_matches_jax():
    """The polish's Jacobian (jacfwd in float64) against jax.jacfwd."""
    jrig, trig = _rigs()
    uv1, uv2, cams, T2 = _scene_rays(jrig, (5.0, 15.0), outfrac=0.0)
    rays = [jseventeen.plucker_rays(jnp.asarray(u), jnp.asarray(cams), jrig)
            for u in (uv1, uv2)]
    f1, o1, f2, o2 = (np.asarray(a) for r in rays for a in r)
    R = T2[:3, :3].astype(np.float32)
    t = (T2[:3, 3] * 1.1).astype(np.float32)
    w = np.ones(len(f1), np.float32)
    d = np.zeros(6, np.float32)
    jJ = np.asarray(jax.jacfwd(jseventeen._geo_residuals)(
        *(jnp.asarray(a) for a in (d, R, t, f1, o1, f2, o2, w))))
    tJ = torch.func.jacfwd(tseventeen._geo_residuals)(
        *(_t(a).double() for a in (d, R, t, f1, o1, f2, o2, w))).numpy()
    np.testing.assert_allclose(tJ, jJ, atol=1e-3 * np.abs(jJ).max(), rtol=0)
    jR, jt = jseventeen._geo_lm(*(jnp.asarray(a) for a in
                                  (R, t, f1, o1, f2, o2, w)), iters=4)
    tR, tt = tseventeen._geo_lm(*(_t(a) for a in (R, t, f1, o1, f2, o2, w)),
                                iters=4)
    assert _rot_deg(np.asarray(jR), tR.numpy()) < ROT_DEG
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=2e-3)


# -- driver sessions ----------------------------------------------------------

SESSION_CFG = dict(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                   local_map_landmarks=1024, kf_translation=0.2,
                   kf_rotation=0.1, min_inter_matches=40)


def test_blank_frames_then_texture_initialize_on_both():
    """The repaired fault: frames with too little rig depth (blank images)
    keep the session NOT_INITIALIZED, with a pending 17-point anchor and no
    exception, and the first textured frame initializes from rig depth in
    both packages."""
    jrig, trig = _rigs(baseline=0.2)
    poses = jsyn.smooth_trajectory(3, radius=5.0, step_angle=0.03, seed=0)
    lms = jsyn.make_landmarks(700, seed=1, depth_range=(4.0, 12.0))
    imgs = jsyn.render_blob_images(jrig, poses, lms, seed=2)
    frames = [np.zeros_like(imgs[0])] * 3 + list(imgs)
    ecfg = dict(num_points=512, num_levels=1, max_intra=768)
    js = JSLAM(jrig, JConfig(**SESSION_CFG))
    ts = tslam.MultiCameraSLAM(trig, tslam.SlamConfig(**SESSION_CFG))
    init = {}
    for name, s, conv in (("jax", js, jnp.asarray), ("port", ts, _t)):
        for k, im in enumerate(frames):
            info = s.process_image(conv(im), k / 20.0, extract_cfg=ecfg)
            if k < 3:
                assert s.state == J_NOT == tslam.NOT_INITIALIZED
                assert getattr(s, "_pending17", None) is not None
            if info.get("initialized") and name not in init:
                init[name] = k
        assert s.state == J_INIT == tslam.INITIALIZED
        assert s.stats["failures"] == 0
        assert "init_17pt" not in s.stats
    assert init["jax"] == init["port"] == 3
    _, est = ts.trajectory_arrays()
    assert tmetrics.ate_rmse(est[3:], poses) < 0.1


def _feature_session(slam_mod, cfg_cls, rig, frames, make_frame, cfg):
    slam = slam_mod(rig, cfg_cls(**cfg))
    for f in frames:
        slam.process_frame(make_frame(f), f.timestamp)
    return slam


def _jax_ff(jrig, **kw):
    return lambda f: jframe.build_frame_from_keypoints(
        jnp.asarray(f.uv), jnp.asarray(f.desc), jnp.asarray(f.valid), jrig,
        **kw)


def _port_ff(trig, **kw):
    return lambda f: tframe.build_frame_from_keypoints(
        _t(f.uv), hamming.desc_to_torch(f.desc, "cpu"), _t(f.valid), trig,
        **kw)


def test_mono_session_matches_jax_gates():
    """tests/test_slam_mono.py's session on both packages."""
    jrig, trig = _rigs(num_cams=1, baseline=0.12, image_size=(640, 480),
                       focal=400.0)
    poses = jsyn.smooth_trajectory(14, radius=5.0, step_angle=0.04, seed=0)
    lms = jsyn.make_landmarks(800, seed=1, depth_range=(5.0, 14.0))
    descs = jsyn.make_descriptors(800, seed=2)
    frames = jsyn.render_feature_frames(jrig, poses, lms, descs,
                                        kps_per_cam=400, px_noise=0.3,
                                        desc_bit_noise=4, seed=3)
    cfg = dict(SESSION_CFG, ba_obs_capacity=4096, kf_translation=0.15)
    for slam_cls, cfg_cls, ff, metrics in (
            (JSLAM, JConfig, _jax_ff(jrig, max_intra=512), jmetrics),
            (tslam.MultiCameraSLAM, tslam.SlamConfig,
             _port_ff(trig, max_intra=512), tmetrics)):
        rig = jrig if slam_cls is JSLAM else trig
        slam = _feature_session(slam_cls, cfg_cls, rig, frames, ff, cfg)
        assert slam.state == J_INIT
        assert slam.stats["keyframes"] >= 3
        assert slam.map.num_valid > 100
        _, est = slam.trajectory_arrays()
        ate = metrics.ate_rmse(est[2:], poses[2:], with_scale=True)
        assert ate < 0.1, (slam_cls, ate)
        assert np.linalg.norm(est[-1][:3, 3] - est[2][:3, 3]) > 0.1


def test_seventeen_session_matches_jax_gates():
    """tests/test_seventeen.py's distant-scene rig bootstrap on both."""
    jrig, trig = _rigs()
    poses = jsyn.smooth_trajectory(8, radius=5.0, step_angle=0.02)
    lms = jsyn.make_landmarks(700, seed=5, depth_range=(150.0, 300.0),
                              spread=(120.0, 60.0))
    descs = jsyn.make_descriptors(700, seed=6)
    frames = jsyn.render_feature_frames(jrig, poses, lms, descs,
                                        kps_per_cam=320, px_noise=0.3,
                                        desc_bit_noise=4, seed=7)
    cfg = dict(SESSION_CFG, max_z=60.0)
    kw = dict(max_intra=1024, max_z=60.0)
    length_gt = sum(np.linalg.norm(poses[i + 1][:3, 3] - poses[i][:3, 3])
                    for i in range(len(poses) - 1))
    for slam_cls, cfg_cls, ff, metrics, rig in (
            (JSLAM, JConfig, _jax_ff(jrig, **kw), jmetrics, jrig),
            (tslam.MultiCameraSLAM, tslam.SlamConfig, _port_ff(trig, **kw),
             tmetrics, trig)):
        slam = _feature_session(slam_cls, cfg_cls, rig, frames, ff, cfg)
        assert slam.state == J_INIT
        assert slam.stats.get("init_17pt", 0) >= 1
        assert slam.stats["failures"] == 0
        _, est = slam.trajectory_arrays()
        ate_s = metrics.ate_rmse(est, poses, with_scale=True)
        assert ate_s < 0.40, (slam_cls, ate_s)
        length = sum(np.linalg.norm(est[i + 1][:3, 3] - est[i][:3, 3])
                     for i in range(len(est) - 1))
        assert 0.2 * length_gt < length < 5.0 * length_gt, (slam_cls, length)
