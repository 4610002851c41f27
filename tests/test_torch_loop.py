"""The port's loop-closure slice (data/synthetic loop scenes, loop/vocab,
loop/detector, backend/pgo, utils/mapio, driver_loop) against the JAX
package on the CPU, on the same numpy inputs.

Tolerances:
- loop-scene generators: bit for bit (the same numpy code and draws);
- vocabulary: the trained tree, word ids and node ids exact; BoW 1e-6;
  a .npz written by either package loads in the other;
- retrieval (retrieve_topn, host numpy in both): the same candidate lists
  and consistency groups over a 48-keyframe BoW sequence with revisits,
  an aliased place (several islands) and a gap that expires groups;
- _match_direct_index: idx, ok and dist exact;
- _verify (RANSAC-PnP + pose LM) and _verify_seventeen with the same
  sample indices handed to both sides: the same verdict and match
  keyframe; PnP: pose 2e-3 (the pose LM's parity bound,
  tests/test_torch_pose.py), inlier count within 2 %; 17-point: rotation
  within 0.05 deg of JAX's, both within tests/test_seventeen.py's bounds of
  the truth;
- PGO (float64 in the port, float32 in JAX): the edge Jacobians 1e-5 of
  jax.jacfwd's; the solved poses of tests/test_loop_reloc.py's and
  tests/test_pgo_sim3.py's graphs 2e-4 (rotation) and 2e-4 m, scales 1e-4;
- map I/O: exact both ways (the same json / text code);
- the loop-closing driver on twin states (the same keyframe and map
  records loaded into both drivers): _close_loop given one detection,
  _retriangulate_landmarks, _run_global_ba + _finish_pending_gba, held to
  the bounds stated at each test (the window and global solves differ in
  their float64 elimination, ROADMAP Queue 3)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcslam_tpu.backend import pgo as jpgo
from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.frontend import ransac as jransac
from mcslam_tpu.frontend import seventeen as jseventeen
from mcslam_tpu.geometry import lie as jlie
from mcslam_tpu.keyframe import Keyframe as JKeyframe
from mcslam_tpu.loop import detector as jdet
from mcslam_tpu.loop import vocab as jvocab
from mcslam_tpu.slam import INITIALIZED as J_INIT
from mcslam_tpu.slam import MultiCameraSLAM as JSLAM
from mcslam_tpu.slam import SlamConfig as JConfig
from mcslam_tpu.utils import mapio as jmapio
from mcslam_tpu_torch import slam as tslam
from mcslam_tpu_torch.backend import pgo as tpgo
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.frontend import ransac as transac
from mcslam_tpu_torch.keyframe import Keyframe as TKeyframe
from mcslam_tpu_torch.loop import detector as tdet
from mcslam_tpu_torch.loop import vocab as tvocab
from mcslam_tpu_torch.ops import hamming
from mcslam_tpu_torch.utils import mapio as tmapio

SPEC = dict(num_cams=3, baseline=0.2)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """These driver runs are many small ops: one intra-op thread runs them
    faster than a pool that the suite's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_loop_pipeline.py's scene and driver configuration
N_FRAMES, REVISIT = 60, 8
CFG = dict(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
           local_map_landmarks=2048, kf_translation=0.3, kf_rotation=0.2,
           global_ba_lm_capacity=2048, global_ba_obs_per_kf=256)
LOOP_CFG = dict(dislocal=12, k_consistency=2, min_nss=0.02, alpha=0.15,
                min_matches=15, min_inliers=10)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _rigs():
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(**SPEC))
    trig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(**SPEC),
                                   device="cpu")
    return jrig, trig


# -- the loop scenes ---------------------------------------------------------


def test_loop_scene_generators_match_jax():
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, image_size=(96, 72), focal=80.0))
    trig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, image_size=(96, 72), focal=80.0), device="cpu")
    eq = np.testing.assert_array_equal
    poses = jsyn.loop_trajectory(12, radius=4.0, revisit_frames=3, seed=2,
                                 drift=0.5)
    eq(tsyn.loop_trajectory(12, radius=4.0, revisit_frames=3, seed=2,
                            drift=0.5), poses)
    lms = jsyn.make_ring_landmarks(300, radius=9.0, seed=4)
    eq(tsyn.make_ring_landmarks(300, radius=9.0, seed=4), lms)
    for textured in (False, True):
        eq(tsyn.render_blob_images(trig, poses[:3], lms, seed=5,
                                   textured=textured),
           jsyn.render_blob_images(jrig, poses[:3], lms, seed=5,
                                   textured=textured))
    for a, b in zip(tsyn.pan_shake_imu(6, accel_noise=1e-3, seed=3),
                    jsyn.pan_shake_imu(6, accel_noise=1e-3, seed=3)):
        eq(a, b)
    kw = dict(height=64, width=256, octaves=4, num_posters=12, seed=9)
    tex = jsyn.make_procedural_texture(**kw)
    eq(tsyn.make_procedural_texture(**kw), tex)
    ftex = jsyn.make_procedural_texture(height=64, width=64, num_posters=3,
                                        seed=10)
    kw = dict(radius=6.0, tex=tex, floor_tex=ftex, return_depth=True)
    for a, b in zip(tsyn.render_textured_world(trig, poses[:2], **kw),
                    jsyn.render_textured_world(jrig, poses[:2], **kw)):
        eq(a, b)
    imgs = jsyn.render_textured_world(jrig, poses[:3], tex=tex,
                                      floor_tex=ftex)
    kw = dict(seed=2, exposure_flicker=0.3, pixel_noise=0.025,
              motion_blur_px=3, vignette=0.2)
    eq(tsyn.apply_photometric(imgs, **kw), jsyn.apply_photometric(imgs, **kw))


# -- vocabulary --------------------------------------------------------------


@pytest.fixture(scope="module")
def vocabs():
    descs = jsyn.make_descriptors(2000, seed=11)
    return (jvocab.Vocabulary.train(descs, k=6, depth=3, iters=3),
            tvocab.Vocabulary.train(descs, k=6, depth=3, iters=3))


def test_vocabulary_train_and_transform_match_jax(vocabs):
    jv, tv = vocabs
    for f in ("nodes", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(tv, f), getattr(jv, f))
    assert (tv.k, tv.depth, tv.num_words) == (jv.k, jv.depth, jv.num_words)
    rng = np.random.RandomState(12)
    descs = jsyn.corrupt_descriptors(jsyn.make_descriptors(300, seed=12), 8,
                                     rng)
    assert (descs >= 2**31).any()  # words that are negative as int32
    valid = rng.rand(300) > 0.2
    td = hamming.desc_to_torch(descs, "cpu")
    np.testing.assert_array_equal(tv.word_ids(td).numpy(),
                                  np.asarray(jv.word_ids(jnp.asarray(descs))))
    for up in (1, 2):
        np.testing.assert_array_equal(
            tv.node_ids(td, up).numpy(),
            np.asarray(jv.node_ids(jnp.asarray(descs), up)))
    np.testing.assert_allclose(
        tv.transform(td, _t(valid)).numpy(),
        np.asarray(jv.transform(jnp.asarray(descs), jnp.asarray(valid))),
        atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tvocab.popcount32(td).numpy(),
                                  tvocab._popcount_np(descs))


def test_vocabulary_npz_loads_in_both_packages(vocabs, tmp_path):
    jv, tv = vocabs
    descs = jsyn.make_descriptors(100, seed=15)
    jv.save(tmp_path / "j.npz")
    tv.save(tmp_path / "t.npz")
    tl = tvocab.Vocabulary.load(tmp_path / "j.npz")
    jl = jvocab.Vocabulary.load(tmp_path / "t.npz")
    for f in ("nodes", "children", "word_id", "weights"):
        np.testing.assert_array_equal(getattr(tl, f), getattr(jv, f))
        np.testing.assert_array_equal(getattr(jl, f), getattr(tv, f))
    np.testing.assert_array_equal(
        tl.word_ids(hamming.desc_to_torch(descs, "cpu")).numpy(),
        np.asarray(jl.word_ids(jnp.asarray(descs))))


# -- retrieval ---------------------------------------------------------------


def _bow_sequence(V, n=48, places=32, seed=3):
    """BoWs of n keyframes along a loop of `places` places (keyframe k at
    place k % places, so the tail revisits the start), neighbouring places
    overlapping (the nss gate passes), place 21 an alias of place 4 (a
    second island), and keyframes 40-43 one word each outside the places'
    words (the nss gate fails: the consistency groups age and expire)."""
    rng = np.random.RandomState(seed)
    Vp = V - 8  # the places' words; the last 8 are the gap's
    base = np.zeros((places + 1, V), np.float32)
    for p in range(places + 1):
        base[p, rng.choice(Vp, 24, replace=False)] = rng.rand(24) + 0.5
    base[21] = 0.6 * base[4] + 0.4 * base[21]
    out = []
    for k in range(n):
        p = k % places
        v = base[p] + 0.5 * base[p + 1]
        v[:Vp] += 0.15 * rng.rand(Vp) * (rng.rand(Vp) < 0.1)
        if 40 <= k <= 43:
            v = np.zeros(V, np.float32)
            v[Vp + k - 40] = 1.0
        out.append((v / np.linalg.norm(v)).astype(np.float32))
    return out


def test_retrieve_topn_matches_jax(vocabs):
    jv, tv = vocabs
    jrig, trig = _rigs()
    cfg = dict(dislocal=8, k_consistency=2, min_nss=0.05, alpha=0.3,
               group_expiry=3)
    jl = jdet.LoopCloser(jv, jrig, jdet.LoopConfig(**cfg))
    tl = tdet.LoopCloser(tv, trig, tdet.LoopConfig(**cfg))
    fired = expired = islands = 0
    for k, bow in enumerate(_bow_sequence(tv.num_words)):
        n_db = tl._n_bows
        expired += sum(n_db - last > cfg["group_expiry"]
                       for _, _, last in tl._consistent_groups)
        if tl._last_bow is not None and n_db > cfg["dislocal"]:
            scores = tl._bow_mat[:n_db - cfg["dislocal"]] @ bow
            cand = np.nonzero(scores >= cfg["alpha"] * float(
                bow @ tl._last_bow))[0]
            if len(cand) and float(bow @ tl._last_bow) >= cfg["min_nss"]:
                islands = max(islands, int(np.sum(np.diff(cand) >
                                                  tl.cfg.island_gap)) + 1)
        got, ref = tl.retrieve_topn(bow, 3), jl.retrieve_topn(bow, 3)
        assert got == ref, (k, got, ref)
        assert tl._consistent_groups == jl._consistent_groups, k
        fired += bool(got)
        tl.add_keyframe(k, bow)
        jl.add_keyframe(k, bow)
    assert fired >= 5 and expired >= 1 and islands >= 2, (fired, expired,
                                                          islands)


# -- matching and verification -----------------------------------------------


@pytest.fixture(scope="module")
def loop_scene():
    """tests/test_loop_pipeline.py's scene (clean everywhere), its frames
    built by the port, and keyframe records of frame 6 and of frame 58,
    which revisits it: host arrays with the truth's landmark ids at frame
    6's anchors, the truth's poses and a map of the true landmarks."""
    jrig, trig = _rigs()
    poses = tsyn.loop_trajectory(N_FRAMES, radius=5.0,
                                 revisit_frames=REVISIT, seed=0)
    lms = tsyn.make_ring_landmarks(1400, radius=11.0, seed=1)
    descs = tsyn.make_descriptors(1400, seed=2)
    frames = tsyn.render_feature_frames(trig, poses, lms, descs,
                                        kps_per_cam=320, px_noise=0.4,
                                        desc_bit_noise=4, seed=3,
                                        max_depth=9.0)
    recs = {}
    for k in (3, 6, 58):
        f = frames[k]
        ff = tframe.build_frame_from_keypoints(
            _t(f.uv), hamming.desc_to_torch(f.desc, "cpu"), _t(f.valid),
            trig, max_intra=1024)
        kf = TKeyframe(k, k / 20.0, poses[k], ff)
        kp = kf.im_ray_idx[np.arange(len(kf.lm_id)), kf.im_anchor_cam]
        true_id = np.where(kf.im_valid & (kp >= 0),
                           f.lm_id[kf.im_anchor_cam, np.maximum(kp, 0)], -1)
        recs[k] = (kf, true_id.astype(np.int32))
    lm_map = types.SimpleNamespace(pos=lms, valid=np.ones(len(lms), bool))
    return jrig, trig, poses, descs, recs, lm_map


def _record(kf, lm_id):
    return types.SimpleNamespace(
        kf_id=kf.kf_id, world_T_ref=kf.world_T_ref, im_desc=kf.im_desc,
        im_valid=kf.im_valid, im_uv=kf.im_uv, im_anchor_cam=kf.im_anchor_cam,
        im_sigma2=kf.im_sigma2, lm_id=lm_id)


def _closers(vocabs, jrig, trig, **cfg):
    jv, tv = vocabs
    c = dict(LOOP_CFG, **cfg)
    return (jdet.LoopCloser(jv, jrig, jdet.LoopConfig(**c)),
            tdet.LoopCloser(tv, trig, tdet.LoopConfig(**c)))


def test_match_direct_index_matches_jax(vocabs, loop_scene):
    jrig, trig, _, _, recs, _ = loop_scene
    jl, tl = _closers(vocabs, jrig, trig)
    (q, _), (o, o_ids) = recs[58], recs[6]
    args = (q.im_desc, q.im_valid, o.im_desc, o.im_valid & (o_ids >= 0))
    tr, td = tl._match_direct_index(*args)
    jr, jd = jl._match_direct_index(*args)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    for f in ("idx", "ok", "dist"):
        np.testing.assert_array_equal(getattr(tr, f).numpy(),
                                      np.asarray(getattr(jr, f)))
    assert int(tr.ok.sum()) >= 100


def _fixed_samples(monkeypatch, idx):
    """Both packages' RANSAC samplers return idx (the JAX RANSACs retraced
    so that the patched sampler is the one traced)."""
    monkeypatch.setattr(jransac, "_sample_idx",
                        lambda *a, **k: jnp.asarray(idx))
    # a fresh partial per patch: jax.jit caches traces by the function
    monkeypatch.setattr(jransac, "ransac_pnp", jax.jit(
        functools.partial(jransac.ransac_pnp.__wrapped__),
        static_argnames=("num_hyp", "sample_size")))
    monkeypatch.setattr(jseventeen, "ransac_seventeen", jax.jit(
        functools.partial(jseventeen.ransac_seventeen.__wrapped__),
        static_argnames=("num_hyp", "sample_size", "num_scales",
                         "refine_iters")))
    monkeypatch.setattr(transac, "_sample_idx",
                        lambda *a, **k: torch.as_tensor(idx).long())


def _rot_deg(Ra, Rb):
    c = (np.trace(Ra.T @ Rb) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


def test_verify_pnp_matches_jax(vocabs, loop_scene, monkeypatch):
    jrig, trig, poses, _, recs, lm_map = loop_scene
    jl, tl = _closers(vocabs, jrig, trig)
    (q, _), (o, o_ids) = recs[58], recs[6]
    qr, orr = _record(q, np.full(len(q.lm_id), -1, np.int32)), \
        _record(o, o_ids)
    # the landmark mask _verify samples from (its match, the map gate)
    res, _ = tl._match_direct_index(q.im_desc, q.im_valid, o.im_desc,
                                    o.im_valid & (o_ids >= 0))
    ok, idx = tl._ok_idx(res)
    sel = ok & (o_ids[idx] >= 0)
    samples = np.random.RandomState(4).choice(np.flatnonzero(sel), (256, 6))
    _fixed_samples(monkeypatch, samples.astype(np.int32))
    td = tl._verify(qr, orr, lm_map)
    jd = jl._verify(qr, orr, lm_map)
    assert td.detected and jd.detected
    assert td.match_kf == jd.match_kf == 6
    assert abs(td.n_inliers - jd.n_inliers) <= 0.02 * jd.n_inliers
    np.testing.assert_allclose(td.world_T_query, np.asarray(jd.world_T_query),
                               atol=2e-3, rtol=0)
    np.testing.assert_allclose(td.rel_pose, jd.rel_pose, atol=2e-3, rtol=0)
    # and the truth (the map is the true landmarks)
    assert np.linalg.norm(td.world_T_query[:3, 3] - poses[58][:3, 3]) < 0.02
    common = np.intersect1d(td.query_slots, jd.query_slots)
    assert len(common) >= 0.98 * max(len(td.query_slots),
                                     len(jd.query_slots))
    a = dict(zip(td.query_slots, td.lm_ids))
    b = dict(zip(jd.query_slots, jd.lm_ids))
    assert all(a[s] == b[s] for s in common)


def test_verify_seventeen_matches_jax(vocabs, loop_scene, monkeypatch):
    """The old keyframe (frame 3, 1.8 m behind the query's place) has no
    landmarks: both fall back to the 17-point 2D-2D check."""
    jrig, trig, poses, _, recs, lm_map = loop_scene
    jl, tl = _closers(vocabs, jrig, trig)
    (q, _), (o, _) = recs[58], recs[3]
    none = np.full(len(q.lm_id), -1, np.int32)
    qr, orr = _record(q, none), _record(o, none)
    res, _ = tl._match_direct_index(q.im_desc, q.im_valid, o.im_desc,
                                    o.im_valid)
    ok, _ = tl._ok_idx(res)
    samples = np.random.RandomState(5).choice(np.flatnonzero(ok), (96, 20))
    _fixed_samples(monkeypatch, samples.astype(np.int32))
    td = tl._verify(qr, orr, lm_map)
    jd = jl._verify(qr, orr, lm_map)
    assert td.detected and jd.detected
    assert td.match_kf == jd.match_kf == 3
    assert len(td.lm_ids) == 0  # no landmark to merge
    jT = np.asarray(jd.rel_pose, np.float64)
    tT = td.rel_pose.astype(np.float64)
    assert _rot_deg(jT[:3, :3], tT[:3, :3]) < 0.05
    assert abs(td.n_inliers - jd.n_inliers) <= 0.02 * jd.n_inliers
    # tests/test_seventeen.py's bounds against the truth
    T_true = np.linalg.inv(poses[3]) @ poses[58]
    tt, tn = np.linalg.norm(T_true[:3, 3]), np.linalg.norm(tT[:3, 3])
    assert _rot_deg(tT[:3, :3], T_true[:3, :3]) < 0.6
    cos = np.dot(tT[:3, 3], T_true[:3, 3]) / max(tn * tt, 1e-9)
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 45.0
    assert 0.2 * tt < tn < 5.0 * tt


# -- pose-graph optimization -------------------------------------------------


def _drift_graph(sim3: bool):
    """The graphs of tests/test_loop_reloc.py::test_pgo_corrects_drift
    (SE(3) drift) and tests/test_pgo_sim3.py (3 % scale drift per step)."""
    N = 10 if sim3 else 12
    true = jsyn.smooth_trajectory(N, step_angle=0.12 if sim3 else 0.1)
    drift = np.asarray(jlie.se3_exp(jnp.asarray(
        [0.002, 0.004, -0.002, 0.01, 0.005, 0.0])))
    est = [true[0]]
    for k in range(1, N):
        odo = np.linalg.inv(true[k - 1]) @ true[k]
        if sim3:
            odo = odo.copy()
            odo[:3, 3] *= 0.97 ** k
            est.append(est[-1] @ odo)
        else:
            est.append(est[-1] @ odo @ drift)
    est = np.stack(est).astype(np.float32)
    ei, ej, meas, w = (np.asarray(a) for a in jpgo.build_odometry_edges(
        jnp.asarray(est)))
    loop = (np.linalg.inv(true[0]) @ true[-1]).astype(np.float32)
    return dict(poses=est, edge_i=np.append(ei, 0).astype(np.int32),
                edge_j=np.append(ej, N - 1).astype(np.int32),
                edge_meas=np.concatenate([meas, loop[None]]),
                edge_weight=np.append(w, 50.0).astype(np.float32),
                edge_valid=np.ones(N, bool), anchor=0), true


def test_pgo_edge_jacobians_match_jax():
    g, _ = _drift_graph(False)
    args = [g["poses"][3], g["poses"][7], g["edge_meas"][5]]
    for argnum in (0, 1):
        jJ = np.asarray(jax.jacfwd(jpgo._edge_residual, argnums=argnum)(
            jnp.zeros(6), jnp.zeros(6), *(jnp.asarray(a) for a in args)))
        tJ = torch.func.jacfwd(tpgo._edge_residual, argnums=argnum)(
            torch.zeros(6, dtype=torch.float64),
            torch.zeros(6, dtype=torch.float64),
            *(_t(a).double() for a in args))
        np.testing.assert_allclose(tJ.numpy(), jJ, atol=1e-5, rtol=0)
    ei, ej, meas, _ = tpgo.build_odometry_edges(_t(g["poses"]))
    np.testing.assert_allclose(meas.numpy(), g["edge_meas"][:-1], atol=1e-6)
    assert ei.tolist() == g["edge_i"][:-1].tolist()
    assert ej.tolist() == g["edge_j"][:-1].tolist()


@pytest.mark.parametrize("sim3", [False, True], ids=["se3", "sim3"])
def test_pgo_solve_matches_jax(sim3):
    g, true = _drift_graph(sim3)
    jg = jpgo.PoseGraph(**{k: jnp.asarray(v) for k, v in g.items()})
    tg = tpgo.PoseGraph(**{k: (_t(v) if k != "anchor" else v)
                           for k, v in g.items()})
    if sim3:
        jp, js = jpgo.pgo_solve_sim3(jg, iters=12)
        tp, ts = tpgo.pgo_solve_sim3(tg, iters=12)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-4,
                                   rtol=0)
    else:
        jp = jpgo.pgo_solve(jg, iters=10)
        tp = tpgo.pgo_solve(tg, iters=10)
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.dtype == np.float32
    np.testing.assert_allclose(tp[:, :3, :3], jp[:, :3, :3], atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(tp[:, :3, 3], jp[:, :3, 3], atol=2e-4, rtol=0)
    # and the JAX tests' own gates
    err0 = np.linalg.norm(g["poses"][-1][:3, 3] - true[-1][:3, 3])
    err = np.linalg.norm(tp[-1][:3, 3] - true[-1][:3, 3])
    assert err < err0 * (0.05 if sim3 else 0.3), (err, err0)


# -- map I/O -----------------------------------------------------------------


def _session_records(seed=0, n_kf=3, n_lm=60):
    rng = np.random.RandomState(seed)
    lm_map = types.SimpleNamespace(
        pos=rng.randn(n_lm, 3).astype(np.float32),
        desc=rng.randint(0, 2**32, (n_lm, 8), dtype=np.uint64).astype(
            np.uint32),
        valid=rng.rand(n_lm) > 0.1)
    kfs = []
    for k in range(n_kf):
        M = 40
        kfs.append(types.SimpleNamespace(
            kf_id=3 * k, timestamp=0.05 * k,
            world_T_ref=np.asarray(jlie.se3_exp(jnp.asarray(
                rng.randn(6).astype(np.float32) * 0.3))),
            lm_id=np.where(rng.rand(M) > 0.3, rng.randint(0, n_lm, M),
                           -1).astype(np.int32),
            im_uv=rng.uniform(0, 640, (M, 2)).astype(np.float32),
            im_anchor_cam=rng.randint(0, 4, M).astype(np.int32)))
    return kfs, lm_map


def _same_map(a, b):
    (ka, la), (kb, lb) = a, b
    assert len(ka) == len(kb) and sorted(la) == sorted(lb)
    for ea, eb in zip(ka, kb):
        assert ea.keys() == eb.keys()
        for f in ea:
            np.testing.assert_array_equal(ea[f], eb[f])
    for lid in la:
        for x, y in zip(la[lid], lb[lid]):
            np.testing.assert_array_equal(x, y)


def test_map_and_graph_log_load_in_both_packages(tmp_path):
    kfs, lm_map = _session_records()
    for w, r in ((jmapio, tmapio), (tmapio, jmapio)):
        p = tmp_path / f"{w.__name__}.json"
        w.save_map_json(p, kfs, lm_map)
        _same_map(r.load_map_json(p), w.load_map_json(p))
        assert len(r.load_map_json(p)[1]) > 20
        g = tmp_path / f"{w.__name__}.log"
        log = w.GraphLogWriter(g)
        log.pose(0, kfs[1].world_T_ref, 0.25)
        log.landmark(5, lm_map.pos[5])
        log.edge(0, 1, 5, 100.5, 200.25)
        log.imu_raw(0.005, [0.1, 0.2, 0.3], [9.0, 0.1, 0.2])
        log.gps(0, [1.0, 2.0, 3.0], [42.0, -71.0, 10.0])
        log.loop_pose(8, 2, kfs[2].world_T_ref)
        log.loop_measurement(8, 0, 5, 50.0, 60.0)
        log.close()
        a, b = r.read_graph_logs(g), w.read_graph_logs(g)
        assert a.keys() == b.keys()
        for key in a:
            assert len(a[key]) == len(b[key]) == (key != "none")
            for x, y in zip(a[key][0], b[key][0]):
                np.testing.assert_array_equal(x, y)


def test_navability_map_loads_in_both_packages(tmp_path):
    import json

    rng = np.random.RandomState(1)
    feats, poses = {}, {}
    for p in range(3):
        q = rng.randn(4)
        poses[f"p{p}"] = {"timestamp": f"2024-01-0{p + 1}T00:00:00",
                          "pos": rng.randn(3).tolist(),
                          "quat": (q / np.linalg.norm(q)).tolist()}
    for i in range(20):
        feats[f"lm{i}_p{i % 3}_"] = {
            "pos": (rng.randn(3) + [0, 0, 5]).tolist(),
            "descriptor": rng.randint(0, 256, 32).tolist(),
            "adj_cams": [f"p{(i + 1) % 3}"] if i % 4 == 0 else []}
    fp, pp = tmp_path / "f.json", tmp_path / "p.json"
    fp.write_text(json.dumps(feats))
    pp.write_text(json.dumps(poses))
    _same_map(tmapio.load_map_navability(fp, pp),
              jmapio.load_map_navability(fp, pp))


# -- the loop-closing driver on twin states ----------------------------------


@pytest.fixture(scope="module")
def twin_source():
    """Keyframe and map records of a port VO session over the 60-frame
    loop scene of tests/test_loop_pipeline.py (noisy middle), and the
    detection of its last keyframe against the keyframe it revisits
    (the port's _verify)."""
    jrig, trig = _rigs()
    poses = tsyn.loop_trajectory(N_FRAMES, radius=5.0,
                                 revisit_frames=REVISIT, seed=0)
    lms = tsyn.make_ring_landmarks(1400, radius=11.0, seed=1)
    descs = tsyn.make_descriptors(1400, seed=2)
    kw = dict(kps_per_cam=320, desc_bit_noise=4, seed=3, max_depth=9.0)
    clean = tsyn.render_feature_frames(trig, poses, lms, descs, px_noise=0.4,
                                       **kw)
    noisy = tsyn.render_feature_frames(trig, poses, lms, descs, px_noise=1.8,
                                       **kw)
    slam = tslam.MultiCameraSLAM(trig, tslam.SlamConfig(**CFG))
    for i in range(N_FRAMES):
        f = noisy[i] if 10 <= i < N_FRAMES - REVISIT - 4 else clean[i]
        ff = tframe.build_frame_from_keypoints(
            _t(f.uv), hamming.desc_to_torch(f.desc, "cpu"), _t(f.valid),
            trig, max_intra=1024)
        slam.process_frame(ff, f.timestamp)
    slam.finalize()
    assert slam.state == tslam.INITIALIZED
    tv = tvocab.Vocabulary.train(descs, k=6, depth=3, iters=3)
    looper = tdet.LoopCloser(tv, trig, tdet.LoopConfig(**LOOP_CFG))
    q = slam.keyframes[-1]
    ts = np.array([k.timestamp for k in slam.keyframes])
    t_old = (N_FRAMES - 1 - (N_FRAMES - REVISIT)) / 20.0
    old = slam.keyframes[int(np.argmin(np.abs(ts - t_old)))]
    det = looper._verify(q, old, slam.map)
    assert det.detected
    kfs = [{f: np.copy(getattr(k, f)) for f in _KF_FIELDS} | {
        "kf_id": k.kf_id, "timestamp": k.timestamp} for k in slam.keyframes]
    m = slam.map
    mp = {f: np.copy(getattr(m, f)) for f in _MAP_FIELDS}
    mp["_free"] = list(m._free)
    return jrig, trig, kfs, mp, det, slam.cur_pose.copy(), poses


_KF_FIELDS = ("world_T_ref", "im_desc", "im_uv", "im_anchor_cam", "im_valid",
              "im_sigma2", "im_point3d", "im_has_depth", "im_ray_idx",
              "ray_uv", "ray_sigma2", "ray_valid", "lm_id")
_MAP_FIELDS = ("pos", "desc", "normal", "n_obs", "first_kf", "last_kf",
               "valid")


def _load(slam, kf_cls, src, **dev):
    """The records into a fresh driver: keyframes (no device copies),
    the host map and its device mirror, an initialized state."""
    _, _, kfs, mp, _, cur, _ = src
    slam.keyframes = []
    for r in kfs:
        k = kf_cls.__new__(kf_cls)
        for f, v in r.items():
            setattr(k, f, np.copy(v) if isinstance(v, np.ndarray) else v)
        k.d_desc = k.d_valid = k._d_lm_id = None
        k.device = dev.get("device")
        slam.keyframes.append(k)
    for f in _MAP_FIELDS:
        getattr(slam.map, f)[:] = mp[f]
    slam.map._free = list(mp["_free"])
    ids = np.flatnonzero(mp["valid"])
    slam.dmap.upsert(ids, pos=mp["pos"][ids], desc=mp["desc"][ids],
                     valid=True, normal=mp["normal"][ids])
    slam.state = J_INIT
    slam.kf_counter = kfs[-1]["kf_id"] + 1
    slam.cur_pose = cur.copy()
    slam.last_pose = cur.copy()
    slam.stats["frames"] = N_FRAMES
    return slam


def _twins(src, **cfg):
    jrig, trig = src[0], src[1]
    c = dict(CFG, **cfg)
    j = _load(JSLAM(jrig, JConfig(**c)), JKeyframe, src)
    t = _load(tslam.MultiCameraSLAM(trig, tslam.SlamConfig(**c)), TKeyframe,
              src, device=torch.device("cpu"))
    return j, t


def _compare_state(j, t, pose_atol, lm_atol, lm_frac=1.0, max_flips=0):
    """Poses within pose_atol; the same landmarks alive (up to max_flips
    kept by one driver and deleted by the other) and keyframe tables equal
    apart from those; live positions within lm_atol for lm_frac of them;
    the port's device mirror equal to its host map."""
    jp = np.stack([k.world_T_ref for k in j.keyframes])
    tp = np.stack([k.world_T_ref for k in t.keyframes])
    np.testing.assert_allclose(tp, jp, atol=pose_atol, rtol=0)
    flips = np.flatnonzero(t.map.valid != j.map.valid)  # freed by one only
    assert len(flips) <= max_flips, flips
    assert set(t.map._free) ^ set(j.map._free) == set(flips.tolist())
    for a, b in zip(t.keyframes, j.keyframes):
        same = (a.lm_id == b.lm_id) | np.isin(a.lm_id, flips) | np.isin(
            b.lm_id, flips)
        assert same.all()
    v = np.flatnonzero(j.map.valid & t.map.valid)
    d = np.linalg.norm(t.map.pos[v] - j.map.pos[v], axis=-1)
    assert np.mean(d <= lm_atol) >= lm_frac, (np.max(d), np.mean(
        d <= lm_atol))
    v = np.flatnonzero(t.map.valid)
    np.testing.assert_allclose(t.dmap.pos.numpy()[v], t.map.pos[v])


def test_close_loop_twin_state_matches_jax(twin_source):
    """_close_loop given the same detection (global BA off here; the next
    test holds it): the same PGO decision, merged and freed landmark ids
    and keyframe tables equal; poses 2e-3 (the PGO bend in float64 vs
    float32, then the loop-window BA); landmark positions 1e-2 m for
    >= 99 % of them (re-triangulated from those poses)."""
    det = twin_source[4]
    j, t = _twins(twin_source, global_ba=False)
    jdet_ = jdet.LoopDetection(**vars(det))
    j._close_loop(j.keyframes[-1], jdet_)
    t._close_loop(t.keyframes[-1], det)
    assert t.stats["loops"] == j.stats["loops"] == 1
    assert t.stats.get("pgo", 0) == 1  # the trajectory disagreed: a bend
    _compare_state(j, t, 2e-3, 1e-2, 0.99)
    np.testing.assert_allclose(t.cur_pose, j.cur_pose, atol=2e-3, rtol=0)


def test_retriangulate_twin_state_matches_jax(twin_source):
    """_retriangulate_landmarks on identical records (~4900 landmarks,
    ~150 deleted): kept / deleted equal but for at most 0.1 % (a chi2 or
    parallax gate met within rounding), keyframe tables equal apart from
    those; positions 1e-3 m for >= 99 % (distant two-ray landmarks are
    ill-conditioned along the ray: five Gauss-Newton steps from another
    rounding end up to 0.15 m apart at about equal reprojection cost)."""
    j, t = _twins(twin_source)
    n0 = int(twin_source[3]["valid"].sum())
    j._retriangulate_landmarks()
    t._retriangulate_landmarks()
    assert n0 - 200 < int(t.map.valid.sum()) < n0  # some were deleted
    _compare_state(j, t, 0.0, 1e-3, 0.99, max_flips=int(0.001 * n0))


def test_global_ba_twin_state_matches_jax(twin_source, monkeypatch):
    """_run_global_ba + _finish_pending_gba (deferred, then landed) on
    identical records: the same keyframes and landmarks selected; both
    solutions at the same cost within 1e-5 relative (on this 60-keyframe
    trajectory the cost is flat along weakly constrained directions: equal
    costs sit up to ~1 cm apart, so poses are held to 2e-2 and landmarks
    to 5e-2 m for >= 99 %); every keyframe but the gauge moved."""
    from mcslam_tpu_torch.backend import ba as tba

    problems = []
    solve = tba.ba_solve
    monkeypatch.setattr(tba, "ba_solve", lambda p, **kw: (
        problems.append(p), solve(p, **kw))[1])
    j, t = _twins(twin_source)
    j._run_global_ba()
    t._run_global_ba()
    jg, tg = j._pending_gba, t._pending_gba
    assert tg["lm_ids"].tolist() == jg["lm_ids"].tolist()
    assert tg["sel_kf_ids"] == jg["sel_kf_ids"]

    def cost(g):
        p = problems[0]._replace(poses=_t(g["sp"]), landmarks=_t(g["sl"]))
        return float(tba._total_cost(p, 2.5))

    c0 = float(tba._total_cost(problems[0], 2.5))
    assert cost(tg) < 0.8 * c0
    assert cost(tg) <= cost(jg) * (1 + 1e-5), (cost(tg), cost(jg))
    j._finish_pending_gba()
    t._finish_pending_gba()
    assert t.stats["global_ba"] == j.stats["global_ba"] == 1
    _compare_state(j, t, 2e-2, 5e-2, 0.99)
    before = np.stack([r["world_T_ref"] for r in twin_source[2]])
    after = np.stack([k.world_T_ref for k in t.keyframes])
    # all but the gauge keyframe
    assert (np.abs(after - before).max(axis=(1, 2))[1:] > 1e-5).all()
