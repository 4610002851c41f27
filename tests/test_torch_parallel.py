"""The port's multi-device paths (mcslam_tpu_torch/parallel, the driver's
and the app's mesh hooks, mcslam_tpu_torch/entry.py) against the JAX
package's on the CPU, on the same numpy inputs. The JAX side runs on the
8 virtual CPU devices that tests/conftest.py forces; the port's meshes
repeat the CPU (parallel/mesh).

Tolerances (tests/test_parallel.py's, f32 with shard-order sums):
- sharded_lm_step against the port's single-device step: poses 2e-4,
  landmarks rtol 2e-2 / atol 5e-3;
- the observation-sharded solve against JAX's and against the port's
  ba_solve: poses 5e-4, landmarks rtol 5e-2 / atol 1e-2, the same inlier
  mask and count, within 0.02 m of the truth;
- the landmark-sharded solve (a permuted table): poses 5e-3, landmarks
  rtol 8e-2 / atol 3e-2, inlier counts within 3, within 0.02 m;
- shard_by_landmark, sharded_hamming_match and the sharded frame builds:
  exact;
- the driver over a mesh: ATE < 0.08 m (tests/test_parallel.py's gate).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcslam_tpu.backend import ba as jba
from mcslam_tpu.ops import hamming as jhamming
from mcslam_tpu.parallel import sharded_ba as jsb
from mcslam_tpu.parallel import sharded_match as jsm
from mcslam_tpu_torch import entry
from mcslam_tpu_torch.backend import ba as tba
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.geometry import lie as tlie
from mcslam_tpu_torch.ops import hamming as thamming
from mcslam_tpu_torch.parallel import mesh as tmesh
from mcslam_tpu_torch.parallel import sharded_ba as tsb
from mcslam_tpu_torch.parallel import sharded_frame as tsf
from mcslam_tpu_torch.parallel import sharded_match as tsm
from test_parallel import _toy_problem


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small shapes and many small ops: one intra-op thread runs them
    faster than a pool that the suite's parallel workers oversubscribe."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _toy(n):
    """tests/test_parallel.py's toy problem for an n-device mesh ->
    (poses_gt, JAX arrays of the problem, port args (numpy), prior)."""
    poses_gt, _, poses0, lms0, obs, cam_T_ref, fxycxy = _toy_problem(n)
    K, L = poses0.shape[0], lms0.shape[0]
    prior_H = np.zeros((K * 6, K * 6), np.float32)
    prior_H[:6, :6] = np.eye(6) * 1e6
    obs_np = tba.BAObservations(*(np.asarray(f) for f in obs))
    args = (poses0, lms0, np.ones(L, bool), np.ones(K, bool))
    consts = (cam_T_ref, fxycxy, prior_H, np.zeros(K * 6, np.float32))
    return poses_gt, obs, obs_np, args, consts


def _jargs(args, consts):
    return ([jnp.asarray(a) for a in args], [jnp.asarray(c) for c in consts])


def _single(obs_np, args, consts, **kw):
    p = tba.problem_from_numpy(*args[:3], obs_np, *consts[:2], *consts[2:],
                               args[3], device="cpu")
    return tba.ba_solve(p, **kw)


def test_mesh_collectives_and_construction():
    m = tmesh.Mesh(["cpu"] * 3, "x")
    assert m.size == 3 and not m.distinct and m.first.type == "cpu"
    parts = m.shard(torch.arange(12.0).reshape(6, 2))
    assert [p.shape for p in parts] == [(2, 2)] * 3
    torch.testing.assert_close(m.all_gather(parts),
                               torch.arange(12.0).reshape(6, 2))
    # psum adds in shard order: ((a + b) + c), the same bits every run
    a, b, c = (torch.tensor([1e8]), torch.tensor([1.0]), torch.tensor([-1e8]))
    assert float(m.psum([a, b, c])) == float((a + b) + c)
    assert torch.equal(m.pmin([torch.tensor([3, 1]), torch.tensor([2, 5]),
                               torch.tensor([4, 0])]), torch.tensor([2, 0]))
    with pytest.raises(ValueError, match="divide"):
        m.shard(torch.ones(4))
    assert tmesh.make_mesh(4, "cpu").size == 4
    assert tmesh.spread_mesh(2, "cpu").devices == [torch.device("cpu")] * 2
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="mesh needs 2"):
            tmesh.make_mesh(2, "cuda")


def test_sharded_lm_step_matches_single_device():
    """One damped step (lambda 1e-4) over a 4-shard mesh against the same
    math on one device, and the step reduces the error to the truth."""
    n = 4
    poses_gt, _, obs_np, args, consts = _toy(n)
    K, L = args[0].shape[0], args[1].shape[0]
    new_poses, new_lms = tsb.sharded_lm_step(
        tsb.make_mesh(n, "cpu"), *args, obs_np, *consts, lam=1e-4)
    p = tba.problem_from_numpy(*args[:3], obs_np, *consts[:2], *consts[2:],
                               args[3], device="cpu")
    r, Jp, Jl, w = tba._residuals_and_jacobians(p, 2.5)
    dp, dl = tba._schur_solve(*tba._assemble(p, r, Jp, Jl, w),
                              torch.tensor(1e-4), p.lm_valid)
    ref_poses = tlie.se3_retract(p.poses, dp.reshape(K, 6))
    np.testing.assert_allclose(new_poses.numpy(), ref_poses.numpy(),
                               atol=2e-4)
    np.testing.assert_allclose(new_lms.numpy(), (p.landmarks + dl).numpy(),
                               rtol=2e-2, atol=5e-3)
    err0 = np.linalg.norm(args[0][1:, :3, 3] - poses_gt[1:, :3, 3])
    err1 = np.linalg.norm(new_poses.numpy()[1:, :3, 3] - poses_gt[1:, :3, 3])
    assert err1 < err0


def test_sharded_ba_solve_matches_jax_and_single_device():
    """The observation-sharded solve (5 x 2) over 4 shards against JAX's
    over its 4-device mesh and against the port's ba_solve."""
    n = 4
    poses_gt, obs, obs_np, args, consts = _toy(n)
    ja, jc = _jargs(args, consts)
    jp, jl, j_inl, _, j_nin = jsb.sharded_ba_solve(
        jsb.make_mesh(n), *ja, jsb.shard_observations(jsb.make_mesh(n), obs),
        *jc, iters=5, gate_rounds=2)
    sp, sl, s_inl, s_cost, s_nin = tsb.sharded_ba_solve(
        tsb.make_mesh(n, "cpu"), *args, obs_np, *consts, iters=5,
        gate_rounds=2)
    ref = _single(obs_np, args, consts, iters=5, gate_rounds=2)
    for other_p, other_l, other_inl, other_n in (
            (np.asarray(jp), np.asarray(jl), np.asarray(j_inl), int(j_nin)),
            (ref.poses.numpy(), ref.landmarks.numpy(),
             ref.obs_inliers.numpy(), int(ref.num_inliers))):
        np.testing.assert_allclose(sp.numpy(), other_p, atol=5e-4)
        np.testing.assert_allclose(sl.numpy(), other_l, rtol=5e-2, atol=1e-2)
        assert int(s_nin) == other_n
        np.testing.assert_array_equal(s_inl.numpy(), other_inl)
    assert s_cost.device == torch.device("cpu") and s_cost.ndim == 0
    err = np.linalg.norm(sp.numpy()[1:, :3, 3] - poses_gt[1:, :3, 3])
    assert err < 0.02


def test_shard_observations_pads_to_the_mesh():
    """O = 256 over a 3-shard mesh: padded to 258 with invalid rows; the
    solve equals the 4-shard one within the obs-sharded tolerance and the
    padding never counts as an inlier."""
    poses_gt, _, obs_np, args, consts = _toy(4)
    m3 = tsb.make_mesh(3, "cpu")
    shards = tsb.shard_observations(m3, obs_np)
    assert [o.kf.shape[0] for o in shards] == [86, 86, 86]
    assert not bool(shards[2].valid[-2:].any())
    assert bool((shards[2].sigma2[-2:] == 1).all())
    sp, sl, s_inl, _, s_nin = tsb.sharded_ba_solve(
        m3, *args, shards, *consts, iters=5, gate_rounds=2)
    ref = _single(obs_np, args, consts, iters=5, gate_rounds=2)
    np.testing.assert_allclose(sp.numpy(), ref.poses.numpy(), atol=5e-4)
    assert s_inl.shape == (258,) and not bool(s_inl[256:].any())
    assert int(s_nin) == int(ref.num_inliers)


def test_shard_by_landmark_matches_jax():
    _, obs, obs_np, args, _ = _toy(4)
    L = args[1].shape[0]
    j = jsb.shard_by_landmark(obs, L, 4, pad_multiple=32)
    t = tsb.shard_by_landmark(obs_np, L, 4, pad_multiple=32)
    for name in jba.BAObservations._fields:
        np.testing.assert_array_equal(getattr(t, name),
                                      np.asarray(getattr(j, name)), name)
    # tensors in, the same table out
    t2 = tsb.shard_by_landmark(tba.BAObservations(
        *(torch.from_numpy(np.array(f)) for f in obs_np)), L, 4,
        pad_multiple=32)
    for a, b in zip(t, t2):
        np.testing.assert_array_equal(a, b)


def test_landmark_sharded_solve_matches_jax_and_single_device():
    n = 4
    poses_gt, obs, obs_np, args, consts = _toy(n)
    L = args[1].shape[0]
    ja, jc = _jargs(args, consts)
    jp, jl, _, _, j_nin = jsb.sharded_ba_solve_lm(
        jsb.make_mesh(n), *ja, jsb.shard_by_landmark(obs, L, n, 32), *jc,
        iters=5, gate_rounds=2)
    sp, sl, s_inl, _, s_nin = tsb.sharded_ba_solve_lm(
        tsb.make_mesh(n, "cpu"), *args,
        tsb.shard_by_landmark(obs_np, L, n, 32), *consts, iters=5,
        gate_rounds=2)
    ref = _single(obs_np, args, consts, iters=5, gate_rounds=2)
    for other_p, other_l, other_n in (
            (np.asarray(jp), np.asarray(jl), int(j_nin)),
            (ref.poses.numpy(), ref.landmarks.numpy(),
             int(ref.num_inliers))):
        np.testing.assert_allclose(sp.numpy(), other_p, atol=5e-3)
        np.testing.assert_allclose(sl.numpy(), other_l, rtol=8e-2, atol=3e-2)
        assert abs(int(s_nin) - other_n) <= 3
    assert int(s_nin) == int(s_inl.sum())
    err = np.linalg.norm(sp.numpy()[1:, :3, 3] - poses_gt[1:, :3, 3])
    assert err < 0.02


def _match_inputs():
    """tests/test_parallel.py's match problem: N=1003 map rows (not
    divisible by the mesh), 64 queries, bit-corrupted copies and noise."""
    rng = np.random.RandomState(3)
    N, Q = 1003, 64
    map_desc = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(
        np.uint32)
    map_valid = rng.rand(N) > 0.1
    q = map_desc[rng.randint(0, N, Q)].copy()
    flip = rng.randint(0, 2**32, (Q, 8), dtype=np.uint64).astype(np.uint32)
    q = np.where(rng.rand(Q, 8) > 0.06, q, q ^ flip)
    q[: Q // 4] = rng.randint(0, 2**32, (Q // 4, 8),
                              dtype=np.uint64).astype(np.uint32)
    # planted ties across shards: two exact copies of one query's row
    q[20] = map_desc[5]
    map_desc[700] = map_desc[5]
    map_valid[[5, 700]] = True
    return map_desc, map_valid, q, np.ones(Q, bool)


@pytest.mark.parametrize("n", [8, 3])
def test_sharded_hamming_match_matches_single_device(n):
    """Every output equal to the single-device brute force (ties to the
    lowest row) and, on 8 shards, to JAX's sharded match."""
    map_desc, map_valid, q, qv = _match_inputs()
    mesh = tsm.make_mesh(n, "cpu")
    d_sh, v_sh, Np = tsm.shard_map_desc(mesh, map_desc, map_valid)
    assert Np % (8 * n) == 0 and Np >= len(map_desc)
    idx, ok, dist = tsm.sharded_hamming_match(
        mesh, thamming.desc_to_torch(q, "cpu"), torch.from_numpy(qv), d_sh,
        v_sh, max_dist=64, ratio=0.85)
    d_raw = thamming.hamming_matrix(thamming.desc_to_torch(q, "cpu"),
                                    thamming.desc_to_torch(map_desc, "cpu")
                                    ).numpy()
    d = np.where(map_valid[None, :], d_raw, 1 << 20)
    i1 = np.argmin(d, axis=1)
    d1 = d[np.arange(len(q)), i1]
    d_wo = d.copy()
    d_wo[np.arange(len(q)), i1] = 1 << 20
    ref_ok = qv & (d1 <= 64) & (d1 <= 0.85 * d_wo.min(axis=1))
    np.testing.assert_array_equal(ok.numpy(), ref_ok)
    np.testing.assert_array_equal(dist.numpy(), d1)
    np.testing.assert_array_equal(idx.numpy(), i1)
    assert int(idx[20]) == 5 and int(dist[20]) == 0  # the tie: lowest row
    if n == 8:
        jm = jsm.make_mesh(8)
        jd, jv, _ = jsm.shard_map_desc(jm, map_desc, map_valid)
        jout = jsm.sharded_hamming_match(jm, jnp.asarray(q), jnp.asarray(qv),
                                         jd, jv, max_dist=64, ratio=0.85)
        for a, b in zip((idx, ok, dist), jout):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        # the plain distance matrix is JAX's too
        np.testing.assert_array_equal(
            d_raw[:, :10], np.asarray(jhamming.hamming_matrix(
                jnp.asarray(q), jnp.asarray(map_desc[:10]))))


def _frame_scene(num_cams, size, focal, frames, seed):
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=num_cams, baseline=0.25, image_size=size, focal=focal),
        device="cpu")
    poses = tsyn.smooth_trajectory(frames, radius=5.0, step_angle=0.03,
                                   seed=seed)
    lms = tsyn.make_landmarks(500, seed=seed + 1, depth_range=(4.0, 12.0))
    return rig, torch.from_numpy(np.asarray(tsyn.render_blob_images(
        rig, poses, lms, seed=seed + 2)))


def _assert_frames_equal(got, ref, what=""):
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), \
            f"{what} {name}"


@pytest.mark.parametrize("route", ["default", "A", "B"])
def test_sharded_frame_build_is_bit_exact(route):
    """4 cameras over 4 and 2 shards (default route; routes A and B over
    4): every field equal to build_frame's; a 3-shard mesh is refused."""
    from mcslam_tpu_torch.ops import orb

    routes = {"default": orb.OrbRoute(),
              "A": orb.OrbRoute(select_in_kernel=False, late_compact=True),
              "B": orb.OrbRoute(fused_blur=False, hskip=False,
                                fused_orient=True)}
    rig, imgs = _frame_scene(4, (256, 192), 210.0, 1, 3)
    kw = dict(num_points=256, num_levels=3, max_intra=512,
              route=routes[route])
    ref = tframe.build_frame(imgs[0], rig, **kw)
    assert int(ref.im_valid.sum()) > 100
    for n in ((4, 2) if route == "default" else (4,)):
        got = tsf.sharded_build_frame(tsf.make_mesh(n, "cpu"), imgs[0], rig,
                                      **kw)
        _assert_frames_equal(got, ref, f"{n} shards")
    with pytest.raises(ValueError, match="not divisible"):
        tsf.sharded_build_frame(tsf.make_mesh(3, "cpu"), imgs[0], rig, **kw)


def test_sharded_frames_batch_matches_sequential():
    rig, imgs = _frame_scene(2, (192, 144), 160.0, 4, 6)
    kw = dict(num_points=128, num_levels=2, max_intra=256)
    got = tsf.sharded_build_frames(tsf.make_mesh(4, "cpu"), imgs, rig, **kw)
    assert len(got) == 4
    for b in range(4):
        _assert_frames_equal(got[b], tframe.build_frame(imgs[b], rig, **kw),
                             f"frame {b}")
    with pytest.raises(ValueError, match="must equal"):
        tsf.sharded_build_frames(tsf.make_mesh(4, "cpu"), imgs[:3], rig, **kw)


def test_driver_with_mesh_sharded_ba(monkeypatch):
    """tests/test_parallel.py's driver scene (3 cameras, 8 feature-level
    frames) with an 8-shard mesh: every window solve observation-sharded,
    then the final global BA landmark-sharded; INITIALIZED, ATE < 0.08."""
    from mcslam_tpu_torch.slam import INITIALIZED, MultiCameraSLAM, SlamConfig
    from mcslam_tpu_torch.utils import metrics

    rig = tsyn.make_synthetic_rig(
        tsyn.SyntheticRigSpec(num_cams=3, baseline=0.2), device="cpu")
    poses = tsyn.smooth_trajectory(8, radius=5.0, step_angle=0.03)
    lms_w = tsyn.make_landmarks(700, seed=1, depth_range=(5.0, 14.0))
    descs = tsyn.make_descriptors(700, seed=2)
    frames = tsyn.render_feature_frames(rig, poses, lms_w, descs,
                                        kps_per_cam=300, seed=3)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=4096, ba_lm_capacity=512,
                     local_map_landmarks=1024, kf_translation=0.2,
                     final_global_ba=True, global_ba_lm_capacity=1024,
                     global_ba_obs_per_kf=256)
    with pytest.raises(TypeError, match="Mesh"):
        MultiCameraSLAM(rig, cfg, mesh=object())
    calls = []
    solve = tsb.sharded_ba_solve_lm
    slam = MultiCameraSLAM(rig, cfg, mesh=tsb.make_mesh(8, "cpu"))
    for f in frames:
        ff = tframe.build_frame_from_keypoints(
            torch.from_numpy(f.uv), thamming.desc_to_torch(f.desc, "cpu"),
            torch.from_numpy(f.valid), rig, max_intra=768)
        slam.process_frame(ff, f.timestamp)
    assert slam.state == INITIALIZED
    assert slam.stats.get("window_ba", 0) >= 1
    assert getattr(slam, "_vis_marg_prior", None) is None  # no marginal
    monkeypatch.setattr(tsb, "sharded_ba_solve_lm", lambda *a, **kw: (
        calls.append(1), solve(*a, **kw))[1])
    slam.finalize()
    assert calls and slam.stats.get("global_ba", 0) == 1
    ate = metrics.ate_rmse(slam.trajectory_arrays()[1], poses)
    assert ate < 0.08, ate


def test_entry_and_dryrun_on_cpu():
    """entry()'s forward (the 4-camera VGA fused build) gives finite
    outputs of the stated shapes; dryrun_multichip(4) passes."""
    fn, (example,) = entry.entry(device="cpu")
    assert example.shape == (4, 480, 640) and example.device.type == "cpu"
    X, desc, valid = fn(example)
    assert X.shape == (2048, 3) and desc.shape == (2048, 8)
    assert valid.shape == (2048,) and bool(torch.isfinite(X).all())
    entry.dryrun_multichip(4, device="cpu")
