"""The port's graphed frame step and window solve (utils/graphs).

On the CPU: a TorchDispatchMode guard runs what the card captures - the
fused frame step with the fast-path decision on the device
(branch="device"), on both sides of the branch and under the three
extraction routes, the kf-blocked window solve, and the VIO solve of
the flattened problem a VIO program takes as its inputs (warm and cold,
with and without GPS factors; bit-equal to the solve of the problem
itself) - at a small size
(2 cameras, 192x144, 128 keypoints per camera) and fails on any op a
capturing stream cannot take: a host read (aten._local_scalar_dense:
.item(), bool(), int(), a 0-d tensor index), nonzero, masked_select,
unique, a fresh host tensor (aten.lift_fresh: torch.tensor, from_numpy,
a Python list index), a boolean-mask index, linalg's host-checked
factorizations. The device branch is held to the host branch bit for
bit (also where the predicted pose flips the branch) and to the JAX
_build_and_track_step with test_build_and_track_step_matches_jax's
tolerances; the launch accounting (no wrapper counts under a capture;
chip_smoke counts a replay's kernels in the device trace) is checked on
stubs; a CPU session, vision-only or VIO + GPS, leaves the program
caches empty; and with cuda_graphs on, a VIO session's cold solve runs
eagerly and its warm ones go to the graph (the replays stubbed).

`gpu` cases (they skip without a card) hold the captured frame step,
window solve and VIO solve to their eager runs on the card, bit for bit,
the frame program over replays whose predicted pose flips the branch,
the VIO program over two windows of other index columns:
    python -m pytest --noconftest tests/test_torch_graphs.py -m gpu -q
(this file imports JAX only inside the JAX comparison)."""

import collections
import traceback

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from mcslam_tpu_torch import _build
from mcslam_tpu_torch import tracking_kernels as ttk
from mcslam_tpu_torch.backend import ba, ba_vio
from mcslam_tpu_torch.backend.imu import ImuParams
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.ops import hamming, orb
from mcslam_tpu_torch.slam import MultiCameraSLAM, SlamConfig
from mcslam_tpu_torch.utils import graphs

CAP, LML, M = 1024, 256, 256
KW = dict(num_points=128, max_intra=M, angle_bins=16)
STEP = dict(num_points=128, fast_threshold=20 / 255, min_threshold=7 / 255,
            max_intra=M, min_z=0.5, max_z=40.0, angle_bins=16, num_hyp=64,
            px=5.0, max_dist=64, ratio=0.85, lm_radius=18.0, lm_max_dist=60,
            gate_px=100.0, fastpath_min=30)
ROUTES = {
    "default": orb.OrbRoute(),
    "A": orb.OrbRoute(select_in_kernel=False, late_compact=True),
    "B": orb.OrbRoute(fused_blur=False, hskip=False, fused_orient=True),
}
# ops a capturing CUDA stream refuses, or that read the device on the host
UNSAFE = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
          "aten._unique", "aten.unique", "aten.lift_fresh",
          "aten._linalg_check_errors", "aten._linalg_svd", "aten._linalg_eigh",
          "aten.repeat_interleave.Tensor", "aten.bincount")


class CaptureGuard(TorchDispatchMode):
    """Records every op that a CUDA graph capture would refuse, with the
    port's frames of its stack."""

    def __init__(self):
        super().__init__()
        self.seen = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func)
        bad = name.startswith(UNSAFE)
        if name.startswith(("aten.index.Tensor", "aten.index_put")):
            bad = any(i is not None and i.dtype == torch.bool
                      for i in args[1])
        if bad:
            where = [f"{f.filename.rsplit('/', 2)[-1]}:{f.lineno}"
                     for f in traceback.extract_stack()
                     if "mcslam_tpu_torch" in f.filename]
            self.seen[(name, " <- ".join(where[-3:][::-1]))] += 1
        return func(*args, **(kwargs or {}))


def _scene(device):
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0), device=device)
    poses = tsyn.smooth_trajectory(2, step_angle=0.02)
    lms = tsyn.make_landmarks(600, depth_range=(4.0, 15.0))
    return rig, poses, tsyn.render_blob_images(rig, poses, lms)


def _seed(f0, device):
    """bench.py's map mirror from frame 0 (the port's own frame)."""
    valid0 = (f0.im_valid & f0.im_has_depth).cpu()
    prev_lm = torch.where(valid0, torch.arange(M, dtype=torch.int32),
                          torch.full((M,), -1, dtype=torch.int32))
    pos = torch.zeros(CAP, 3)
    pos[:M] = f0.im_point3d.cpu()
    mvalid = torch.zeros(CAP, dtype=torch.bool)
    mvalid[:M] = valid0
    mdesc = torch.zeros(CAP, 8, dtype=torch.int32)
    mdesc[:M] = f0.im_desc.cpu()
    nrm = pos / torch.clamp(torch.linalg.vector_norm(pos, dim=1,
                                                     keepdim=True), min=1e-6)
    cand = np.flatnonzero(mvalid.numpy())[:LML]
    cand_ids = np.zeros(LML, np.int32)
    cand_ids[:len(cand)] = cand
    return tuple(t.to(device) for t in (
        f0.im_desc, f0.im_valid, prev_lm, pos, mvalid, mdesc, nrm,
        torch.from_numpy(cand_ids), torch.arange(LML) < len(cand)))


@pytest.fixture(scope="module")
def cpu_scene():
    rig, poses, imgs = _scene("cpu")
    f0 = tframe.build_frame(torch.from_numpy(imgs[0]), rig, num_levels=2,
                            **KW)
    return rig, imgs, torch.from_numpy(imgs[1]), _seed(f0, "cpu")


def _yawed(deg, device="cpu"):
    """A predicted pose rotated by `deg` degrees about y: at 30 it takes
    frame 1 off the fast path at fastpath_frac 0.6 (a pose is still
    found)."""
    a = np.deg2rad(deg)
    T = np.eye(4, dtype=np.float32)
    T[0, 0] = T[2, 2] = np.cos(a)
    T[0, 2], T[2, 0] = np.sin(a), -np.sin(a)
    return torch.from_numpy(T).to(device)


def _step(rig, img, mapstate, frac, branch, route=orb.OrbRoute(),
          pred=None):
    """Frame 1 tracked against frame 0's map on the CPU."""
    return ttk._build_and_track_step(
        torch.Generator().manual_seed(0), img, rig, *mapstate,
        torch.eye(4) if pred is None else pred, num_levels=2,
        image_wh=rig.image_size, fastpath_frac=frac, route=route,
        branch=branch, **STEP)


def _leaves(x):
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _leaves(v)]
    return [x]


@pytest.mark.parametrize("frac", [0.6, 2.0], ids=["fast_path", "portfolio"])
@pytest.mark.parametrize("route", list(ROUTES))
def test_device_branch_step_is_capture_safe(cpu_scene, route, frac):
    """What the card captures makes no host read and no host upload (its
    constants come from graphs.const after a first call, as the warm-up
    makes them before the capture), and equals the host branch."""
    rig, _, img, mapstate = cpu_scene
    _step(rig, img, mapstate, frac, "device", ROUTES[route])
    with CaptureGuard() as guard:
        out = _step(rig, img, mapstate, frac, "device", ROUTES[route])
    assert not guard.seen, dict(guard.seen)
    assert out[-1][20] == (1.0 if frac < 1.0 else 0.0)
    ref = _step(rig, img, mapstate, frac, "host", ROUTES[route])
    assert all(torch.equal(a, b) for a, b in zip(_leaves(out), _leaves(ref)))


def test_device_branch_follows_the_predicted_pose(cpu_scene):
    """One fastpath_frac, the branch flipped by the predicted pose alone
    (identity: fast path; yawed 30 degrees: the portfolio; identity):
    each call capture-safe and equal to the host branch."""
    rig, _, img, mapstate = cpu_scene
    flags = []
    for pred in (torch.eye(4), _yawed(30.0), torch.eye(4)):
        with CaptureGuard() as guard:
            out = _step(rig, img, mapstate, 0.6, "device", pred=pred)
        assert not guard.seen, dict(guard.seen)
        ref = _step(rig, img, mapstate, 0.6, "host", pred=pred)
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(out), _leaves(ref)))
        flags.append(float(out[-1][20]))
        assert out[-1][19] == 1.0  # a pose was found
    assert flags == [1.0, 0.0, 1.0]


def test_guard_sees_the_host_branch_read(cpu_scene):
    """The guard is not blind: the host branch reads the decision."""
    rig, _, img, mapstate = cpu_scene
    with CaptureGuard() as guard:
        _step(rig, img, mapstate, 0.6, "host")
    assert any(name == "aten._local_scalar_dense.default"
               and "tracking_kernels.py" in where
               for name, where in guard.seen)


@pytest.mark.parametrize("iters", [1, 3])
def test_window_solve_is_capture_safe(cpu_scene, iters):
    rig = cpu_scene[0]
    f = tsyn.random_window_ba_problem(rig, num_lms=64, obs_capacity=6 * 128,
                                      px_noise=0.5)
    problem = ba.problem_from_numpy(**dict(f, device="cpu"))
    ref = ba.ba_solve(problem, iters=iters, kf_blocked=True)
    with CaptureGuard() as guard:
        res = ba.ba_solve(problem, iters=iters, kf_blocked=True)
    assert not guard.seen, dict(guard.seen)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))


@pytest.mark.parametrize("frac", [0.95, 2.0], ids=["frac095", "portfolio"])
def test_device_branch_matches_jax(frac):
    """The branch as the graph takes it against the JAX frame step, with
    test_torch_slice's tolerances: on the fast path the pose 1e-3 and the
    counts 2 %; off it (torch and jax.random draw different samples) the
    pose 1e-2."""
    import jax
    import jax.numpy as jnp

    from mcslam_tpu import tracking_kernels as jtk
    from mcslam_tpu.data import synthetic as jsyn
    from mcslam_tpu.frontend import frame as jframe

    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0))
    trig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0), device="cpu")
    poses = jsyn.smooth_trajectory(2, step_angle=0.02)
    imgs = jsyn.render_blob_images(
        jrig, poses, jsyn.make_landmarks(600, depth_range=(4.0, 15.0)))
    jf0 = jframe.build_frame(jnp.asarray(imgs[0]), jrig, num_levels=1, **KW)
    # frame 0's map mirror, as tests/test_torch_slice.py seeds it
    valid0 = np.asarray(jf0.im_valid) & np.asarray(jf0.im_has_depth)
    prev_lm = np.where(valid0, np.arange(M, dtype=np.int32), -1)
    pos = np.zeros((CAP, 3), np.float32)
    pos[:M] = np.asarray(jf0.im_point3d)
    mvalid = np.zeros(CAP, bool)
    mvalid[:M] = valid0
    mdesc = np.zeros((CAP, 8), np.uint32)
    mdesc[:M] = np.asarray(jf0.im_desc)
    nrm = pos / np.maximum(np.linalg.norm(pos, axis=1, keepdims=True), 1e-6)
    cand = np.flatnonzero(mvalid)[:LML]
    cand_ids = np.zeros(LML, np.int32)
    cand_ids[:len(cand)] = cand
    cand_valid = np.arange(LML) < len(cand)
    *_, jp = jtk._build_and_track_step(
        jax.random.PRNGKey(0), jnp.asarray(imgs[1]), jrig, jf0.im_desc,
        jf0.im_valid, *(jnp.asarray(a) for a in (
            prev_lm, pos, mvalid, mdesc, nrm, cand_ids, cand_valid)),
        jnp.eye(4, dtype=jnp.float32), num_levels=1, approx_topk=True,
        image_wh=jrig.image_size, fastpath_frac=frac, **STEP)
    tf0 = tframe.frame_from_numpy(jf0, device="cpu")
    mapstate = (tf0.im_desc, tf0.im_valid, torch.from_numpy(prev_lm),
                *ttk.map_mirror_from_numpy(pos, mvalid, mdesc, nrm,
                                           device="cpu"),
                torch.from_numpy(cand_ids), torch.from_numpy(cand_valid))
    kw = dict(num_levels=1, image_wh=trig.image_size, fastpath_frac=frac,
              **STEP)
    tp = ttk._build_and_track_step(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs[1]), trig,
        *mapstate, torch.eye(4), branch="device", **kw)[-1]
    host = ttk._build_and_track_step(
        torch.Generator().manual_seed(0), torch.from_numpy(imgs[1]), trig,
        *mapstate, torch.eye(4), **kw)[-1]
    assert torch.equal(tp, host)
    jp, tp = np.asarray(jp), tp.numpy()
    assert tp.shape == jp.shape == (21 + 3 * M + 16 + 2 * M,)
    off = 21 + 3 * M
    fast = jp[20] > 0.5
    assert tp[20] == jp[20]
    if frac > 1.0:
        assert not fast
    tol = 1e-3 if fast else 1e-2
    np.testing.assert_allclose(tp[:16], jp[:16], atol=tol, rtol=0)
    np.testing.assert_allclose(tp[off:off + 16], jp[off:off + 16], atol=tol,
                               rtol=0)
    if fast:
        np.testing.assert_allclose(tp[16:19], jp[16:19], rtol=0.02, atol=0)
        assert tp[19] == jp[19]
        n_lm = (jp[off + 16 + M:] > 0.5).sum()
        assert abs((tp[off + 16 + M:] > 0.5).sum() - n_lm) <= 0.02 * n_lm
    gt = np.linalg.inv(poses[0]) @ poses[1]
    assert np.abs(tp[off:off + 16].reshape(4, 4) - gt).max() < 0.1


def test_replay_launch_accounting(monkeypatch):
    """A wrapper counts the launches it makes, none under a capture (it
    records the kernel into the graph; a replay runs no wrapper)."""
    saved = collections.Counter(_build.LAUNCHES)
    try:
        _build.LAUNCHES.clear()
        # a wrapper counts only on the CUDA path, where torch has CUDA
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        _build.count("pose_lm")
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: True)
        _build.count("pose_lm")
        _build.count("ba_linearize")
        monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                            lambda: False)
        _build.count("ba_linearize")
        assert _build.LAUNCHES == collections.Counter(pose_lm=1,
                                                      ba_linearize=1)
    finally:
        _build.LAUNCHES.clear()
        _build.LAUNCHES.update(saved)


def test_trace_counts_each_wrapper_once():
    """chip_smoke counts a replay's launches in the device trace: one
    event per wrapper call (hamming_argmin2 by its merge kernel,
    intra_pairs by its link kernel; other kernels, copies and the trace's
    sentinels count nothing)."""
    import types

    import chip_smoke

    events = [types.SimpleNamespace(name=n) for n in (
        "void patch_gather_kernel<(Mode)0>(float const*, int)",
        "fast_select_kernel", "fast_select_kernel",
        "void hamming_tile_kernel<14>(unsigned int const*)",
        "hamming_merge_kernel", "pose_lm_cluster_kernel", "linearize_kernel",
        "void (anonymous namespace)::tri_refine_kernel<4>(Args)",
        "(anonymous namespace)::intra_rows_kernel(int const*)",
        "(anonymous namespace)::intra_link_kernel(unsigned char const*)",
        "mc_set_cond_kernel", "Memcpy HtoD (Pinned -> Device)",
        "at::cuda::(anonymous namespace)::spin_kernel(long)")]
    assert chip_smoke.trace_counts(events) == dict(
        fast_select=2, patch_gather=1, hamming_argmin2=1, pose_lm=1,
        ba_linearize=1, tri_refine=1, intra_pairs=1)
    assert chip_smoke.PATH == tuple(chip_smoke.TRACE_NAMES)


@pytest.mark.parametrize("flag", [True, False])
def test_cond_outside_a_capture_selects_on_the_device(flag):
    pred = torch.tensor(flag)
    calls = []

    def body(a, b):
        calls.append(1)
        return a + b, (a * b).to(torch.int32)

    a, b = torch.arange(4.0), torch.full((4,), 2.0)
    other = (torch.zeros(4), torch.full((4,), -1, dtype=torch.int32))
    with CaptureGuard() as guard:
        out = graphs.cond(pred, body, (a, b), other)
    assert not guard.seen and calls == [1]  # both sides run, no host read
    want = (a + b, (a * b).to(torch.int32)) if flag else other
    assert all(torch.equal(x, y) for x, y in zip(out, want))
    with pytest.raises(ValueError, match="0-d bool"):
        graphs.cond(torch.tensor([flag]), body, (a, b), other)


def test_const_is_made_once_per_key_and_device():
    made = []

    def make():
        made.append(1)
        return np.arange(3, dtype=np.float32)

    key = ("test_torch_graphs", 3)
    t1 = graphs.const(key, "cpu", make)
    t2 = graphs.const(key, torch.device("cpu"), make)
    assert t1 is t2 and made == [1] and t1.tolist() == [0.0, 1.0, 2.0]
    v = graphs.values((1, 2), torch.int64, "cpu")
    assert v.dtype == torch.int64 and v.tolist() == [1, 2]
    assert graphs.values((1, 2), torch.int64, "cpu") is v


def test_cpu_session_takes_the_eager_path(cpu_scene):
    """A CPU session never touches the program caches."""
    rig, imgs, _, _ = cpu_scene
    slam = MultiCameraSLAM(rig, SlamConfig(window_size=3, ba_obs_capacity=
                                           1536, ba_lm_capacity=256,
                                           local_map_landmarks=256))
    assert slam.cuda_graphs is False
    for k in range(2):
        slam.process_image(imgs[k], k / 20.0,
                           extract_cfg=dict(num_levels=2, **KW))
    assert slam.stats["frames"] == 2 and slam.stats.get("track_dispatch")
    assert not slam._frame_programs.programs
    assert not slam._solve_programs.programs


def _vio_problem(gps, device="cpu"):
    """synthetic.random_vio_problem at tests/test_torch_vio.py's small
    shape (K=4, C=2, L=256, Ok=400; 3 GPS factors, 2 valid) -> (rig,
    problem)."""
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(num_cams=2),
                                  device=device)
    f = tsyn.random_vio_problem(rig, num_kfs=4, num_lms=256,
                                obs_capacity=1600, num_gps=3 if gps else 0,
                                seed=7)
    return rig, ba_vio.problem_from_numpy(**dict(f, device=device))


@pytest.mark.parametrize("gps", [True, False], ids=["gps", "no_gps"])
@pytest.mark.parametrize("iters", [1, 8], ids=["warm", "cold"])
def test_vio_solve_is_capture_safe(iters, gps):
    """What _replay_vio_solve captures: the solve of the flattened problem
    (every field a tensor, the factor tables' index columns among them:
    the program's inputs) makes no op a capture refuses, and equals the
    solve of the problem itself bit for bit."""
    _, problem = _vio_problem(gps)
    ref = ba_vio.vio_solve(problem, iters=iters, kf_blocked=True)
    flat, present = ba_vio._flatten(problem)
    assert present == (True, gps, False)
    assert all(isinstance(t, torch.Tensor) for t in flat)
    p = ba_vio._unflatten(flat, present, problem.g_norm)
    assert p.g_norm == problem.g_norm
    assert all(getattr(t, f).dtype == torch.int32
               for t in (p.imu, p.gps) if t is not None
               for f in t._fields if f in ("i", "j", "kf"))
    with CaptureGuard() as guard:
        res = ba_vio.vio_solve(p, iters=iters, kf_blocked=True)
    assert not guard.seen, dict(guard.seen)
    assert all(torch.equal(a, b) for a, b in zip(res, ref))


def _vio_session(setup=None, frames=12):
    """tests/test_torch_slam_vio.py's feature-level VIO + GPS scene, on
    the CPU through process_frame; setup(slam) runs before the first
    frame -> the session (12 frames: 1 VIO solve; 20: 4)."""
    fps = 20.0
    rig = tsyn.make_synthetic_rig(
        tsyn.SyntheticRigSpec(num_cams=3, baseline=0.2), device="cpu")
    poses, imu_ts, gyro, accel = tsyn.analytic_circle_imu(
        frames, fps=fps, radius=4.0, omega=0.35, accel_noise=2e-3,
        gyro_noise=2e-4, stationary_s=0.3, ramp_s=0.3, seed=0)
    frames = tsyn.render_feature_frames(
        rig, poses, tsyn.make_landmarks(900, seed=1, depth_range=(5.0, 16.0)),
        tsyn.make_descriptors(900, seed=2), kps_per_cam=320, px_noise=0.3,
        desc_bit_noise=5, fps=fps, seed=3)
    slam = MultiCameraSLAM(rig, SlamConfig(
        window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
        local_map_landmarks=1024, imu_init_samples=40, kf_translation=0.1,
        kf_rotation=0.08), imu_params=ImuParams(accel_noise=2e-3,
                                                gyro_noise=2e-4),
        gps_lever_arm=np.zeros(3))
    if setup is not None:
        setup(slam)
    for k, f in enumerate(frames):
        t_prev = (k - 1) / fps if k else -1.0
        sel = (imu_ts > t_prev) & (imu_ts <= k / fps)
        ff = tframe.build_frame_from_keypoints(
            torch.from_numpy(f.uv), hamming.desc_to_torch(f.desc, "cpu"),
            torch.from_numpy(f.valid), rig, max_intra=1024)
        p = poses[k][:3, 3]
        lla = (42.36 + p[1] / 110_900.0,
               -71.06 + p[0] / (110_900.0 * np.cos(np.radians(42.36))),
               10.0 + p[2])
        slam.process_frame(ff, f.timestamp,
                           imu=(imu_ts[sel], gyro[sel], accel[sel]),
                           gps=(np.array([k / fps]), np.array([lla])))
    assert slam.imu_initialized and slam.stats.get("window_ba_vio", 0) >= 1
    return slam


def test_cpu_vio_session_takes_the_eager_path():
    """A CPU VIO + GPS session solves its windows eagerly: the program
    caches stay empty."""
    slam = _vio_session()
    assert slam.cuda_graphs is False
    assert not slam._frame_programs.programs
    assert not slam._solve_programs.programs


def test_only_warm_vio_solves_take_the_graph(monkeypatch):
    """With cuda_graphs on (the card's default), a cold VIO solve runs
    eagerly (its program would seldom repeat) and every warm one goes to
    _replay_vio_solve; here the replays are stubbed by the eager solve
    and recorded, as is every vio_solve call with its iters."""
    calls, replayed = [], []
    solve = ba_vio.vio_solve

    def recorded(problem, iters, **kw):
        calls.append(iters)
        return solve(problem, iters=iters, **kw)

    def setup(slam):
        def replay(problem, iters, gate_rounds=2):
            replayed.append(iters)
            return solve(problem, iters=iters, gate_rounds=gate_rounds,
                         kf_blocked=True)

        slam.cuda_graphs = True
        slam._replay_vio_solve = replay
        slam._replay_solve = lambda problem, iters: ba.ba_solve(
            problem, iters=iters, kf_blocked=True)

    monkeypatch.setattr(ba_vio, "vio_solve", recorded)
    slam = _vio_session(setup, frames=20)
    cfg = slam.cfg
    assert calls and calls == [cfg.ba_iters_cold] * len(calls)
    assert replayed and replayed == [cfg.ba_iters] * len(replayed)
    assert len(calls) + len(replayed) == slam.stats["window_ba_vio"]
    assert not slam._solve_programs.programs


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (captured graph against eager)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("frac", [0.6, 2.0], ids=["fast_path", "portfolio"])
def test_graphed_frame_step_equals_eager(cuda, frac):
    rig, _, imgs = _scene(cuda)
    f0 = tframe.build_frame(torch.from_numpy(imgs[0]).to(cuda), rig,
                            num_levels=2, **KW)
    mapstate = _seed(f0, cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    eye = torch.eye(4, device=cuda)
    kw = dict(num_levels=2, image_wh=rig.image_size, fastpath_frac=frac,
              **STEP)
    cache = graphs.ProgramCache(cuda, gen)

    def step(img, pred):
        return ttk._build_and_track_step(gen, img, rig, *mapstate, pred,
                                         branch="device", **kw)

    img = torch.from_numpy(imgs[1]).to(cuda)
    # the capturing call, then replays of the one program whose predicted
    # pose flips the branch on the fast-path fraction (the IF node's
    # predicate changes between replays)
    preds = (eye, eye, _yawed(30.0, cuda), eye)
    flags = []
    for pred in preds:
        state = gen.get_state()
        eager = ttk._build_and_track_step(gen, img, rig, *mapstate, pred,
                                          **kw)
        gen.set_state(state)
        out, prog = cache("step", step, (img, pred))
        assert all(torch.equal(a, b)
                   for a, b in zip(_leaves(eager), _leaves(out)))
        flags.append(out[-1][20].item())
    assert prog.replays == len(preds) and len(cache.programs) == 1
    assert flags == ([1.0, 1.0, 0.0, 1.0] if frac < 1.0 else [0.0] * 4)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 8])
def test_graphed_window_solve_equals_eager(cuda, iters):
    rig = _scene(cuda)[0]
    problem = ba.problem_from_numpy(**tsyn.random_window_ba_problem(
        rig, num_lms=256, obs_capacity=6 * 512, px_noise=0.5))
    slam = MultiCameraSLAM(rig, SlamConfig())
    stream = slam._ba_side_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        eager = ba.ba_solve(problem, iters=iters, kf_blocked=True)
        graphed = slam._replay_solve(problem, iters)
    torch.cuda.current_stream().wait_stream(stream)
    assert all(torch.equal(a, b) for a, b in zip(eager, graphed))
    assert len(slam._solve_programs.programs) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("gps", [True, False], ids=["gps", "no_gps"])
@pytest.mark.parametrize("iters", [1, 8], ids=["warm", "cold"])
def test_graphed_vio_solve_equals_eager(cuda, iters, gps):
    """One captured VIO program replays two windows whose index columns
    differ (the IMU pairs and GPS fixes rolled), each bit-equal to the
    eager solve."""
    rig, problem = _vio_problem(gps, cuda)
    imu = problem.imu._replace(i=torch.roll(problem.imu.i, 1),
                               j=torch.roll(problem.imu.j, 1))
    other = problem._replace(imu=imu, gps=None if problem.gps is None else
                             problem.gps._replace(
                                 kf=torch.roll(problem.gps.kf, 1)))
    slam = MultiCameraSLAM(rig, SlamConfig())
    for p in (problem, other):
        eager = ba_vio.vio_solve(p, iters=iters, kf_blocked=True)
        graphed = slam._replay_vio_solve(p, iters)
        assert all(torch.equal(a, b) for a, b in zip(eager, graphed))
    (prog,) = slam._solve_programs.programs.values()
    assert prog.replays == 2
