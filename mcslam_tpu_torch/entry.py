"""The port's counterparts of the driver contract's `entry()` and
`dryrun_multichip(n)` (the repository's __graft_entry__.py).

    fn, (example,) = entry()           # the fused frame build, on the card
    dryrun_multichip(4)                # sharded BA / frame build parity

Both run on the card unless the caller passes device="cpu".
"""

from __future__ import annotations

import numpy as np
import torch


def entry(device="cuda"):
    """The flagship forward step, the multi-camera ORB front end (pyramid,
    FAST, orientation, BRIEF, intra-rig matching, rig triangulation) of a
    4-camera VGA rig (1024 keypoints per camera, 4 levels, 2048 intra
    slots), as a callable and its example input: fn(imgs) ->
    (im_point3d, im_desc, im_valid)."""
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend import frame as frame_mod

    rig = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=4, image_size=(640, 480)),
        device=device)

    def fwd(imgs):
        ff = frame_mod.build_frame(imgs, rig, num_points=1024, num_levels=4,
                                   max_intra=2048)
        return ff.im_point3d, ff.im_desc, ff.im_valid

    rng = np.random.RandomState(0)
    example = torch.from_numpy(rng.rand(4, 480, 640).astype(np.float32))
    return fwd, (example.to(device),)


def _toy_problem(O: int, K: int = 4, L: int = 64, C: int = 2, seed: int = 0):
    """The JAX contract's consistent toy window: projected observations
    with 0.3 px noise, perturbed poses (kf 0 exact) and landmarks, as
    numpy arrays -> (poses_gt, poses0, lms0, obs fields, cam_T_ref,
    fxycxy)."""
    from mcslam_tpu_torch.geometry import lie

    rng = np.random.RandomState(seed)
    lms_gt = (rng.uniform(-3, 3, (L, 3)) + [0, 0, 8]).astype(np.float32)
    poses_gt = np.stack([lie.se3_exp(torch.tensor(np.concatenate(
        [rng.randn(3) * 0.02, rng.randn(3) * 0.1]), dtype=torch.float32)
    ).numpy() for _ in range(K)])
    fxycxy = np.tile(np.array([[400.0, 400.0, 320.0, 240.0]], np.float32),
                     (C, 1))
    cam_T_ref = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam_T_ref[1, 0, 3] = -0.2
    kf = rng.randint(0, K, O).astype(np.int32)
    cam = rng.randint(0, C, O).astype(np.int32)
    lm = rng.randint(0, L, O).astype(np.int32)
    cTw = np.einsum("oij,ojk->oik", cam_T_ref[cam],
                    np.linalg.inv(poses_gt[kf]))
    p = np.einsum("oij,oj->oi", cTw[:, :3, :3], lms_gt[lm]) + cTw[:, :3, 3]
    uv = (p[:, :2] / p[:, 2:] * fxycxy[cam, :2] + fxycxy[cam, 2:])
    uv = (uv + rng.randn(O, 2) * 0.3).astype(np.float32)
    obs = dict(kf=kf, cam=cam, lm=lm, uv=uv, sigma2=np.ones(O, np.float32),
               valid=np.ones(O, bool))
    poses0 = np.stack([lie.se3_retract(
        torch.from_numpy(poses_gt[k]),
        torch.tensor(rng.randn(6) * (0.02 if k else 0), dtype=torch.float32)
    ).numpy() for k in range(K)])
    lms0 = lms_gt + rng.randn(L, 3).astype(np.float32) * 0.05
    return poses_gt, poses0, lms0, obs, cam_T_ref, fxycxy


def _require(cond, msg: str):
    """An AssertionError (also under python -O) unless cond."""
    if not cond:
        raise AssertionError(msg)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """The sharded window-BA solves over an n-shard mesh (distinct cards
    where the machine has n, else n shards on `device`) on a tiny
    consistent problem, held to the single-device ba_solve with the
    contract's tolerances (observation-sharded: poses 2e-3, landmarks
    rtol 5e-2 / atol 2e-2, inliers within 2; landmark-sharded: poses
    1e-2, inliers within 4; both within 0.05 m of the truth); then the
    camera-sharded frame build of an n-camera rig, bit-exact against
    build_frame. Raises AssertionError on a mismatch."""
    from mcslam_tpu_torch.backend import ba
    from mcslam_tpu_torch.data import synthetic
    from mcslam_tpu_torch.frontend.frame import build_frame
    from mcslam_tpu_torch.parallel import mesh as mesh_mod
    from mcslam_tpu_torch.parallel import sharded_ba, sharded_frame

    mesh = mesh_mod.spread_mesh(n_devices, device, sharded_ba.AXIS)
    K, L = 4, 64
    # one problem size for every mesh width (divisible by any power-of-two
    # mesh up to 256), so each width solves the same problem
    O = max(256, 32 * n_devices)
    if O % n_devices:
        O = 32 * n_devices
    poses_gt, poses0, lms0, obs, cam_T_ref, fxycxy = _toy_problem(O, K, L)
    prior_H = np.zeros((K * 6, K * 6), np.float32)
    prior_H[:6, :6] = np.eye(6) * 1e6
    args = (poses0, lms0, np.ones(L, bool), np.ones(K, bool))
    consts = (cam_T_ref, fxycxy, prior_H, np.zeros(K * 6, np.float32))
    problem = ba.problem_from_numpy(
        *args[:3], ba.BAObservations(**obs), *consts[:2], *consts[2:],
        args[3], device=mesh.first)
    ref = ba.ba_solve(problem, iters=6, gate_rounds=2)
    ref_poses = ref.poses.cpu().numpy()
    _require(np.all(np.isfinite(ref_poses)), "ba_solve: non-finite poses")

    sp, sl, _, cost, n_in = sharded_ba.sharded_ba_solve(
        mesh, *args, ba.BAObservations(**obs), *consts, iters=6,
        gate_rounds=2)
    sp = sp.cpu().numpy()
    _require(np.all(np.isfinite(sp)) and np.isfinite(float(cost)),
             "sharded_ba_solve: non-finite result")
    np.testing.assert_allclose(sp, ref_poses, atol=2e-3)
    np.testing.assert_allclose(sl.cpu().numpy(), ref.landmarks.cpu().numpy(),
                               rtol=5e-2, atol=2e-2)
    _require(abs(int(n_in) - int(ref.num_inliers)) <= 2,
             "sharded_ba_solve: inlier count")
    err = np.linalg.norm(sp[1:, :3, 3] - poses_gt[1:, :3, 3])
    _require(err < 0.05, f"sharded_ba_solve: {err} m from the truth")

    obs_lm = sharded_ba.shard_by_landmark(ba.BAObservations(**obs), L,
                                          n_devices, pad_multiple=16)
    p2, _, _, c2, n2 = sharded_ba.sharded_ba_solve_lm(
        mesh, *args, obs_lm, *consts, iters=6, gate_rounds=2)
    p2 = p2.cpu().numpy()
    _require(np.all(np.isfinite(p2)) and np.isfinite(float(c2)),
             "sharded_ba_solve_lm: non-finite result")
    np.testing.assert_allclose(p2, ref_poses, atol=1e-2)
    _require(abs(int(n2) - int(ref.num_inliers)) <= 4,
             "sharded_ba_solve_lm: inlier count")
    err2 = np.linalg.norm(p2[1:, :3, 3] - poses_gt[1:, :3, 3])
    _require(err2 < 0.05, f"sharded_ba_solve_lm: {err2} m from the truth")

    # camera-sharded frame build: one camera per shard, bit-exact
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=n_devices, baseline=0.15, image_size=(128, 96),
        focal=110.0), device=mesh.first)
    fposes = synthetic.smooth_trajectory(1, radius=4.0, step_angle=0.03,
                                         seed=7)
    flms = synthetic.make_landmarks(200, seed=8, depth_range=(3.0, 9.0))
    fimgs = torch.from_numpy(np.asarray(synthetic.render_blob_images(
        rig, fposes, flms, seed=9)[0])).to(mesh.first)
    fkw = dict(num_points=64, num_levels=2, max_intra=128)
    ff_ref = build_frame(fimgs, rig, **fkw)
    ff_sh = sharded_frame.sharded_build_frame(
        mesh_mod.Mesh(mesh.devices, sharded_frame.AXIS), fimgs, rig, **fkw)
    for name in ff_ref._fields:
        _require(torch.equal(getattr(ff_sh, name).cpu(),
                             getattr(ff_ref, name).cpu()),
                 f"sharded frame field {name} diverged")
