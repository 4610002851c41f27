"""Parity of the port's pose estimation (mcslam_tpu_torch.frontend:
pose_opt_cuda, pose_opt, ransac) with the JAX package on the same numpy
inputs, on the CPU. The Pallas LM runs in interpret mode; RANSAC is
compared with the same sample indices handed to both sides (torch cannot
reproduce jax.random's streams).

Tolerances: refined poses 2e-3 (the f32 sums over observations run in
another order; tests/test_pose_opt_pallas.py holds the TPU kernel to the
same bound); inlier sets equal except observations within 1e-3 of the
chi2 threshold; RANSAC best-hypothesis inlier counts within 2 % and
poses within 2e-2 (minimal-sample solves amplify f32 rounding)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu.frontend import pose_opt as jpose
from mcslam_tpu.frontend import ransac as jransac
from mcslam_tpu.frontend.pose_opt_pallas import optimize_pose_pallas
from mcslam_tpu.geometry import alignment as jalign
from mcslam_tpu.geometry import lie as jlie
from mcslam_tpu_torch.frontend import pose_opt as tpose
from mcslam_tpu_torch.frontend import pose_opt_cuda
from mcslam_tpu_torch.frontend import ransac as transac

CHI2 = pose_opt_cuda.CHI2_2DOF


def _t(x):
    return torch.from_numpy(np.array(x))


def _problem(seed, M=512, C=4, noise=0.3, outliers=0.15):
    """tests/test_pose_opt_pallas.py's resectioning problem: numpy
    arrays X, uv, per-obs cam_T_ref and fxycxy, 1/sigma^2, T_true."""
    rng = np.random.RandomState(seed)
    X = (rng.uniform(-6, 6, (M, 3)) + [0, 0, 10]).astype(np.float32)
    xi = np.asarray([0.03, -0.05, 0.02, 0.2, -0.1, 0.15], np.float32)
    T_true = np.asarray(jlie.se3_exp(jnp.asarray(xi)))
    cam = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    cam[:, 0, 3] = 0.1 * np.arange(C)
    anchor = rng.randint(0, C, M)
    f = np.tile(np.asarray([[400.0, 400.0, 320.0, 240.0]], np.float32), (C, 1))
    rTw = np.linalg.inv(T_true)
    q = X @ rTw[:3, :3].T + rTw[:3, 3]
    p = np.einsum("mij,mj->mi", cam[anchor, :3, :3], q) + cam[anchor, :3, 3]
    uv = (p[:, :2] / np.maximum(p[:, 2:], 1e-3) * f[anchor, :2]
          + f[anchor, 2:]).astype(np.float32)
    uv += rng.normal(0, noise, (M, 2)).astype(np.float32)
    out = rng.rand(M) < outliers
    uv[out] += rng.uniform(-60, 60, (out.sum(), 2)).astype(np.float32)
    sigma2 = ((1.2 ** rng.randint(0, 4, M)) ** 2).astype(np.float32)
    return dict(X=X, uv=uv, cam=cam[anchor], f=f[anchor],
                isig2=(1.0 / sigma2).astype(np.float32), T_true=T_true)


def _pallas(P, T0, mask):
    return optimize_pose_pallas(
        jnp.asarray(T0), jnp.asarray(P["X"]), jnp.asarray(P["uv"]),
        jnp.asarray(P["cam"]), jnp.asarray(P["f"]), jnp.asarray(mask),
        jnp.asarray(P["isig2"]), sched=(8, 8), interpret=True)


def _plain(P, T0, mask):
    data = pose_opt_cuda._pack_obs(_t(P["X"]), _t(P["uv"]), _t(P["cam"]),
                                   _t(P["f"]), _t(P["isig2"]))
    return pose_opt_cuda.pose_lm(_t(T0), data, _t(mask).float(), (8, 8))


def _assert_inliers_agree(chi2_ref, chi2, mask):
    a = mask & (chi2_ref < CHI2)
    b = mask & (chi2 < CHI2)
    edge = np.abs(chi2_ref - CHI2) < 1e-3
    assert np.all((a == b) | edge)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_lm_plain_matches_pallas(seed):
    P = _problem(seed)
    mask = np.ones(512, bool)
    T_ref, chi2_ref = _pallas(P, np.eye(4, dtype=np.float32), mask)
    T, chi2 = _plain(P, np.eye(4, dtype=np.float32)[None], mask[None])
    np.testing.assert_allclose(T[0].numpy(), np.asarray(T_ref), atol=2e-3,
                               rtol=0)
    assert np.abs(T[0].numpy() - P["T_true"]).max() < 5e-3
    _assert_inliers_agree(np.asarray(chi2_ref), chi2[0].numpy(), mask)


@pytest.mark.parametrize("B,M", [(2, 512), (3, 333)],
                         ids=["B2-M512", "B3-M333"])
def test_pose_lm_batch_and_mask_match_pallas(B, M):
    """A batch of candidates in one call (2: the portfolio's refine), one
    with half the observations masked off; B = 3 at an M that is no
    multiple of 128 (nor of the kernel's cluster slice) adds a candidate
    with every third observation off and a shifted start."""
    P = _problem(5, M=M)
    ar = np.arange(M)
    masks = np.stack([np.ones(M, bool), ar % 2 == 0, ar % 3 != 1][:B])
    inits = np.stack([np.eye(4, dtype=np.float32)] * B)
    if B > 2:
        inits[2, :3, 3] = [0.05, -0.03, 0.04]
    # the JAX side refines the candidates one call each (what its vmap
    # computes), reusing the compiled M=512 program: shorter problems are
    # padded with masked-off copies of their last observation, which add
    # nothing to the sums
    pad = {k: np.concatenate([v, np.repeat(v[-1:], 512 - M, 0)])
           for k, v in P.items() if k != "T_true"}
    ref = [_pallas(pad, inits[b], np.pad(masks[b], (0, 512 - M)))
           for b in range(B)]
    Ts_ref = [r[0] for r in ref]
    chi2_ref = [np.asarray(r[1])[:M] for r in ref]
    Ts, chi2 = _plain(P, inits, masks)
    for b in range(B):
        np.testing.assert_allclose(Ts[b].numpy(), np.asarray(Ts_ref[b]),
                                   atol=2e-3, rtol=0)
        _assert_inliers_agree(np.asarray(chi2_ref[b]), chi2[b].numpy(),
                              masks[b])


def test_pose_lm_ignores_masked_outliers():
    P = _problem(3, outliers=0.0)
    P["uv"][:256] += 500.0
    mask = np.arange(512) >= 256
    T, _ = _plain(P, np.eye(4, dtype=np.float32)[None], mask[None])
    T_ref, _ = _pallas(P, np.eye(4, dtype=np.float32), mask)
    assert np.abs(T[0].numpy() - P["T_true"]).max() < 5e-3
    np.testing.assert_allclose(T[0].numpy(), np.asarray(T_ref), atol=2e-3,
                               rtol=0)


def test_optimize_pose_matches_jax():
    """The port's optimize_pose (always the one-launch LM) against the
    JAX package's CPU chain (XLA LM with LU solves)."""
    P = _problem(1)
    mask = np.ones(512, bool)
    ref = jpose.optimize_pose(
        jnp.eye(4, dtype=jnp.float32), jnp.asarray(P["X"]),
        jnp.asarray(P["uv"]), jnp.asarray(P["cam"]), jnp.asarray(P["f"]),
        jnp.asarray(mask), sigma2=1.0 / jnp.asarray(P["isig2"]),
        iters=(8, 8))
    got = tpose.optimize_pose(torch.eye(4), _t(P["X"]), _t(P["uv"]),
                              _t(P["cam"]), _t(P["f"]), _t(mask),
                              sigma2=1.0 / _t(P["isig2"]), iters=(8, 8))
    np.testing.assert_allclose(got.world_T_ref.numpy(),
                               np.asarray(ref.world_T_ref), atol=2e-3, rtol=0)
    assert abs(int(got.num_inliers) - int(ref.num_inliers)) <= 0.02 * 512


def _rig_matches(seed, M=400, C=4):
    """Landmarks X_world, their rig-frame points X_rig (noisy depth),
    anchor-camera observations and the true world_T_ref."""
    rng = np.random.RandomState(seed)
    P = _problem(seed, M=M, C=C, outliers=0.2)
    rTw = np.linalg.inv(P["T_true"])
    X_rig = (P["X"] @ rTw[:3, :3].T + rTw[:3, 3]
             + 0.02 * rng.randn(M, 3)).astype(np.float32)
    return P, X_rig, rng


def _best(hyp, counts):
    b = int(np.argmax(counts))
    return hyp[b], int(counts[b])


def test_score_reprojection_matches_jax():
    P, _, rng = _rig_matches(7)
    hyp = np.asarray(jlie.se3_exp(jnp.asarray(
        np.concatenate([0.02 * rng.randn(16, 3), 0.1 * rng.randn(16, 3)], 1)
        .astype(np.float32)))) @ P["T_true"]
    mask = rng.rand(400) > 0.1
    c_ref, i_ref = jransac._score_reprojection(
        jnp.asarray(hyp), jnp.asarray(P["X"]), jnp.asarray(P["uv"]),
        jnp.asarray(P["cam"]), jnp.asarray(P["f"]), jnp.asarray(mask), 5.0)
    c, i = transac._score_reprojection(_t(hyp), _t(P["X"]), _t(P["uv"]),
                                       _t(P["cam"]), _t(P["f"]), _t(mask),
                                       5.0)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_ref))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))


def test_ransac_kabsch_with_fixed_samples_matches_jax():
    P, X_rig, rng = _rig_matches(8)
    mask = rng.rand(400) > 0.05
    idx = rng.choice(np.flatnonzero(mask), (256, 3))
    R, t = jalign.kabsch_quat(jnp.asarray(X_rig[idx]), jnp.asarray(P["X"][idx]))
    hyp_ref = np.asarray(jlie.se3_matrix(R, t))
    c_ref, _ = jransac._score_reprojection(
        jnp.asarray(hyp_ref), jnp.asarray(P["X"]), jnp.asarray(P["uv"]),
        jnp.asarray(P["cam"]), jnp.asarray(P["f"]), jnp.asarray(mask), 5.0)
    res = transac.ransac_kabsch(None, _t(X_rig), _t(P["X"]), _t(P["uv"]),
                                _t(P["cam"]), _t(P["f"]), _t(mask),
                                idx=_t(idx))
    T_ref, n_ref = _best(hyp_ref, np.asarray(c_ref))
    assert abs(int(res.num_inliers) - n_ref) <= 0.02 * n_ref
    np.testing.assert_allclose(res.world_T_ref.numpy(), T_ref, atol=2e-2,
                               rtol=0)


def _jax_pnp_hypotheses(idx, X, uv, cam, f):
    """The body of mcslam_tpu ransac_pnp after its sampling step."""
    Xs, fs = jnp.asarray(X[idx]), jnp.asarray(f[idx])
    xn_cam = (jnp.asarray(uv[idx]) - fs[..., 2:]) / fs[..., :2]
    rays = jnp.concatenate([xn_cam, jnp.ones_like(xn_cam[..., :1])], -1)
    Tcr = jnp.asarray(cam[idx])
    rays_ref = jnp.einsum("ksji,ksj->ksi", Tcr[..., :3, :3], rays)
    xn_ref = rays_ref[..., :2] / jnp.maximum(rays_ref[..., 2:], 1e-6)
    kc = idx.shape[0] // 2
    c = jransac._dlt_pnp(Xs[:kc], xn_ref[:kc])
    g = jransac._dlt_gpnp(Xs[kc:], rays[kc:], Tcr[kc:])
    return np.asarray(jlie.se3_inverse(jnp.concatenate([c, g], 0)))


def test_ransac_pnp_with_fixed_samples_matches_jax():
    P, _, rng = _rig_matches(9)
    mask = rng.rand(400) > 0.05
    idx = rng.choice(np.flatnonzero(mask), (128, 6))
    hyp_ref = _jax_pnp_hypotheses(idx, P["X"], P["uv"], P["cam"], P["f"])
    c_ref, _ = jransac._score_reprojection(
        jnp.asarray(hyp_ref), jnp.asarray(P["X"]), jnp.asarray(P["uv"]),
        jnp.asarray(P["cam"]), jnp.asarray(P["f"]), jnp.asarray(mask), 5.0)
    hyp = transac.pnp_hypotheses(_t(idx), _t(P["X"]), _t(P["uv"]),
                                 _t(P["cam"]), _t(P["f"]))
    res = transac.ransac_pnp(None, _t(P["X"]), _t(P["uv"]), _t(P["cam"]),
                             _t(P["f"]), _t(mask), idx=_t(idx))
    # the non-degenerate hypotheses agree one by one
    good = np.asarray(c_ref) >= 0.8 * np.asarray(c_ref).max()
    np.testing.assert_allclose(hyp.numpy()[good], hyp_ref[good], atol=2e-2,
                               rtol=0)
    T_ref, n_ref = _best(hyp_ref, np.asarray(c_ref))
    assert abs(int(res.num_inliers) - n_ref) <= 0.02 * n_ref
    np.testing.assert_allclose(res.world_T_ref.numpy(), T_ref, atol=2e-2,
                               rtol=0)


def test_ransac_sampling_draws_from_the_mask():
    gen = torch.Generator().manual_seed(0)
    w = torch.zeros(50)
    w[[3, 17, 40]] = 1.0
    idx = transac._sample_idx(gen, 64, 3, 50, w)
    assert idx.shape == (64, 3)
    assert set(idx.flatten().tolist()) <= {3, 17, 40}
