"""The port's window BA (backend/ba.py, ops/ba_cuda.py) against the JAX
package on the CPU, on the same numpy inputs.

Tolerances (f32, different summation orders): the plain linearization
against the Pallas kernel in interpret mode, payload / Hpp / gp to 1e-5
of their largest magnitude, r atol 1e-4 + rtol 1e-6, w atol 1e-5 (r is
pred - uv with pred up to ~1000 px on this random problem, and XLA on the
CPU contracts multiply-adds into FMAs while torch rounds each product,
so a few ulps of pred, 6e-5 each above 512 px, show); the assembled
system to 1e-5 of scale; one Schur step to 1e-4 of scale; whole solves,
poses atol 1e-3, inlier sets equal away from the chi2 threshold (within
1e-3 of 5.991 either side may gate differently), marginal_H within 1e-3
of its largest entry outside the gauge-clamped first pose, and the port's
poses within 3e-2 of ground truth (the bound of tests/test_backend.py).
The port eliminates the landmarks in float64 (backend/ba._eliminate), so
where the f32 Schur complement cancels heavily it is held to the exact
solution rather than to JAX's f32 one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mcslam_tpu.backend import ba as jba
from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.geometry import lie as jlie
from mcslam_tpu.ops.ba_pallas import linearize_payload_pallas
from mcslam_tpu_torch.backend import ba as tba
from mcslam_tpu_torch.geometry import lie as tlie
from mcslam_tpu_torch.ops import ba_cuda
from test_backend import _make_ba_problem

CHI2 = 5.991


def _rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-6))


def _random_blocked_problem():
    """The problem of tests/test_backend.py test_ba_pallas_linearize_parity:
    C=3, K=4, L=128, Ok=300 (not tile-divisible), random validity and
    sigma^2."""
    C, K, L, Ok = 3, 4, 128, 300
    O = K * Ok
    rng = np.random.RandomState(1)
    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(num_cams=C))
    poses = np.stack([np.asarray(jlie.se3_exp(jnp.asarray(rng.randn(6) * 0.1)))
                      for _ in range(K)]).astype(np.float32)
    lms = (rng.uniform(-6, 6, (L, 3)) + [0, 0, 8]).astype(np.float32)
    obs = jba.BAObservations(
        kf=jnp.asarray(np.repeat(np.arange(K, dtype=np.int32), Ok)),
        cam=jnp.asarray(rng.randint(0, C, O), jnp.int32),
        lm=jnp.asarray(rng.randint(0, L, O), jnp.int32),
        uv=jnp.asarray(rng.uniform(0, 640, (O, 2)).astype(np.float32)),
        sigma2=jnp.asarray(rng.uniform(0.5, 2.0, O).astype(np.float32)),
        valid=jnp.asarray(rng.rand(O) > 0.1),
    )
    return jba.BAProblem(
        poses=jnp.asarray(poses), landmarks=jnp.asarray(lms),
        lm_valid=jnp.asarray(rng.rand(L) > 0.05), obs=obs,
        cam_T_ref=rig.cam_T_ref, fxycxy=rig.fxycxy,
        prior_H=jnp.zeros((K * 6, K * 6)), prior_b=jnp.zeros(K * 6),
        kf_valid=jnp.ones(K, bool),
    )


def _blocked(problem):
    """Re-lay a JAX problem out in K equal contiguous blocks (as
    tests/test_backend.py test_ba_kf_blocked_assembly_matches_generic)
    -> (problem, src): src[o] is the original index of slot o, -1 for
    padding."""
    obs = problem.obs
    K = problem.poses.shape[0]
    kf = np.asarray(obs.kf)
    Ok = int(np.bincount(kf, minlength=K).max())
    src = np.full(Ok * K, -1)
    for k in range(K):
        sel = np.nonzero(kf == k)[0]
        src[k * Ok:k * Ok + len(sel)] = sel
    pad = src < 0

    def lay(arr, fill=0):
        a = np.asarray(arr)[np.maximum(src, 0)].copy()
        a[pad] = fill
        return jnp.asarray(a)

    return problem._replace(obs=jba.BAObservations(
        kf=jnp.asarray(np.repeat(np.arange(K, dtype=np.int32), Ok)),
        cam=lay(obs.cam), lm=lay(obs.lm), uv=lay(obs.uv),
        sigma2=lay(obs.sigma2, 1), valid=lay(obs.valid, False))), src


def test_ba_linearize_reference_matches_pallas():
    jp = _random_blocked_problem()
    tp = tba.problem_from_numpy(*jp)
    args = tba.linearize_inputs(tp)
    C = np.asarray(jp.cam_T_ref).shape[0]
    cam = np.asarray(jp.obs.cam)
    ctr = np.asarray(jp.cam_T_ref)
    jout = linearize_payload_pallas(
        jnp.asarray(args[0].numpy()), jp.landmarks[jp.obs.lm], jp.obs.uv,
        jnp.asarray(ctr[:, :3, :3].reshape(C, 9)[cam]),
        jnp.asarray(ctr[:, :3, 3][cam]), jnp.asarray(np.asarray(jp.fxycxy)[cam]),
        jp.obs.sigma2, jnp.asarray(args[6].numpy()), tile=256, interpret=True)
    n0 = ba_cuda.LAUNCHES
    payload, r, w, Hpp, gp = ba_cuda.ba_linearize(*args)
    assert ba_cuda.LAUNCHES == n0  # CPU tensors take the plain version
    assert payload.shape == (4, 30, 300) and Hpp.shape == (4, 36)
    for name, a, b in (("payload", payload, jout[0]), ("Hpp", Hpp, jout[3]),
                       ("gp", gp, jout[4])):
        assert _rel_err(a.numpy(), b) <= 1e-5, name
    H = Hpp.reshape(4, 6, 6)
    assert torch.equal(H, H.transpose(1, 2))  # mirrored, exactly symmetric
    np.testing.assert_allclose(r.numpy(), np.asarray(jout[1]), atol=1e-4,
                               rtol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(jout[2]), atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="unsupported device"):
        ba_cuda.ba_linearize(*(a.to("meta") for a in args))


def test_assemble_from_payload_matches_jax():
    jp = _random_blocked_problem()
    r, Jp, Jl, w = jba._residuals_and_jacobians_blocked(jp, 2.5)
    jsys = jba._assemble(jp, r, Jp, Jl, w, jba._make_onehots(jp, True), True)
    tp = tba.problem_from_numpy(*jp)
    payload, _, _, Hpp, gp = ba_cuda.ba_linearize(*tba.linearize_inputs(tp))
    tsys = tba._assemble_from_payload(tp, payload, Hpp, gp,
                                      tba._landmark_onehot(tp))
    for name, a, b in zip(("Hpp", "gp", "Hll", "gl", "Wc"), tsys, jsys):
        assert a.shape == b.shape, name
        assert _rel_err(a.numpy(), b) <= 1e-5, name


def _conditioned_system(K=3, L=50, seed=3):
    """A random well-conditioned damped system (SPD Hpp and Hll blocks,
    weak cross terms) in the layout of ba._assemble."""
    rng = np.random.RandomState(seed)
    A = rng.randn(6 * K, 6 * K)
    B = rng.randn(L, 3, 3)
    f = np.float32
    return [(A @ A.T + 6 * K * np.eye(6 * K)).astype(f),
            rng.randn(6 * K).astype(f),
            (B @ B.transpose(0, 2, 1) + 3 * np.eye(3)).astype(f),
            rng.randn(L, 3).astype(f),
            (rng.randn(K, 6, L, 3) * 0.3).astype(f)]


def _schur_f64(Hpp, gp, Hll, gl, Wc, lam):
    """The exact solution of the same damped Schur system, in numpy f64."""
    Hpp, gp, Hll, gl, Wc = (np.asarray(x, np.float64)
                            for x in (Hpp, gp, Hll, gl, Wc))
    K6, L = Hpp.shape[0], Hll.shape[0]
    Hinv = np.linalg.inv(Hll + (lam + 1e-6) * np.eye(3))
    Wm = Wc.reshape(K6, L, 3)
    WH = np.einsum("plj,ljk->plk", Wm, Hinv)
    S = Hpp + lam * np.eye(K6) - np.einsum("plk,qlk->pq", WH, Wm)
    dp = -np.linalg.solve(S, gp - np.einsum("plk,lk->p", WH, gl))
    return dp, -np.einsum("ljk,lk->lj", Hinv,
                          gl + np.einsum("plj,p->lj", Wm, dp))


@pytest.mark.parametrize("case", ["conditioned", "ba_scene"])
def test_schur_solve_matches_jax(case):
    """One damped step on the same system and lambda. On a well-conditioned
    system the two packages agree to 1e-4 of scale. On the first
    linearization of the BA scene the f32 Schur complement cancels
    heavily: there the port, which eliminates in float64, is held to
    1e-4 of the exact (f64) solution, and JAX's f32 step lies ~2e-2 from
    it (bounded at 5e-2)."""
    lam = 1e-4
    if case == "conditioned":
        sys_np = _conditioned_system()
        lm_valid = np.ones(sys_np[2].shape[0], bool)
    else:
        jp = _blocked(_make_ba_problem()[0])[0]
        r, Jp, Jl, w = jba._residuals_and_jacobians_blocked(jp, 2.5)
        sys_np = [np.array(x) for x in jba._assemble(
            jp, r, Jp, Jl, w, jba._make_onehots(jp, True), True)]
        lm_valid = np.array(jp.lm_valid)
    jdp, jdl = jba._schur_solve(*(jnp.asarray(x) for x in sys_np),
                                jnp.float32(lam), jnp.asarray(lm_valid))
    tdp, tdl = tba._schur_solve(*(torch.from_numpy(x) for x in sys_np),
                                torch.tensor(lam), torch.from_numpy(lm_valid))
    assert tdp.dtype == tdl.dtype == torch.float32
    if case == "conditioned":
        assert _rel_err(tdp.numpy(), jdp) <= 1e-4
        assert _rel_err(tdl.numpy(), jdl) <= 1e-4
    else:
        xdp, xdl = _schur_f64(*sys_np, lam)
        assert _rel_err(tdp.numpy(), xdp) <= 1e-4
        assert _rel_err(tdl.numpy(), xdl) <= 1e-4
        assert _rel_err(jdp, xdp) <= 5e-2 and _rel_err(jdl, xdl) <= 5e-2


def _near_gate(tp, res) -> np.ndarray:
    """Observations whose chi2 at the solution lies within 1e-3 of 5.991."""
    prob = tp._replace(poses=res.poses, landmarks=res.landmarks)
    r = tba._residuals_and_jacobians(prob, 2.5)[0]
    chi2 = (r * r).sum(-1) / torch.clamp(tp.obs.sigma2, min=1e-6)
    return (chi2 - CHI2).abs().numpy() < 1e-3


def _solve_both(jp, **kw):
    jres = jba.ba_solve(jp, kf_blocked=True, **kw)
    tp = tba.problem_from_numpy(*jp)
    tres = tba.ba_solve(tp, kf_blocked=True, **kw)
    np.testing.assert_allclose(tres.poses.numpy(), np.asarray(jres.poses),
                               atol=1e-3, rtol=0)
    near = _near_gate(tp, tres) | _near_gate(tp, jres._replace(
        poses=torch.from_numpy(np.array(jres.poses)),
        landmarks=torch.from_numpy(np.array(jres.landmarks))))
    same = tres.obs_inliers.numpy() == np.asarray(jres.obs_inliers)
    assert np.all(same | near)
    # marginal_H outside the gauge-clamped first pose: there (prior 1e6 on
    # a data block of ~1e7) JAX's f32 Schur complement is ~6 % off the
    # exact one at its own solution, the port's (f64 elimination) 1e-5
    mj = np.asarray(jres.marginal_H)[6:, 6:]
    mt = tres.marginal_H.numpy()[6:, 6:]
    assert np.abs(mt - mj).max() <= 1e-3 * np.abs(mj).max()
    assert int(tres.num_inliers) == int(tres.obs_inliers.sum())
    return tres


def _assert_near_truth(poses, poses_gt):
    for k in range(poses_gt.shape[0]):
        err = tlie.se3_log(tlie.se3_inverse(torch.from_numpy(poses_gt[k]))
                           @ poses[k])
        assert float(torch.linalg.vector_norm(err)) < 3e-2, k


def test_ba_solve_converges_like_jax():
    """The scene of tests/test_backend.py
    test_ba_kf_blocked_assembly_matches_generic (K=4, L=64)."""
    problem, poses_gt, lms_gt = _make_ba_problem(K=4, L=64)
    jp = _blocked(problem)[0]
    tres = _solve_both(jp, iters=4, gate_rounds=2)
    _assert_near_truth(tres.poses, poses_gt)
    # the solution fits the noisy measurements at least as well as the
    # ground truth does (tests/test_backend.py's optimality check)
    tp = tba.problem_from_numpy(*jp)
    gt_cost = float(tba._total_cost(tp._replace(
        poses=torch.from_numpy(poses_gt), landmarks=torch.from_numpy(lms_gt)),
        2.5))
    assert float(tres.cost) <= gt_cost * 1.02


def test_ba_solve_rejects_outliers_like_jax():
    """The outlier scene of tests/test_backend.py with its budget (15 LM
    steps per gate round: after 4 steps neither package has reached the
    basin, and the first gate drops most good observations in both)."""
    problem, poses_gt, _ = _make_ba_problem(seed=1)
    rng = np.random.RandomState(2)
    O = problem.obs.uv.shape[0]
    bad = rng.rand(O) < 0.1
    uv = np.asarray(problem.obs.uv).copy()
    uv[bad] += rng.uniform(30, 120, (bad.sum(), 2))
    jp, src = _blocked(problem._replace(
        obs=problem.obs._replace(uv=jnp.asarray(uv))))
    tres = _solve_both(jp, iters=15, gate_rounds=2)
    inl = tres.obs_inliers.numpy()[src >= 0]
    bad = bad[src[src >= 0]]
    assert inl[~bad].mean() > 0.9
    assert inl[bad].mean() < 0.1
    _assert_near_truth(tres.poses, poses_gt)


def test_ba_solve_refuses_generic_layout():
    jp = _random_blocked_problem()
    with pytest.raises(NotImplementedError, match="kf-blocked"):
        tba.ba_solve(tba.problem_from_numpy(*jp), kf_blocked=False)
