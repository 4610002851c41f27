"""The RANSAC portfolio's kernels (frontend/ransac_cuda: csrc/ransac_score.cu,
csrc/kabsch_hyp.cu, csrc/pnp_hyp.cu).

On the CPU: each wrapper takes its plain version for CPU tensors, bit for
bit and without a launch (score: ransac._score_reprojection with the
first argmax and its gathers; kabsch_hyp: ransac.kabsch_hypotheses;
pnp_hyp: ransac.pnp_hypotheses), and so do ransac_kabsch and ransac_pnp;
the plain versions equal the JAX package's functions on the same numpy
inputs and sample indices (scores exactly; hypotheses under
chip_smoke.check_hypotheses' criteria: where their score is 0.8 of the
best within 2e-2, but where float32 rounding moves one of the two
solves by 2e-2 from the port's float64 solve, and the winner's count
within 2 %: tests/test_torch_pose.py's bounds), also on degenerate
samples (a repeated index, three collinear points, six coplanar points,
six copies of one point, whose Cholesky fails: a NaN pose, no inlier);
K = 1 and K = 3 (with a tie) give the winner, pose, count and mask of the
argmax.

On the CPU too: the Newton iteration of kabsch_hyp's plain version
(geometry/alignment.charpoly4, newton_step) stopped at lambda's first
bitwise fixed point gives the 12 steps' lambda bit for bit (the kernel's
early exit), on random, RANSAC-like and degenerate samples, NaN too.

`gpu` cases (they skip without a card) hold each kernel to its plain
version on the card at the portfolio's shapes (K = 512 Kabsch and 256 PnP
hypotheses, M = 2048) and at odd ones (K = 1, 3, 257; M = 37), on a rig
with lever arms and on a central one, under the criteria of
chip_smoke.py phase 2 (check_score, check_hypotheses): a score's inlier
flag may differ only where |err2 - px^2| <= 1e-5 px^2 (err2 in float64),
a count by at most the number of such flags, the winner only where its
margin is within them; hypotheses scoring 0.8 of the best within 2e-2 of
the plain version's, but where one of the two float32 solves is itself
2e-2 from the float64 solve (a minimal sample whose nullspace is nearly
double: five inverse-iteration steps leave it to rounding), and the
kernel no more often so than the plain version (+ 2 or 5 %); the
winner's count within 2 %; NaN in both where the sample is six copies of
one point, in one only (a pivot within float32 rounding of zero) for at
most 2 % of the hypotheses; one launch counted per call, equal across
two runs, and the score through CUDA graph replays, its count
accumulators and arrival counter back at zero after each; the score
also at shapes that cross its tiles (M one past a tile, K one past a
hypothesis tile, M < 32, tied counts), pnp_hyp at K one past a block,
M < 32 and with every sample from the camera without a lever arm, and
kabsch_hyp at K = 1, 2, 3, 5, 257, 511, 512 and 513 (no multiple of a
warp's 8 quads), with a repeated-index and a collinear sample and an
out-of-range one (its NaN pose, the others unchanged bit for bit):
    python -m pytest --noconftest tests/test_torch_ransac_kernels.py -m gpu -q
(this file imports JAX only inside the JAX comparisons)."""

import collections

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mcslam_tpu_torch import _build
from mcslam_tpu_torch.frontend import ransac, ransac_cuda

PX = 5.0
POSE_ATOL = 2e-2
COUNT_REL = 0.02


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _rodrigues(w):
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def _scene(seed, M, C=4, lever=True, outliers=0.2, noise=0.3):
    """numpy float32 arrays of a rig tracking problem: landmarks X (M, 3),
    their rig-frame points X_rig (noisy depth), pixels uv in each
    observation's camera (anchor cam_T_ref cam (M, 4, 4) and f (M, 4)),
    with noise and outliers, and the true world_T_ref T_true. lever=False
    gives a central rig (every camera at the reference's centre)."""
    rng = np.random.RandomState(seed)
    X = (rng.uniform(-6, 6, (M, 3)) + [0, 0, 10]).astype(np.float32)
    T_true = np.eye(4)
    T_true[:3, :3] = _rodrigues(np.array([0.03, -0.05, 0.02]))
    T_true[:3, 3] = [0.2, -0.1, 0.15]
    T_true = T_true.astype(np.float32)
    cams = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    for c in range(C):
        cams[c, :3, :3] = _rodrigues(np.array([0.0, 0.15 * (c - C / 2), 1e-3]))
        if lever:
            cams[c, :3, 3] = [0.1 * c, 0.02 * c, 0.0]
    anchor = rng.randint(0, C, M)
    f = np.tile(np.asarray([[400.0, 400.0, 320.0, 240.0]], np.float32), (C, 1))
    rTw = np.linalg.inv(T_true.astype(np.float64))
    q = X @ rTw[:3, :3].T + rTw[:3, 3]
    cam = cams[anchor]
    p = np.einsum("mij,mj->mi", cam[:, :3, :3], q) + cam[:, :3, 3]
    uv = (p[:, :2] / np.maximum(p[:, 2:], 1e-3) * f[anchor, :2]
          + f[anchor, 2:]).astype(np.float32)
    uv += rng.normal(0, noise, (M, 2)).astype(np.float32)
    out = rng.rand(M) < outliers
    uv[out] += rng.uniform(-60, 60, (out.sum(), 2)).astype(np.float32)
    X_rig = (q + 0.02 * rng.randn(M, 3)).astype(np.float32)
    mask = rng.rand(M) > 0.05
    return dict(X=X, X_rig=X_rig, uv=uv, cam=cam, f=f[anchor].copy(),
                mask=mask, T_true=T_true, rng=rng)


def _t(x, dev="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dev)


def _obs(P, dev="cpu"):
    return (_t(P["X"], dev), _t(P["uv"], dev), _t(P["cam"], dev),
            _t(P["f"], dev), _t(P["mask"], dev))


def _samples(P, K, S):
    return P["rng"].choice(np.flatnonzero(P["mask"]), (K, S))


def _perturbed(P, K, scale=0.02):
    """K world_T_ref hypotheses around T_true (a few far off)."""
    rng = P["rng"]
    out = np.tile(P["T_true"], (K, 1, 1)).astype(np.float64)
    for k in range(K):
        s = scale * (10.0 if k % 7 == 3 else 1.0)
        R = _rodrigues(s * rng.randn(3) + 1e-9)
        out[k, :3, :3] = R @ out[k, :3, :3]
        out[k, :3, 3] += 5 * s * rng.randn(3)
    return out.astype(np.float32)


# ---- CPU: the wrappers take the plain versions ----------------------------

def test_wrappers_on_cpu_take_the_plain_versions_bit_for_bit():
    P = _scene(1, 300)
    obs = _obs(P)
    hyp = _t(_perturbed(P, 24))
    before = collections.Counter(_build.LAUNCHES)
    got = ransac_cuda.score(hyp, *obs, PX)
    counts, inl = ransac._score_reprojection(hyp, *obs, PX)
    b = int(torch.argmax(counts))
    assert torch.equal(got[0], counts) and int(got[1]) == b
    assert torch.equal(got[2], hyp[b]) and torch.equal(got[4], inl[b])
    assert got[3].dtype == torch.int32 and int(got[3]) == int(counts[b])
    idx3, idx6 = _t(_samples(P, 32, 3)), _t(_samples(P, 32, 6))
    assert cs.same_bits(ransac_cuda.kabsch_hyp(idx3, _t(P["X_rig"]), obs[0]),
                 ransac.kabsch_hypotheses(idx3, _t(P["X_rig"]), obs[0]))
    assert cs.same_bits(ransac_cuda.pnp_hyp(idx6, *obs[:4]),
                 ransac.pnp_hypotheses(idx6, *obs[:4]))
    assert _build.LAUNCHES == before


def test_ransac_on_cpu_composes_the_plain_versions():
    """ransac_kabsch / ransac_pnp on CPU tensors: the plain hypotheses,
    _score_reprojection and the first argmax, bit for bit."""
    P = _scene(2, 300)
    obs = _obs(P)
    for fn, idx, hyp in (
            (ransac.ransac_kabsch, _t(_samples(P, 64, 3)),
             lambda i: ransac.kabsch_hypotheses(i, _t(P["X_rig"]), obs[0])),
            (ransac.ransac_pnp, _t(_samples(P, 64, 6)),
             lambda i: ransac.pnp_hypotheses(i, *obs[:4]))):
        args = (_t(P["X_rig"]), *obs) if fn is ransac.ransac_kabsch else obs
        res = fn(None, *args, px_thresh=PX, min_inliers=10, idx=idx)
        h = hyp(idx)
        counts, inl = ransac._score_reprojection(h, *obs, PX)
        b = int(torch.argmax(counts))
        assert torch.equal(res.world_T_ref, h[b])
        assert torch.equal(res.inliers, inl[b])
        assert res.num_inliers.dtype == torch.int32
        assert int(res.num_inliers) == int(counts[b])
        assert bool(res.ok) == (int(counts[b]) >= 10)


@pytest.mark.parametrize("K", [1, 3])
def test_score_small_batches_pick_the_first_argmax(K):
    """K = 1 (the motion candidate's score) and K = 3 (the portfolio's
    re-score, two hypotheses tied): the winner, pose, count and mask."""
    P = _scene(3, 200)
    obs = _obs(P)
    hyp = _perturbed(P, K, scale=0.005)
    if K == 3:
        hyp[2] = hyp[1]  # a tie: the first wins
    hyp = _t(hyp)
    counts, best, pose, n, inl = ransac_cuda.score(hyp, *obs, PX)
    want, flags = ransac._score_reprojection(hyp, *obs, PX)
    b = int(torch.argmax(want))
    assert torch.equal(counts, want) and best.tolist() == [b]
    assert torch.equal(pose, hyp[b]) and torch.equal(inl, flags[b])
    assert int(n) == int(want[b]) > 0
    if K == 3:
        assert int(want[1]) == int(want[2]) and b != 2


# ---- CPU: the plain versions against the JAX package ----------------------

def _jax_score(hyp, P, X=None):
    import jax.numpy as jnp
    from mcslam_tpu.frontend import ransac as jransac

    c, _ = jransac._score_reprojection(
        jnp.asarray(hyp), jnp.asarray(P["X"] if X is None else X),
        jnp.asarray(P["uv"]), jnp.asarray(P["cam"]), jnp.asarray(P["f"]),
        jnp.asarray(P["mask"]), PX)
    return np.asarray(c)


def _jax_kabsch(idx, X_rig, X):
    import jax.numpy as jnp
    from mcslam_tpu.geometry import alignment as jalign
    from mcslam_tpu.geometry import lie as jlie

    R, t = jalign.kabsch_quat(jnp.asarray(X_rig[idx]), jnp.asarray(X[idx]))
    return np.asarray(jlie.se3_matrix(R, t))


def _jax_pnp(idx, X, uv, cam, f):
    """mcslam_tpu ransac_pnp's hypotheses after its sampling step (the
    generalized half for a rig with lever arms, else central)."""
    import jax.numpy as jnp
    from mcslam_tpu.frontend import ransac as jransac
    from mcslam_tpu.geometry import lie as jlie

    Xs, fs = jnp.asarray(X[idx]), jnp.asarray(f[idx])
    xn_cam = (jnp.asarray(uv[idx]) - fs[..., 2:]) / fs[..., :2]
    rays = jnp.concatenate([xn_cam, jnp.ones_like(xn_cam[..., :1])], -1)
    Tcr = jnp.asarray(cam[idx])
    rays_ref = jnp.einsum("ksji,ksj->ksi", Tcr[..., :3, :3], rays)
    xn_ref = rays_ref[..., :2] / jnp.maximum(rays_ref[..., 2:], 1e-6)
    kc = idx.shape[0] // 2
    c = jransac._dlt_pnp(Xs[:kc], xn_ref[:kc])
    if np.abs(cam[:, :3, 3]).max() > 0:
        g = jransac._dlt_gpnp(Xs[kc:], rays[kc:], Tcr[kc:])
    else:
        g = jransac._dlt_pnp(Xs[kc:], xn_ref[kc:])
    return np.asarray(jlie.se3_inverse(jnp.concatenate([c, g], 0)))


def _hold(h, h64, h_ref, P):
    """The port's plain hypotheses h (h64 in float64) against the JAX
    package's h_ref under chip_smoke.check_hypotheses' criteria (the
    bounds of tests/test_torch_pose.py per hypothesis, but where float32
    rounding moves one of the two solves by the bound itself)."""
    return cs.check_hypotheses(
        "plain vs JAX", h, torch.tensor(h_ref), h64,
        torch.tensor(_jax_score(h.numpy(), P)),
        torch.tensor(_jax_score(h_ref, P)))


def test_score_plain_matches_jax():
    P = _scene(4, 400)
    hyp = _perturbed(P, 40)
    hyp[5] = np.nan  # a NaN hypothesis scores no inlier
    counts, _ = ransac._score_reprojection(_t(hyp), *_obs(P), PX)
    want = _jax_score(hyp, P)
    np.testing.assert_array_equal(counts.numpy(), want)
    assert want[5] == 0 and want.max() > 100


@pytest.mark.parametrize("lever", [True, False])
def test_kabsch_plain_matches_jax(lever):
    P = _scene(5, 400, lever=lever)
    idx = _samples(P, 64, 3)
    h = ransac.kabsch_hypotheses(_t(idx), _t(P["X_rig"]), _t(P["X"]))
    h64 = ransac.kabsch_hypotheses(_t(idx), _t(P["X_rig"]).double(),
                                   _t(P["X"]).double())
    st = _hold(h, h64, _jax_kabsch(idx, P["X_rig"], P["X"]), P)
    assert st["good"] - st["rounding"] >= 4 and st["plain_best"] > 200


@pytest.mark.parametrize("lever", [True, False])
def test_pnp_plain_matches_jax(lever):
    P = _scene(6, 400, lever=lever, outliers=0.05, noise=0.1)
    idx = _samples(P, 64, 6)
    obs = _obs(P)
    h = ransac.pnp_hypotheses(_t(idx), *obs[:4])
    h64 = ransac.pnp_hypotheses(_t(idx), *(o.double() for o in obs[:4]))
    st = _hold(h, h64, _jax_pnp(idx, P["X"], P["uv"], P["cam"], P["f"]), P)
    assert st["good"] - st["rounding"] >= 4 and st["plain_best"] > 200


def test_degenerate_kabsch_samples_match_jax():
    """A repeated index, one point three times and three collinear points:
    the rotation about the line is free; both packages give the same
    finite pose and score."""
    P = _scene(7, 400)
    X, Xr = P["X"].copy(), P["X_rig"].copy()
    X[10] = 0.5 * (X[11] + X[12])
    Xr[10] = 0.5 * (Xr[11] + Xr[12])
    P["X"] = X
    idx = np.array([[5, 5, 9], [5, 5, 5], [10, 11, 12], [3, 50, 200]])
    h = ransac.kabsch_hypotheses(_t(idx), _t(Xr), _t(X)).numpy()
    h_ref = _jax_kabsch(idx, Xr, X)
    assert np.isfinite(h).all() and np.isfinite(h_ref).all()
    np.testing.assert_allclose(h, h_ref, atol=POSE_ATOL, rtol=0)
    c, c_ref = _jax_score(h, P), _jax_score(h_ref, P)
    assert np.all(np.abs(c - c_ref) <= COUNT_REL * np.maximum(c_ref, 1))


def test_degenerate_pnp_samples_match_jax():
    """A repeated index and six coplanar points (both forms of the DLT):
    no pose worth an inlier in either package; six copies of one point:
    the Cholesky fails, a NaN pose in both, no inlier."""
    P = _scene(8, 400)
    X = P["X"].copy()
    X[20:26, 2] = 10.0  # coplanar: z = 10
    P["X"] = X
    rows = [[1, 1, 3, 4, 5, 6], list(range(20, 26)), [7] * 6]
    idx = np.array(rows * 2)  # central, then generalized
    obs = _obs(P)
    h = ransac.pnp_hypotheses(_t(idx), *obs[:4]).numpy()
    h_ref = _jax_pnp(idx, X, P["uv"], P["cam"], P["f"])
    nan, nan_ref = (np.isnan(x).any(axis=(1, 2)) for x in (h, h_ref))
    np.testing.assert_array_equal(nan, nan_ref)
    assert nan.tolist() == [False, False, True] * 2
    c, c_ref = _jax_score(h, P), _jax_score(h_ref, P)
    assert c.max() <= 5 and c_ref.max() <= 5
    assert c[2] == c[5] == c_ref[2] == c_ref[5] == 0


# ---- CPU: models of the kernels' plans ------------------------------------

def _score_plan(K, M):
    """csrc/ransac_score.cu's plan(): (GW, J, MT, HT, m-tiles, k-tiles)."""
    hl = 4 if K >= 4 else (2 if K >= 2 else 1)
    gw = 4 // hl
    mt = 32 * gw
    nmt = -(-M // mt) if M > 0 else 1
    want = hl * 1024
    j = min(max(1, -(-K * nmt // want)), 64 // hl, -(-K // hl))
    return gw, j, mt, hl * j, nmt, -(-K // (hl * j))


def _score_model(hyp, X, uv, cam, f, mask, px):
    """The plan of csrc/ransac_score.cu on the plain version's flags: the
    2-D grid of tiles, each warp's ballot of 32 flags a word of a bit row,
    the words' popcounts added to per-hypothesis counts, one arrival per
    block; the last block's first argmax and the winner's row expanded
    into its mask -> (counts, best, pose, count, inliers), the rows and
    how often each word was written."""
    counts_ref, flags = ransac._score_reprojection(hyp, X, uv, cam, f, mask,
                                                   px)
    K, M = flags.shape
    W = (M + 31) // 32
    padded = np.zeros((K, W * 32), bool)
    padded[:, :M] = flags.numpy()
    words = (padded.reshape(K, W, 32).astype(np.uint64)
             << np.arange(32, dtype=np.uint64)).sum(-1)
    gw, j, mt, ht, nmt, nkt = _score_plan(K, M)
    hl = 4 // gw
    rows = np.full((K, W), 0xDEADBEEF, np.uint64)
    writes = np.zeros((K, W), np.int64)
    acc = np.zeros(K + 1, np.int64)
    for bx in range(nmt):
        for by in range(nkt):
            m0, k0 = bx * mt, by * ht
            for warp in range(4):
                g, h = warp % gw, warp // gw
                word = m0 // 32 + g
                if word >= W:
                    continue
                for i in range(j):
                    k = k0 + h + i * hl
                    if k >= K:
                        break
                    rows[k, word] = words[k, word]
                    writes[k, word] += 1
                    acc[k] += bin(int(words[k, word])).count("1")
            acc[K] += 1
    assert acc[K] == nmt * nkt  # the last block saw every arrival
    counts = torch.from_numpy(acc[:K].copy())
    keys = [(int(c) << 32) | (0xFFFFFFFF - k) for k, c in enumerate(acc[:K])]
    b = 0xFFFFFFFF - (max(keys) & 0xFFFFFFFF)
    inl = torch.from_numpy(
        ((rows[b, np.arange(M) // 32] >> (np.arange(M) % 32).astype(
            np.uint64)) & 1).astype(bool))
    return ((counts, torch.tensor([b]), hyp[b], torch.tensor(
        int(acc[b]), dtype=torch.int32), inl), rows, writes, counts_ref)


@pytest.mark.parametrize("K,M,case", [
    *[(K, M, "nan") for K in (1, 3, 257, 512) for M in (37, 2048, 2049)],
    (3, 2048, "masked"), (512, 37, "masked"), (3, 37, "tie"),
    (257, 2049, "tie"), (512, 2048, "tie")])
def test_score_plan_model_matches_the_plain_score(K, M, case):
    """A model of ransac_score.cu's tiles, bit rows, count atomics, arrival
    and mask expansion, on the plain version's flags: every bit-row word
    written once, and the counts, the winner (the first of the largest)
    and its mask equal to score_reference's."""
    P = _scene(70 + K, M)
    hyp = _perturbed(P, K)
    if case == "nan":
        hyp[K // 2] = np.nan
    if case == "masked":
        P["mask"][:] = False
    if case == "tie":  # hypothesis 0 far off, every later one the same pose
        hyp[1:] = P["T_true"]
        hyp[0, :3, 3] += 3.0
    hyp = _t(hyp)
    obs = _obs(P)
    got, rows, writes, counts = _score_model(hyp, *obs, PX)
    want = ransac_cuda.score_reference(hyp, *obs, PX)
    assert (writes == 1).all() and (rows <= 0xFFFFFFFF).all()
    assert torch.equal(got[0], want[0]) and torch.equal(got[0], counts)
    assert torch.equal(got[1], want[1]) and cs.same_bits(got[2], want[2])
    assert int(got[3]) == int(want[3]) and torch.equal(got[4], want[4])
    if case == "nan":
        assert int(want[0][K // 2]) == 0 and (K == 1 or M < 100
                                               or int(want[3]) > 0)
    if case == "masked":
        assert int(want[0].abs().sum()) == 0 and int(want[1]) == 0
    if case == "tie":
        assert int(want[1]) == 1 and int(want[0][1]) == int(want[0][-1]) > 0
    gw, j, mt, ht, nmt, nkt = _score_plan(K, M)
    assert {(1, 2048): 16, (3, 2048): 64, (512, 2048): 1024}.get(
        (K, M), nmt * nkt) == nmt * nkt


def _fma(a, b, c):
    """float32 fused multiply-add (the product exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def _warp_sum(x):
    """csrc/pnp_hyp.cu's warp_sum: a butterfly over 32 lanes (x (K, N))."""
    v = torch.zeros(x.shape[0], 32, dtype=torch.float32)
    v[:, :x.shape[1]] = x
    lane = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        v = v + v[:, lane ^ off]
    return v[:, :1]


def _nullspace_recip(A, second=False, iters=5):
    """A float32 model of csrc/pnp_hyp.cu's null vectors in its order of
    operations: G by rows (fused multiply-adds over A's rows in order),
    the trace shift, the right-looking Cholesky factor with one
    reciprocal per pivot (lanes i > j multiply by it), both triangular
    sweeps of every solve as a fused multiply-add a step on the row and
    the column scaled by 1 / L_ii, butterfly norms and dots. A NaN vector
    where a pivot is not positive (the kernel's NaN pose)."""
    A = A.float()
    K_, R, N = A.shape
    G = torch.zeros(K_, N, N)
    for r in range(R):
        G = _fma(A[:, r, :, None], A[:, r, None, :], G)
    tr = torch.zeros(K_)
    for i in range(N):
        tr = tr + G[:, i, i]
    eps = tr / float(N) * 1e-7 + 1e-12
    a = G.clone()
    idx = torch.arange(N)
    a[:, idx, idx] = a[:, idx, idx] + eps[:, None]
    fail = torch.zeros(K_, dtype=torch.bool)
    r = torch.zeros(K_, N)
    for j in range(N):
        piv = a[:, j, j].clone()
        fail = fail | ~(piv > 0)
        d = torch.sqrt(piv)
        rj = 1.0 / d
        col = a[:, :, j] * rj[:, None]
        col[:, j] = d
        a[:, :, j] = col
        r[:, j] = rj
        if j + 1 < N:
            a[:, :, j + 1:] = _fma(-col[:, :, None], col[:, None, j + 1:],
                                   a[:, :, j + 1:])
    L = torch.tril(a)
    lrow = L * r[:, :, None]  # lrow[i, j] = L_ij / L_ii
    lcol = L.transpose(1, 2) * r[:, :, None]  # lcol[i, j] = L_ji / L_ii

    def solve(x):
        x = x * r
        for j in range(N - 1):
            x[:, j + 1:] = _fma(-lrow[:, j + 1:, j], x[:, j:j + 1],
                                x[:, j + 1:])
        x = x * r
        for j in range(N - 1, 0, -1):
            x[:, :j] = _fma(-lcol[:, :j, j], x[:, j:j + 1], x[:, :j])
        return x

    def normalize(x):
        return x * torch.rsqrt(torch.clamp(_warp_sum(x * x), min=1e-30))

    ar = torch.arange(N, dtype=torch.float32)
    v = torch.cos(ar * 1.7 + 0.3).expand(K_, N).clone()
    for _ in range(iters):
        v = normalize(solve(v))
    nan = torch.full_like(v, float("nan"))
    if not second:
        return torch.where(fail[:, None], nan, v)
    w = torch.sin(ar * 2.3 + 1.1).expand(K_, N).clone()
    for _ in range(iters):
        w = solve(w)
        w = w - _warp_sum(w * v) * v
        w = normalize(w)
    return torch.where(fail[:, None], nan, v), torch.where(fail[:, None],
                                                           nan, w)


@pytest.mark.parametrize("lever,cam0", [(True, False), (False, False),
                                        (True, True)])
def test_pnp_recip_model_holds_the_criteria(monkeypatch, lever, cam0):
    """The float32 model of pnp_hyp.cu's solve order (reciprocal pivots,
    G by rows, the right-looking factor) in the plain version's
    hypotheses, against the plain version in float64 under
    chip_smoke.check_hypotheses' criteria, at the scenes of
    test_pnp_kernel_matches_plain (K = 256, M = 2048, the central and the
    lever rig, with the degenerate six-copy samples; also every sample
    from the camera without a lever arm)."""
    K, M = 256, 2048
    P = _scene(30 + K, M, lever=lever, outliers=0.1, noise=0.2)
    obs = _obs(P)
    if cam0:
        central = np.abs(P["cam"][:, :3, 3]).max(axis=1) == 0
        idx = P["rng"].choice(np.flatnonzero(P["mask"] & central), (K, 6))
    else:
        idx = _samples(P, K, 6)
    # six copies of one point (whether such a factor fails is a matter of
    # rounding: planted where test_pnp_kernel_matches_plain plants them)
    planted = () if cam0 else (2, K - 1)
    for k in planted:
        idx[k] = idx[k, 0]
    idx = _t(idx)
    hp = ransac.pnp_hypotheses(idx, *obs[:4])
    h64 = ransac.pnp_hypotheses(idx, *(o.double() for o in obs[:4]))
    monkeypatch.setattr(ransac, "_nullspace_vecs", _nullspace_recip)
    hm = ransac.pnp_hypotheses(idx, *obs[:4])
    monkeypatch.undo()
    st = cs.check_hypotheses(
        "model vs plain", hm, hp, h64,
        ransac._score_reprojection(hm, *obs, PX)[0],
        ransac._score_reprojection(hp, *obs, PX)[0], structural=planted)
    assert st["good"] - st["rounding"] >= 4 and st["plain_best"] > 200


# ---- gpu: the kernels against their plain versions on the card ------------

def _check_score(hyp, obs, px=PX):
    """The score kernel against its plain version (chip_smoke.check_score),
    equal across two runs."""
    k = ransac_cuda.score(hyp, *obs, px)
    k2 = ransac_cuda.score(hyp, *obs, px)
    counts, flags = ransac._score_reprojection(hyp, *obs, px)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(k, k2))
    assert torch.equal(k[2], hyp[int(k[1])])
    cs.check_score("score", k, counts, flags,
                   cs.score_edges(hyp, *obs[:4], px))
    return k


def _check_hyp(hyp, plain, obs, structural=()):
    """Hypotheses against the plain version's (plain(dtype) runs it) under
    chip_smoke.check_hypotheses' criteria."""
    ref, ref64 = plain(torch.float32), plain(torch.float64)
    return cs.check_hypotheses(
        "kernel vs plain", hyp, ref, ref64,
        ransac._score_reprojection(hyp, *obs, PX)[0],
        ransac._score_reprojection(ref, *obs, PX)[0], structural)


def _counted(name, fn):
    before = _build.LAUNCHES[name]
    out = fn()
    assert _build.LAUNCHES[name] - before == 1
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("K,M,tie", [
    (1, 2048, False), (3, 2048, False), (512, 2048, False), (257, 37, False),
    (1, 37, False),
    # M one past a tile of correspondences (128 at K = 1, 64 at K = 2-3, 32
    # from K = 4), K one past a tile of hypotheses (4 at K = 33, M = 2048),
    # M < 32, tied counts (the first of the largest wins)
    (1, 129, False), (3, 65, False), (512, 2049, False), (33, 2048, False),
    (3, 20, False), (512, 20, False), (3, 2048, True), (512, 2049, True)])
def test_score_kernel_matches_plain(cuda, K, M, tie):
    P = _scene(10 + K, M)
    obs = _obs(P, cuda)
    hyp = _perturbed(P, K)
    if K > 3:
        hyp[7] = np.nan
    if tie:  # hypothesis 0 far off, every later one the same pose
        hyp[1:] = P["T_true"]
        hyp[0, :3, 3] += 3.0
    hyp = _t(hyp, cuda)
    _counted("ransac_score", lambda: ransac_cuda.score(hyp, *obs, PX))
    k = _check_score(hyp, obs)
    if K > 3 and not tie:
        assert int(k[0][7]) == 0
    if tie:
        counts = ransac._score_reprojection(hyp, *obs, PX)[0]
        assert torch.equal(k[0], counts) and int(counts[1]) > int(counts[0])
        assert int(k[1]) == 1 == int(torch.argmax(counts))


@pytest.mark.gpu
@pytest.mark.parametrize("K,M,lever", [
    (512, 2048, True), (257, 37, True), (3, 2048, False), (1, 400, True),
    # K no multiple of a block's or a warp's quads (8 hypotheses a warp)
    (2, 2048, True), (5, 2048, False), (511, 2048, True),
    (513, 2048, True)])
def test_kabsch_kernel_matches_plain(cuda, K, M, lever):
    """kabsch_hyp against its plain version (check_hypotheses), twice
    alike, one launch a call; with K >= 5 also a sample with a repeated
    index and one of three collinear points (planted), and a sample
    out of range (index M, then -1): NaN rows 0-2 and (0, 0, 0, 1) in its
    hypothesis, every other hypothesis bit for bit as without it."""
    P = _scene(20 + K, M, lever=lever)
    if K >= 5:  # point 10 on the segment between 11 and 12, both frames
        for key in ("X", "X_rig"):
            P[key][10] = 0.5 * (P[key][11] + P[key][12])
    obs = _obs(P, cuda)
    idx_np = _samples(P, K, 3)
    if K >= 5:
        idx_np[1] = [5, 5, 9]
        idx_np[3] = [10, 11, 12]
    idx = _t(idx_np, cuda)
    X_rig = _t(P["X_rig"], cuda)
    h = _counted("kabsch_hyp",
                 lambda: ransac_cuda.kabsch_hyp(idx, X_rig, obs[0]))
    assert cs.same_bits(h, ransac_cuda.kabsch_hyp(idx, X_rig, obs[0]))
    _check_hyp(h, lambda dt: ransac.kabsch_hypotheses(
        idx, X_rig.to(dt), obs[0].to(dt)), obs)
    if K >= 5:
        assert torch.isfinite(h[[1, 3]]).all()
        for bad in (M, -1):
            out = idx.clone()
            out[K - 2, 1] = bad
            ho = ransac_cuda.kabsch_hyp(out, X_rig, obs[0])
            torch.cuda.synchronize()
            assert torch.isnan(ho[K - 2, :3]).all()
            assert torch.equal(ho[K - 2, 3], torch.tensor(
                [0.0, 0.0, 0.0, 1.0], device=cuda))
            keep = torch.arange(K, device=cuda) != K - 2
            assert cs.same_bits(ho[keep], h[keep])


def _lam_both_ways(K_):
    """lambda after _dominant_eigvec4's 12 Newton steps, and lambda when
    each matrix stops at its first bitwise fixed point (its later steps
    skipped), in alignment's arithmetic; and the steps to that point."""
    from mcslam_tpu_torch.geometry import alignment

    a3, a2, a1, a0, lam = alignment.charpoly4(K_)
    full, early = lam, lam.clone()
    going = torch.ones(lam.shape, dtype=torch.bool)
    for _ in range(alignment.NEWTON_STEPS):
        full = alignment.newton_step(full, a3, a2, a1, a0)
        nxt = alignment.newton_step(early, a3, a2, a1, a0)
        fixed = torch.eq(nxt.view(torch.int32), early.view(torch.int32))
        early = torch.where(going, nxt, early)
        going = going & ~fixed
    return full, early, alignment.newton_fixed_steps(K_)


def test_newton_stops_exactly_at_its_fixed_point():
    """csrc/kabsch_hyp.cu's early Newton exit on the CPU, in float32: on
    Davenport matrices of random and RANSAC-like samples and of degenerate
    ones (three copies of a point: K = 0; collinear points; a NaN and an
    infinite coordinate), lambda stopped at its first bitwise fixed point
    equals lambda after the 12 steps bit for bit, NaN rows included; the
    steps counted to that point, those after it change nothing."""
    from mcslam_tpu_torch.geometry import alignment

    P = _scene(40, 2048)
    idx = _samples(P, 512, 3)
    rng = np.random.RandomState(41)
    src = np.concatenate([P["X_rig"][idx],
                          rng.normal(0, 3, (256, 3, 3)).astype(np.float32)])
    dst = np.concatenate([P["X"][idx],
                          rng.normal(0, 3, (256, 3, 3)).astype(np.float32)])
    src[0] = src[0, :1]
    dst[0] = dst[0, :1]  # three copies of one point
    src[1, 2] = 0.5 * (src[1, 0] + src[1, 1])
    dst[1, 2] = 0.5 * (dst[1, 0] + dst[1, 1])  # collinear
    src[2, 1, 0] = np.nan
    dst[3, 2, 2] = np.inf
    K_ = alignment.davenport(_t(src), _t(dst))[0]
    full, early, steps = _lam_both_ways(K_)
    assert torch.equal(full.view(torch.int32), early.view(torch.int32))
    assert torch.isnan(full[2]) and torch.isnan(full[3])
    assert torch.isfinite(full[[0, 1]]).all()
    # how often a hypothesis stops early at the portfolio's samples
    st = steps[:512]
    assert bool((st >= 1).all() and (st <= 12).all())
    assert int((st < 12).sum()) > 256 and int((st == 12).sum()) > 0


@pytest.mark.gpu
@pytest.mark.parametrize("K,M,lever,cam0", [
    (256, 2048, True, False), (256, 2048, False, False),
    (257, 37, True, False), (3, 2048, True, False), (1, 400, True, False),
    # K one past a block of 4 hypotheses, M < 32; every sample seen by the
    # camera without a lever arm (the flag then comes from the scan of M)
    (5, 2048, True, False), (9, 20, True, False), (256, 2048, True, True)])
def test_pnp_kernel_matches_plain(cuda, K, M, lever, cam0):
    P = _scene(30 + K, M, lever=lever, outliers=0.1, noise=0.2)
    obs = _obs(P, cuda)
    if cam0:
        central = np.abs(P["cam"][:, :3, 3]).max(axis=1) == 0
        idx = P["rng"].choice(np.flatnonzero(P["mask"] & central), (K, 6))
    else:
        idx = _samples(P, K, 6)
    # six copies of one point: no pose (at the portfolio's shapes; whether
    # the factor of such a sample fails is a matter of rounding, so the
    # small shapes plant none)
    planted = (2, K - 1) if K >= 256 and not cam0 else ()
    for k in planted:
        idx[k] = idx[k, 0]
    idx = _t(idx, cuda)
    h = _counted("pnp_hyp", lambda: ransac_cuda.pnp_hyp(idx, *obs[:4]))
    assert cs.same_bits(h, ransac_cuda.pnp_hyp(idx, *obs[:4]))
    _check_hyp(h, lambda dt: ransac.pnp_hypotheses(
        idx, *(o.to(dt) for o in obs[:4])), obs, structural=planted)


@pytest.mark.gpu
def test_ransac_on_cuda_matches_the_plain_ransac(cuda):
    """ransac_kabsch / ransac_pnp on the card (two launches each) against
    the plain composition on the same samples: the winners' counts within
    2 %, their poses within 2e-2."""
    P = _scene(40, 2048)
    obs = _obs(P, cuda)
    X_rig = _t(P["X_rig"], cuda)
    for fn, args, idx, plain in (
            (ransac.ransac_kabsch, (X_rig, *obs), _samples(P, 512, 3),
             lambda i: ransac.kabsch_hypotheses(i, X_rig, obs[0])),
            (ransac.ransac_pnp, obs, _samples(P, 256, 6),
             lambda i: ransac.pnp_hypotheses(i, *obs[:4]))):
        idx = _t(idx, cuda)
        before = collections.Counter(_build.LAUNCHES)
        res = fn(None, *args, px_thresh=PX, idx=idx)
        assert sum((_build.LAUNCHES - before).values()) == 2
        counts = ransac._score_reprojection(plain(idx), *obs, PX)[0]
        b = int(torch.argmax(counts))
        n_ref = int(counts[b])
        assert abs(int(res.num_inliers) - n_ref) <= COUNT_REL * n_ref
        assert float((res.world_T_ref - plain(idx)[b]).abs().max()) \
            <= POSE_ATOL


@pytest.mark.gpu
def test_score_kernel_in_a_cuda_graph(cuda):
    """The score captured in a CUDA graph: two replays equal to the eager
    call, the arrival counter back at zero after each."""
    P = _scene(50, 2048)
    obs = _obs(P, cuda)
    hyp = _t(_perturbed(P, 512), cuda)
    want = ransac_cuda.score(hyp, *obs, PX)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        ransac_cuda.score(hyp, *obs, PX)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ransac_cuda.score(hyp, *obs, PX)
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(out, want))
        assert int(ransac_cuda.counters(cuda, 512).abs().sum()) == 0


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    P = _scene(60, 64)
    obs = _obs(P, cuda)
    idx = _t(_samples(P, 8, 6), cuda)
    with pytest.raises(ValueError, match="samples"):
        ransac_cuda.pnp_hyp(idx[:, :5].contiguous(), *obs[:4])
    with pytest.raises(ValueError, match="int64"):
        ransac_cuda.kabsch_hyp(idx[:, :3].int(), obs[0], obs[0])
    with pytest.raises(ValueError, match="float32"):
        ransac_cuda.score(_t(_perturbed(P, 2), cuda), obs[0].double(),
                          *obs[1:], PX)
