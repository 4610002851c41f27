"""The tri_refine kernel of the port's triangulation
(geometry/triangulation_cuda, csrc/tri_refine.cu).

On the CPU: geometry/triangulation.triangulate_and_refine takes the plain
version (triangulate_and_refine_reference) for CPU tensors, bit for bit
and without a launch, and refuses a device that is neither CPU nor CUDA;
the plain version equals the JAX package's triangulate_and_refine at R =
2, 3, 4 and 5 rays and M = 37 and 256 points: ok exactly, and X within
test_torch_geometry.py's 2e-5 m where ok (the Gauss-Newton fixed point
moves with the float32 rounding of the residuals). The inputs, made with
numpy from a seed, hold single-ray and empty points, parallel rays (the
pixels of one world direction in every camera), points behind the
cameras and points past max_z.

`gpu` cases (they skip without a card) hold the kernel to the plain
version on the card with torch.equal (NaN-aware) on X and ok, at those
shapes and at the frame's (M = 2048, R = 4) and a keyframe pair's (M =
2048, R = 2), with world_T_cam an expand of R poses and a contiguous
per-point table, equal across two runs and one launch counted per call;
and the wrapper refusing what the kernel does not take:
    python -m pytest --noconftest tests/test_torch_tri_refine.py -m gpu -q
(this file imports JAX only inside the JAX comparison)."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.geometry import triangulation, triangulation_cuda

MIN_Z, MAX_Z = 0.5, 4.5
SHAPES = [(M, R) for R in (2, 3, 4, 5) for M in (37, 256)]


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)


def _problem(seed, M, R, per_point=False):
    """(poses, uv, f, mask, sigma) as numpy: poses (R, 4, 4) world_T_cam
    of a rig (cameras 0.2 m apart along x, small yaws), or (M, R, 4, 4)
    per point (each point's rig moved by its own offset) if per_point."""
    rng = np.random.RandomState(seed)
    rig = np.tile(np.eye(4, dtype=np.float32), (R, 1, 1))
    for r in range(R):
        rig[r, :3, :3] = _rot_y(0.03 * (r - R / 2))
        rig[r, 0, 3] = 0.2 * r
        rig[r, 1, 3] = 0.01 * r
    if per_point:
        poses = np.tile(rig, (M, 1, 1, 1))
        poses[..., :3, 3] += rng.uniform(-0.5, 0.5, (M, 1, 3)).astype(
            np.float32)
    else:
        poses = np.broadcast_to(rig, (M, R, 4, 4))
    X = np.concatenate([rng.uniform(-2, 2, (M, 2)),
                        rng.uniform(1.5, 4, (M, 1))], 1).astype(np.float32)
    kind = rng.randint(0, 10, M)
    X[kind == 0, 2] = rng.uniform(-4, -1.5, (kind == 0).sum())  # behind
    X[kind == 1, 2] = rng.uniform(5, 9, (kind == 1).sum())  # past max_z
    f = np.stack([np.array([400 + 10 * r, 405 + 10 * r, 320 + r, 240 - r],
                           np.float32) for r in range(R)])
    f = np.broadcast_to(f, (M, R, 4)).copy()
    # world -> camera: R^T (X - t)
    rot = poses[..., :3, :3]
    p = np.einsum("mrji,mrj->mri", rot, X[:, None, :] - poses[..., :3, 3])
    uv = p[..., :2] / p[..., 2:] * f[..., :2] + f[..., 2:]
    uv = (uv + rng.normal(0, 0.4, uv.shape)).astype(np.float32)
    # parallel rays: the pixels of one world direction D in every camera
    par = kind == 2
    D = np.array([0.1, -0.05, 1.0], np.float32)
    d = np.einsum("mrji,j->mri", rot[par], D)
    uv[par] = (d[..., :2] / d[..., 2:] * f[par][..., :2]
               + f[par][..., 2:]).astype(np.float32)
    mask = rng.rand(M, R) < 0.8
    mask[kind == 3] = False
    mask[kind == 3, rng.randint(0, R)] = True  # a single ray
    mask[kind == 4] = False  # no ray
    sig = (1.2 ** rng.randint(0, 3, (M, R))).astype(np.float32)
    return (np.ascontiguousarray(poses, np.float32), uv, f, mask, sig)


def _torch(problem, dev, expand):
    poses, uv, f, mask, sig = problem
    M, R = mask.shape
    t = [torch.from_numpy(np.array(a)).to(dev) for a in problem]
    if expand:  # the frame's layout: C poses and intrinsics expanded
        t[0] = t[0][0][None].expand(M, R, 4, 4)
        t[2] = t[2][0][None].expand(M, R, 4)
    return t


def _same(a, b):
    """Equal bits up to NaN payloads: the same NaN positions, torch.equal
    elsewhere."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


def test_wrapper_takes_the_reference_for_cpu_tensors():
    before = dict(_build.LAUNCHES)
    for expand in (True, False):
        wTc, uv, f, mask, sig = _torch(_problem(0, 64, 4), "cpu", expand)
        X, ok = triangulation.triangulate_and_refine(
            wTc, uv, f, mask, sigma=sig, min_z=MIN_Z, max_z=MAX_Z)
        Xr, okr = triangulation.triangulate_and_refine_reference(
            wTc, uv, f, mask, sigma=sig, min_z=MIN_Z, max_z=MAX_Z)
        assert _same(X, Xr) and torch.equal(ok, okr)
        assert X.shape == (64, 3) and ok.dtype == torch.bool
        assert 0 < int(ok.sum()) < 64
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="unsupported device"):
        triangulation.triangulate_and_refine(
            wTc.to("meta"), uv.to("meta"), f.to("meta"), mask.to("meta"))


def test_reference_is_the_same_for_any_layout():
    """The plain version makes its components contiguous (R, M), so an
    expanded pose table and its copy give the same bits."""
    p = _problem(1, 256, 4)
    a = triangulation.triangulate_and_refine_reference(
        *_torch(p, "cpu", True)[:4], sigma=torch.from_numpy(p[4]))
    b = triangulation.triangulate_and_refine_reference(
        *_torch(p, "cpu", False)[:4], sigma=torch.from_numpy(p[4]))
    assert _same(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("R", [2, 3, 4, 5])
@pytest.mark.parametrize("per_point", [False, True], ids=["rig", "per_point"])
def test_reference_matches_jax(R, per_point):
    """M = 37 and M = 256 in one JAX call (the points are independent;
    one eager JAX call per ray count keeps the file fast)."""
    import jax.numpy as jnp
    from mcslam_tpu.geometry import triangulation as jtri

    probs = [_problem(10 * R + M, M, R, per_point) for M in (37, 256)]
    cat = [np.concatenate([p[k] for p in probs]) for k in range(5)]
    Xj, okj = jtri.triangulate_and_refine(
        *(jnp.asarray(a) for a in cat[:4]), sigma=jnp.asarray(cat[4]),
        min_z=MIN_Z, max_z=MAX_Z)
    Xj, okj = np.asarray(Xj), np.asarray(okj)
    start = 0
    for p in probs:
        M = p[3].shape[0]
        Xt, okt = triangulation.triangulate_and_refine_reference(
            *_torch(p, "cpu", not per_point)[:4], sigma=torch.from_numpy(p[4]),
            min_z=MIN_Z, max_z=MAX_Z)
        ok = okj[start:start + M]
        np.testing.assert_array_equal(okt.numpy(), ok)
        assert ok.sum() >= M // 8  # the scene triangulates
        np.testing.assert_allclose(Xt.numpy()[ok], Xj[start:start + M][ok],
                                   atol=2e-5, rtol=0)
        start += M


GPU_SHAPES = SHAPES + [(2048, 4), (2048, 2), (37, 8)]


@pytest.mark.gpu
@pytest.mark.parametrize("M,R", GPU_SHAPES)
@pytest.mark.parametrize("expand", [True, False],
                         ids=["expanded", "contiguous"])
def test_kernel_matches_plain(cuda, M, R, expand):
    p = _problem(10 * R + M, M, R, per_point=not expand)
    wTc, uv, f, mask, sig = _torch(p, cuda, expand)
    ref = triangulation.triangulate_and_refine_reference(
        wTc, uv, f, mask, sigma=sig, min_z=MIN_Z, max_z=MAX_Z)
    before = _build.LAUNCHES["tri_refine"]
    runs = [triangulation_cuda.tri_refine(wTc, uv, f, mask, sigma=sig,
                                          min_z=MIN_Z, max_z=MAX_Z)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["tri_refine"] == before + 2
    for X, ok in runs:
        assert _same(X, ref[0]), (X - ref[0]).abs().nan_to_num().max()
        assert torch.equal(ok, ref[1])
    # a number sigma and the frame build's default depth gate
    ref = triangulation.triangulate_and_refine_reference(wTc, uv, f, mask, 1.3)
    X, ok = triangulation.triangulate_and_refine(wTc, uv, f, mask, 1.3)
    assert _same(X, ref[0]) and torch.equal(ok, ref[1])


@pytest.mark.gpu
def test_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    wTc, uv, f, mask, sig = _torch(_problem(3, 16, 9), cuda, False)
    with pytest.raises(ValueError, match="1 to 8 rays"):
        triangulation_cuda.tri_refine(wTc, uv, f, mask, sig)
    wTc, uv, f, mask, sig = _torch(_problem(3, 16, 4), cuda, False)
    with pytest.raises(ValueError, match="float32"):
        triangulation_cuda.tri_refine(wTc.double(), uv, f, mask, sig)
    with pytest.raises(ValueError, match="bool"):
        triangulation_cuda.tri_refine(wTc, uv, f, mask.float(), sig)
