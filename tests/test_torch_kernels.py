"""The port's four kernel wrappers: their dispatch rule on the CPU, and each
CUDA kernel against its plain PyTorch version on the card (`gpu` marker;
these skip without a card).

This file imports no JAX (neither does the port), so on a machine with a
card and without JAX it runs with the suite's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances on the card: candidates, patches and integer outputs exact;
blur 1e-6; gated-matcher rows / columns with a pair within 1e-3 * thr2 of
the gate threshold are excluded (f32 summation order); pose 2e-3 and
inlier sets equal away from the chi2 threshold (f32 reduction order)."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import tracking_kernels as tk
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame, pose_opt_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import fast_cuda, hamming, image, match_cuda
from mcslam_tpu_torch.ops import patch_cuda

TAPS = image._np_gaussian_taps(7, 2.0)
CHI2 = pose_opt_cuda.CHI2_2DOF


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _plateau_stack(seed, H, W, heights, widths):
    rng = np.random.RandomState(seed)
    img = (rng.randint(0, 24, (len(heights), H, W)) / 24.0).astype(np.float32)
    for c, (h, w) in enumerate(zip(heights, widths)):
        img[c, h:] = img[c, h - 1]
        img[c, :, w:] = img[c, :, w - 1][:, None]
    return (torch.from_numpy(img), torch.tensor(heights, dtype=torch.int32),
            torch.tensor(widths, dtype=torch.int32))


def _match_problem(seed, M, N, want_cols, C=3):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b[N // 2] = b[N // 2 + 1] = a[0]
    uv = torch.from_numpy(rng.rand(M, 2).astype(np.float32) * 400.0)
    proj = rng.rand(C, N, 2).astype(np.float32) * 400.0
    proj[:, : N // 2] = uv.numpy()[rng.randint(0, M, N // 2)][None] \
        + rng.randn(C, N // 2, 2).astype(np.float32) * 10.0
    ahat, bhat = tk._gate_factors(
        uv, torch.from_numpy(rng.randint(0, C, M)), torch.from_numpy(proj),
        torch.from_numpy(rng.rand(C, N) < 0.1),
        torch.from_numpy(rng.rand(M) < 0.1),
        torch.from_numpy(rng.rand(N) < 0.1),
        col_pass=torch.from_numpy(rng.rand(N) < 0.3) if want_cols else None)
    return hamming.desc_to_torch(a), hamming.desc_to_torch(b), ahat, bhat


def _pose_problem(seed, M, B=2):
    rng = np.random.RandomState(seed)
    X = (rng.uniform(-6, 6, (M, 3)) + [0, 0, 10]).astype(np.float32)
    T_true = lie.se3_exp(torch.tensor([0.03, -0.05, 0.02, 0.2, -0.1, 0.15]))
    cam = np.tile(np.eye(4, dtype=np.float32), (M, 1, 1))
    cam[:, 0, 3] = 0.1 * rng.randint(0, 4, M)
    rTw = np.linalg.inv(T_true.numpy())
    q = X @ rTw[:3, :3].T + rTw[:3, 3]
    p = q + cam[:, :3, 3]
    f = np.tile(np.float32([400, 400, 320, 240]), (M, 1))
    uv = (p[:, :2] / p[:, 2:] * f[:, :2] + f[:, 2:]).astype(np.float32)
    uv += rng.normal(0, 0.3, uv.shape).astype(np.float32)
    out = rng.rand(M) < 0.15
    uv[out] += rng.uniform(-60, 60, (out.sum(), 2)).astype(np.float32)
    isig2 = (1.0 / (1.2 ** rng.randint(0, 4, M)) ** 2).astype(np.float32)
    data = pose_opt_cuda._pack_obs(*(torch.from_numpy(x) for x in (
        X, uv, cam, f, isig2)))
    mask = torch.ones(B, M)
    mask[1, ::2] = 0.0
    return torch.eye(4).expand(B, 4, 4).contiguous(), data, mask


def test_wrappers_take_plain_versions_for_cpu_tensors():
    """CPU tensors run the plain version and launch nothing; a device
    that is neither CPU nor CUDA is refused."""
    before = (fast_cuda.LAUNCHES, patch_cuda.LAUNCHES, match_cuda.LAUNCHES,
              pose_opt_cuda.LAUNCHES)
    img, h, w = _plateau_stack(0, 40, 64, [40, 33], [64, 50])
    out = fast_cuda.fast_select(img, 0.04, 0.12, h, w, TAPS)
    ref = fast_cuda.fast_select_reference(img, 0.04, 0.12, h, w, TAPS)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    yx = torch.tensor([[20, 30], [0, 0]], dtype=torch.int32)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    p, o = patch_cuda.patch_gather(img, yx, idx)
    assert p.shape == (2, 39, 39) and o.tolist() == [[1, 11], [0, 0]]
    a, b, ahat, bhat = _match_problem(1, 40, 50, True)
    best, second, ridx, cidx = match_cuda.hamming_argmin2(a, b, ahat, bhat,
                                                          1600.0)
    assert best.shape == (40,) and cidx.dtype == torch.int32
    T0, data, mask = _pose_problem(2, 64)
    T, chi2 = pose_opt_cuda.pose_lm(T0, data, mask, (2, 2))
    assert T.shape == (2, 4, 4) and chi2.shape == (2, 64)
    after = (fast_cuda.LAUNCHES, patch_cuda.LAUNCHES, match_cuda.LAUNCHES,
             pose_opt_cuda.LAUNCHES)
    assert after == before
    with pytest.raises(ValueError, match="unsupported device"):
        fast_cuda.fast_select(img.to("meta"), 0.04, 0.12, h, w, TAPS)


@pytest.mark.gpu
@pytest.mark.parametrize("H,W,heights,widths", [
    (90, 200, [90, 61, 40], [200, 170, 120]),
    (480, 640, [480, 400, 333, 278], [640, 533, 444, 370]),
])
def test_fast_select_kernel_matches_plain(cuda, H, W, heights, widths):
    img, h, w = (x.to(cuda) for x in _plateau_stack(7, H, W, heights,
                                                     widths))
    n0 = fast_cuda.LAUNCHES
    kb, kv, kr = fast_cuda.fast_select(img, 0.04, 0.12, h, w, TAPS)
    pb, pv, pr = fast_cuda.fast_select_reference(img, 0.04, 0.12, h, w, TAPS)
    assert fast_cuda.LAUNCHES == n0 + 1
    assert torch.equal(kv, pv) and torch.equal(kr, pr)
    assert float((kb - pb).abs().max()) <= 1e-6
    with pytest.raises(ValueError):
        fast_cuda.fast_select(img.double(), 0.04, 0.12, h, w, TAPS)


@pytest.mark.gpu
def test_patch_gather_kernel_matches_plain(cuda):
    rng = np.random.RandomState(0)
    imgs = torch.from_numpy(rng.rand(5, 96, 200).astype(np.float32)).to(cuda)
    yx = torch.from_numpy(np.stack([rng.randint(0, 96, 500),
                                    rng.randint(0, 200, 500)], -1)
                          .astype(np.int32)).to(cuda)
    idx = torch.from_numpy(rng.randint(0, 5, 500).astype(np.int32)).to(cuda)
    kp, ko = patch_cuda.patch_gather(imgs, yx, idx)
    pp, po = patch_cuda.patch_gather_reference(imgs, yx, idx)
    assert torch.equal(kp, pp) and torch.equal(ko, po)
    with pytest.raises(ValueError):
        patch_cuda.patch_gather(imgs, yx.long(), idx)


@pytest.mark.gpu
@pytest.mark.parametrize("seed,M,N,want_cols", [
    (0, 300, 700, True), (2, 257, 1000, False), (3, 2048, 2048, True)])
def test_hamming_argmin2_kernel_matches_plain(cuda, seed, M, N, want_cols):
    a, b, ahat, bhat = (x.to(cuda) for x in _match_problem(seed, M, N,
                                                           want_cols))
    kout = match_cuda.hamming_argmin2(a, b, ahat, bhat, 1600.0, want_cols)
    pout = match_cuda.hamming_argmin2_reference(a, b, ahat, bhat, 1600.0,
                                                want_cols)
    near = ((ahat.double() @ bhat.double()) - 1600.0).abs() < 1.6
    keep = ~near.any(1)
    for x, y in zip(kout[:3], pout[:3]):
        assert torch.equal(x[keep], y[keep])
    if want_cols:
        kc = ~near.any(0)
        assert torch.equal(kout[3][kc], pout[3][kc])


@pytest.mark.gpu
def test_pose_lm_kernel_matches_plain(cuda):
    T0, data, mask = (x.to(cuda) for x in _pose_problem(0, 2048))
    kT, kc = pose_opt_cuda.pose_lm(T0, data, mask, (8, 8))
    pT, pc = pose_opt_cuda.pose_lm_reference(T0, data, mask, (8, 8))
    assert float((kT - pT).abs().max()) <= 2e-3
    edge = (pc - CHI2).abs() < 1e-3
    assert bool(torch.all(((kc < CHI2) == (pc < CHI2)) | edge | (mask < 0.5)))


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu(cuda):
    """The kernels' path (CUDA) against the plain path (CPU) on one frame
    of the small 2-camera scene (1 pyramid level: the resize matmuls of
    further levels round differently on the two devices)."""
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0))
    poses = synthetic.smooth_trajectory(2, step_angle=0.02)
    imgs = synthetic.render_blob_images(
        rig, poses, synthetic.make_landmarks(600, depth_range=(4.0, 15.0)))
    kw = dict(num_points=128, num_levels=1, max_intra=256, angle_bins=16)
    packed = []
    for dev in ("cpu", cuda):
        r = rig.to(dev)
        ff0 = frame.build_frame(torch.from_numpy(imgs[0]).to(dev), r, **kw)
        M = ff0.im_valid.shape[0]
        v0 = ff0.im_valid & ff0.im_has_depth
        ids = torch.arange(M, dtype=torch.int32, device=dev)
        prev_lm = torch.where(v0, ids, torch.full_like(ids, -1))
        cand = torch.nonzero(v0)[:, 0].to(torch.int32)
        cand_ids = torch.zeros(256, dtype=torch.int32, device=dev)
        cand_ids[:len(cand)] = cand
        nrm = ff0.im_point3d / ff0.im_point3d.norm(dim=1, keepdim=True)
        *_, p = tk._build_and_track_step(
            torch.Generator(device=dev).manual_seed(0),
            torch.from_numpy(imgs[1]).to(dev), r, ff0.im_desc, ff0.im_valid,
            prev_lm, ff0.im_point3d, v0, ff0.im_desc, nrm, cand_ids,
            torch.arange(256, device=dev) < len(cand), torch.eye(4,
                                                                 device=dev),
            fast_threshold=20 / 255, min_threshold=7 / 255, min_z=0.5,
            max_z=40.0, num_hyp=64, px=5.0, max_dist=64, ratio=0.85,
            image_wh=rig.image_size, lm_radius=18.0, lm_max_dist=60,
            gate_px=100.0, fastpath_frac=0.6, fastpath_min=30, **kw)
        packed.append(p.cpu().numpy())
    cpu, gpu = packed
    off = 21 + 3 * M
    np.testing.assert_allclose(gpu[:16], cpu[:16], atol=1e-3, rtol=0)
    np.testing.assert_allclose(gpu[off:off + 16], cpu[off:off + 16],
                               atol=1e-3, rtol=0)
    np.testing.assert_allclose(gpu[16:19], cpu[16:19], rtol=0.02, atol=0)
