"""The port's five kernel wrappers: their dispatch rule on the CPU, and each
CUDA kernel against its plain PyTorch version on the card (`gpu` marker;
these skip without a card).

This file imports no JAX (neither does the port), so on a machine with a
card and without JAX it runs with the suite's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances on the card: candidates, patches and integer outputs exact;
blur 1e-6; gated-matcher rows / columns with a pair within 1e-3 * thr2 of
the gate threshold are excluded (f32 summation order); pose 2e-3 and
inlier sets equal away from the chi2 threshold (f32 reduction order);
ba_linearize's payload, Hpp and gp to 1e-5 of their largest magnitude,
r atol 1e-4 + rtol 1e-6 (pixel residuals up to ~1000 px on the random
stage C problem), w atol 1e-5, and bitwise equal across two runs."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import tracking_kernels as tk
from mcslam_tpu_torch.backend import ba
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame, pose_opt_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import ba_cuda, fast_cuda, hamming, image
from mcslam_tpu_torch.ops import match_cuda, patch_cuda

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
              pose_opt_cuda.LAUNCHES, ba_cuda.LAUNCHES)
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
    lin = ba.linearize_inputs(ba.problem_from_numpy(
        **synthetic.random_window_ba_problem(
            synthetic.make_synthetic_rig(), num_lms=64, obs_capacity=600)))
    payload, _, _, Hpp, _ = ba_cuda.ba_linearize(*lin)
    assert payload.shape == (6, 30, 100) and Hpp.shape == (6, 36)
    after = (fast_cuda.LAUNCHES, patch_cuda.LAUNCHES, match_cuda.LAUNCHES,
             pose_opt_cuda.LAUNCHES, ba_cuda.LAUNCHES)
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
def test_ba_linearize_kernel_matches_plain(cuda):
    """bench.py's stage C problem: K=6, Ok=1365, L=2048, C=4."""
    f = synthetic.random_window_ba_problem(synthetic.make_synthetic_rig())
    args = ba.linearize_inputs(ba.problem_from_numpy(**f, device=cuda))
    n0 = ba_cuda.LAUNCHES
    kout = ba_cuda.ba_linearize(*args)
    again = ba_cuda.ba_linearize(*args)
    pout = ba_cuda.ba_linearize_reference(*args)
    assert ba_cuda.LAUNCHES == n0 + 2
    for x, y in zip(kout, again):
        assert torch.equal(x, y)  # fixed reduction order: bitwise
    for i in (0, 3, 4):  # payload, Hpp, gp
        err = (kout[i] - pout[i]).abs().max() / pout[i].abs().max()
        assert float(err) <= 1e-5, i
    H = kout[3].reshape(-1, 6, 6)
    assert torch.equal(H, H.transpose(1, 2))
    torch.testing.assert_close(kout[1], pout[1], atol=1e-4, rtol=1e-6)
    torch.testing.assert_close(kout[2], pout[2], atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        ba_cuda.ba_linearize(args[0].double(), *args[1:])


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


@pytest.mark.gpu
def test_session_on_cuda_matches_cpu(cuda):
    """The vision-only driver on the card (the kernels, the window solve on
    its side stream, deferred landing) against the same driver on the CPU
    (plain versions): the 3-camera 320x240 scene of tests/test_torch_slam.py
    at one pyramid level; per-frame positions within 0.005 m, the bound
    of the JAX-against-port session test."""
    from mcslam_tpu_torch.slam import INITIALIZED, MultiCameraSLAM, SlamConfig

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=3, baseline=0.2, image_size=(320, 240), focal=260.0))
    poses = synthetic.smooth_trajectory(8, radius=5.0, step_angle=0.03)
    imgs = synthetic.render_blob_images(rig, poses, synthetic.make_landmarks(
        700, seed=1, depth_range=(4.0, 12.0)), seed=2)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                     local_map_landmarks=1024, kf_translation=0.2,
                     kf_rotation=0.1, min_inter_matches=40)
    runs = []
    for dev in ("cpu", cuda):
        n0 = ba_cuda.LAUNCHES
        slam = MultiCameraSLAM(rig, cfg, device=dev)
        for k in range(len(poses)):
            slam.process_image(imgs[k], k / 20.0, extract_cfg=dict(
                num_points=512, num_levels=1, max_intra=768))
        _, est = slam.trajectory_arrays()
        assert slam.state == INITIALIZED and slam.stats["failures"] == 0
        runs.append((slam.stats, est, ba_cuda.LAUNCHES - n0))
    (cpu_stats, cpu_est, cpu_n), (gpu_stats, gpu_est, gpu_n) = runs
    assert cpu_n == 0 and gpu_n > 0
    assert abs(cpu_stats["keyframes"] - gpu_stats["keyframes"]) <= 1
    gap = np.linalg.norm(gpu_est[:, :3, 3] - cpu_est[:, :3, 3], axis=-1)
    assert gap.max() <= 0.005, gap
