"""The port's nine kernel wrappers: their dispatch rule on the CPU, and each
CUDA kernel against its plain PyTorch version on the card (`gpu` marker;
these skip without a card).

This file imports no JAX (neither does the port), so on a machine with a
card and without JAX it runs with the suite's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels.py -m gpu -q

Tolerances on the card: candidates, FAST score maps, patches (f32 and
bf16), the orientation moments and integer outputs exact; blur 1e-6
(fast_select) or exact (fast_corners); both FAST kernels bitwise equal
across two runs; gated-matcher rows / columns with a pair within 1e-3 * thr2 of
the gate threshold are excluded (f32 summation order); pose 2e-3 and
inlier sets equal away from the chi2 threshold (f32 reduction order);
the gated matcher and the pose LM bitwise equal across two runs;
ba_linearize's payload, r and w bitwise (the kernel rounds every
multiply and add as the plain version does), Hpp and gp to 1e-5 of their
largest magnitude (summed in another order), and bitwise equal across
two runs, at K in {1, 2, 6} x Ok in {1, 1365, 8192} x C in {1, 4, 8};
the oriented gather bitwise, also across two runs, at T in {1, 7, 3072}
x W in {640, 200, 201}. vio_solve at the stage D shape on the card
against the CPU within VIO_TOL. The frame build on the card against the CPU
under the extraction routes A and B: keypoints exact, descriptors equal
except at keypoints whose angle lies within 1e-4 rad of a steering-bin
boundary."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch import tracking_kernels as tk
from mcslam_tpu_torch.backend import ba
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame, pose_opt_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import ba_cuda, fast_cuda, hamming, image
from mcslam_tpu_torch.ops import match_cuda, orb, patch_cuda

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


def _plant_edges(a, b, uv, anchor, proj, pen, row_inv, col_inv):
    """Ties and gated rows in a gated-matching problem (numpy, in place):
    row 0's descriptor at columns 5, 133 and N - 1 (three 128-column
    splits where N allows), all passing row 0's gate; rows 3, 70 and 140
    (three 64-row tiles where M allows) sharing a descriptor, pixel and
    camera, with column 7 holding that descriptor on top of them; rows
    10-13 invalid, so every pair of theirs is gated out."""
    M, N = len(a), len(b)
    cols = [j for j in (5, 133, N - 1) if j < N]
    rows = [i for i in (3, 70, 140) if i < M]
    b[cols] = a[0]
    proj[:, cols] = uv[0]
    a[rows], uv[rows], anchor[rows] = a[3], uv[3], anchor[3]
    b[7], proj[:, 7] = a[3], uv[3]
    pen[:, cols + [7]] = False
    col_inv[cols + [7]] = False
    row_inv[[0] + rows] = False
    row_inv[10:14] = True


def _check_edges(out, want_cols):
    """The planted ties resolve to the first index; gated rows give BIGF
    at column 0."""
    best, _, idx = (x.cpu() for x in out[:3])
    assert int(idx[0]) == 5 and float(best[0]) == 0.0
    assert torch.all(best[10:14] == match_cuda.BIGF)
    assert torch.all(idx[10:14] == 0)
    if want_cols:
        assert int(out[3][7]) == 3


def _match_problem(seed, M, N, want_cols, C=3):
    rng = np.random.RandomState(seed)
    a = rng.randint(0, 2**32, (M, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.randint(0, 2**32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b[N // 2] = b[N // 2 + 1] = a[0]
    uv = rng.rand(M, 2).astype(np.float32) * 400.0
    proj = rng.rand(C, N, 2).astype(np.float32) * 400.0
    proj[:, : N // 2] = uv[rng.randint(0, M, N // 2)][None] \
        + rng.randn(C, N // 2, 2).astype(np.float32) * 10.0
    anchor = rng.randint(0, C, M)
    pen, row_inv, col_inv = (rng.rand(C, N) < 0.1, rng.rand(M) < 0.1,
                             rng.rand(N) < 0.1)
    col_pass = rng.rand(N) < 0.3
    _plant_edges(a, b, uv, anchor, proj, pen, row_inv, col_inv)
    ahat, bhat = tk._gate_factors(
        *(torch.from_numpy(x) for x in (uv, anchor, proj, pen, row_inv,
                                        col_inv)),
        col_pass=torch.from_numpy(col_pass) if want_cols else None)
    return (hamming.desc_to_torch(a, "cpu"), hamming.desc_to_torch(b, "cpu"),
            ahat, bhat)


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
    T0 = torch.eye(4).expand(B, 4, 4).contiguous()
    if B > 1:
        mask[1, ::2] = 0.0
    if B > 2:
        mask[2, 1::3] = 0.0
        T0[2, :3, 3] = torch.tensor([0.05, -0.03, 0.04])
    return T0, data, mask


def test_wrappers_take_plain_versions_for_cpu_tensors():
    """CPU tensors run the plain version and launch nothing; a device
    that is neither CPU nor CUDA is refused."""
    before = dict(_build.LAUNCHES)
    img, h, w = _plateau_stack(0, 40, 64, [40, 33], [64, 50])
    out = fast_cuda.fast_select(img, 0.04, 0.12, h, w, TAPS)
    ref = fast_cuda.fast_select_reference(img, 0.04, 0.12, h, w, TAPS)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))
    yx = torch.tensor([[20, 30], [0, 0]], dtype=torch.int32)
    idx = torch.tensor([1, 0], dtype=torch.int32)
    p, o = patch_cuda.patch_gather(img, yx, idx)
    assert p.shape == (2, 39, 39) and o.tolist() == [[1, 11], [0, 0]]
    score, blur = fast_cuda.fast_corners(img, 0.04, h, TAPS)
    assert torch.equal(score, fast_cuda.fast_corners_reference(img, 0.04, h,
                                                               TAPS)[0])
    assert torch.equal(blur, out[0])  # the two blurs agree bit for bit
    assert fast_cuda.fast_corners(img, 0.04).shape == img.shape
    pb, ob = patch_cuda.patch_gather_batched(img, yx[None].expand(2, 2, 2))
    assert pb.shape == (2, 2, 39, 39) and torch.equal(pb[1, 0], p[0])
    po, m, oo = patch_cuda.patch_gather_oriented(img, yx, idx)
    assert po.dtype == torch.bfloat16 and m.shape == (2, 2)
    assert torch.equal(oo, o)
    a, b, ahat, bhat = _match_problem(1, 40, 50, True)
    best, second, ridx, cidx = match_cuda.hamming_argmin2(a, b, ahat, bhat,
                                                          1600.0)
    assert best.shape == (40,) and cidx.dtype == torch.int32
    T0, data, mask = _pose_problem(2, 64)
    T, chi2 = pose_opt_cuda.pose_lm(T0, data, mask, (2, 2))
    assert T.shape == (2, 4, 4) and chi2.shape == (2, 64)
    lin = ba.linearize_inputs(ba.problem_from_numpy(
        **synthetic.random_window_ba_problem(
            synthetic.make_synthetic_rig(device="cpu"), num_lms=64,
            obs_capacity=600)))
    payload, _, _, Hpp, _ = ba_cuda.ba_linearize(*lin)
    assert payload.shape == (6, 30, 100) and Hpp.shape == (6, 36)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError, match="unsupported device"):
        fast_cuda.fast_select(img.to("meta"), 0.04, 0.12, h, w, TAPS)


# FAST kernel inputs: (kind, H, W, true heights, true widths). The kernels
# compute 32-row blocks and skip 16-row bands: H = 90 and 100 end inside
# a block, and the heights 61, 40, 77, 333 and 278 put the skip boundary
# inside one. W = 640 stages with 16-byte copies, W = 200 with 4-byte
# ones, and so does "misaligned" (a W = 640 view 4 bytes off a 16-byte
# boundary). "flat" is one value (every warp skips the arc trees),
# "noise" uniform noise (none does).
FAST_INPUTS = [
    ("plateau", 90, 200, [90, 61, 40], [200, 170, 120]),
    ("plateau", 480, 640, [480, 400, 333, 278], [640, 533, 444, 370]),
    ("plateau", 100, 640, [100, 61, 40, 77], [640, 600, 300, 500]),
    ("misaligned", 100, 640, [100, 77], [640, 500]),
    ("flat", 96, 640, [96, 61], [640, 500]),
    ("noise", 480, 640, [480, 400, 333, 278], [640, 533, 444, 370]),
    ("noise", 90, 200, [90, 61, 40], [200, 170, 120]),
]
FAST_IDS = [f"{k}-{H}x{W}" for k, H, W, _, _ in FAST_INPUTS]


def _fast_stack(kind, H, W, heights, widths, dev):
    """A FAST kernel input of FAST_INPUTS on dev."""
    if kind in ("plateau", "misaligned"):
        img, h, w = _plateau_stack(7, H, W, heights, widths)
    else:
        rng = np.random.RandomState(11)
        img = (torch.full((len(heights), H, W), 0.375) if kind == "flat"
               else torch.from_numpy(rng.rand(len(heights), H, W)
                                     .astype(np.float32)))
        h = torch.tensor(heights, dtype=torch.int32)
        w = torch.tensor(widths, dtype=torch.int32)
    img, h, w = img.to(dev), h.to(dev), w.to(dev)
    if kind == "misaligned":
        buf = torch.empty(img.numel() + 1, device=dev)
        img = buf[1:].view(img.shape).copy_(img)
        assert img.data_ptr() % 16 == 4
    return img, h, w


@pytest.mark.gpu
@pytest.mark.parametrize("kind,H,W,heights,widths", FAST_INPUTS, ids=FAST_IDS)
def test_fast_select_kernel_matches_plain(cuda, kind, H, W, heights, widths):
    img, h, w = _fast_stack(kind, H, W, heights, widths, cuda)
    n0 = _build.LAUNCHES["fast_select"]
    kout = fast_cuda.fast_select(img, 0.04, 0.12, h, w, TAPS)
    again = fast_cuda.fast_select(img, 0.04, 0.12, h, w, TAPS)
    pb, pv, pr = fast_cuda.fast_select_reference(img, 0.04, 0.12, h, w, TAPS)
    assert _build.LAUNCHES["fast_select"] == n0 + 2
    assert all(torch.equal(x, y) for x, y in zip(kout, again))
    kb, kv, kr = kout
    assert torch.equal(kv, pv) and torch.equal(kr, pr)
    assert float((kb - pb).abs().max()) <= 1e-6
    if kind == "noise":
        assert int((kv > 0).sum()) > kv.shape[1]  # the trees ran
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
    (0, 300, 700, True), (2, 257, 1000, False), (3, 2048, 2048, True),
    (4, 64, 100, True), (5, 2048, 4096, False), (6, 257, 300, True)])
def test_hamming_argmin2_kernel_matches_plain(cuda, seed, M, N, want_cols):
    """Ragged row tiles (M = 257, 300), fewer columns than one split
    (N = 100), the production shapes, ties across column splits and row
    tiles, and rows whose every pair is gated out (_plant_edges)."""
    a, b, ahat, bhat = (x.to(cuda) for x in _match_problem(seed, M, N,
                                                           want_cols))
    n0 = _build.LAUNCHES["hamming_argmin2"]
    kout = match_cuda.hamming_argmin2(a, b, ahat, bhat, 1600.0, want_cols)
    again = match_cuda.hamming_argmin2(a, b, ahat, bhat, 1600.0, want_cols)
    pout = match_cuda.hamming_argmin2_reference(a, b, ahat, bhat, 1600.0,
                                                want_cols)
    assert _build.LAUNCHES["hamming_argmin2"] == n0 + 2
    for x, y in zip(kout, again):
        assert (x is None and y is None) or torch.equal(x, y)  # no atomics
    near = ((ahat.double() @ bhat.double()) - 1600.0).abs() < 1.6
    keep = ~near.any(1)
    for x, y in zip(kout[:3], pout[:3]):
        assert torch.equal(x[keep], y[keep])
    if want_cols:
        kc = ~near.any(0)
        assert torch.equal(kout[3][kc], pout[3][kc])
    else:
        assert kout[3] is None
    _check_edges(kout, want_cols)
    _check_edges(pout, want_cols)
    with pytest.raises(ValueError):
        match_cuda.hamming_argmin2(a, b, ahat.repeat(1, 2)[:, :17].contiguous(),
                                   bhat.repeat(2, 1)[:17].contiguous(),
                                   1600.0)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [333, 2048])
@pytest.mark.parametrize("B", [1, 2, 3])
def test_pose_lm_kernel_matches_plain(cuda, B, M):
    """One cluster of CTAs per candidate: B = 1 (the fast path's refines),
    2 (the portfolio's), 3; M = 333 leaves the cluster's last slice
    short."""
    T0, data, mask = (x.to(cuda) for x in _pose_problem(0, M, B))
    n0 = _build.LAUNCHES["pose_lm"]
    kT, kc = pose_opt_cuda.pose_lm(T0, data, mask, (8, 8))
    kT2, kc2 = pose_opt_cuda.pose_lm(T0, data, mask, (8, 8))
    pT, pc = pose_opt_cuda.pose_lm_reference(T0, data, mask, (8, 8))
    assert _build.LAUNCHES["pose_lm"] == n0 + 2
    assert torch.equal(kT, kT2) and torch.equal(kc, kc2)  # fixed order
    assert float((kT - pT).abs().max()) <= 2e-3
    edge = (pc - CHI2).abs() < 1e-3
    assert bool(torch.all(((kc < CHI2) == (pc < CHI2)) | edge | (mask < 0.5)))


@pytest.mark.gpu
def test_pose_lm_wrapper_rejects_what_the_kernel_cannot_take(cuda):
    T0, data, mask = (x.to(cuda) for x in _pose_problem(0, 64))
    with pytest.raises(ValueError, match="schedule"):
        pose_opt_cuda.pose_lm(T0, data, mask, (1, 1, 1, 1, 1))
    big = torch.zeros(22, 40000, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        pose_opt_cuda.pose_lm(T0, big, torch.ones(2, 40000, device=cuda),
                              (1,))
    assert pose_opt_cuda.pose_lm(T0[:0], data, mask[:0], (8, 8))[0].shape \
        == (0, 4, 4)


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 4, 8])
@pytest.mark.parametrize("Ok", [1, 1365, 8192])
@pytest.mark.parametrize("K", [1, 2, 6])
def test_ba_linearize_kernel_matches_plain(cuda, K, Ok, C):
    """bench.py's random problem at K keyframes x Ok observations with a
    C-camera rig (stage C is K=6, Ok=1365, C=4; the two-view init pair of
    a 1-camera rig K=2, Ok=8192, C=1): one launch per call, bitwise equal
    across two calls, the prepared call equal to the one-shot one."""
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(num_cams=C))
    f = synthetic.random_window_ba_problem(rig, num_kfs=K, num_lms=2048,
                                           obs_capacity=K * Ok, seed=K + C)
    args = ba.linearize_inputs(ba.problem_from_numpy(**f))  # on the card
    assert args[0].device.type == "cuda" and args[2].shape == (K * Ok,)
    n0 = _build.LAUNCHES["ba_linearize"]
    kout = ba_cuda.ba_linearize(*args)
    lin = ba_cuda.Linearizer(*args[2:6], *args[7:], K, 2048)
    again = lin(args[0], args[1], args[6])
    pout = ba_cuda.ba_linearize_reference(*args)
    assert _build.LAUNCHES["ba_linearize"] == n0 + 2
    for x, y in zip(kout, again):
        assert torch.equal(x, y)  # fixed reduction order: bitwise
    for i in (0, 1, 2):  # payload, r, w: the plain version's roundings
        assert torch.equal(kout[i], pout[i]), i
    for i in (3, 4):  # Hpp, gp: summed in another order
        err = (kout[i] - pout[i]).abs().max() / pout[i].abs().max()
        assert float(err) <= 1e-5, i
    H = kout[3].reshape(-1, 6, 6)
    assert torch.equal(H, H.transpose(1, 2))
    assert _build.library().mc_ba_linearize_cluster() > 1
    with pytest.raises(ValueError):
        ba_cuda.ba_linearize(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        lin(args[0], args[1], args[6][:-1])


@pytest.mark.gpu
def test_slice_on_cuda_matches_cpu(cuda):
    """The kernels' path (CUDA) against the plain path (CPU) on one frame
    of the small 2-camera scene (1 pyramid level: the resize matmuls of
    further levels round differently on the two devices)."""
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0), device="cpu")
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
        num_cams=3, baseline=0.2, image_size=(320, 240), focal=260.0),
        device="cpu")
    poses = synthetic.smooth_trajectory(8, radius=5.0, step_angle=0.03)
    imgs = synthetic.render_blob_images(rig, poses, synthetic.make_landmarks(
        700, seed=1, depth_range=(4.0, 12.0)), seed=2)
    cfg = SlamConfig(window_size=4, ba_obs_capacity=8192, ba_lm_capacity=1024,
                     local_map_landmarks=1024, kf_translation=0.2,
                     kf_rotation=0.1, min_inter_matches=40)
    runs = []
    for dev in ("cpu", cuda):
        n0 = _build.LAUNCHES["ba_linearize"]
        slam = MultiCameraSLAM(rig, cfg, device=dev)
        for k in range(len(poses)):
            slam.process_image(imgs[k], k / 20.0, extract_cfg=dict(
                num_points=512, num_levels=1, max_intra=768))
        _, est = slam.trajectory_arrays()
        assert slam.state == INITIALIZED and slam.stats["failures"] == 0
        runs.append((slam.stats, est, _build.LAUNCHES["ba_linearize"] - n0))
    (cpu_stats, cpu_est, cpu_n), (gpu_stats, gpu_est, gpu_n) = runs
    assert cpu_n == 0 and gpu_n > 0
    assert abs(cpu_stats["keyframes"] - gpu_stats["keyframes"]) <= 1
    gap = np.linalg.norm(gpu_est[:, :3, 3] - cpu_est[:, :3, 3], axis=-1)
    assert gap.max() <= 0.005, gap


@pytest.mark.gpu
@pytest.mark.parametrize("kind,H,W,heights,widths", FAST_INPUTS, ids=FAST_IDS)
@pytest.mark.parametrize("hskip", [True, False], ids=["hskip", "full"])
@pytest.mark.parametrize("blur", [True, False], ids=["blur", "noblur"])
def test_fast_corners_kernel_matches_plain(cuda, hskip, blur, kind, H, W,
                                           heights, widths):
    img, h, _ = _fast_stack(kind, H, W, heights, widths, cuda)
    name = "fast_corners_hskip" if hskip else "fast_corners_full"
    args = (img, 0.04, h if hskip else None, TAPS if blur else None)
    n0 = _build.LAUNCHES[name]
    kout = fast_cuda.fast_corners(*args)
    again = fast_cuda.fast_corners(*args)
    pout = fast_cuda.fast_corners_reference(*args)
    assert _build.LAUNCHES[name] == n0 + 2
    if not blur:
        kout, again, pout = (kout,), (again,), (pout,)
    for k, k2, p in zip(kout, again, pout):
        assert torch.equal(k, k2)
        assert torch.equal(k, p)
    with pytest.raises(ValueError):
        fast_cuda.fast_corners(img, 0.04, h.long(), None)


@pytest.mark.gpu
def test_patch_gather_batched_kernel_matches_plain(cuda):
    rng = np.random.RandomState(1)
    imgs = torch.from_numpy(rng.rand(4, 96, 200).astype(np.float32)).to(cuda)
    yx = torch.from_numpy(np.stack([rng.randint(0, 96, (4, 130)),
                                    rng.randint(0, 200, (4, 130))], -1)
                          .astype(np.int32)).to(cuda)
    n0 = _build.LAUNCHES["patch_gather_batched"]
    kp, ko = patch_cuda.patch_gather_batched(imgs, yx)
    pp, po = patch_cuda.patch_gather_batched_reference(imgs, yx)
    assert _build.LAUNCHES["patch_gather_batched"] == n0 + 1
    assert torch.equal(kp, pp) and torch.equal(ko, po)
    with pytest.raises(ValueError):
        patch_cuda.patch_gather_batched(imgs, yx[:3])


def _oriented_inputs(T, W, dev, B=5, H=100, seed=2):
    """T keypoints over B random H x W images, the first ones at the four
    corners and past each border (their windows clamp), the rest anywhere
    within 3 px of the images."""
    rng = np.random.RandomState(seed + T + W)
    imgs = torch.from_numpy(rng.rand(B, H, W).astype(np.float32)).to(dev)
    yx = np.stack([rng.randint(-3, H + 3, T), rng.randint(-3, W + 3, T)], -1)
    edges = [(0, 0), (H - 1, W - 1), (0, W - 1), (H - 1, 0), (-7, 60),
             (H + 4, 61), (50, -2), (51, W + 9)]
    yx[:min(T, len(edges))] = edges[:T]
    idx = rng.randint(0, B, T)
    return (imgs, torch.from_numpy(yx.astype(np.int32)).to(dev),
            torch.from_numpy(idx.astype(np.int32)).to(dev))


@pytest.mark.gpu
@pytest.mark.parametrize("W", [640, 200, 201])
@pytest.mark.parametrize("T", [1, 7, 3072])
def test_patch_gather_oriented_kernel_matches_plain(cuda, T, W):
    """Windows clamped at all four borders, odd and even t (a patch of
    1521 bf16 elements starts mid-word for odd t), W = 640 and 200 staged
    by 16-byte copies and W = 201 by 4-byte ones: bf16 patches, moments
    and origins bitwise equal to the plain version and across two runs."""
    imgs, yx, idx = _oriented_inputs(T, W, cuda)
    n0 = _build.LAUNCHES["patch_gather_oriented"]
    kout = patch_cuda.patch_gather_oriented(imgs, yx, idx)
    again = patch_cuda.patch_gather_oriented(imgs, yx, idx)
    pout = patch_cuda.patch_gather_oriented_reference(imgs, yx, idx)
    assert _build.LAUNCHES["patch_gather_oriented"] == n0 + 2
    for k, a, p in zip(kout, again, pout):  # moments in the same fixed order
        assert torch.equal(k, p) and torch.equal(k, a)
    with pytest.raises(ValueError):
        patch_cuda.patch_gather_oriented(imgs, yx, idx.long())


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["A", "B"])
def test_build_frame_routes_on_cuda_match_cpu(cuda, route):
    """build_frame under route A (score map with blur, late compaction) and
    route B (standalone blur, full score map, oriented gather) on the
    kernels (CUDA) against the plain versions (CPU), 1 pyramid level."""
    r = (orb.OrbRoute(select_in_kernel=False, late_compact=True)
         if route == "A" else
         orb.OrbRoute(fused_blur=False, hskip=False, fused_orient=True))
    names = (("fast_corners_hskip", "patch_gather_batched") if route == "A"
             else ("fast_corners_full", "patch_gather_oriented"))
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0), device="cpu")
    imgs = synthetic.render_blob_images(
        rig, synthetic.smooth_trajectory(1, step_angle=0.02),
        synthetic.make_landmarks(600, depth_range=(4.0, 15.0)))
    kw = dict(num_points=128, num_levels=1, max_intra=256, angle_bins=16,
              route=r)
    n0 = {n: _build.LAUNCHES[n] for n in names}
    ffs = [frame.build_frame(torch.from_numpy(imgs[0]).to(dev), rig.to(dev),
                             **kw) for dev in ("cpu", cuda)]
    assert all(_build.LAUNCHES[n] == n0[n] + 1 for n in names)
    cpu, gpu = ffs
    for name in ("kp_xy", "kp_response", "kp_octave", "kp_valid"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name))
    differ = ~torch.all(gpu.kp_desc.cpu() == cpu.kp_desc, dim=-1) \
        & cpu.kp_valid
    x = torch.remainder(cpu.kp_angle, 2 * np.pi) / (2 * np.pi) * 16
    near = (x - torch.floor(x) - 0.5).abs() * (2 * np.pi / 16) < 1e-4
    assert not bool((differ & ~near).any())


# vio_solve on the card against the CPU: both solve the damped step in
# float64, the vision sums differ in order (ba_linearize against its plain
# version); measured at most 2.8e-6 (velocities, the cold solve with GPS),
# so the states must agree to 1e-4 (chip_smoke.VIO_TOL)
VIO_TOL = dict(poses=1e-4, vels=1e-4, biases=1e-4, E_T_V=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("num_gps", [0, 6], ids=["no_gps", "gps"])
@pytest.mark.parametrize("iters", [1, 8], ids=["warm", "cold"])
def test_vio_solve_on_cuda_matches_cpu(cuda, iters, num_gps):
    """The visual-inertial window solve at bench.py's stage D shape (K=6,
    Ok=1365, L=2048, C=4, 5 IMU factors; with 6 GPS factors, 4 valid) on
    the card, with host syncs turned into errors, against the CPU."""
    from mcslam_tpu_torch.backend import ba_vio

    rig = synthetic.make_synthetic_rig(device=cuda)
    f = synthetic.random_vio_problem(rig, num_gps=num_gps)
    ref = ba_vio.vio_solve(ba_vio.problem_from_numpy(**dict(f, device="cpu")),
                           iters=iters, kf_blocked=True)
    p = ba_vio.problem_from_numpy(**f)
    torch.cuda.synchronize()
    n0 = _build.LAUNCHES["ba_linearize"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = ba_vio.vio_solve(p, iters=iters, kf_blocked=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["ba_linearize"] > n0
    err = {k: float((getattr(res, k).cpu() - getattr(ref, k)).abs().max())
           for k in VIO_TOL}
    print(f"vio_solve {iters} x 2, {num_gps} GPS: card vs CPU {err}")
    for k, tol in VIO_TOL.items():
        assert err[k] <= tol, err


# -- the generic layout and the mesh on the card ------------------------------
# generic against kf-blocked / CPU solves: tests/test_backend.py's 1e-3
# between the JAX package's two layouts; sharded against one device:
# tests/test_parallel.py's 5e-4 (observation-sharded) and 5e-3
# (landmark-sharded); frame builds and matches exact


def _stage_c(cuda):
    rig = synthetic.make_synthetic_rig(device=cuda)
    f = synthetic.random_window_ba_problem(rig, px_noise=0.5)
    return ba.problem_from_numpy(**f), f


@pytest.mark.gpu
def test_generic_ba_solve_on_cuda_matches_cpu(cuda):
    """ba_solve's generic layout (the default) at the stage C shape on the
    card, with host syncs turned into errors: twice bit-equal, within 1e-3
    of the CPU's generic solve and of the card's kf-blocked solve, and no
    ba_linearize launch (the generic path is plain PyTorch, as in JAX)."""
    p, f = _stage_c(cuda)
    torch.cuda.synchronize()
    n0 = _build.LAUNCHES["ba_linearize"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        a = ba.ba_solve(p, iters=1)
        b = ba.ba_solve(p, iters=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert _build.LAUNCHES["ba_linearize"] == n0
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    ref = ba.ba_solve(ba.problem_from_numpy(**dict(f, device="cpu")), iters=1)
    blk = ba.ba_solve(p, iters=1, kf_blocked=True)
    assert float((a.poses.cpu() - ref.poses).abs().max()) <= 1e-3
    assert float((a.poses - blk.poses).abs().max()) <= 1e-3


@pytest.mark.gpu
def test_sharded_solves_on_a_cuda_mesh(cuda):
    """Both sharded solves over a 4-shard mesh of the card(s), with host
    syncs turned into errors, against the single-device solve."""
    from mcslam_tpu_torch.parallel import mesh as mesh_mod
    from mcslam_tpu_torch.parallel import sharded_ba

    mesh = mesh_mod.spread_mesh(4, cuda)
    p, f = _stage_c(cuda)
    L = p.landmarks.shape[0]
    pg = ba.problem_from_numpy(**dict(f, obs=sharded_ba.shard_by_landmark(
        f["obs"], L, 4)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        obs_out = sharded_ba.sharded_ba_solve(
            mesh, *p[:3], p.kf_valid, p.obs, *p[4:8], iters=1)
        lm_out = sharded_ba.sharded_ba_solve_lm(
            mesh, *pg[:3], pg.kf_valid, pg.obs, *pg[4:8], iters=1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    ref = ba.ba_solve(p, iters=1)
    assert float((obs_out[0] - ref.poses).abs().max()) <= 5e-4
    assert float((lm_out[0] - ref.poses).abs().max()) <= 5e-3
    assert obs_out[1].shape == lm_out[1].shape == (L, 3)


@pytest.mark.gpu
def test_sharded_frame_build_and_match_on_cuda_are_exact(cuda):
    """The camera-sharded build of a 4-camera frame over 4 shards equals
    build_frame bit for bit, with fast_select and patch_gather launched
    once per shard; the map-sharded match equals the brute force."""
    from mcslam_tpu_torch.parallel import mesh as mesh_mod
    from mcslam_tpu_torch.parallel import sharded_frame, sharded_match

    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=4, baseline=0.25, image_size=(256, 192), focal=210.0),
        device=cuda)
    poses = synthetic.smooth_trajectory(1, radius=5.0, step_angle=0.03,
                                        seed=3)
    lms = synthetic.make_landmarks(500, seed=4, depth_range=(4.0, 12.0))
    imgs = torch.from_numpy(synthetic.render_blob_images(
        rig, poses, lms, seed=5)[0]).to(cuda)
    kw = dict(num_points=256, num_levels=3, max_intra=512)
    ref = frame.build_frame(imgs, rig, **kw)
    _build.LAUNCHES.clear()
    got = sharded_frame.sharded_build_frame(
        mesh_mod.spread_mesh(4, cuda, sharded_frame.AXIS), imgs, rig, **kw)
    assert _build.LAUNCHES["fast_select"] == 4
    assert _build.LAUNCHES["patch_gather"] == 4
    for name in ref._fields:
        assert torch.equal(getattr(got, name), getattr(ref, name)), name

    rng = np.random.RandomState(3)
    mdesc = rng.randint(0, 2**32, (1003, 8), dtype=np.uint64).astype(
        np.uint32)
    q = hamming.desc_to_torch(mdesc[rng.randint(0, 1003, 64)], cuda)
    mesh = mesh_mod.spread_mesh(4, cuda, sharded_match.AXIS)
    d_sh, v_sh, _ = sharded_match.shard_map_desc(mesh, mdesc,
                                                 np.ones(1003, bool))
    idx, ok, dist = sharded_match.sharded_hamming_match(
        mesh, q, torch.ones(64, dtype=torch.bool, device=cuda), d_sh, v_sh)
    d = hamming.hamming_matrix(q, hamming.desc_to_torch(mdesc, cuda))
    d1, i1 = torch.min(d, dim=1)
    assert torch.equal(idx.long(), i1) and torch.equal(dist, d1.int())
