"""The port's ORB extraction routes (ops.orb.OrbRoute) and their kernels'
plain versions against the JAX package on the same numpy inputs, on the
CPU. The Pallas kernels run in interpret mode; the JAX package selects its
routes with environment switches (set here with monkeypatch), the port
with explicit OrbRoute fields.

Route A = OrbRoute(select_in_kernel=False, late_compact=True): score map
with the blur (fast_corners, mode hskip) and the selection chain outside
the kernel, descriptors for every slot, compaction after
(patch_gather_batched). Route B = OrbRoute(fused_blur=False, hskip=False,
fused_orient=True): standalone blur, score map without the skip
(fast_corners, mode full), patch gather with the orientation moments
(patch_gather_oriented).

Tolerances: FAST scores, zeroed bands, patches, origins, keypoints,
responses and descriptors exact; the blur within 1e-6 of the Pallas
kernel's (its multiply-adds are contracted into FMAs on the CPU; the
plain version rounds each product, as the CUDA kernel does); moments
within 1e-5 of the sum of their 1521 |products| (the Pallas kernel sums
in another order, and the moments of a nearly flat window cancel),
angles 1e-4; IC angles of whole routes 1e-5 (the moment matmul's
summation order)."""

import pathlib
import re

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.ops import image as jimage
from mcslam_tpu.ops import orb as jorb
from mcslam_tpu.ops import topk_grid as jtopk
from mcslam_tpu.ops.fast_pallas import fast_corners_pallas
from mcslam_tpu.ops.patch_pallas import (extract_patches_oriented_pallas,
                                         extract_patches_pallas)
from mcslam_tpu_torch import tracking_kernels as ttk
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.frontend import frame as tframe
from mcslam_tpu_torch.ops import fast as tfast
from mcslam_tpu_torch.ops import fast_cuda, patch_cuda
from mcslam_tpu_torch.ops import hamming as tham
from mcslam_tpu_torch.ops import orb as torb
from mcslam_tpu_torch.ops import topk_grid as ttopk
from test_torch_ops import _plateau_stack

REPO = pathlib.Path(__file__).resolve().parents[1]
ROUTE_A = torb.OrbRoute(select_in_kernel=False, late_compact=True)
ROUTE_B = torb.OrbRoute(fused_blur=False, hskip=False, fused_orient=True)
TAPS = jimage._np_gaussian_taps(7, 2.0)
KW = dict(num_points=128, angle_bins=16)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def blobs():
    """Frame 0 of the 2-camera 192x144 blob scene and JAX's 2-level
    pyramid of it (the two packages' pyramids agree to 1e-6 only, see
    tests/test_torch_ops.py, so the routes are compared on one pyramid)."""
    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0))
    poses = jsyn.smooth_trajectory(2, step_angle=0.02)
    lms = jsyn.make_landmarks(600, depth_range=(4.0, 15.0))
    imgs = jsyn.render_blob_images(rig, poses, lms)
    levels = jimage.build_pyramid(jnp.asarray(imgs[0]), 2, 1.2)
    return imgs, [_t(lv) for lv in levels]


def _jax_orb(img, monkeypatch, **env):
    with monkeypatch.context() as m:
        for k, v in env.items():
            m.setenv(k, v)
        return jorb.extract_orb_rig(jnp.asarray(img), num_levels=2,
                                    approx_topk=False, **KW)


def _assert_keypoints_exact(ref, got):
    for name in ("xy", "response", "octave", "sigma2", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_array_equal(tham.desc_to_numpy_u32(got.desc),
                                  np.asarray(ref.desc))
    v = np.asarray(ref.valid)
    np.testing.assert_allclose(got.angle.numpy()[v], np.asarray(ref.angle)[v],
                               atol=1e-5, rtol=0)


def _bin_edge_distance(angle, bins):
    """Radians from each angle to the nearest steering-bin boundary."""
    x = (torch.remainder(angle, 2 * np.pi) / (2 * np.pi)) * bins
    return (x - torch.floor(x) - 0.5).abs() * (2 * np.pi / bins)


@pytest.mark.parametrize("hskip", [True, False], ids=["hskip", "full"])
@pytest.mark.parametrize("blur", [True, False], ids=["blur", "noblur"])
def test_fast_corners_reference_matches_pallas(hskip, blur):
    heights, widths = [96, 61, 40], [160, 140, 100]
    img = _plateau_stack(7, 96, 160, heights, widths)
    h = np.asarray(heights, np.int32)
    ref = fast_corners_pallas(jnp.asarray(img), 0.04, tile_h=16,
                              interpret=True,
                              heights=jnp.asarray(h) if hskip else None,
                              taps=TAPS if blur else None)
    got = fast_cuda.fast_corners(_t(img), 0.04, _t(h) if hskip else None,
                                 TAPS if blur else None)
    if not blur:
        ref, got = (ref,), (got,)
    score = got[0].numpy()
    np.testing.assert_array_equal(score, np.asarray(ref[0]))
    assert (score > 0).sum() > 1000  # plateau ties survive NMS
    full = tfast.fast_corners(_t(img), 0.04).numpy()
    if hskip:  # the skipped bands are zero, the others the full map
        skip_from = h if blur else h - tfast.BORDER
        band = (np.arange(96) // 16) * 16
        live = band[None, :] < skip_from[:, None]
        assert not live.all()
        np.testing.assert_array_equal(score, np.where(live[..., None], full,
                                                      0.0))
    else:
        np.testing.assert_array_equal(score, full)
    if blur:
        b, rb = got[1].numpy(), np.asarray(ref[1])
        np.testing.assert_array_equal(b == 0.0, rb == 0.0)
        np.testing.assert_allclose(b, rb, atol=1e-6, rtol=0)
        # the same blur, bit for bit, as fast_select's plain version
        sel_blur, _, _ = fast_cuda.fast_select_reference(
            _t(img), 0.04, 0.12, _t(h) if hskip else _t(np.full(3, 96,
                                                                np.int32)),
            _t(np.asarray(widths, np.int32)), TAPS)
        assert torch.equal(got[1], sel_blur)


def test_patch_gather_batched_reference_matches_pallas():
    rng = np.random.RandomState(13)
    C, H, W, N = 3, 96, 200, 40
    imgs = rng.rand(C, H, W).astype(np.float32)
    yx = np.stack([rng.randint(0, H, (C, N)), rng.randint(0, W, (C, N))],
                  -1).astype(np.int32)
    yx[0, :4] = [[0, 0], [H - 1, W - 1], [5, W - 2], [H - 3, 7]]  # clamped
    ref_p, ref_o = extract_patches_pallas(jnp.asarray(imgs), jnp.asarray(yx),
                                          batch=16, interpret=True)
    got_p, got_o = patch_cuda.patch_gather_batched(_t(imgs), _t(yx))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))
    assert got_o[0, 1].tolist() == [H - 39, W - 39]


def test_patch_gather_oriented_reference_matches_pallas():
    rng = np.random.RandomState(5)
    B, H, W, T = 3, 96, 200, 70
    # intensity ramps plus noise: well-defined centroid angles
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    a = rng.randn(B, 2, 1, 1).astype(np.float32)
    imgs = (0.5 + 0.002 * (a[:, 0] * xx + a[:, 1] * yy)
            + 0.1 * rng.rand(B, H, W)).astype(np.float32)
    yx = np.stack([rng.randint(0, H, T), rng.randint(0, W, T)],
                  -1).astype(np.int32)
    idx = rng.randint(0, B, T).astype(np.int32)
    ref_p, ref_m, ref_o = extract_patches_oriented_pallas(
        jnp.asarray(imgs), jnp.asarray(yx), jnp.asarray(idx), batch=16,
        interpret=True)
    got_p, got_m, got_o = patch_cuda.patch_gather_oriented(
        _t(imgs), _t(yx), _t(idx))
    assert got_p.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_equal(got_p.float().numpy(),
                                  np.asarray(ref_p).astype(np.float32))
    # the moments of the f32 window under the circle weights, in f64; each
    # moment's rounding scales with the sum of its |products|
    win, _ = patch_cuda.patch_gather_reference(_t(imgs), _t(yx), _t(idx))
    prods = (win.double().reshape(T, 1, -1)
             * patch_cuda.circle_weights().double())
    exact, scale = prods.sum(-1).numpy(), prods.abs().sum(-1).numpy()
    rm, gm = np.asarray(ref_m), got_m.numpy()
    assert np.all(np.abs(gm - rm) <= 1e-5 * scale)
    assert np.all(np.abs(gm - exact) <= 1e-5 * scale)
    np.testing.assert_allclose(np.arctan2(gm[:, 1], gm[:, 0]),
                               np.arctan2(rm[:, 1], rm[:, 0]), atol=1e-4,
                               rtol=0)


def test_kernel_circle_table_matches_circle_weights():
    """The oriented kernel's circle test (dx^2 + dy^2 against a squared
    radius, on the window offsets it advances by increments) describes
    exactly orb._circle_weights' circle."""
    src = (REPO / "mcslam_tpu_torch/csrc/patch_gather.cu").read_text()
    r2 = int(re.search(r"dx \* dx \+ dy \* dy <= (\d+);", src).group(1))
    wx, wy = jorb._circle_weights()
    d = np.arange(39) - 19
    inside = d[None, :] ** 2 + d[:, None] ** 2 <= r2
    np.testing.assert_array_equal(wx, np.where(inside, d[None, :], 0))
    np.testing.assert_array_equal(wy, np.where(inside, d[:, None], 0))
    np.testing.assert_array_equal(
        patch_cuda.circle_weights().numpy(),
        np.stack([wx.reshape(-1), wy.reshape(-1)]))


def test_route_a_matches_jax_late_compact(blobs, monkeypatch):
    imgs, levels = blobs
    ref = _jax_orb(imgs[0], monkeypatch, MCSLAM_LATE_COMPACT="1")
    got = torb.extract_orb_levels(levels, route=ROUTE_A, **KW)
    assert int(got.valid.sum()) > 150
    _assert_keypoints_exact(ref, got)


def test_sel_subcell_route_matches_jax(blobs, monkeypatch):
    imgs, levels = blobs
    ref = _jax_orb(imgs[0], monkeypatch, MCSLAM_SEL_SUBCELL="1")
    got = torb.extract_orb_levels(
        levels, route=torb.OrbRoute(select_in_kernel=False, sel_subcell=True),
        **KW)
    _assert_keypoints_exact(ref, got)


@pytest.mark.parametrize("kind", ["blobs", "plateaus"])
def test_select_keypoints_subcell_matches_jax(kind):
    if kind == "blobs":
        img = jsyn.render_blob_images(
            jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
                num_cams=2, image_size=(150, 100), focal=100.0)),
            jsyn.smooth_trajectory(1), jsyn.make_landmarks(500))[0]
    else:
        img = _plateau_stack(3, 90, 120, [90, 90], [120, 120])
    score = tfast.fast_corners(_t(img), 7.0 / 255.0)
    got = ttopk.select_keypoints_subcell(score, 96)  # both images at once
    for c in range(img.shape[0]):
        ref = jtopk.select_keypoints_subcell(jnp.asarray(score[c].numpy()),
                                             96)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b[c].numpy(), np.asarray(a))


def test_route_b_matches_the_default_route(blobs):
    _, levels = blobs
    ref = torb.extract_orb_levels(levels, **KW)
    got = torb.extract_orb_levels(levels, route=ROUTE_B, **KW)
    for name in ("xy", "response", "octave", "sigma2", "valid"):
        assert torch.equal(getattr(got, name), getattr(ref, name)), name
    v = ref.valid
    d = torch.remainder(got.angle - ref.angle + np.pi, 2 * np.pi) - np.pi
    assert float(d[v].abs().max()) <= 1e-5
    differ = ~torch.all(got.desc == ref.desc, dim=-1) & v
    # a descriptor may differ only where the angle sits at a bin boundary,
    # or where a BRIEF sample (<= 18 px from the keypoint) reads the 3-px
    # border of the stacked image: the standalone blur reflects there, the
    # fused one clamps rows and wraps columns
    near = _bin_edge_distance(ref.angle, KW["angle_bins"]) < 1e-4
    s = 1.2 ** ref.octave.to(torch.float32)
    x, y = torch.round(ref.xy[..., 0] / s), torch.round(ref.xy[..., 1] / s)
    H, W = levels[0].shape[-2:]
    border = (x < 21) | (y < 21) | (x >= W - 21) | (y >= H - 21)
    assert not bool((differ & ~near & ~border).any())


def test_build_and_track_step_takes_every_route():
    """The fused frame program on the 2-camera scene under each route:
    routes A and B give the default route's packed tracking output."""
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, image_size=(192, 144), focal=130.0), device="cpu")
    poses = tsyn.smooth_trajectory(2, step_angle=0.02)
    imgs = tsyn.render_blob_images(
        rig, poses, tsyn.make_landmarks(600, depth_range=(4.0, 15.0)))
    kw = dict(num_points=128, num_levels=2, max_intra=256, angle_bins=16)
    ff0 = tframe.build_frame(torch.from_numpy(imgs[0]), rig, **kw)
    ffa = tframe.build_frame(torch.from_numpy(imgs[0]), rig, route=ROUTE_A,
                             **kw)
    for name in tframe.FrameFeatures._fields:
        if name != "kp_angle":
            assert torch.equal(getattr(ffa, name), getattr(ff0, name)), name
    v0 = ff0.im_valid & ff0.im_has_depth
    ids = torch.arange(v0.shape[0], dtype=torch.int32)
    cand = torch.nonzero(v0)[:, 0].to(torch.int32)
    cand_ids = torch.zeros(256, dtype=torch.int32)
    cand_ids[:len(cand)] = cand
    nrm = ff0.im_point3d / ff0.im_point3d.norm(dim=1, keepdim=True)
    packed = []
    for route in (torb.OrbRoute(), ROUTE_A, ROUTE_B):
        *_, p = ttk._build_and_track_step(
            torch.Generator().manual_seed(0), torch.from_numpy(imgs[1]), rig,
            ff0.im_desc, ff0.im_valid,
            torch.where(v0, ids, torch.full_like(ids, -1)), ff0.im_point3d,
            v0, ff0.im_desc, nrm, cand_ids, torch.arange(256) < len(cand),
            torch.eye(4), fast_threshold=20 / 255, min_threshold=7 / 255,
            min_z=0.5, max_z=40.0, num_hyp=64, px=5.0, max_dist=64,
            ratio=0.85, image_wh=rig.image_size, lm_radius=18.0,
            lm_max_dist=60, gate_px=100.0, fastpath_frac=0.6,
            fastpath_min=30, route=route, **kw)
        packed.append(p)
    assert packed[0][16] >= 30  # tracked: enough inliers
    for p in packed[1:]:
        assert torch.equal(p, packed[0])
