"""Parity of the port's frame-build ops (mcslam_tpu_torch.ops: image, fast,
topk_grid, fast_cuda, patch_cuda, orb) with the JAX package on the same
numpy inputs, on the CPU. The Pallas kernels run in interpret mode.

Tolerances: pyramid levels 1e-6 (the f32 resize weights and products
round in a different order); FAST scores, selections, candidates and
patches exact; fast_select's blur 2e-6 at >= 13 px inside each true
image (the TPU kernel's FMA contraction); descriptors equal on >= 99.5 %
of valid keypoints (an orientation within an ulp of a steering-bin edge
may flip its bin)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.ops import fast as jfast
from mcslam_tpu.ops import image as jimage
from mcslam_tpu.ops import orb as jorb
from mcslam_tpu.ops import topk_grid as jtopk
from mcslam_tpu.ops.fast_pallas import fast_select_pallas
from mcslam_tpu.ops.patch_pallas import extract_patches_indexed_pallas
from mcslam_tpu_torch.ops import fast as tfast
from mcslam_tpu_torch.ops import fast_cuda, patch_cuda
from mcslam_tpu_torch.ops import hamming as thamming
from mcslam_tpu_torch.ops import image as timage
from mcslam_tpu_torch.ops import orb as torb
from mcslam_tpu_torch.ops import topk_grid as ttopk


def _t(x):
    return torch.from_numpy(np.array(x))


def _blob_images(num_cams=2, size=(192, 144), frame=0):
    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=num_cams, image_size=size, focal=130.0))
    poses = jsyn.smooth_trajectory(frame + 1, step_angle=0.02)
    lms = jsyn.make_landmarks(600, depth_range=(4.0, 15.0))
    return jsyn.render_blob_images(rig, poses, lms)[frame]


def _plateau_stack(seed, H, W, heights, widths):
    """Quantized pixels (forcing score ties) with per-image true bounds,
    edge-padded beyond them like the stacked pyramid."""
    rng = np.random.RandomState(seed)
    img = (rng.randint(0, 24, (len(heights), H, W)) / 24.0).astype(np.float32)
    for c, (h, w) in enumerate(zip(heights, widths)):
        img[c, h:] = img[c, h - 1]
        img[c, :, w:] = img[c, :, w - 1][:, None]
    return img


def test_constant_tables_match_jax():
    np.testing.assert_array_equal(torb.brief_pattern(), jorb.brief_pattern())
    for a, b in zip(torb._circle_weights(), jorb._circle_weights()):
        np.testing.assert_array_equal(a, b)
    for bins in (16, 32):
        D = jorb._steered_bit_matrices(bins)
        np.testing.assert_array_equal(torb._steered_bit_matrices(bins), D)
        # the gather tables name exactly D's -1 / +1 columns
        idx = torb._steered_sample_index(bins).reshape(bins * 256, 2)
        rows = np.arange(bins * 256)
        rebuilt = np.zeros_like(D)
        np.add.at(rebuilt, (rows, idx[:, 0]), -1.0)
        np.add.at(rebuilt, (rows, idx[:, 1]), 1.0)
        np.testing.assert_array_equal(rebuilt, D)
    assert timage._np_gaussian_taps(7, 2.0) == jimage._np_gaussian_taps(7, 2.0)
    assert torb._level_budget(768, 4, 1.2) == jorb._level_budget(768, 4, 1.2)


@pytest.mark.parametrize("size,levels", [((192, 144), 3), ((133, 97), 4)])
def test_pyramid_matches_jax(size, levels):
    rng = np.random.RandomState(1)
    img = rng.rand(2, size[1], size[0]).astype(np.float32)
    ref = jimage.build_pyramid(jnp.asarray(img), levels, 1.2)
    got = timage.build_pyramid(_t(img), levels, 1.2)
    for a, b in zip(ref, got):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)


def test_gaussian_blur_matches_jax():
    img = np.random.RandomState(2).rand(3, 60, 80).astype(np.float32)
    np.testing.assert_allclose(
        timage.gaussian_blur(_t(img)).numpy(),
        np.asarray(jimage.gaussian_blur(jnp.asarray(img))), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["blobs", "plateaus"])
def test_fast_corners_and_selection_exact(kind):
    if kind == "blobs":
        img = _blob_images()
    else:
        img = _plateau_stack(3, 90, 120, [90, 90], [120, 120])
    s_ref = np.asarray(jfast.fast_corners(jnp.asarray(img), 7.0 / 255.0))
    s_got = tfast.fast_corners(_t(img), 7.0 / 255.0).numpy()
    np.testing.assert_array_equal(s_got, s_ref)
    for c in range(img.shape[0]):
        ref = jtopk.select_keypoints(jnp.asarray(s_ref[c]), 96)
        got = ttopk.select_keypoints(_t(s_ref[c]), 96)
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


@pytest.mark.parametrize("H,W,heights,widths", [
    (90, 200, [90, 61, 40], [200, 170, 120]),  # partial last band
    (96, 256, [96, 77], [256, 200]),
])
def test_fast_select_plain_matches_pallas(H, W, heights, widths):
    """The plain fast_select against fast_select_pallas(tile_h=16) in
    interpret mode: candidates exact, blur within 2e-6 >= 13 px inside
    each true image (and bit-equal to fast_select's own rule elsewhere)."""
    img = _plateau_stack(7, H, W, heights, widths)
    taps = jimage._np_gaussian_taps(7, 2.0)
    h = np.asarray(heights, np.int32)
    w = np.asarray(widths, np.int32)
    jb, jv, jr = fast_select_pallas(
        jnp.asarray(img), 0.04, 0.12, jnp.asarray(h), jnp.asarray(w),
        taps=taps, tile_h=16, cell=16, k=4, interpret=True)
    tb, tv, tr = fast_cuda.fast_select(_t(img), 0.04, 0.12, _t(h), _t(w),
                                       taps)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    m = 13
    for c, hc in enumerate(heights):
        np.testing.assert_allclose(tb.numpy()[c, m:hc - m, m:W - m],
                                   np.asarray(jb)[c, m:hc - m, m:W - m],
                                   atol=2e-6, rtol=0)


def test_patch_gather_plain_matches_pallas():
    rng = np.random.RandomState(13)
    B, H, W, T = 5, 96, 200, 70
    imgs = rng.rand(B, H, W).astype(np.float32)
    yx = np.stack([rng.randint(0, H, T), rng.randint(0, W, T)],
                  -1).astype(np.int32)
    idx = rng.randint(0, B, T).astype(np.int32)
    ref_p, ref_o = extract_patches_indexed_pallas(
        jnp.asarray(imgs), jnp.asarray(yx), jnp.asarray(idx), batch=16,
        interpret=True)
    got_p, got_o = patch_cuda.patch_gather(_t(imgs), _t(yx), _t(idx))
    np.testing.assert_array_equal(got_o.numpy(), np.asarray(ref_o))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(ref_p))


def test_orientation_and_descriptors_match_jax():
    rng = np.random.RandomState(4)
    # intensity ramps in random directions plus noise: well-defined
    # centroid angles (pure noise leaves near-cancelling moments)
    g = np.arange(torb.PATCH, dtype=np.float32) / torb.PATCH
    a = rng.randn(300, 2, 1, 1).astype(np.float32)
    patches = (0.5 + 0.3 * (a[:, 0] * g[None, :] + a[:, 1] * g[:, None])
               + 0.05 * rng.rand(300, torb.PATCH, torb.PATCH)).astype(
                   np.float32)
    zero = jnp.zeros((300, 2), jnp.int32)
    ang_ref = np.asarray(jorb.patch_orientation(jnp.asarray(patches), zero,
                                                zero))
    ang = torb.patch_orientation(_t(patches)).numpy()
    np.testing.assert_allclose(ang, ang_ref, atol=1e-5, rtol=0)
    # same angles on both sides: the descriptor bits must be identical
    d_ref = np.asarray(jorb.compute_descriptors_patch(
        jnp.asarray(patches), jnp.zeros((300, 2)), jnp.asarray(ang_ref), 16))
    d = torb.compute_descriptors_patch(_t(patches), _t(ang_ref), 16)
    np.testing.assert_array_equal(thamming.desc_to_numpy_u32(d), d_ref)


def _orb_ref(img, levels):
    return jorb.extract_orb_rig(jnp.asarray(img), num_points=128,
                                num_levels=levels, angle_bins=16,
                                approx_topk=True)


def _assert_keypoints_equal(ref, got):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(got.xy.numpy(), np.asarray(ref.xy))
    np.testing.assert_array_equal(got.octave.numpy(), np.asarray(ref.octave))
    np.testing.assert_array_equal(got.response.numpy(),
                                  np.asarray(ref.response))
    np.testing.assert_array_equal(got.sigma2.numpy(), np.asarray(ref.sigma2))
    v = np.asarray(ref.valid)
    same = np.all(thamming.desc_to_numpy_u32(got.desc) == np.asarray(ref.desc),
                  axis=-1)
    assert same[v].mean() >= 0.995, same[v].mean()


def test_extract_orb_single_level_matches_jax():
    img = _blob_images()
    _assert_keypoints_equal(_orb_ref(img, 1),
                            torb.extract_orb_rig(_t(img), num_points=128,
                                                 num_levels=1, angle_bins=16))


def test_extract_orb_from_same_pyramid_matches_jax():
    """Given JAX's own pyramid levels, selection, octaves and validity are
    exact across levels (the pyramids themselves agree to 1e-6, which can
    reorder plateau ties on levels >= 1, see the next test)."""
    img = _blob_images()
    levels = jimage.build_pyramid(jnp.asarray(img), 2, 1.2)
    got = torb.extract_orb_levels([_t(lv) for lv in levels], num_points=128,
                                  angle_bins=16)
    _assert_keypoints_equal(_orb_ref(img, 2), got)


def test_extract_orb_own_pyramid_keeps_the_keypoint_set():
    img = _blob_images()
    ref = _orb_ref(img, 2)
    got = torb.extract_orb_rig(_t(img), num_points=128, num_levels=2,
                               angle_bins=16)
    for c in range(img.shape[0]):
        a = {tuple(p) for p in np.asarray(ref.xy)[c][np.asarray(ref.valid)[c]]}
        b = {tuple(p) for p in got.xy.numpy()[c][got.valid.numpy()[c]]}
        assert len(a & b) >= 0.95 * max(len(a), len(b)), (len(a & b), len(a),
                                                          len(b))
