"""Parity of the port's public ops and loop helpers with the JAX package's
functions of the same names, on the same numpy inputs (CPU): ops/orb
(patches, single-image extraction), ops/match.topk_neighbors,
ops/hamming.hamming_pairwise, ops/image (Gaussian taps, gray, CLAHE-like
normalization), loop/vocab.score_database and loop/detector's
LoopCloser.retrieve. One parametrised test, one case per helper.

Tolerances: patches, origins, keypoints, integer distances, neighbour
indices (with planted ties: the lower index first, as jax.lax.top_k)
and retrieval exact; descriptors equal on >= 99.5 % of valid keypoints
(tests/test_torch_ops.py's bound); float32 outputs 1e-6 (rounding
order: a sum of 7 taps, a 3-term dot, a box filter of 15 taps, a
sigmoid); BoW scores 1e-6."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu.data import synthetic as jsyn
from mcslam_tpu.loop import detector as jdet
from mcslam_tpu.loop import vocab as jvocab
from mcslam_tpu.ops import hamming as jham
from mcslam_tpu.ops import image as jimage
from mcslam_tpu.ops import match as jmatch
from mcslam_tpu.ops import orb as jorb
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.loop import detector as tdet
from mcslam_tpu_torch.loop import vocab as tvocab
from mcslam_tpu_torch.ops import hamming as tham
from mcslam_tpu_torch.ops import image as timage
from mcslam_tpu_torch.ops import match as tmatch
from mcslam_tpu_torch.ops import orb as torb


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, ref, atol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol,
                               rtol=0)


def _image(size=(160, 120), frame=0):
    """Camera 0 of the blob scene at `size` (the JAX generator)."""
    rig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(
        num_cams=1, image_size=size, focal=110.0))
    poses = jsyn.smooth_trajectory(frame + 1, step_angle=0.02)
    lms = jsyn.make_landmarks(500, depth_range=(4.0, 15.0))
    return jsyn.render_blob_images(rig, poses, lms)[frame, 0]


# -- ops/orb -----------------------------------------------------------------


def case_extract_patches():
    img = _image()
    rng = np.random.RandomState(0)
    # interior keypoints and ones whose window is clamped at each border
    yx = np.concatenate([rng.randint(0, [120, 160], (40, 2)),
                         [[0, 0], [119, 159], [3, 150], [110, 2]]]
                        ).astype(np.int32)
    got = torb.extract_patches(_t(img), _t(yx))
    ref = jorb.extract_patches(jnp.asarray(img), jnp.asarray(yx))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def case_extract_patches_indexed():
    imgs = np.stack([_image(), _image(frame=1)[::-1].copy(), _image() * 0.5])
    rng = np.random.RandomState(1)
    yx = rng.randint(0, [120, 160], (50, 2)).astype(np.int32)
    idx = rng.randint(0, 3, 50).astype(np.int32)
    got = torb.extract_patches_indexed(_t(imgs), _t(yx), _t(idx))
    ref = jorb.extract_patches_indexed(jnp.asarray(imgs), jnp.asarray(yx),
                                       jnp.asarray(idx))
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def case_extract_orb():
    """One level (the pyramid is not on this path): every field exact but
    the descriptors (tests/test_torch_ops.py's 99.5 %)."""
    img = _image()
    kw = dict(num_points=96, num_levels=1, angle_bins=16)
    got = torb.extract_orb(_t(img), **kw)
    ref = jorb.extract_orb(jnp.asarray(img), approx_topk=True, **kw)
    assert got.xy.shape == (96, 2) and got.valid.shape == (96,)
    for f in ("valid", "xy", "octave", "response", "sigma2"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    v = np.asarray(ref.valid)
    assert v.sum() > 40
    same = np.all(tham.desc_to_numpy_u32(got.desc) == np.asarray(ref.desc),
                  axis=-1)
    assert same[v].mean() >= 0.995, same[v].mean()


# -- ops/match, ops/hamming --------------------------------------------------


def case_topk_neighbors():
    """Hamming-like integer distances with planted ties (whole rows of
    equal values, and a tie straddling the k-th place), with and without
    a column mask."""
    rng = np.random.RandomState(2)
    d = rng.randint(0, 12, (30, 50)).astype(np.int32)
    d[0] = 5
    d[1, [3, 17, 40]] = 0
    d[2, :] = 9
    d[2, [10, 20, 30, 45]] = 1
    col = rng.rand(50) > 0.3
    for k in (1, 4, 7):
        for mask in (None, col):
            got = tmatch.topk_neighbors(
                _t(d), k, None if mask is None else _t(mask))
            ref = jmatch.topk_neighbors(
                jnp.asarray(d), k, None if mask is None else jnp.asarray(mask))
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
            assert got[0].dtype == torch.int32 and got[1].dtype == torch.int32
    np.testing.assert_array_equal(tmatch.topk_neighbors(_t(d), 4)[0][0].numpy(),
                                  [0, 1, 2, 3])


def case_hamming_pairwise():
    rng = np.random.RandomState(3)
    a = rng.randint(0, 2**32, (4, 30, 8), dtype=np.uint64).astype(np.uint32)
    b = a.copy()
    b[:, ::2] = rng.randint(0, 2**32, (4, 15, 8), dtype=np.uint64).astype(
        np.uint32)
    b[0, 1] = ~a[0, 1]  # distance 256
    got = tham.hamming_pairwise(tham.desc_to_torch(a, "cpu"),
                                tham.desc_to_torch(b, "cpu"))
    ref = jham.hamming_pairwise(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32 and got[0, 1] == 256 and got[0, 3] == 0


# -- ops/image ---------------------------------------------------------------


def case_gaussian_kernel():
    for ksize, sigma in ((7, 2.0), (5, 1.1), (9, 3.0)):
        _close(timage.gaussian_kernel(ksize, sigma, device="cpu"),
               jimage.gaussian_kernel(ksize, sigma), 1e-7)


def case_rgb_to_gray():
    rgb = np.random.RandomState(4).rand(2, 24, 32, 3).astype(np.float32)
    _close(timage.rgb_to_gray(_t(rgb)), jimage.rgb_to_gray(jnp.asarray(rgb)),
           1e-6)


def case_clahe_like():
    img = np.stack([_image(), _image(frame=1)])
    got = timage.clahe_like(_t(img))
    ref = jimage.clahe_like(jnp.asarray(img))
    assert got.shape == img.shape
    _close(got, ref, 1e-6)


# -- loop/vocab, loop/detector -----------------------------------------------


def case_score_database():
    rng = np.random.RandomState(5)
    db = rng.rand(12, 40).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    q = db[7] + 0.01 * rng.rand(40).astype(np.float32)
    q /= np.linalg.norm(q)
    got = tvocab.score_database(_t(q), _t(db))
    ref = jvocab.score_database(jnp.asarray(q), jnp.asarray(db))
    _close(got, ref, 1e-6)
    assert int(torch.argmax(got)) == 7


def case_loop_closer_retrieve():
    """A revisit sequence through both LoopClosers: the same single
    candidate (or None) for every query, and at least one firing."""
    descs = jsyn.make_descriptors(600, seed=6)
    jv = jvocab.Vocabulary.train(descs, k=4, depth=2, iters=2)
    tv = tvocab.Vocabulary.train(descs, k=4, depth=2, iters=2)
    cfg = dict(dislocal=4, k_consistency=1, min_nss=0.05, alpha=0.3)
    jl = jdet.LoopCloser(jv, jsyn.make_synthetic_rig(
        jsyn.SyntheticRigSpec(num_cams=2)), jdet.LoopConfig(**cfg))
    tl = tdet.LoopCloser(tv, tsyn.make_synthetic_rig(
        tsyn.SyntheticRigSpec(num_cams=2), device="cpu"),
        tdet.LoopConfig(**cfg))
    rng = np.random.RandomState(7)
    base = rng.rand(8, tv.num_words).astype(np.float32)
    seq = [base[k] for k in range(8)] + [base[k] + 0.05 * rng.rand(
        tv.num_words).astype(np.float32) for k in (1, 2, 3, 3, 4)]
    fired = 0
    for k, v in enumerate(seq):
        bow = (v / np.linalg.norm(v)).astype(np.float32)
        got, ref = tl.retrieve(bow), jl.retrieve(bow)
        assert got == ref, (k, got, ref)
        fired += got is not None
        tl.add_keyframe(k, bow)
        jl.add_keyframe(k, bow)
    assert fired >= 1


CASES = {name[5:]: fn for name, fn in list(globals().items())
         if name.startswith("case_")}


@pytest.mark.parametrize("name", sorted(CASES))
def test_helper_matches_jax(name):
    CASES[name]()
