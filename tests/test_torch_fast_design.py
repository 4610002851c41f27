"""The FAST kernels' design (csrc/fast_select.cu), checked on the CPU:

* the compass pre-test that decides which pixels run the arc trees is
  exact: every circle pattern with 9 contiguous pixels beyond the
  threshold has two compass points among them;
* a numpy model of the kernel's score in its order of operations (the
  compass test per polarity, with the lower compass difference taken as
  -(centre - lower) as the kernel's column walk does; for a pixel that
  only one polarity can pass, one doubling tree m2 -> m4 -> m8 -> m9 on
  sgn * d; for one that both can pass, the trees on d and on -d; the
  pairwise max over the starts) equals ops/fast.fast_score bit for bit.

Imports no JAX; the model and the plain version see the same f32 inputs
and threshold."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch.ops import fast

COMPASS = (0, 4, 8, 12)


def test_compass_pretest_is_exact():
    """Over all 2^16 above / below patterns of the circle: a 9-long cyclic
    run holds at least two compass points, and two is all the test may
    ask (some runs hold exactly two)."""
    p = np.arange(1 << 16, dtype=np.int64)
    run = np.zeros(p.shape, bool)
    for s in range(16):
        m = sum(1 << ((s + j) % 16) for j in range(fast.ARC_LEN))
        run |= (p & m) == m
    n_compass = sum((p >> c) & 1 for c in COMPASS)
    assert run[0xFFFF] and run[0x01FF] and not run[0x00FF]
    assert np.all(n_compass[run] >= 2)
    assert np.any(n_compass[run] == 2)


def _arc_score(e):
    """The kernel's arc_score of 16 difference arrays: the doubling tree
    of 9-long arc minima, then the pairwise max over the starts
    (e[s] = max(e[s], e[s + w]) for w = 8, 4, 2, 1)."""
    m2 = [np.minimum(e[s], e[(s + 1) % 16]) for s in range(16)]
    m4 = [np.minimum(m2[s], m2[(s + 2) % 16]) for s in range(16)]
    m = [np.minimum(np.minimum(m4[s], m4[(s + 4) % 16]), e[(s + 8) % 16])
         for s in range(16)]
    w = 8
    while w:
        for s in range(w):
            m[s] = np.maximum(m[s], m[s + w])
        w //= 2
    return m[0]


def _two_of_four(a, b, c, e):
    return (a & b) | (c & e) | ((a | b) & (c | e))


def _kernel_score(img: np.ndarray, thr: np.float32) -> np.ndarray:
    """The kernel's FAST score of (N, H, W) f32 images, in its order of
    operations."""
    N, H, W = img.shape
    pad = np.pad(img, ((0, 0), (3, 3), (3, 3)), mode="edge")
    at = [pad[:, 3 + dy:3 + dy + H, 3 + dx:3 + dx + W]
          for dy, dx in fast.CIRCLE]
    d = [a - img for a in at]
    up, right, left = d[0], d[4], d[12]
    u_low = img - at[8]  # the lower difference, negated
    ys, xs = np.arange(H)[:, None], np.arange(W)[None, :]
    interior = ((ys >= fast.BORDER) & (ys < H - fast.BORDER)
                & (xs >= fast.BORDER) & (xs < W - fast.BORDER))
    bright = interior & _two_of_four(up > thr, right > thr, u_low < -thr,
                                     left > thr)
    dark = interior & _two_of_four(up < -thr, right < -thr, u_low > thr,
                                   left < -thr)
    sgn = np.where(dark & ~bright, np.float32(-1), np.float32(1))
    one = _arc_score([x * sgn for x in d])
    both = np.maximum(_arc_score(d), _arc_score([-x for x in d]))
    zero = np.float32(0)
    return np.where(bright ^ dark, np.where(one > thr, one, zero),
                    np.where(bright & dark & (both > thr), both, zero)
                    ).astype(np.float32)


def _blobs(rng, N, H, W):
    """bench-like: low-amplitude noise with constant square blobs."""
    img = rng.rand(N, H, W).astype(np.float32) * np.float32(0.02)
    for n in range(N):
        for _ in range(12):
            y, x, s = rng.randint(0, H), rng.randint(0, W), rng.randint(1, 6)
            img[n, max(y - s, 0):y + s + 1, max(x - s, 0):x + s + 1] = \
                np.float32(rng.uniform(0.4, 1.0))
    return img, np.float32(7.0 / 255.0)


def _eighths(rng, N, H, W, ulps):
    """Values k/8: many differences sit exactly at +-1/8; the threshold is
    1/8 moved by `ulps` f32 ulps."""
    img = (rng.randint(0, 9, (N, H, W)) / 8.0).astype(np.float32)
    thr = np.float32(0.125)
    for _ in range(abs(ulps)):
        thr = np.nextafter(thr, np.float32(np.inf if ulps > 0 else -np.inf))
    return img, thr


CASES = {
    "random-0": lambda rng: (rng.rand(2, 45, 70).astype(np.float32),
                             np.float32(0.04)),
    "random-1": lambda rng: (rng.rand(3, 33, 64).astype(np.float32),
                             np.float32(0.2)),
    "blobs": lambda rng: _blobs(rng, 2, 60, 96),
    "constant": lambda rng: (np.full((2, 20, 40), 0.375, np.float32),
                             np.float32(0.04)),
    "plateaus": lambda rng: ((rng.randint(0, 3, (2, 40, 50)) / 2.0)
                             .repeat(4, 1).repeat(4, 2)[:, :40, :50]
                             .astype(np.float32), np.float32(0.04)),
    "at-threshold": lambda rng: _eighths(rng, 2, 40, 70, 0),
    "one-ulp-above": lambda rng: _eighths(rng, 2, 40, 70, 1),
    "one-ulp-below": lambda rng: _eighths(rng, 2, 40, 70, -1),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_order_score_matches_plain_bitwise(case):
    img, thr = CASES[case](np.random.RandomState(3))
    got = _kernel_score(img, thr)
    want = fast.fast_score(torch.from_numpy(img), float(thr)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    if case.startswith(("random", "blobs", "at-", "one-ulp-below")):
        assert np.count_nonzero(want) > 0  # the trees decided something
    if case in ("at-threshold", "one-ulp-above"):
        # differences at exactly 1/8 never score: > is strict
        assert np.all((want == 0) | (want > np.float32(0.125)))
