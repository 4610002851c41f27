"""Parity of the port's descriptor matching (mcslam_tpu_torch.ops: hamming,
match, match_cuda) with the JAX package on the same numpy inputs, on the
CPU. The Pallas matcher runs in interpret mode.

Tolerances: Hamming distances, mutual / one-way matches, and the gated
matcher's indices and distances exact — except, for the gated matcher,
rows (and columns) holding a pair whose f32 gate distance lies within
1e-3 * thr2 of the threshold, where the two summation orders may gate
differently."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from mcslam_tpu import tracking_kernels as jtk
from mcslam_tpu.ops import hamming as jham
from mcslam_tpu.ops import match as jmatch
from mcslam_tpu.ops import match_pallas
from mcslam_tpu_torch import tracking_kernels as ttk
from mcslam_tpu_torch.ops import hamming as tham
from mcslam_tpu_torch.ops import match as tmatch
from mcslam_tpu_torch.ops import match_cuda


def _t(x):
    return torch.from_numpy(np.array(x))


def _desc(rng, n):
    return rng.randint(0, 2**32, (n, 8), dtype=np.uint64).astype(np.uint32)


def test_descriptor_words_and_hamming_match_jax():
    rng = np.random.RandomState(0)
    a, b = _desc(rng, 70), _desc(rng, 90)
    a[0] = 0xFFFFFFFF  # all-ones words: the int32 sign bit is data too
    ta, tb = tham.desc_to_torch(a, "cpu"), tham.desc_to_torch(b, "cpu")
    assert ta.dtype == torch.int32
    np.testing.assert_array_equal(tham.desc_to_numpy_u32(ta), a)
    np.testing.assert_array_equal(tham.unpack_bits(ta).numpy(),
                                  np.asarray(jham.unpack_bits(jnp.asarray(a))))
    np.testing.assert_array_equal(
        tham.desc_to_numpy_u32(tham.pack_bits(tham.unpack_bits(ta))), a)
    np.testing.assert_array_equal(
        tham.to_planes(ta).numpy(),
        np.asarray(jham.to_planes(jnp.asarray(a)), np.float32))
    np.testing.assert_array_equal(
        tham.hamming_matrix(ta, tb).numpy(),
        np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b))))


@pytest.mark.parametrize("kind", ["mutual", "one_way"])
def test_dense_matchers_match_jax(kind):
    rng = np.random.RandomState(1)
    a, b = _desc(rng, 120), _desc(rng, 150)
    b[:60] = a[rng.permutation(120)[:60]]
    b[60] = b[61]  # duplicate target: tie-breaking
    d = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    rm, cm = rng.rand(120) > 0.1, rng.rand(150) > 0.1
    pm = rng.rand(120, 150) > 0.3
    jfn = getattr(jmatch, "match_" + kind)
    tfn = getattr(tmatch, "match_" + kind)
    ref = jfn(jnp.asarray(d), row_mask=jnp.asarray(rm),
              col_mask=jnp.asarray(cm), max_dist=80, pair_mask=jnp.asarray(pm))
    got = tfn(_t(d), row_mask=_t(rm), col_mask=_t(cm), max_dist=80,
              pair_mask=_t(pm))
    for x, y in zip(ref, got):
        np.testing.assert_array_equal(y.numpy(), np.asarray(x))


def _problem(seed, M, N, C=3, with_pass=True):
    """tests/test_match_pallas.py's random gated-matching problem."""
    rng = np.random.RandomState(seed)
    a, b = _desc(rng, M), _desc(rng, N)
    b[N // 2] = a[0]
    b[N // 2 + 1] = a[0]
    uv = rng.rand(M, 2).astype(np.float32) * 400.0
    anchor = rng.randint(0, C, M).astype(np.int32)
    proj = rng.rand(C, N, 2).astype(np.float32) * 400.0
    proj[:, : N // 2] = uv[rng.randint(0, M, N // 2)][None, :, :] + rng.randn(
        C, N // 2, 2).astype(np.float32) * 10.0
    pen = rng.rand(C, N) < 0.1
    rv, cv = rng.rand(M) > 0.1, rng.rand(N) > 0.1
    cp = (rng.rand(N) < 0.3) if with_pass else None
    return a, b, uv, anchor, proj, pen, rv, cv, cp


def _plant_edges(edge, a, b, uv, anchor, proj, pen, rv, cv):
    """In place. "ties": row 0's descriptor at columns 5, 133 and N - 1
    (three 128-column blocks), all passing row 0's gate; rows 3, 70 and 140
    share a descriptor, pixel and camera, with column 7 holding that
    descriptor on top of them (a column tie across row tiles). "gated":
    rows 10-29 invalid and rows 30-39 far from every projection, so every
    pair of theirs is gated out."""
    if edge == "ties":
        N = len(b)
        cols, rows = [5, 133, N - 1], [3, 70, 140]
        b[cols] = a[0]
        proj[:, cols] = uv[0]
        a[rows], uv[rows], anchor[rows] = a[3], uv[3], anchor[3]
        b[7], proj[:, 7] = a[3], uv[3]
        pen[:, cols + [7]] = False
        cv[cols + [7]] = True
        rv[[0] + rows] = True
    elif edge == "gated":
        rv[10:30] = False
        rv[30:40] = True
        uv[30:40] = 1e4


def _near(ahat, bhat, thr2):
    d2 = np.asarray(ahat, np.float64) @ np.asarray(bhat, np.float64)
    near = np.abs(d2 - thr2) < 1e-3 * thr2
    return near.any(1), near.any(0)


@pytest.mark.parametrize("seed,M,N,want_cols,edge", [
    # mutual (tracking) encoding
    pytest.param(0, 128, 256, True, None, id="0-128-256-True"),
    pytest.param(1, 200, 300, True, None, id="1-200-300-True"),
    # one-way (local map)
    pytest.param(2, 128, 512, False, None, id="2-128-512-False"),
    pytest.param(3, 160, 130, False, None, id="3-160-130-False"),
    # ties across column blocks and row tiles; all-gated rows
    pytest.param(4, 200, 300, True, "ties", id="4-200-300-True-ties"),
    pytest.param(5, 160, 300, False, "gated", id="5-160-300-False-gated"),
])
def test_gated_matcher_plain_matches_pallas(seed, M, N, want_cols, edge):
    a, b, uv, anchor, proj, pen, rv, cv, cp = _problem(seed, M, N,
                                                        with_pass=want_cols)
    _plant_edges(edge, a, b, uv, anchor, proj, pen, rv, cv)
    thr = 40.0 if want_cols else 30.0
    jargs = [jnp.asarray(x) for x in (uv, anchor, proj, pen)]
    ahat, bhat = jtk._gate_factors(
        *jargs, ~jnp.asarray(rv), ~jnp.asarray(cv),
        col_pass=jnp.asarray(cp) if want_cols else None)
    t_ahat, t_bhat = ttk._gate_factors(
        _t(uv), _t(anchor), _t(proj), _t(pen), ~_t(rv), ~_t(cv),
        col_pass=_t(cp) if want_cols else None)
    np.testing.assert_array_equal(t_ahat.numpy(), np.asarray(ahat))
    np.testing.assert_array_equal(t_bhat.numpy(), np.asarray(bhat))
    # the factors' product is the anchored pixel distance on valid pairs
    d2 = ttk._anchored_sq_px_dist(_t(uv), _t(anchor), _t(proj), _t(pen))
    np.testing.assert_allclose(
        d2.numpy(), np.asarray(jtk._anchored_sq_px_dist(*jargs)), rtol=1e-5,
        atol=0.5)
    ok = rv[:, None] & cv[None, :]
    if want_cols:
        ok &= ~cp[None, :]
    np.testing.assert_allclose((t_ahat @ t_bhat).numpy()[ok], d2.numpy()[ok],
                               rtol=1e-5, atol=0.5)
    ref = match_pallas.hamming_argmin2(
        jham.to_planes(jnp.asarray(a)), jham.to_planes(jnp.asarray(b)).T,
        ahat, bhat, thr * thr, want_cols=want_cols, interpret=True)
    got = match_cuda.hamming_argmin2(tham.desc_to_torch(a, "cpu"),
                                     tham.desc_to_torch(b, "cpu"), t_ahat,
                                     t_bhat, thr * thr, want_cols=want_cols)
    rows, cols = _near(ahat, bhat, thr * thr)
    keep = ~rows
    for x, y in zip(ref[:3], got[:3]):
        np.testing.assert_array_equal(y.numpy()[keep], np.asarray(x)[keep])
    if want_cols:
        np.testing.assert_array_equal(got[3].numpy()[~cols],
                                      np.asarray(ref[3])[~cols])
    else:
        assert got[3] is None
    best, idx = got[0].numpy(), got[2].numpy()
    if edge == "ties":  # the first index wins, in both packages
        assert idx[0] == 5 and best[0] == 0.0 and got[3][7] == 3
    if edge == "gated":  # BIGF at column 0
        assert np.all(best[10:40] == match_cuda.BIGF)
        assert np.all(idx[10:40] == 0)
