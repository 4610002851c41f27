"""The tracking step's glue kernels (frontend/track_cuda: csrc/track_glue.cu):
track_gate, track_epilogue, localmap_gate and localmap_epilogue.

On the CPU: each wrapper takes its plain version for CPU tensors, bit for
bit and without a launch, and each plain version is held to the JAX
package's code it replaces on the same numpy inputs:
- track_gate against mcslam_tpu/tracking_kernels.py's projection
  (:162-178) and _gate_factors (:187-190): ahat's one-hot and one columns
  and bhat's one and bias rows exactly; ahat's -2 uv and u^2 + v^2 (+ 4 PB)
  columns to rtol 1e-6 (XLA may contract u u + v v into an FMA; they come
  out equal); bhat's projection rows to rtol 1e-5 and 1e-2 px: the port
  writes the pose products as 3-term dots, XLA sums its einsums in
  another order, and a pixel's rounding is relative to the terms (f x /
  z and c, hundreds of pixels), not to the pixel, so a pixel near 0 moves
  by ~1e-3 px and one of 5000 px by ~0.02 (the largest seen, 0.016 px,
  and 5.2e-6 relative on the P2 rows); penalized columns (z <= 0.05: the
  1e12 row decides their gate, and their pixel moves with the rounding of
  a z near 0) to rtol 1e-3, exactly at the +-1e5 clamp; the P2 rows (the
  1e12 penalty included) to rtol 1e-5 and the penalty equal;
- localmap_gate against :479-505 with _gate_factors (:508): the
  candidates' descriptors and positions exactly, the factors as above,
  visibility equal
  but where a projection lies within 1e-4 px of a frustum edge or the
  viewing cone's cosine within 1e-6 of 0.5 (a stated tie, counted); on
  identity poses, whose products are exact, also at projections exactly on
  the edges and a cone exactly at 0.5, visibility equal throughout;
- track_epilogue against :196-219 and localmap_epilogue against :516 and
  :349-353 exactly (ints, masks and gathers), pose_lm's rows exactly as
  pose_opt_cuda._pack_obs of the JAX-side gathers, the local epilogue fed
  the candidates' positions as JAX gathers them;
- the local epilogue's identity, on the plain versions: where(ok,
  lm_pos[idx], map_pos[0]) with localmap_gate's lm_pos is map_pos[max(lm,
  0)] bit for bit, with candidate ids of -1 too (what the kernel reads in
  place of a third load round).
The cases include points behind a camera, prev_lm_id = -1, invalid map
rows, zero normals, no valid rows and odd M / N / L. The frame step
writes every slot of its packed vector (its buffers come from
torch.empty).

On the CPU too: the wrappers' outputs carved from one buffer
(track_cuda.epilogue_outputs, localmap_gate_outputs,
localmap_epilogue_outputs) keep the plain
versions' shapes, strides and dtypes, start at 512-byte boundaries and do
not overlap, also in a buffer that starts at an offset of its storage.

`gpu` cases (they skip without a card) hold each kernel bit-equal to its
plain version on the card at those shapes and at the production ones (C =
4, M = N = 2048, L = 4096, and odd M = 2049, N = 2047, L = 4097), twice
alike, one launch counted a call; track_epilogue also through CUDA graph
replays with its counters back at zero. The redesigned track_gate and
localmap_gate (32-column blocks), track_epilogue and localmap_epilogue
(32-row blocks) also at shapes that are no multiple of those blocks (M
no multiple of 4 either: the local epilogue's copy by scalars), at C =
1-4, at M = 0 and L = 0 (but the local epilogue, which takes L >= 1), at
counts of 0 and of M (every row a match with a landmark; every
row a match, none with a landmark; no valid row), with no previous
feature with a landmark and with the map rows at or behind the cameras
(depths <= 0.05 and < 1e-6), and track_epilogue through repeated graph
replays on inputs that change between replays, its two counts right on
every one; localmap_epilogue with no row a match, with candidate ids of
-1 that rows match, with idx past L and below 0 (clamped, held to the
plain version on the clamped idx), with rows at a 4-byte offset (its
copy by scalars):
    python -m pytest --noconftest tests/test_torch_track_kernels.py -m gpu -q
(this file imports JAX only inside the JAX comparisons)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mcslam_tpu_torch import _build
from mcslam_tpu_torch.frontend import pose_opt_cuda, track_cuda as tc
from mcslam_tpu_torch.utils import outputs

MAX_DIST, RATIO = cs.STEP["max_dist"], cs.STEP["ratio"]
LM_MAX_DIST = cs.STEP["lm_max_dist"]
WH = (cs.W, cs.H)


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _problem(seed, C, M, N, L, cap, case="random", dev="cpu"):
    """chip_smoke.track_problem's tensors on dev."""
    return cs.track_problem(np.random.RandomState(seed), C, M, N, L, cap,
                            torch.device(dev), case)


def _np(T):
    return {k: v.cpu().numpy() for k, v in T.items()}


def _all(T, plain=False):
    """Every output of the four wrappers (or of their plain versions) on
    T's tensors, track_epilogue's packed slots included, in a list."""
    calls = cs.track_calls(T)
    out = []
    for n in cs.TRACK_KERNELS:
        fn = getattr(tc, f"{n}_reference" if plain else n)
        out += cs.track_outputs(n, fn, *calls[n])
    return out


def _same(a, b) -> bool:
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return torch.equal(a.contiguous().view(torch.int32),
                           b.contiguous().view(torch.int32))
    return torch.equal(a, b)


SHAPES = {"C4_M96_N80_L111": (4, 96, 80, 111, 500),
          "C1_M37_N33_L45": (1, 37, 33, 45, 60),
          "C3_M65_N129_L7": (3, 65, 129, 7, 300)}


# ---- CPU: the wrappers take the plain versions ----------------------------

def test_wrappers_on_cpu_take_the_plain_versions():
    T = _problem(0, *SHAPES["C4_M96_N80_L111"])
    before = dict(_build.LAUNCHES)
    got = _all(T)
    assert dict(_build.LAUNCHES) == before
    want = _all(T, plain=True)
    assert len(got) == len(want) == 2 + 8 + 2 + 4 + 3
    assert all(_same(a, b) for a, b in zip(got, want))


LAYOUT_SHAPES = [(2048, 4096, 4), (2049, 4097, 3), (37, 45, 1), (0, 0, 2)]


def _carved_ok(views, base, nbytes):
    """The views' byte ranges lie in [base, base + nbytes), each starting
    at a 512-byte boundary from base, none overlapping another (empty
    views hold no bytes)."""
    spans = sorted((v.data_ptr(), v.data_ptr() + v.numel() * v.element_size())
                   for v in views if v.numel())
    if not spans:
        return
    assert all((a - base) % outputs.ALIGN == 0 for a, _ in spans)
    assert all(b0 <= a1 for (_, b0), (a1, _) in zip(spans, spans[1:]))
    assert spans[0][0] >= base and spans[-1][1] <= base + nbytes


@pytest.mark.parametrize("M,L,C", LAYOUT_SHAPES)
def test_carved_outputs_keep_their_layout(M, L, C, monkeypatch):
    """epilogue_outputs, localmap_gate_outputs and
    localmap_epilogue_outputs: the plain versions' shapes, strides and
    dtypes (at M = 37, L = 45, C = 1 taken from the plain versions' own
    outputs), contiguous, aligned, disjoint; and so in a buffer that
    torch.empty hands out at an offset of its storage."""
    want = {"track_epilogue": [((M, 3), torch.float32), ((M, 4, 4), torch.float32),
                               ((M, 4), torch.float32), ((22, M), torch.float32),
                               ((M,), torch.bool), ((M,), torch.bool),
                               ((M,), torch.float32), ((M,), torch.float32)],
            "localmap_gate": [((L, 8), torch.int32), ((M, 3 * C + 2), torch.float32),
                              ((3 * C + 2, L), torch.float32),
                              ((L, 3), torch.float32)],
            "localmap_epilogue": [((22, M), torch.float32),
                                  ((M,), torch.float32), ((M,), torch.int32)]}
    if (M, L, C) == (37, 45, 1):
        T = _problem(10, C, M, 33, L, 60)
        calls = cs.track_calls(T)
        for n in want:
            a, kw = calls[n]
            plain = getattr(tc, f"{n}_reference")(*a, **kw)
            assert [(tuple(x.shape), x.dtype) for x in plain] == want[n]
            assert all(x.is_contiguous() for x in plain)
    real = torch.empty
    for offset in (0, 300):
        held = []

        def empty(*size, **kw):
            n = size[0]
            slab = real(n + 2 * offset, **kw)
            held.append(slab)
            return slab[offset:offset + n]

        monkeypatch.setattr(torch, "empty", empty)
        outs = {"track_epilogue": tc.epilogue_outputs(M, "cpu"),
                "localmap_gate": tc.localmap_gate_outputs(M, L, C, "cpu"),
                "localmap_epilogue": tc.localmap_epilogue_outputs(M, "cpu")}
        monkeypatch.setattr(torch, "empty", real)
        for (n, views), slab in zip(outs.items(), held):
            assert [(tuple(x.shape), x.dtype) for x in views] == want[n]
            assert all(x.is_contiguous() for x in views)
            buf = slab[offset:]
            _carved_ok(views, buf.data_ptr(), (slab.numel() - 2 * offset) * 4)
        assert isinstance(outs["track_epilogue"], tc.TrackObs)


# ---- CPU: the plain versions against the JAX package ----------------------

def _jax_gate_factors(P, uvp, pen, col_invalid, col_pass=None):
    import jax.numpy as jnp

    from mcslam_tpu import tracking_kernels as jtk

    ahat, bhat = jtk._gate_factors(
        jnp.asarray(P["uv"]), jnp.asarray(P["anchor"]), uvp, pen,
        ~jnp.asarray(P["cur_valid"]), jnp.asarray(col_invalid),
        col_pass=None if col_pass is None else jnp.asarray(col_pass))
    return np.asarray(ahat), np.asarray(bhat)


def _jax_track_gate(P):
    """mcslam_tpu/tracking_kernels.py:162-178 and :187-190 -> (ahat,
    bhat, pen (C, N))."""
    import jax.numpy as jnp

    from mcslam_tpu.geometry import lie as jlie

    prev_lm_id = jnp.asarray(P["prev_lm"])
    map_valid, map_pos = jnp.asarray(P["map_valid"]), jnp.asarray(P["map_pos"])
    cam, f = jnp.asarray(P["cam"]), jnp.asarray(P["f"])
    safe_prev = jnp.maximum(prev_lm_id, 0)
    prev_has = (prev_lm_id >= 0) & map_valid[safe_prev]
    Xp = map_pos[safe_prev]
    cam_T_w = jnp.einsum("cij,jk->cik", cam,
                         jlie.se3_inverse(jnp.asarray(P["pred"])))
    pc = (jnp.einsum("cij,mj->cmi", cam_T_w[:, :3, :3], Xp)
          + cam_T_w[:, None, :3, 3])
    z = pc[..., 2]
    uvp = jnp.clip(pc[..., :2] / jnp.maximum(z[..., None], 1e-6)
                   * f[:, None, :2] + f[:, None, 2:], -1e5, 1e5)
    pen = z <= 0.05
    ahat, bhat = _jax_gate_factors(P, uvp, pen, ~P["prev_valid"],
                                   ~np.asarray(prev_has))
    return ahat, bhat, np.asarray(pen)


def _jax_localmap_gate(P):
    """mcslam_tpu/tracking_kernels.py:341-343 and :479-508 -> (lm_desc,
    ahat, bhat, vis (C, L), the projections (C, L, 2) unclamped, the
    cone's cosine (L,), lm_pos (L, 3))."""
    import jax.numpy as jnp

    from mcslam_tpu.geometry import lie as jlie

    ids = jnp.asarray(P["cand"])
    lm_pos = jnp.asarray(P["map_pos"])[ids]
    lm_normal = jnp.asarray(P["nrm"])[ids]
    cam, f = jnp.asarray(P["cam"]), jnp.asarray(P["f"])
    T_wr = jnp.asarray(P["pred"])
    rTw = jlie.se3_inverse(T_wr)
    p_ref = jlie.se3_apply(rTw, lm_pos)
    p_cam = jlie.se3_apply(cam[None], p_ref[:, None])
    z = p_cam[..., 2]
    zs = jnp.where(z > 0.05, z, 1.0)
    proj = p_cam[..., :2] / zs[..., None] * f[None, :, :2] + f[None, :, 2:]
    w, h = WH
    vis = ((z > 0.05) & (proj[..., 0] >= 0) & (proj[..., 0] < w)
           & (proj[..., 1] >= 0) & (proj[..., 1] < h))
    view = lm_pos - T_wr[:3, 3][None]
    view = view / jnp.maximum(jnp.linalg.norm(view, axis=-1, keepdims=True),
                              1e-9)
    has_n = jnp.linalg.norm(lm_normal, axis=-1) > 1e-6
    cosv = jnp.sum(view * lm_normal, axis=-1)
    vis = vis & ((cosv > 0.5) | ~has_n)[:, None]
    proj_c = jnp.clip(proj.transpose(1, 0, 2), -1e5, 1e5)
    pen = ~vis.transpose(1, 0)
    ahat, bhat = _jax_gate_factors(P, proj_c, pen, ~P["cand_valid"])
    return (np.asarray(jnp.asarray(P["map_desc"])[ids]), ahat, bhat,
            ~np.asarray(pen), np.asarray(proj.transpose(1, 0, 2)),
            np.asarray(cosv), np.asarray(lm_pos))


def _hold_ahat(a, a_ref, C):
    """ahat's one-hot and one columns exactly, the rest to rtol 1e-6."""
    exact = list(range(2 * C, 3 * C)) + [3 * C + 1]
    np.testing.assert_array_equal(a[:, exact], a_ref[:, exact])
    np.testing.assert_allclose(a, a_ref, rtol=1e-6, atol=0)


def _hold_bhat(b, b_ref, pen, C):
    """bhat's one and bias rows exactly; the P2 rows to rtol 1e-5; the
    projection rows to rtol 1e-5 and 1e-2 px, but penalized columns to
    rtol 1e-3, and exactly where clamped at +-1e5."""
    np.testing.assert_array_equal(b[3 * C:], b_ref[3 * C:])
    np.testing.assert_allclose(b[2 * C:3 * C], b_ref[2 * C:3 * C], rtol=1e-5,
                               atol=0)
    proj, proj_ref = b[:2 * C], b_ref[:2 * C]
    pen2 = np.repeat(pen, 2, axis=0)
    np.testing.assert_allclose(proj[~pen2], proj_ref[~pen2], rtol=1e-5,
                               atol=1e-2)
    np.testing.assert_allclose(proj[pen2], proj_ref[pen2], rtol=1e-3, atol=0)
    clamped = np.abs(proj_ref) == 1e5
    np.testing.assert_array_equal(proj[clamped], proj_ref[clamped])


CASES = [("C4_M96_N80_L111", "random"), ("C1_M37_N33_L45", "random"),
         ("C3_M65_N129_L7", "random"), ("C4_M96_N80_L111", "identity"),
         ("C4_M96_N80_L111", "no_valid")]


@pytest.mark.parametrize("shape,case", CASES)
def test_track_gate_matches_jax(shape, case):
    C = SHAPES[shape][0]
    T = _problem(1, *SHAPES[shape], case=case)
    P = _np(T)
    a, kw = cs.track_calls(T)["track_gate"]
    ahat, bhat = (x.numpy() for x in tc.track_gate(*a, **kw))
    a_ref, b_ref, pen = _jax_track_gate(P)
    assert ahat.shape == a_ref.shape and bhat.shape == b_ref.shape
    _hold_ahat(ahat, a_ref, C)
    np.testing.assert_array_equal(bhat[2 * C:3 * C] >= 1e12, pen)
    _hold_bhat(bhat, b_ref, pen, C)
    if case == "no_valid":  # every column without a landmark: it passes
        np.testing.assert_array_equal(bhat[-1], np.where(
            P["prev_valid"], np.float32(-tc.PB), np.float32(tc.PB)))
    else:
        assert pen.any() and (~pen).any()


@pytest.mark.parametrize("shape,case", CASES)
def test_localmap_gate_matches_jax(shape, case):
    C = SHAPES[shape][0]
    T = _problem(2, *SHAPES[shape], case=case)
    P = _np(T)
    a, kw = cs.track_calls(T)["localmap_gate"]
    lm_desc, ahat, bhat, lm_pos = (x.numpy()
                                   for x in tc.localmap_gate(*a, **kw))
    d_ref, a_ref, b_ref, vis_ref, proj, cosv, pos_ref = _jax_localmap_gate(P)
    np.testing.assert_array_equal(lm_desc, d_ref)
    np.testing.assert_array_equal(lm_pos, pos_ref)
    _hold_ahat(ahat, a_ref, C)
    vis = bhat[2 * C:3 * C] < 1e12
    # a stated tie: a projection within 1e-4 px of a frustum edge, or the
    # cone's cosine within 1e-6 of 0.5, where either side may round over
    edge = ((np.abs(proj[..., 0]) < 1e-4)
            | (np.abs(proj[..., 0] - WH[0]) < 1e-4)
            | (np.abs(proj[..., 1]) < 1e-4)
            | (np.abs(proj[..., 1] - WH[1]) < 1e-4)
            | (np.abs(cosv - 0.5) < 1e-6)[None])
    if case == "identity":
        # exact products: projections on the edges (candidates 6-9: u = 0,
        # u = W, v = 0, v = H) and a cone exactly at 0.5 (10) agree, no tie
        # excused
        edge[:] = False
        assert vis_ref[:, [6, 8, 11]].all() and not vis_ref[:, [7, 9, 10]].any()
    np.testing.assert_array_equal(vis[~edge], vis_ref[~edge])
    keep = (vis == vis_ref).all(axis=0)
    assert keep.sum() >= 0.99 * keep.size
    _hold_bhat(bhat[:, keep], b_ref[:, keep], ~vis_ref[:, keep], C)
    assert vis_ref.any() and (~vis_ref).any()


def _jax_track_epilogue(P):
    """mcslam_tpu/tracking_kernels.py:196-219 -> its arrays (numpy)."""
    import jax.numpy as jnp

    best, second = jnp.asarray(P["best"]), jnp.asarray(P["second"])
    idx, col_idx = jnp.asarray(P["idx"]), jnp.asarray(P["col"])
    cur_valid = jnp.asarray(P["cur_valid"])
    prev_lm_id = jnp.asarray(P["prev_lm"])
    map_valid, map_pos = jnp.asarray(P["map_valid"]), jnp.asarray(P["map_pos"])
    anchor = jnp.asarray(P["anchor"])
    rows = jnp.arange(best.shape[0], dtype=jnp.int32)
    ok = ((col_idx[idx] == rows) & (best <= MAX_DIST)
          & (best <= RATIO * second) & cur_valid)
    lm = jnp.where(ok, prev_lm_id[idx], -1)
    safe = jnp.maximum(lm, 0)
    with_lm = (lm >= 0) & map_valid[safe]
    lm = jnp.where(with_lm, lm, -1)
    out = dict(ok=ok, lm=lm, with_lm=with_lm, X_world=map_pos[safe],
               cTr=jnp.asarray(P["cam"])[anchor],
               f=jnp.asarray(P["f"])[anchor],
               mask3d=with_lm & jnp.asarray(P["has_depth"]))
    return {k: np.asarray(v) for k, v in out.items()}


def _rows_of(X, cTr, f, P):
    return pose_opt_cuda._pack_obs(
        *(torch.from_numpy(np.array(a)) for a in (X, P["uv"], cTr, f)),
        1.0 / torch.from_numpy(P["sigma2"])).numpy()


@pytest.mark.parametrize("shape,case", CASES)
def test_track_epilogue_matches_jax(shape, case):
    T = _problem(3, *SHAPES[shape], case=case)
    P = _np(T)
    M = P["uv"].shape[0]
    a, kw = cs.track_calls(T)["track_epilogue"]
    *obs, counts, rows = cs.track_outputs("track_epilogue",
                                          tc.track_epilogue, a, kw)
    obs = tc.TrackObs(*obs)
    J = _jax_track_epilogue(P)
    np.testing.assert_array_equal(obs.with_lm.numpy(), J["with_lm"])
    np.testing.assert_array_equal(obs.mask3d.numpy(), J["mask3d"])
    np.testing.assert_array_equal(obs.with_f.numpy(), J["with_lm"])
    np.testing.assert_array_equal(obs.mask3d_f.numpy(), J["mask3d"])
    np.testing.assert_array_equal(obs.X_world.numpy(), J["X_world"])
    np.testing.assert_array_equal(obs.cam_T_ref.numpy(), J["cTr"])
    np.testing.assert_array_equal(obs.fxycxy.numpy(), J["f"])
    np.testing.assert_array_equal(
        obs.rows.numpy(), _rows_of(J["X_world"], J["cTr"], J["f"], P))
    n_ok, n_with = counts.numpy()
    assert n_ok == J["ok"].sum() and n_with == J["with_lm"].sum()
    v = rows.numpy()
    np.testing.assert_array_equal(v[:M], J["ok"])
    np.testing.assert_array_equal(v[M:2 * M], P["idx"])
    np.testing.assert_array_equal(v[2 * M:], J["lm"])
    if case == "no_valid":
        assert n_ok == 0 and n_with == 0
    else:
        assert 0 < n_with < n_ok


@pytest.mark.parametrize("shape,case", CASES)
def test_localmap_epilogue_matches_jax(shape, case):
    import jax.numpy as jnp

    T = _problem(4, *SHAPES[shape], case=case)
    P = _np(T)
    a, kw = cs.track_calls(T)["localmap_epilogue"]
    # the candidates' positions as the JAX package gathers them (:341)
    lm_pos = torch.from_numpy(np.array(
        jnp.asarray(P["map_pos"])[jnp.asarray(P["cand"])]))
    rows, mask, lm = tc.localmap_epilogue(*a[:5], lm_pos, *a[6:], **kw)
    # mcslam_tpu/tracking_kernels.py:516 and :349-353
    best, second = jnp.asarray(P["best"]), jnp.asarray(P["second"])
    ok = (best <= LM_MAX_DIST) & (best <= second) & jnp.asarray(
        P["cur_valid"])
    lm_ref = jnp.where(ok, jnp.asarray(P["cand"])[jnp.asarray(P["lidx"])], -1)
    X = np.asarray(jnp.asarray(P["map_pos"])[jnp.maximum(lm_ref, 0)])
    lm_ref = np.asarray(lm_ref)
    np.testing.assert_array_equal(lm.numpy(), lm_ref)
    np.testing.assert_array_equal(mask.numpy(), lm_ref >= 0)
    np.testing.assert_array_equal(
        rows.numpy(), _rows_of(X, P["cam"][P["anchor"]], P["f"][P["anchor"]],
                               P))
    assert (lm_ref >= 0).any() == (case != "no_valid")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_localmap_epilogue_reads_the_gates_positions(shape):
    """On the plain versions: where(ok, lm_pos[idx], map_pos[0]), lm_pos
    localmap_gate's output, equals localmap_epilogue's map_pos[max(lm,
    0)] bit for bit, also where a matched candidate's id is -1 (row 0 on
    both sides): the kernel's X rows, one load round nearer."""
    T = _problem(13, *SHAPES[shape])
    cand = T["cand"].clone()
    cand[::3] = -1  # a third of the candidates without a landmark
    T["cand"] = cand
    calls = cs.track_calls(T)
    a, kw = calls["localmap_gate"]
    lm_pos = tc.localmap_gate_reference(*a, **kw)[3]
    a, kw = calls["localmap_epilogue"]
    assert _same(lm_pos, a[5])
    rows, _, lm = tc.localmap_epilogue_reference(*a, **kw)
    best, second, idx, valid = a[:4]
    ok = (best <= LM_MAX_DIST) & (best <= second) & valid
    X = torch.where(ok[:, None], lm_pos[idx.long()], T["map_pos"][0][None])
    assert _same(X.T.contiguous(), rows[:3])
    assert (ok & (lm == -1)).any() and (lm >= 0).any() and (~ok).any()


def test_track_and_map_step_writes_every_slot(monkeypatch):
    """The frame step's packed vector and its kernels' outputs come from
    torch.empty: with every such buffer NaN-filled, no NaN is left."""
    from mcslam_tpu_torch import tracking_kernels as ttk

    T = _problem(5, 2, 64, 64, 50, 200)
    real = torch.empty

    def nan_empty(*size, **kw):
        out = real(*size, **kw)
        return out.fill_(float("nan")) if out.is_floating_point() else out

    desc = torch.from_numpy(np.random.RandomState(6).randint(
        -2**31, 2**31 - 1, (64, 8)).astype(np.int32))
    monkeypatch.setattr(torch, "empty", nan_empty)
    packed = ttk._track_and_map_step(
        torch.Generator().manual_seed(0), desc, T["cur_valid"], T["uv"],
        T["anchor"], T["sigma2"], T["map_pos"][:64], T["has_depth"],
        desc.flip(0).contiguous(), T["prev_valid"], T["prev_lm"], T["map_pos"],
        T["map_valid"], T["map_desc"], T["nrm"], T["cand"], T["cand_valid"],
        T["cam"], T["f"], T["pred"], 64, 5.0, MAX_DIST, RATIO, image_wh=WH,
        gate_px=100.0, fastpath_frac=0.6, fastpath_min=5)
    assert packed.shape == (21 + 5 * 64 + 16,)
    assert not torch.isnan(packed).any()


# ---- the card: each kernel bit-equal to its plain version -----------------

CARD_SHAPES = [(4, 96, 80, 111, 500, "random"), (1, 37, 33, 45, 60, "random"),
               (4, 96, 80, 111, 500, "identity"),
               (4, 96, 80, 111, 500, "no_valid"),
               (4, 2048, 2048, 4096, 65536, "random"),
               (3, 2049, 2047, 4097, 65536, "random")]


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,N,L,cap,case", CARD_SHAPES)
def test_kernels_match_plain_on_card(cuda, C, M, N, L, cap, case):
    """Each kernel twice alike, one launch counted a call, its outputs
    the plain version's bits on the card and the CPU's (the same orders
    of operations, none contracted)."""
    T = _problem(7, C, M, N, L, cap, case)
    Tc = {k: v.to(cuda) for k, v in T.items()}
    before = {n: _build.LAUNCHES[n] for n in cs.TRACK_KERNELS}
    got, again = _all(Tc), _all(Tc)
    assert {n: _build.LAUNCHES[n] - before[n] for n in cs.TRACK_KERNELS} \
        == dict.fromkeys(cs.TRACK_KERNELS, 2)
    torch.cuda.synchronize()
    assert all(_same(a, b) for a, b in zip(got, again))
    for want in (_all(Tc, plain=True), _all(T)):
        differ = [k for k, (a, b) in enumerate(zip(got, want))
                  if not _same(a.cpu(), b.cpu())]
        assert not differ, differ


@pytest.mark.gpu
def test_track_epilogue_in_a_cuda_graph(cuda):
    """track_epilogue captured in a CUDA graph: two replays equal to the
    eager call, its three counters back at zero after each."""
    from mcslam_tpu_torch.utils import graphs

    T = _problem(8, 4, 2048, 2048, 4096, 65536, dev=cuda)
    a, kw = cs.track_calls(T)["track_epilogue"]

    def call():
        return cs.track_outputs("track_epilogue", tc.track_epilogue, a, kw)

    want = call()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    for _ in range(2):
        for o in out:
            o.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert all(_same(x, y) for x, y in zip(out, want))
        assert int(graphs.counters("track_epilogue", 2, cuda).abs().sum()) == 0


# shapes no multiple of the redesigned kernels' 32-row and 32-column
# blocks, C = 1-4, M = 0 and L = 0; then the counts' extremes; then no
# previous feature with a landmark and the map rows behind the cameras
ODD_SHAPES = [(1, 31, 7, 63, 50, "random"), (2, 33, 40, 65, 100, "random"),
              (3, 95, 96, 129, 300, "random"), (4, 161, 200, 191, 700, "random"),
              (2, 1, 1, 1, 20, "random"), (4, 0, 5, 3, 20, "random"),
              (3, 70, 9, 0, 20, "random")]
COUNT_SHAPES = [(4, 2048, 2048, 4096, 65536, "all_ok"),
                (4, 2048, 2048, 4096, 65536, "none_with"),
                (3, 777, 800, 100, 1000, "all_ok"),
                (4, 2049, 2047, 4097, 65536, "no_valid")]
GATE_SHAPES = [(4, 2048, 2048, 4096, 65536, "no_lm"),
               (3, 97, 130, 50, 300, "behind")]
REDESIGNED = ("track_gate", "track_epilogue", "localmap_gate",
              "localmap_epilogue")


@pytest.mark.gpu
@pytest.mark.parametrize("C,M,N,L,cap,case",
                         ODD_SHAPES + COUNT_SHAPES + GATE_SHAPES)
def test_redesigned_kernels_match_plain_on_card(cuda, C, M, N, L, cap, case):
    """track_gate, track_epilogue, localmap_gate and localmap_epilogue
    twice alike, one launch a call, bit-equal to the plain versions on the
    card and on the CPU; the epilogue's counts (packed slots 17, 18) those
    the case makes. The local epilogue takes no L = 0 (nothing to look
    up; its wrapper refuses it)."""
    T = _problem(11, C, M, N, L, cap, case)
    Tc = {k: v.to(cuda) for k, v in T.items()}
    calls, calls_cpu = cs.track_calls(Tc), cs.track_calls(T)
    for n in REDESIGNED:
        if n == "localmap_epilogue" and L == 0:
            continue
        fn, plain = getattr(tc, n), getattr(tc, f"{n}_reference")
        a, kw = calls[n]
        before = _build.LAUNCHES[n]
        got = cs.track_outputs(n, fn, a, kw)
        again = cs.track_outputs(n, fn, a, kw)
        assert _build.LAUNCHES[n] - before == 2
        torch.cuda.synchronize()
        assert all(_same(x, y) for x, y in zip(got, again)), n
        for want in (cs.track_outputs(n, plain, a, kw),
                     cs.track_outputs(n, plain, *calls_cpu[n])):
            differ = [k for k, (x, y) in enumerate(zip(got, want))
                      if not _same(x.cpu(), y.cpu())]
            assert not differ, (n, differ)
        if n == "track_epilogue":
            n_ok, n_with = got[-2].tolist()
            expect = {"all_ok": (M, M), "none_with": (M, 0),
                      "no_valid": (0, 0)}.get(case)
            if expect is not None:
                assert (n_ok, n_with) == expect
            if M == 0:
                assert (n_ok, n_with) == (0, 0)


@pytest.mark.gpu
def test_track_epilogue_counts_through_graph_replays(cuda):
    """track_epilogue captured once, replayed 12 times on inputs copied in
    between from three problems of one shape (counts random, M and M, M
    and 0): every replay's outputs, packed slots 17 and 18 among them,
    the plain version's on those inputs; the counter at zero after each."""
    from mcslam_tpu_torch.utils import graphs

    shape = (4, 2048, 2048, 4096, 65536)
    probs = [cs.track_calls(_problem(12 + k, *shape, case=case, dev=cuda))[
        "track_epilogue"][0] for k, case in enumerate(
            ("random", "all_ok", "none_with"))]
    ins = [x.clone() for x in probs[0][:14]]
    a = (*ins, *probs[0][14:])

    def call():
        return cs.track_outputs("track_epilogue", tc.track_epilogue, a, {})

    call()
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = call()
    seen = set()
    for k in range(12):
        src = probs[(k * 2) % 3]
        for dst, x in zip(ins, src[:14]):
            dst.copy_(x)
        for o in out:
            o.fill_(-1)
        graph.replay()
        want = cs.track_outputs("track_epilogue",
                                tc.track_epilogue_reference, src, {})
        torch.cuda.synchronize()
        differ = [j for j, (x, y) in enumerate(zip(out, want))
                  if not _same(x, y)]
        assert not differ, (k, differ)
        seen.add(tuple(out[-2].tolist()))
        assert int(graphs.counters("track_epilogue", 2, cuda).abs().sum()) == 0
    assert len(seen) == 3 and (2048.0, 2048.0) in seen and (2048.0, 0.0) in seen


LE_EDGES = ["none_ok", "cand_minus_one", "idx_out", "offset_rows"]


@pytest.mark.gpu
@pytest.mark.parametrize("case", LE_EDGES)
@pytest.mark.parametrize("M", [2048, 2047, 33])
def test_localmap_epilogue_edges_on_card(cuda, case, M):
    """localmap_epilogue bit-equal to its plain version on the card and
    the CPU, twice alike: with no row a match; with matched candidates of
    id -1 (lm -1, X from row 0); with idx past L and below 0 (the kernel
    clamps it: held to the plain version on the clamped idx); with the
    inter-frame rows and the candidates' positions at a 4-byte offset
    (the copy by scalars)."""
    T = _problem(14, 4, M, 64, 300, 4000)
    if case == "none_ok":
        T["best"] = torch.full_like(T["best"], float(LM_MAX_DIST + 1))
    if case == "cand_minus_one":
        T["cand"][T["lidx"][: M // 2].long()] = -1
        T["cur_valid"][:] = True
        T["best"] = torch.zeros_like(T["best"])
    a, kw = cs.track_calls(T)["localmap_epilogue"]
    a = list(a)
    want_idx = a[2]
    if case == "idx_out":
        bad = a[2].clone()
        bad[::5] = 300 + torch.arange(len(bad[::5]), dtype=torch.int32)
        bad[1::7] = -1 - torch.arange(len(bad[1::7]), dtype=torch.int32)
        a[2], want_idx = bad, torch.clamp(bad, 0, 299)
    want = tc.localmap_epilogue_reference(*a[:2], want_idx, *a[3:], **kw)
    ac = [x.to(cuda) if torch.is_tensor(x) else x for x in a]
    if case == "offset_rows":
        for k in (5, 7):
            slab = torch.empty(ac[k].numel() + 1, device=cuda)
            ac[k] = slab[1:].view(ac[k].shape).copy_(ac[k])
            assert ac[k].data_ptr() % 16 == 4
    before = _build.LAUNCHES["localmap_epilogue"]
    got = tc.localmap_epilogue(*ac, **kw)
    again = tc.localmap_epilogue(*ac, **kw)
    assert _build.LAUNCHES["localmap_epilogue"] - before == 2
    torch.cuda.synchronize()
    assert all(_same(x, y) for x, y in zip(got, again))
    plain = tc.localmap_epilogue_reference(
        *ac[:2], want_idx.to(cuda), *ac[3:], **kw)
    for w in (plain, want):
        differ = [k for k, (x, y) in enumerate(zip(got, w))
                  if not _same(x.cpu(), y.cpu())]
        assert not differ, differ
    lm = got[2].cpu()
    if case == "none_ok":
        assert (lm == -1).all()
    if case == "cand_minus_one":
        assert (lm[: M // 2] == -1).all() and (lm >= 0).any()
        assert _same(got[0][:3, : M // 2].cpu(), T["map_pos"][0][:, None]
                     .expand(3, M // 2).contiguous())


@pytest.mark.gpu
def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    T = _problem(9, 4, 64, 64, 50, 200, dev=cuda)
    calls = cs.track_calls(T)
    a, _ = calls["track_gate"]
    with pytest.raises(ValueError, match="int32"):
        tc.track_gate(a[0], a[1].long(), *a[2:])
    a, _ = calls["localmap_gate"]
    cam5, f5 = (torch.cat([x, x[:1]]) for x in a[9:11])
    with pytest.raises(ValueError, match="cameras"):
        tc.localmap_gate(*a[:9], cam5, f5, *a[11:])
    a, _ = calls["track_epilogue"]
    with pytest.raises(ValueError, match="packed"):
        tc.track_epilogue(*a[:-1], torch.empty(10, device=cuda))
    a, _ = calls["localmap_epilogue"]
    with pytest.raises(ValueError, match="float32"):
        tc.localmap_epilogue(a[0].double(), *a[1:])
