"""The ORB extraction's three kernels (ops/orb_cuda: csrc/orb_pyramid.cu,
csrc/orb_select.cu, csrc/orb_describe.cu) and the triangulation's sum
order.

On the CPU:
- the plain versions against the JAX package: the fixed-tap pyramid and
  its stack to 1e-6, the fixed-order orientation to 1e-5 rad, the
  descriptors bit for bit at equal angles;
- orb_select_reference against the selection chain as the port ran it
  before the kernel (copied below as `_chain_before`), bit for bit, on
  fast_select's candidates of blob images and on plateau-tied ones, at
  C = 1, 3, 4 and L = 1, 4;
- numpy models of each kernel's order of work (the pyramid's per-pixel
  taps with the edge replication, the moments' lane subtrees and shuffle
  steps, the selection's 64-bit keys) against the plain versions, bit
  for bit;
- numpy models of the staged-tile pyramid and the one-launch selection:
  orb_cuda.pyramid_plan's tiles, with pyramid_levels' tap table, write
  every pixel of every level once, keep every tap inside its region and
  give the plain bits (PYRAMID_SHAPES, 10 levels, and a plan split over launches); the
  selection's radix digits, ties and rank placement give
  orb_select_reference's result on SELECT_CASES;
- geometry.triangulation.ray_sum against a model of tri_refine's quad of
  lanes (ray r on lane r % 4, the fold ((a0 + a1) + a2) + a3) at R = 1-8.

`gpu` cases (they skip without a card) hold each kernel to its plain
version on the card, bit for bit, across two runs, with its launches
counted, the pyramid also split over launches, and orb_select through a
CUDA graph replayed twice:
    python -m pytest --noconftest tests/test_torch_orb_kernels.py -m gpu -q
(this file imports JAX only inside the JAX comparisons)."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.geometry import triangulation
from mcslam_tpu_torch.ops import fast_cuda, image, orb, orb_cuda
from mcslam_tpu_torch.ops.topk_grid import topk_stable
from mcslam_tpu_torch.utils import graphs


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _blob_images(num_cams, size=(192, 144)):
    rig = synthetic.make_synthetic_rig(synthetic.SyntheticRigSpec(
        num_cams=num_cams, image_size=size, focal=130.0), device="cpu")
    poses = synthetic.smooth_trajectory(1, step_angle=0.02)
    lms = synthetic.make_landmarks(600, depth_range=(4.0, 15.0))
    return synthetic.render_blob_images(rig, poses, lms)[0]


def _patches(n, seed=4):
    """Intensity ramps in random directions plus noise: well-defined
    centroid angles."""
    rng = np.random.RandomState(seed)
    g = np.arange(orb.PATCH, dtype=np.float32) / orb.PATCH
    a = rng.randn(n, 2, 1, 1).astype(np.float32)
    return (0.5 + 0.3 * (a[:, 0] * g[None, :] + a[:, 1] * g[:, None])
            + 0.05 * rng.rand(n, orb.PATCH, orb.PATCH)).astype(np.float32)


# -- the pyramid -----------------------------------------------------------


@pytest.mark.parametrize("n_in,n_out", [(480, 400), (400, 333), (97, 81),
                                        (9, 8), (640, 533), (20, 40)])
def test_resize_taps_are_the_matrix(n_in, n_out):
    """The tap tables hold every nonzero weight of the resize matrix, at
    its place, in ascending input order."""
    W = image._resize_matrix(n_in, n_out)
    taps, first = image.resize_taps(n_in, n_out)
    dense = np.zeros_like(W)
    for k in range(taps.shape[1]):
        np.add.at(dense, (np.arange(n_out), first + k), taps[:, k])
    np.testing.assert_array_equal(dense, W)
    if n_out < n_in and n_in / n_out <= 1.25:
        assert taps.shape[1] <= 3


def _stack_model(imgs, num_levels, scale):
    """numpy model of csrc/orb_pyramid.cu: each pixel of the (H, W) plane
    of level l from the clamped pixel of level l - 1's plane, the vertical
    taps' sums at the horizontal taps' columns, left to right in f32."""
    f32 = np.float32
    B, H, W = imgs.shape
    shapes = image.pyramid_shapes(H, W, num_levels, scale)
    out = [imgs.astype(f32)]
    ys, xs = np.arange(H), np.arange(W)
    for l in range(1, num_levels):
        (ph, pw), (h, w) = shapes[l - 1], shapes[l]
        src = out[-1]
        yc, xc = np.minimum(ys, h - 1), np.minimum(xs, w - 1)

        def vertical(cols):
            if ph == h:
                return src[:, yc][:, :, cols]
            taps, first = image.resize_taps(ph, h)
            t = taps[yc, 0][None, :, None] * src[:, first[yc]][:, :, cols]
            for k in range(1, taps.shape[1]):
                t = t + taps[yc, k][None, :, None] * \
                    src[:, first[yc] + k][:, :, cols]
            return t

        if pw == w:
            plane = vertical(xc)
        else:
            taps, first = image.resize_taps(pw, w)
            plane = taps[xc, 0] * vertical(first[xc])
            for j in range(1, taps.shape[1]):
                plane = plane + taps[xc, j] * vertical(first[xc] + j)
        out.append(plane.astype(f32))
    return np.concatenate(out)


@pytest.mark.parametrize("B,H,W,levels", [(2, 144, 192, 3), (1, 97, 133, 8),
                                          (3, 37, 53, 4)])
def test_pyramid_is_the_kernels_tap_order(B, H, W, levels):
    imgs = np.random.RandomState(B + H).rand(B, H, W).astype(np.float32)
    got = orb_cuda.orb_pyramid(torch.from_numpy(imgs), levels, 1.2)
    np.testing.assert_array_equal(got.numpy(), _stack_model(imgs, levels, 1.2))


def test_pyramid_matches_jax_and_is_batch_invariant():
    from mcslam_tpu.ops import image as jimage

    imgs = np.random.RandomState(1).rand(3, 97, 133).astype(np.float32)
    got = orb_cuda.orb_pyramid(torch.from_numpy(imgs), 4, 1.2)
    ref = jimage.build_pyramid(imgs, 4, 1.2)
    for l, lv in enumerate(ref):
        lv = np.asarray(lv)
        h, w = lv.shape[-2:]
        padded = np.pad(lv, ((0, 0), (0, 97 - h), (0, 133 - w)), mode="edge")
        np.testing.assert_allclose(got[3 * l:3 * l + 3].numpy(), padded,
                                   atol=1e-6, rtol=0)
    # each image alone gives the bits it gets in the batch
    for b in range(3):
        alone = orb_cuda.orb_pyramid(torch.from_numpy(imgs[b:b + 1]), 4, 1.2)
        assert torch.equal(alone, got[b::3])
    # build_pyramid's levels are views of the stack
    levels = image.build_pyramid(torch.from_numpy(imgs), 4, 1.2)
    for l, lv in enumerate(levels):
        assert torch.equal(lv, got[3 * l:3 * l + 3, :lv.shape[1],
                                   :lv.shape[2]])


# -- orientation and descriptors -------------------------------------------


def _moments_model(patches):
    """numpy model of csrc/orb_describe.cu's moments: lane l's 64 leaves
    (slots l + 32 k) through the depth-first subtree, then the five
    shuffle-down steps across the lanes."""
    f32 = np.float32
    N = patches.shape[0]
    flat = np.zeros((N, orb.MOMENT_SLOTS), f32)
    flat[:, :orb.PATCH ** 2] = patches.reshape(N, -1)
    w = np.zeros((orb.MOMENT_SLOTS, 2), f32)
    w[:orb.PATCH ** 2] = orb._moment_weight_matrix()
    prod = flat[:, :, None] * w[None]  # (N, 2048, 2)

    def tree(lane, k, size):
        if size == 64:
            return prod[:, lane + 32 * k]
        return tree(lane, k, 2 * size) + tree(lane, k + size, 2 * size)

    lanes = [tree(l, 0, 1) for l in range(32)]
    for n in (16, 8, 4, 2, 1):
        lanes = [lanes[l] + lanes[l + n] if l + n < 32 else lanes[l]
                 for l in range(32)]
    return lanes[0]


def test_moments_are_the_kernels_order():
    p = _patches(64, seed=7)
    p[:8] = np.random.RandomState(3).rand(8, orb.PATCH, orb.PATCH)
    got = orb.patch_moments(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, _moments_model(p))


def test_orientation_and_descriptors_match_jax():
    import jax.numpy as jnp
    from mcslam_tpu.ops import orb as jorb

    p = _patches(300)
    zero = jnp.zeros((300, 2), jnp.int32)
    ang_ref = np.asarray(jorb.patch_orientation(jnp.asarray(p), zero, zero))
    ang, desc = orb_cuda.orb_describe(torch.from_numpy(p), 16)
    np.testing.assert_allclose(ang.numpy(), ang_ref, atol=1e-5, rtol=0)
    # at the same angles the descriptor bits are the JAX package's
    d_ref = np.asarray(jorb.compute_descriptors_patch(
        jnp.asarray(p), jnp.zeros((300, 2)), jnp.asarray(ang.numpy()), 16))
    np.testing.assert_array_equal(desc.numpy().view(np.uint32), d_ref)


# -- selection and compaction ----------------------------------------------


def _chain_before(cand_v, cand_rid, h_l, w_l, C, budgets, n_out, scale, ncx):
    """The selection chain of the production route as the port ran it
    before orb_select (ops/orb.py extract_orb_levels, from fast_select's
    candidates to patch_gather's inputs), copied as it was."""
    cell, per_cell = 16, 4
    dev = cand_v.device
    LC = cand_v.shape[0]
    L = LC // C
    maxb = max(budgets)
    # _select_from_cells
    flat_v = cand_v.reshape(LC, -1)
    flat_r = cand_rid.reshape(LC, -1)
    n = min(maxb, flat_v.shape[1])
    resp, arg = topk_stable(flat_v, n)
    g = arg // per_cell
    rid = torch.gather(flat_r, 1, arg).to(torch.int64)
    valid = resp > 0.0
    zero = torch.zeros_like(g)
    ys = torch.where(valid, (g // ncx) * cell + rid // cell, zero)
    xs = torch.where(valid, (g % ncx) * cell + rid % cell, zero)
    yx = torch.stack([ys, xs], dim=-1).to(torch.int32)
    if n < maxb:
        pad = maxb - n
        yx = F.pad(yx, (0, 0, 0, pad))
        resp = F.pad(resp, (0, pad))
        valid = torch.cat([valid, torch.zeros(LC, pad, dtype=torch.bool,
                                              device=valid.device)], 1)
    # quota, margin, metadata
    resp = torch.where(resp > 1.0, resp - 1.0, resp)  # undo rank bonus
    budget_arr = graphs.values(tuple(b for b in budgets for _ in range(C)),
                               torch.int64, dev)
    valid = valid & (torch.arange(maxb, device=dev)[None, :]
                     < budget_arr[:, None])
    hl, wl = h_l.long()[:, None], w_l.long()[:, None]
    inb = ((yx[..., 0] >= orb.EDGE) & (yx[..., 0] < hl - orb.EDGE)
           & (yx[..., 1] >= orb.EDGE) & (yx[..., 1] < wl - orb.EDGE))
    valid = valid & inb
    s_lvl = graphs.values(tuple(scale**lvl for lvl in range(L)),
                          torch.float32, dev)
    xy_lvl = torch.stack([yx[..., 1], yx[..., 0]], dim=-1).to(torch.float32)
    xy0 = (xy_lvl.reshape(L, C, maxb, 2)
           * s_lvl[:, None, None, None]).reshape(L * C, maxb, 2)
    octv = torch.arange(L, dtype=torch.int32, device=dev)[:, None, None] \
        .expand(L, C, maxb).reshape(L * C, maxb)
    sigma2 = (s_lvl**2)[:, None, None].expand(L, C, maxb).reshape(L * C, maxb)
    img_idx = torch.arange(L * C, dtype=torch.int32, device=dev)[:, None] \
        .expand(L * C, maxb)

    def merge(x):
        x = x.reshape(L, C, maxb, *x.shape[2:])
        return x.movedim(1, 0).reshape(C, L * maxb, *x.shape[3:])

    yxm, resp_m, valid_m, img_m, octv_m, sig2_m, xy0_m = (
        merge(yx), merge(resp), merge(valid), merge(img_idx), merge(octv),
        merge(sigma2), merge(xy0))
    if L * maxb > n_out:
        prio = torch.where(valid_m, resp_m + 1e3,
                           torch.full_like(resp_m, -1.0))
        _, top = topk_stable(prio, n_out)

        def take(a):
            idx = top.reshape(*top.shape, *([1] * (a.ndim - 2)))
            return torch.take_along_dim(a, idx, dim=1)

        yxm, resp_m, valid_m, img_m, octv_m, sig2_m, xy0_m = (
            take(yxm), take(resp_m), take(valid_m), take(img_m),
            take(octv_m), take(sig2_m), take(xy0_m))
    T = C * n_out
    return (xy0_m, resp_m, octv_m, sig2_m, valid_m,
            yxm.reshape(T, 2).contiguous(), img_m.reshape(T).contiguous())


def _blob_candidates(C, L, num_points, size=(192, 144)):
    """fast_select's candidates (plain version) on the stacked pyramid of
    C blob images, with the orb_select keywords."""
    imgs = torch.from_numpy(_blob_images(C, size))
    H, W = imgs.shape[-2:]
    stacked = orb_cuda.orb_pyramid(imgs, L, 1.2)
    hw = image.pyramid_shapes(H, W, L, 1.2)
    h_l = torch.tensor([h for h, _ in hw for _ in range(C)], dtype=torch.int32)
    w_l = torch.tensor([w for _, w in hw for _ in range(C)], dtype=torch.int32)
    _, v, r = fast_cuda.fast_select_reference(
        stacked, 7 / 255, 20 / 255, h_l, w_l, image._np_gaussian_taps(7, 2.0))
    return v, r, h_l, w_l, _select_kw(C, L, num_points, W)


def _select_kw(C, L, num_points, W):
    budgets = orb._level_budget(num_points, L, 1.2)
    return dict(C=C, budgets=budgets,
                n_out=min(num_points, L * max(budgets)), scale=1.2,
                ncx=(-(-W // 128) * 128) // 16)


def _plateau_candidates(C, L, G, num_points, seed):
    """Candidates with few distinct values (ties everywhere, bonus and
    no-bonus values, zeros and -0.0), random raster offsets and level
    sizes."""
    rng = np.random.RandomState(seed)
    vals = np.array([0.0, -0.0, 0.05, 0.05, 0.3, 1.05, 1.3, 1.3],
                    np.float32)
    v = vals[rng.randint(0, len(vals), (L * C, G, 4))]
    r = rng.randint(0, 256, (L * C, G, 4)).astype(np.int32)
    ncx = 8
    H, W = (-(-G // ncx)) * 16, ncx * 16
    h_l = np.repeat(rng.randint(H // 2, H + 1, L), C).astype(np.int32)
    w_l = np.repeat(rng.randint(W // 2, W + 1, L), C).astype(np.int32)
    kw = _select_kw(C, L, num_points, W)
    return (torch.from_numpy(v), torch.from_numpy(r), torch.from_numpy(h_l),
            torch.from_numpy(w_l), dict(kw, ncx=ncx))


SELECT_CASES = ([("blob", C, L, 256) for C in (1, 3, 4) for L in (1, 4)]
                + [("plateau", C, L, 200) for C in (1, 3, 4) for L in (1, 4)]
                + [("few", 2, 4, 768)])


def _select_case(kind, C, L, num_points):
    if kind == "blob":
        return _blob_candidates(C, L, num_points)
    # "few": 24 cells x 4 candidates per image, fewer than maxb (padding)
    G = 24 if kind == "few" else 60
    return _plateau_candidates(C, L, G, num_points, seed=10 * C + L)


@pytest.mark.parametrize("kind,C,L,num_points", SELECT_CASES)
def test_select_reference_is_the_chain_before(kind, C, L, num_points):
    v, r, h_l, w_l, kw = _select_case(kind, C, L, num_points)
    got = orb_cuda.orb_select(v, r, h_l, w_l, **kw)
    want = _chain_before(v, r, h_l, w_l, kw["C"], kw["budgets"],
                         kw["n_out"], kw["scale"], kw["ncx"])
    assert len(got) == len(want) == 7
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert got[4].any()


def _key_model(v):
    """numpy model of csrc/orb_select.cu's keys: the order-preserving bits
    (-0 as +0), then the complemented index."""
    u = v.view(np.uint32).astype(np.uint64)
    u[v == 0] = 0
    neg = (u & 0x80000000) != 0
    u = np.where(neg, ~u & 0xFFFFFFFF, u | 0x80000000)
    idx = np.arange(v.shape[-1], dtype=np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - idx)


def test_select_keys_order_as_the_stable_sort():
    v = _plateau_candidates(1, 1, 60, 200, seed=3)[0].reshape(1, -1)
    v = torch.cat([v, -v, v * 0.5 - 0.2], dim=1)
    keys = _key_model(v.numpy()[0])
    assert len(set(keys.tolist())) == keys.size  # unique
    order = np.argsort(keys)[::-1]
    _, want = topk_stable(v, v.shape[1])
    np.testing.assert_array_equal(order, want[0].numpy())


# -- the triangulation's sum over the rays ---------------------------------


@pytest.mark.parametrize("R", range(1, 9))
def test_ray_sum_is_tri_refines_quad(R):
    """tri_refine's quad: lane k holds accumulator k (rays k, k + 4, each
    first added to 0.0), the fold reads lanes 0-3 in order."""
    rng = np.random.RandomState(R)
    x = (rng.randn(R, 4096) * 10.0 ** rng.randint(-3, 4, (R, 4096))).astype(
        np.float32)
    x[:, :64] = np.float32(1e8) * np.sign(x[:, :64])  # cancellations
    lanes = []
    for k in range(4):
        a = np.zeros(4096, np.float32)
        for r in range(k, R, 4):
            a = a + x[r]
        lanes.append(a)
    want = ((lanes[0] + lanes[1]) + lanes[2]) + lanes[3]
    got = triangulation.ray_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# -- the wrappers on the CPU -----------------------------------------------


def test_wrappers_take_the_plain_versions_on_the_cpu():
    before = dict(_build.LAUNCHES)
    imgs = torch.from_numpy(_blob_images(2))
    assert torch.equal(orb_cuda.orb_pyramid(imgs, 3),
                       orb_cuda.orb_pyramid_reference(imgs, 3))
    p = torch.from_numpy(_patches(20))
    a, d = orb_cuda.orb_describe(p, 32)
    ra, rd = orb_cuda.orb_describe_reference(p, 32)
    assert torch.equal(a, ra) and torch.equal(d, rd)
    assert dict(_build.LAUNCHES) == before
    with pytest.raises(ValueError):
        orb_cuda.orb_pyramid(imgs[0], 3)
    with pytest.raises(ValueError):
        orb_cuda.orb_describe(p[:, :30], 32)


# -- the staged-tile pyramid's and the one-launch selection's plans, CPU ---


_span = orb_cuda._span


def _entry_at(e):
    """A plan entry's computed indices, in local order."""
    a = np.arange(e[0], e[1] + 1)
    return np.concatenate([a, np.arange(e[2], e[3] + 1)]) if e[3] >= e[2] else a


def _entry_loc(e, y):
    """Local index of level indices y among an entry's computed ones
    (the kernel's Entry::loc)."""
    return np.where(y <= e[1], y - e[0], e[1] - e[0] + 1 + y - e[2])


def _entry_own(e):
    return np.concatenate([np.arange(e[4], e[5]), np.arange(e[6], e[7])])


def _tiled_pyramid(imgs, levels, segs):
    """numpy model of csrc/orb_pyramid.cu over pyramid_plan's launches:
    per tile the source region staged and, per level and axis, the rows
    of pyramid_levels' tap table that its computed rows or columns take;
    each level's region computed from the one before (a first tap's index
    made local to the previous region by its plan entry): the vertical
    pass over every column of the previous region, then the horizontal,
    f32, taps left to right; and each level's part written -> (stack,
    times each pixel of each level's plane was written). Asserts every
    tap lies inside the previous region, every region and the tile's
    tables fit the launch's buffers, and no region is wider than a
    block's threads."""
    f32 = np.float32
    B, H, W = imgs.shape
    dims, table = orb_cuda.pyramid_levels(H, W, levels, 1.2)
    out = np.full((levels * B, H, W), np.nan, f32)
    count = np.zeros((levels, H, W), np.int32)

    def taps(off, e, K):
        """the tile's table of one level and axis: (first taps, weights)"""
        rows = table[off + _entry_at(e)[:, None] * (K + 1) + np.arange(K + 1)]
        return rows[:, 0], rows[:, 1:].view(np.float32)

    def inside(e, y):  # level indices y among an entry's computed ones
        y = np.asarray(y)
        assert (((y >= e[0]) & (y <= e[1])) | ((y >= e[2]) & (y <= e[3]))).all()

    def first_local(prev, cur, off, K, n_in, n_out):
        """local first taps in the previous region, checked against the
        resize's, and the weights (K = 0: the index itself, a copy)"""
        idx = _entry_at(cur)
        if K == 0:
            fl, wt = _entry_loc(prev, idx), None
            first = idx
        else:
            first, wt = taps(off, cur, K)
            fl = _entry_loc(prev, first)
            ref_w, ref_f = image.resize_taps(n_in, n_out)
            np.testing.assert_array_equal(first, ref_f[idx])
            np.testing.assert_array_equal(wt, ref_w[idx])
        K = max(K, 1)
        assert (fl >= 0).all() and (fl + K <= _span(prev)).all()
        inside(prev, first[:, None] + np.arange(K))
        got = _entry_at(prev)[fl[:, None] + np.arange(K)[None]]
        np.testing.assert_array_equal(got, first[:, None] + np.arange(K))
        return fl, wt

    for la, lb, TY, TX, rows, cols, sizes in segs:
        nbytes, buf_a, buf_b, vbuf, _ = sizes
        nlev = lb - la + 2
        tab_room = nbytes // 4 - buf_a - buf_b - vbuf - 16 * nlev
        for i in range(TY):
            for j in range(TX):
                er, ec = rows[0, i], cols[0, j]
                src = imgs if la == 1 else out[(la - 1) * B:la * B]
                S = src[:, _entry_at(er)][:, :, _entry_at(ec)]
                assert not np.isnan(S).any() and S[0].size <= buf_a
                if la == 1:
                    y, x = np.arange(er[4], er[5]), np.arange(ec[4], ec[5])
                    inside(er, y)
                    inside(ec, x)
                    out[:B, y[:, None], x[None]] = S[:, _entry_loc(er, y)][
                        :, :, _entry_loc(ec, x)]
                    count[0, y[:, None], x[None]] += 1
                tab_ints = 0
                for k in range(1, nlev):
                    l = la + k - 1
                    h, w, kv, kh, vt, ht = dims[l]
                    ph, pw = dims[l - 1, :2]
                    pr, pc, er, ec = er, ec, rows[k, i], cols[k, j]
                    nr, nc = _span(er), _span(ec)
                    assert nr * nc <= (buf_b if k % 2 else buf_a)
                    assert nr * S.shape[2] <= vbuf
                    assert nc <= orb_cuda.PYRAMID_THREADS
                    tab_ints += nr * (kv + 1) * (kv > 0) + nc * (kh + 1) * (kh > 0)
                    fl, tv = first_local(pr, er, vt, kv, ph, h)
                    fc, th = first_local(pc, ec, ht, kh, pw, w)
                    if kv == 0:
                        V = S[:, fl]
                    else:
                        V = tv[:, 0][None, :, None] * S[:, fl]
                        for q in range(1, kv):
                            V = V + tv[:, q][None, :, None] * S[:, fl + q]
                    if kh == 0:
                        D = V[:, :, fc]
                    else:
                        D = th[:, 0] * V[:, :, fc]
                        for q in range(1, kh):
                            D = D + th[:, q] * V[:, :, fc + q]
                    y, x = _entry_own(er), _entry_own(ec)
                    inside(er, np.minimum(y, h - 1))
                    inside(ec, np.minimum(x, w - 1))
                    vals = D[:, _entry_loc(er, np.minimum(y, h - 1))][
                        :, :, _entry_loc(ec, np.minimum(x, w - 1))]
                    out[l * B:(l + 1) * B, y[:, None], x[None]] = vals
                    count[l, y[:, None], x[None]] += 1
                    S = D.astype(f32)
                assert tab_ints <= tab_room
    return out, count


@pytest.mark.parametrize("B,H,W,levels,smem", [
    (4, 480, 640, 4, None), (1, 97, 133, 8, None), (2, 144, 192, 3, None),
    (3, 37, 53, 4, None), (5, 120, 160, 4, None), (1, 480, 640, 1, None),
    (1, 97, 133, 8, 6000), (2, 240, 320, 10, None)])
def test_pyramid_tiles_write_each_pixel_once_in_the_plain_order(B, H, W,
                                                                levels, smem):
    """pyramid_plan's tiles (at 132 SMs; the last case with so little
    shared memory that the chain takes several launches) write every
    pixel of every level's plane once, every tap of a tile lies in its
    region, and the tiled order gives the plain version's bits."""
    kw = {} if smem is None else dict(smem=smem)
    segs = orb_cuda.pyramid_plan(H, W, levels, 1.2, B, 132, **kw)
    if smem is not None or levels > orb_cuda.PYRAMID_MAX_LEVELS:
        assert len(segs) > 1
    elif (B, H, W, levels) == (4, 480, 640, 4):
        assert len(segs) == 1  # one launch at the bench shape
    imgs = np.random.RandomState(H).rand(B, H, W).astype(np.float32)
    got, count = _tiled_pyramid(imgs, levels, segs)
    assert (count == 1).all()
    ref = orb_cuda.orb_pyramid_reference(torch.from_numpy(imgs), levels)
    np.testing.assert_array_equal(got.view(np.uint32), ref.numpy().view(
        np.uint32))


def _select_model(v, r, h_l, w_l, kw):
    """numpy model of csrc/orb_select.cu's plan: per image the n-th
    largest value by at most three radix passes of 11, 11 and 10 bits
    over the order-preserving value bits (done where the n-th key's
    bucket is taken whole), the ties at it to the lowest indices,
    each chosen key's slot by counting the chosen keys above it; per
    level the slots' prio keys ranked likewise; per camera each slot's
    rank its own level's rank plus a binary search per other level."""
    v, r = v.numpy(), r.numpy()
    h_l, w_l = h_l.numpy(), w_l.numpy()
    C, budgets, n_out = kw["C"], kw["budgets"], kw["n_out"]
    ncx, cell = kw["ncx"], 16
    LC, N = v.shape[0], v.shape[1] * v.shape[2]
    L, maxb = LC // C, max(budgets)
    n, M = min(maxb, N), L * maxb
    v, r = v.reshape(LC, N), r.reshape(LC, N)
    keys = _key_model(v)  # (value bits << 32) | ~index, per image
    s_lvl = np.array([1.2 ** l for l in range(L)], np.float32)
    fields = np.zeros((C, M, 4), np.int64)
    runs = np.zeros((C, L, maxb), np.uint64)
    for img in range(LC):
        l, c = divmod(img, C)
        u = (keys[img] >> np.uint64(32)).astype(np.int64)
        prefix, known, rem, whole = 0, 0, n, False
        for sh, bits in ((21, 11), (10, 11), (0, 10)):
            live = (u & known) == prefix
            hist = np.bincount((u[live] >> sh) & ((1 << bits) - 1),
                               minlength=1 << bits)
            above = np.cumsum(hist[::-1])[::-1] - hist  # counts above a bin
            d = int(np.nonzero((above < rem) & (rem <= above + hist))[0][0])
            rem -= int(above[d])
            prefix |= d << sh
            known |= ((1 << bits) - 1) << sh
            if hist[d] == rem:  # the bucket taken whole: no more passes
                whole = True
                break
        eq = u == prefix
        chosen = (u >= prefix) if whole else (u > prefix) | (
            eq & (np.cumsum(eq) - eq < rem))
        assert chosen.sum() == n
        ck = keys[img][chosen]
        slot = (ck[None, :] > ck[:, None]).sum(1)  # chosen keys above
        assert sorted(slot) == list(range(n))
        k = (np.uint64(0xFFFFFFFF) - (ck & np.uint64(0xFFFFFFFF))).astype(int)
        val = v[img, k]
        g, rr = k // 4, r[img, k]
        ok0 = val > 0
        y = np.where(ok0, (g // ncx) * cell + rr // cell, 0)
        x = np.where(ok0, (g % ncx) * cell + rr % cell, 0)
        ok = ok0 & (slot < budgets[l]) & (y >= orb.EDGE) & (
            y < h_l[img] - orb.EDGE) & (x >= orb.EDGE) & (x < w_l[img] - orb.EDGE)
        resp = np.where(val > 1, val - np.float32(1), val).astype(np.float32)
        j = l * maxb + slot
        fields[c, j] = np.stack([y, x, resp.view(np.int32), ok], -1)
        prio = np.full(maxb, -1.0, np.float32)
        prio[slot] = np.where(ok, resp + np.float32(1000), np.float32(-1))
        pk = _key_model(prio[None])[0]
        pk = (pk & ~np.uint64(0xFFFFFFFF)) | (
            np.uint64(0xFFFFFFFF) - np.arange(l * maxb, (l + 1) * maxb,
                                              dtype=np.uint64))
        runs[c, l, (pk[None, :] > pk[:, None]).sum(1)] = pk
    out = [np.zeros((C, n_out, 2), np.float32), np.zeros((C, n_out), np.float32),
           np.zeros((C, n_out), np.int32), np.zeros((C, n_out), np.float32),
           np.zeros((C, n_out), bool), np.zeros((C * n_out, 2), np.int32),
           np.zeros(C * n_out, np.int32)]
    for c in range(C):
        for le in range(L):
            for pos, key in enumerate(runs[c, le]):
                if M > n_out:
                    rank = pos + sum(int((runs[c, lo] > key).sum())
                                     for lo in range(L) if lo != le)
                    j = int(np.uint64(0xFFFFFFFF) - (key & np.uint64(0xFFFFFFFF)))
                else:
                    rank = j = le * maxb + pos
                if rank >= n_out:
                    continue
                fy, fx, fr, fv = fields[c, j]
                lv = j // maxb
                o = c * n_out + rank
                out[0][c, rank] = (np.float32(fx) * s_lvl[lv],
                                   np.float32(fy) * s_lvl[lv])
                out[1][c, rank] = np.int32(fr).view(np.float32)
                out[2][c, rank] = lv
                out[3][c, rank] = s_lvl[lv] * s_lvl[lv]
                out[4][c, rank] = bool(fv)
                out[5][o] = (fy, fx)
                out[6][o] = lv * C + c
    return out


@pytest.mark.parametrize("kind,C,L,num_points", SELECT_CASES)
def test_select_plan_reproduces_the_plain_version(kind, C, L, num_points):
    v, r, h_l, w_l, kw = _select_case(kind, C, L, num_points)
    want = orb_cuda.orb_select_reference(v, r, h_l, w_l, **kw)
    got = _select_model(v, r, h_l, w_l, kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b.numpy())


# -- on the card -----------------------------------------------------------

PYRAMID_SHAPES = [(4, 480, 640, 4), (1, 97, 133, 8), (2, 144, 192, 3),
                  (3, 37, 53, 4), (5, 120, 160, 4), (1, 480, 640, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,levels", PYRAMID_SHAPES)
def test_pyramid_kernel_matches_plain(cuda, B, H, W, levels):
    imgs = torch.from_numpy(np.random.RandomState(H).rand(B, H, W).astype(
        np.float32)).to(cuda)
    ref = orb_cuda.orb_pyramid_reference(imgs, levels)
    n0 = _build.LAUNCHES["orb_pyramid"]
    runs = [orb_cuda.orb_pyramid(imgs, levels) for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["orb_pyramid"] == n0 + 2
    for k in runs:
        assert torch.equal(k, ref)


@pytest.mark.gpu
@pytest.mark.parametrize("B,H,W,levels,smem", [
    (1, 97, 133, 8, 6000), (2, 240, 320, 10, None), (3, 127, 201, 5, 6000)])
def test_pyramid_kernel_in_several_launches(cuda, monkeypatch, B, H, W,
                                            levels, smem):
    """The chain split over launches (more levels than one launch takes,
    or tiles whose regions outgrow the shared memory allowed), tiles of
    odd sizes, W % 4 != 0: the plain version's bits."""
    if smem is not None:
        monkeypatch.setattr(orb_cuda, "PYRAMID_SMEM", smem)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    segs = orb_cuda.pyramid_plan(H, W, levels, 1.2, B, sms,
                                 orb_cuda.PYRAMID_SMEM)
    assert len(segs) > 1
    imgs = torch.from_numpy(np.random.RandomState(W).rand(B, H, W).astype(
        np.float32)).to(cuda)
    ref = orb_cuda.orb_pyramid_reference(imgs, levels)
    assert torch.equal(orb_cuda.orb_pyramid(imgs, levels), ref)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,C,L,num_points", SELECT_CASES)
def test_select_kernel_matches_plain(cuda, kind, C, L, num_points):
    v, r, h_l, w_l, kw = _select_case(kind, C, L, num_points)
    v, r, h_l, w_l = (x.to(cuda) for x in (v, r, h_l, w_l))
    ref = orb_cuda.orb_select_reference(v, r, h_l, w_l, **kw)
    n0 = _build.LAUNCHES["orb_select"]
    runs = [orb_cuda.orb_select(v, r, h_l, w_l, **kw) for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["orb_select"] == n0 + 2
    for out in runs:
        for a, b in zip(out, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.gpu
def test_select_kernel_in_a_cuda_graph(cuda):
    v, r, h_l, w_l, kw = _blob_candidates(4, 4, 256)
    v, r, h_l, w_l = (x.to(cuda) for x in (v, r, h_l, w_l))
    ref = orb_cuda.orb_select_reference(v, r, h_l, w_l, **kw)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        orb_cuda.orb_select(v, r, h_l, w_l, **kw)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = orb_cuda.orb_select(v, r, h_l, w_l, **kw)
    for _ in range(2):
        for x in out:
            x.zero_()
        graph.replay()
        torch.cuda.synchronize()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("T,bins", [(3072, 16), (777, 32), (1, 16)])
def test_describe_kernel_matches_plain(cuda, T, bins):
    p = _patches(T, seed=T)
    p[: T // 4] = np.random.RandomState(1).rand(T // 4, orb.PATCH, orb.PATCH)
    p = torch.from_numpy(p).to(cuda)
    ra, rd = orb_cuda.orb_describe_reference(p, bins)
    n0 = _build.LAUNCHES["orb_describe"]
    runs = [orb_cuda.orb_describe(p, bins) for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["orb_describe"] == n0 + 2
    for a, d in runs:
        assert torch.equal(a, ra), int((a != ra).sum())
        assert torch.equal(d, rd), int((d != rd).any(-1).sum())
    # the moments alone: the kernel's angle from the plain moments
    m = orb.patch_moments(p)
    assert torch.equal(runs[0][0], torch.atan2(m[:, 1], m[:, 0]))
