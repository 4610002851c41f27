"""The frame build's glue around the intra pair match and before the
triangulation (frontend/intra_cuda: intra_gate, intra_groups, tri_gather;
csrc/intra_glue.cu) and the rig constants of the intra match and the
triangulation (intra.pair_constants, frame.world_T_cam).

On the CPU, the same numpy inputs through the JAX package and the port
(the wrappers take their plain versions for CPU tensors):
- the Sampson gate pair by pair against jintra.sampson_gate: equal but
  for cells whose float64 ratio lies within GATE_ULPS float32 spacings of
  thr^2 (both sides round their three-term dots on their own; the test
  counts those cells);
- intra_match against JAX's exactly (ray_idx, desc, valid) at C = 2-5
  and N = 96, with C N below and above max_out, on scenes with chains
  across all five cameras, duplicate features, roots of equal priority,
  no valid feature and every feature a root;
- the triangulation stage against JAX's _triangulate_stage on JAX's
  groups: anchor_cam, n_rays, uv_ref, anchor_sigma2 and has_depth
  exactly, X to test_torch_slice.py's bearings (1e-5) and depths (1 %);
- the rig constants: the bits of the per-frame ops, made once per rig,
  again for another rig and after an in-place edit.

The gate's division-free cells (csrc/intra_glue.cu decides RN(a / b) <
thr^2 by two products with margins and divides only the cells within
them) are held to the float32 division on the CPU, modelled op for op,
over 10^5 seeded (a, b) pairs around the threshold and the edge values.
The identity tri_gather's lane-per-ray kernel rests on is held on the
plain version: the anchor's pixel and sigma^2 are the values its own
camera's gather reads, bit for bit, groups without a ray included; and
tri_gather's outputs carved from one buffer (intra_cuda.
tri_gather_outputs) keep the plain version's shapes, strides and dtypes.

`gpu` cases (they skip without a card) hold each kernel to its plain
version on the card with torch.equal at the frame's shape (C = 4, N =
768, max_out 2048), at C = 2, 3, 5 x N = 1, 33, 129, 1000, at the
designs' edges (gate cells on the threshold, an exact rounding tie, the
1e-12 clamp, t^2 overflowing, NaN pixels, thresholds outside the
margins' range; groups with no valid feature, every feature a root,
features of one camera sharing a root, equal priorities across the
blocks' slices; tri_gather at M = 1, 31, 33, 2049 x C = 1-4 and at C = 5
and 33, with groups of no ray, one ray and every ray) and through
repeated replays of a captured CUDA graph:
    python -m pytest --noconftest tests/test_torch_intra_glue.py -m gpu -q
(this file imports JAX only inside its CPU comparisons)."""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mcslam_tpu_torch import _build
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame, intra, intra_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import hamming
from test_torch_intra_kernel import _rig, _scene
from test_torch_track_kernels import _carved_ok

GATE_ULPS = 64
N96 = 96
# (C, max_out): C N = 192 and 384 below max_out (padded), 288 and 480
# above it (cut)
SHAPES = ((2, 256), (3, 160), (4, 512), (5, 160))


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's jitted intra_match per (C, max_out) and
    _triangulate_stage, compiled once for the module."""
    import jax
    import jax.numpy as jnp
    from mcslam_tpu.data import synthetic as jsyn
    from mcslam_tpu.frontend import frame as jframe
    from mcslam_tpu.frontend import intra as jintra

    cache = {}

    def rig(C):
        return jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(num_cams=C))

    def match(C, max_out, desc, xy, valid, response):
        if (C, max_out) not in cache:
            jrig = rig(C)
            cache[(C, max_out)] = jax.jit(lambda *a: jintra.intra_match(
                *a, jrig, max_out=max_out))
        g = cache[(C, max_out)](jnp.asarray(desc), jnp.asarray(xy),
                                jnp.asarray(valid), jnp.asarray(response))
        return tuple(np.asarray(x) for x in g)

    def tri(groups, xy, sigma2):
        C = xy.shape[0]
        g = jintra.IntraGroups(*(jnp.asarray(x) for x in groups))
        out = jframe._triangulate_stage(g, jnp.asarray(xy),
                                        jnp.asarray(sigma2), rig(C), 0.5,
                                        40.0)
        return tuple(np.asarray(x) for x in out)

    def gate(xn_i, xn_j, E, thr):
        f = jax.jit(jax.vmap(jintra.sampson_gate, in_axes=(0, 0, 0, None)))
        return np.asarray(f(jnp.asarray(xn_i), jnp.asarray(xn_j),
                            jnp.asarray(E), jnp.asarray(thr)))

    return dict(match=match, tri=tri, gate=gate)


def _port_match(C, max_out, desc, xy, valid, response):
    g = intra.intra_match(hamming.desc_to_torch(desc, "cpu"),
                          torch.from_numpy(xy), torch.from_numpy(valid),
                          torch.from_numpy(response), _rig(C, "cpu"),
                          max_out=max_out)
    return (g.ray_idx.numpy(), hamming.desc_to_numpy_u32(g.desc),
            g.valid.numpy())


def _landmark_scene(seed, C, N, drift):
    """_scene's features with N // 3 landmarks seen by all C cameras of the
    synthetic rig (camera c at x = 0.12 c), valid, their descriptors
    drifting `drift` bits a camera. At drift 35 neighbours match (35 <=
    max_dist) and cameras two apart do not (70), so a group is a chain c ->
    c - 1 -> ... -> 0."""
    rng = np.random.RandomState(seed)
    desc, xy, valid, response = _scene(seed, C, N)
    L = N // 3
    P = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(3, 8, L)], 1)
    base = rng.randint(0, 2**32, (L, 8), dtype=np.uint64).astype(np.uint32)
    for lm in range(L):
        words = base[lm]
        bits = rng.permutation(256)
        for c in range(C):
            if c:
                words = words.copy()
                for b in bits[drift * (c - 1):drift * c]:
                    words[b // 32] ^= np.uint32(1 << (b % 32))
            desc[c, lm] = words
            x = P[lm, 0] - 0.12 * c
            xy[c, lm] = [400 * x / P[lm, 2] + 320,
                         400 * P[lm, 1] / P[lm, 2] + 240]
    valid[:, :L] = True
    return desc, xy, valid, response


def _scenes():
    """{name: (C, max_out, desc, xy, valid, response)}."""
    out = {f"C={C}": (C, mo, *_scene(C, C, N96)) for C, mo in SHAPES}
    out["chains over five cameras"] = (5, 160,
                                       *_landmark_scene(5, 5, N96, 35))
    desc, xy, valid, response = _scene(33, 3, N96)
    out["roots of equal priority"] = (
        3, 160, desc, xy, valid, np.where(valid, 0.5, 0.0).astype(np.float32))
    desc, xy, _, response = _scene(34, 4, N96)
    out["no valid feature"] = (4, 512, desc, xy, np.zeros((4, N96), bool),
                               response)
    rng = np.random.RandomState(35)
    desc = rng.randint(0, 2**32, (4, N96, 8), dtype=np.uint64).astype(
        np.uint32)
    _, xy, _, response = _scene(35, 4, N96)
    out["every feature a root"] = (4, 512, desc, xy, np.ones((4, N96), bool),
                                   response)
    return out


SCENES = _scenes()


@pytest.mark.parametrize("name", list(SCENES))
def test_intra_match_matches_jax(jax_side, name):
    C, max_out, desc, xy, valid, response = SCENES[name]
    before = dict(_build.LAUNCHES)
    got = _port_match(C, max_out, desc, xy, valid, response)
    want = jax_side["match"](C, max_out, desc, xy, valid, response)
    for g, w, field in zip(got, want, ("ray_idx", "desc", "valid")):
        np.testing.assert_array_equal(g, w, err_msg=field)
    assert dict(_build.LAUNCHES) == before
    rays = (want[0] >= 0).sum(1)
    assert got[0].shape == (max_out, C)
    if name == "chains over five cameras":
        # groups of all five cameras, whose parent chain is four hops
        assert int((rays == 5).sum()) >= 10
    elif name == "no valid feature":
        assert not want[2].any() and (want[0] == -1).all()
    elif name == "every feature a root":
        assert int(rays.max()) == 1 and int(want[2].sum()) == min(
            max_out, C * N96)
    elif name == "roots of equal priority":
        # singletons tie at 1000.5 and pairs at 2000.5: slots by index
        assert int((rays == 1).sum()) > 10 and int((rays >= 2).sum()) > 10
    else:
        assert int(rays.max()) >= 2


def test_chain_scene_needs_the_jumps():
    """The chain scene's parent table: a group's highest camera reaches its
    root in four hops, not fewer."""
    C, _, desc, xy, valid, _ = SCENES["chains over five cameras"]
    rig = _rig(C, "cpu")
    pc = intra.pair_constants(rig)
    gate = intra_cuda.intra_gate(torch.from_numpy(xy), rig.fxycxy, pc.E,
                                 pc.thr2)
    parent = intra_cuda.intra_pairs(hamming.desc_to_torch(desc, "cpu"),
                                    torch.from_numpy(valid), gate).reshape(-1)
    hops = torch.zeros_like(parent)
    x = torch.arange(parent.numel(), dtype=torch.int32)
    for _ in range(8):
        nxt = parent[x.long()]
        hops += (nxt != x).to(hops.dtype)
        x = nxt
    assert int(hops.max()) == 4


def test_sampson_gate_matches_jax(jax_side):
    """Pair by pair at C = 4, N = 256 over the scene's normalized
    coordinates: equal but within GATE_ULPS of thr^2, counted."""
    C, N = 4, 256
    _, xy, _, _ = _scene(40, C, N)
    rig = _rig(C, "cpu")
    pc = intra.pair_constants(rig)
    xn = intra_cuda.normalized(torch.from_numpy(xy), rig.fxycxy).numpy()
    thr_n = (3.0 / torch.mean(rig.fxycxy[:, 0])).numpy()
    pair_i, pair_j = intra_cuda.camera_pairs(C)
    want = jax_side["gate"](xn[pair_i], xn[pair_j], pc.E.numpy(), thr_n)
    got = intra.sampson_gate(torch.from_numpy(xn[pair_i]),
                             torch.from_numpy(xn[pair_j]), pc.E,
                             torch.from_numpy(thr_n)).numpy()
    assert torch.equal(
        intra_cuda.intra_gate(torch.from_numpy(xy), rig.fxycxy, pc.E,
                              pc.thr2), torch.from_numpy(got))
    # the ratio in float64 from the same float32 inputs
    x = xn.astype(np.float64)
    E = pc.E.numpy().astype(np.float64)
    hi = np.concatenate([x[pair_i], np.ones((len(pair_i), N, 1))], -1)
    hj = np.concatenate([x[pair_j], np.ones((len(pair_j), N, 1))], -1)
    Exj = np.einsum("pbl,pkl->pbk", hj, E)
    Ethi = np.einsum("pal,plk->pak", hi, E)
    num = np.einsum("pal,pbl->pab", hi, Exj) ** 2
    den = (Exj[:, None, :, 0] ** 2 + Exj[:, None, :, 1] ** 2
           + Ethi[:, :, None, 0] ** 2 + Ethi[:, :, None, 1] ** 2)
    thr2 = np.float32(thr_n) * np.float32(thr_n)
    near = np.abs(num / np.maximum(den, 1e-12) - thr2) \
        <= GATE_ULPS * np.spacing(thr2)
    differ = got != want
    assert not (differ & ~near).any(), int((differ & ~near).sum())
    assert int(differ.sum()) <= int(near.sum())
    assert 0 < int(got.sum()) < got.size // 10


def _margin_decisions(a, b, thr2):
    """csrc/intra_glue.cu's decided gate cells, op for op in float32:
    (below, above) where a < RN(tlo b) and a >= RN(thi b), tlo, thi =
    RN(thr2 (1 -+ 2^-20)) for thr2 in [2^-60, 2^60], else -1 and inf."""
    t = torch.tensor(thr2, dtype=F32)
    if 2.0 ** -60 <= thr2 <= 2.0 ** 60:
        tlo = t * torch.tensor(1 - 2.0 ** -20, dtype=F32)
        thi = t * torch.tensor(1 + 2.0 ** -20, dtype=F32)
    else:
        tlo = torch.tensor(-1.0, dtype=F32)
        thi = torch.tensor(float("inf"), dtype=F32)
    return a < tlo * b, a >= thi * b


def test_gate_margins_decide_as_the_division():
    """The gate kernel's cells decided without a division give the float32
    division's answer, RN(a / b) < thr2, on 10^5 seeded pairs a stated
    ulp count from the threshold, at random and at the edges: a in {0,
    subnormal, FLT_MAX, inf, NaN}, b at the 1e-12 clamp, FLT_MAX, inf, NaN,
    rounding ties, thresholds inside and outside the margins' range."""
    rng = np.random.RandomState(23)
    n = 100_000
    fmax = float(np.finfo(np.float32).max)
    b = np.exp(rng.uniform(np.log(1e-12), np.log(1e30), n)).astype(np.float32)
    b[:1000] = np.float32(1e-12)
    checked = 0
    for thr2 in ((3.0 / 400.0) ** 2, 1.0, 0.37, 2.0 ** -60, 2.0 ** 60,
                 2.0 ** 59 * 1.5, 0.0, -1.0, TINY, 2.0 ** -61, 2.0 ** 61,
                 float("inf"), float("nan")):
        t32 = np.float32(thr2)
        bt = torch.from_numpy(b)
        # a within +-40 ulps of RN(thr2 b), within 2^-18 relative of it
        # and anywhere over 20 binades
        p = (bt * torch.tensor(t32)).numpy() if np.isfinite(t32) else b
        k = rng.randint(-40, 41, n).astype(np.int64)
        p = np.abs(p)  # a = t^2 >= 0
        a_ulp = (p.view(np.int32).astype(np.int64) + k).clip(
            0, 0x7f7fffff).astype(np.int32).view(np.float32)
        with np.errstate(over="ignore"):  # past FLT_MAX: inf, an edge
            a_rel = (p * (1 + rng.uniform(-2 ** -18, 2 ** -18, n))).astype(
                np.float32)
            a_wide = (p * np.exp2(rng.uniform(-10, 10, n))).astype(
                np.float32)
        edge_a = np.array([0.0, TINY, 1e-40, fmax, np.inf, np.nan, 1.0,
                           9 * 2.0 ** -90], np.float32)
        edge_b = np.array([1e-12, 1.0, fmax, np.inf, np.nan, 2.0 ** 60],
                          np.float32)
        ea, eb = (x.ravel() for x in np.meshgrid(edge_a, edge_b))
        for a, bb in ((a_ulp, b), (a_rel, b), (a_wide, b), (ea, eb)):
            at, btt = torch.from_numpy(a), torch.from_numpy(bb)
            below, above = _margin_decisions(at, btt, float(t32))
            want = at / btt < torch.tensor(t32)
            assert not (below & above).any()
            assert bool(want[below].all()), float(t32)
            assert not bool(want[above].any()), float(t32)
            checked += int((below | above).sum())
            if 2.0 ** -60 <= t32 <= 2.0 ** 60 and a is a_wide:
                # far from the threshold every cell is decided
                assert int((below | above).sum()) == n
    # the tie: 9 2^-150 rounds to the even subnormal 4 2^-149, and a
    # threshold there sends it to the division
    a, bb = torch.tensor([9 * 2.0 ** -90], dtype=F32), torch.tensor(
        [2.0 ** 60], dtype=F32)
    assert (a / bb).item() == 4 * TINY
    below, above = _margin_decisions(a, bb, 5 * TINY)
    assert not below.any() and not above.any()
    assert checked > 10 * n


def test_triangulation_stage_matches_jax(jax_side):
    """_triangulate_stage on JAX's groups of the C = 4 scene, padded slots
    (no ray) included."""
    C, max_out = 4, 512
    desc, xy, valid, response = _landmark_scene(41, C, N96, 8)
    groups = jax_side["match"](C, max_out, desc, xy, valid, response)
    rng = np.random.RandomState(41)
    sigma2 = (1.2 ** rng.randint(0, 4, (C, N96))).astype(np.float32)
    want = jax_side["tri"](groups, xy, sigma2)
    g = intra.IntraGroups(torch.from_numpy(np.array(groups[0])),
                          hamming.desc_to_torch(groups[1], "cpu"),
                          torch.from_numpy(np.array(groups[2])))
    X, has_depth, anchor_cam, uv_ref, anchor_sigma2, n_rays = \
        frame._triangulate_stage(g, torch.from_numpy(xy),
                                 torch.from_numpy(sigma2), _rig(C, "cpu"),
                                 0.5, 40.0)
    for got, w in ((anchor_cam, want[2]), (uv_ref, want[3]),
                   (anchor_sigma2, want[4]), (n_rays, want[5]),
                   (has_depth, want[1])):
        assert got.dtype == torch.from_numpy(np.asarray(w)).dtype
        np.testing.assert_array_equal(got.numpy(), w)
    d = want[1]
    assert int(d.sum()) >= 20
    Xj, Xt = want[0][d], X.numpy()[d]
    np.testing.assert_allclose(Xt[:, :2] / Xt[:, 2:], Xj[:, :2] / Xj[:, 2:],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(Xt[:, 2], Xj[:, 2], rtol=1e-2, atol=0)


def test_rig_constants_are_made_once_per_rig():
    rig = _rig(4, "cpu")
    pc = intra.pair_constants(rig)
    pair_i, pair_j = intra_cuda.camera_pairs(4)
    E = torch.stack([intra.pair_essential(rig, i, j)
                     for i, j in zip(pair_i, pair_j)])
    thr_n = 3.0 / torch.mean(rig.fxycxy[:, 0])
    assert torch.equal(pc.E, E) and torch.equal(pc.thr2, thr_n**2)
    assert pc.thr2.dtype == torch.float32 and pc.thr2.dim() == 0
    wTc = frame.world_T_cam(rig)
    assert torch.equal(wTc, lie.se3_inverse(rig.cam_T_ref))
    # the same values until the rig changes
    assert intra.pair_constants(rig) is pc and frame.world_T_cam(rig) is wTc
    assert intra.pair_constants(rig, 2.0) is not pc
    # another rig gets its own
    other = synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=4, baseline=0.3), device="cpu")
    po = intra.pair_constants(other)
    assert not torch.equal(po.E, pc.E)
    assert torch.equal(frame.world_T_cam(other),
                       lie.se3_inverse(other.cam_T_ref))
    # an in-place edit of the rig's tensors is seen
    rig.cam_T_ref[1, 0, 3] += 0.05
    rig.fxycxy[:, 0] += 10.0
    pe = intra.pair_constants(rig)
    E2 = torch.stack([intra.pair_essential(rig, i, j)
                      for i, j in zip(pair_i, pair_j)])
    assert not torch.equal(pe.E, pc.E) and torch.equal(pe.E, E2)
    assert torch.equal(pe.thr2, (3.0 / torch.mean(rig.fxycxy[:, 0]))**2)
    assert torch.equal(frame.world_T_cam(rig), lie.se3_inverse(rig.cam_T_ref))


def test_wrappers_refuse_what_they_cannot_take():
    desc, xy, valid, response = _scene(0, 3, 32)
    rig = _rig(3, "cpu")
    pc = intra.pair_constants(rig)
    xy_t = torch.from_numpy(xy)
    with pytest.raises(ValueError, match="unsupported device"):
        intra_cuda.intra_gate(xy_t.to("meta"), rig.fxycxy, pc.E, pc.thr2)
    with pytest.raises(ValueError, match=r"\(C >= 2, N, 2\)"):
        intra_cuda.intra_gate(xy_t[:1], rig.fxycxy, pc.E, pc.thr2)
    v = torch.from_numpy(valid)
    with pytest.raises(ValueError, match="unsupported device"):
        intra_cuda.intra_groups(v.int().to("meta"), v.to("meta"),
                                torch.from_numpy(response).to("meta"),
                                hamming.desc_to_torch(desc, "meta"), 64)
    with pytest.raises(ValueError, match="max_out"):
        intra_cuda.intra_groups(v.int(), v, torch.from_numpy(response),
                                hamming.desc_to_torch(desc, "cpu"), 0)
    with pytest.raises(ValueError, match=r"\(M, C\)"):
        intra_cuda.tri_gather(v.int()[0], v[0], xy_t, xy_t[..., 0])


@pytest.mark.parametrize("C", [1, 2, 3, 4, 5])
def test_tri_gather_anchor_is_the_cameras_own_gather(C):
    """On the plain version: uv_ref is uv[m, anchor_cam[m]] and
    anchor_sigma2 is kp_sigma2[c, max(ray_idx[m, c], 0)] at c =
    anchor_cam[m], the values camera c's own gather reads, bit for bit;
    so also for groups without a ray (camera 0, feature 0)."""
    ray_idx, valid, xy, sigma2 = cs.tri_gather_problem(
        np.random.RandomState(70 + C), C, 50, 203, "cpu")
    (uv, _, _, anchor_cam, uv_ref, anchor_sigma2, n_rays,
     _) = intra_cuda.tri_gather_reference(ray_idx, valid, xy, sigma2)
    m = torch.arange(ray_idx.shape[0])
    a = anchor_cam.long()
    assert torch.equal(uv_ref.view(torch.int32), uv[m, a].view(torch.int32))
    own = sigma2[a, torch.clamp(ray_idx[m, a], min=0).long()]
    assert torch.equal(anchor_sigma2.view(torch.int32), own.view(torch.int32))
    none = n_rays == 0
    assert none.any() and (n_rays == 1).any() and (n_rays == C).any()
    assert (a[none] == 0).all()
    assert torch.equal(uv_ref[none], xy[0, 0].expand(int(none.sum()), 2))


@pytest.mark.parametrize("M,C", [(2048, 4), (2049, 3), (1, 1), (0, 2)])
def test_tri_gather_outputs_keep_their_layout(M, C, monkeypatch):
    """tri_gather_outputs: the plain version's shapes, strides and dtypes,
    contiguous, aligned, disjoint; and so in a buffer that torch.empty
    hands out at an offset of its storage."""
    want = [(tuple(x.shape), x.dtype, x.stride())
            for x in intra_cuda.tri_gather_reference(*cs.tri_gather_problem(
                np.random.RandomState(80), C, 9, M, "cpu"))]
    real = torch.empty
    for offset in (0, 300):
        held = []

        def empty(*size, **kw):
            n = size[0]
            slab = real(n + 2 * offset, **kw)
            held.append(slab)
            return slab[offset:offset + n]

        monkeypatch.setattr(torch, "empty", empty)
        views = intra_cuda.tri_gather_outputs(M, C, "cpu")
        monkeypatch.setattr(torch, "empty", real)
        (slab,) = held
        assert [(tuple(x.shape), x.dtype, x.stride()) for x in views] == want
        assert all(x.is_contiguous() for x in views)
        _carved_ok(views, slab[offset:].data_ptr(),
                   (slab.numel() - 2 * offset) * 4)


# ---- on the card: each kernel against its plain version ----

def _gate_inputs(seed, C, N, dev):
    """Pixels of C cameras: the scene's where N allows it, else uniform
    over VGA; the rig's pair constants."""
    rng = np.random.RandomState(seed)
    if N >= 8:
        xy = _scene(seed, C, N)[1]
    else:
        xy = np.stack([rng.uniform(0, 640, (C, N)),
                       rng.uniform(0, 480, (C, N))], -1).astype(np.float32)
    rig = _rig(C, dev)
    pc = intra.pair_constants(rig)
    return torch.from_numpy(xy).to(dev), rig.fxycxy, pc.E, pc.thr2


def _groups_inputs(seed, C, N, dev):
    """A parent table (each feature's parent itself or a random feature of
    a lower camera, chains up to C - 1 hops), validity, responses on a
    few levels (ties) and descriptors."""
    rng = np.random.RandomState(seed)
    flat = np.arange(C * N).reshape(C, N)
    parent = flat.copy()
    for c in range(1, C):
        linked = rng.rand(N) < 0.6
        parent[c, linked] = rng.randint(0, c * N, int(linked.sum()))
    valid = rng.rand(C, N) < 0.85
    response = (rng.randint(0, 4, (C, N)) * 0.25).astype(np.float32)
    desc = rng.randint(-2**31, 2**31 - 1, (C, N, 8)).astype(np.int32)
    return tuple(torch.from_numpy(a).to(dev) for a in (
        parent.astype(np.int32), valid, response, desc))


def _tri_inputs(seed, C, N, M, dev):
    """ray_idx with -1 holes (rows of 0, 1 and several rays), group
    validity, pixels and sigma2 of 1.2^octave."""
    rng = np.random.RandomState(seed)
    ray_idx = rng.randint(0, N, (M, C)).astype(np.int32)
    ray_idx[rng.rand(M, C) < 0.5] = -1
    ray_idx[:min(M, 3)] = -1
    valid = rng.rand(M) < 0.8
    xy = rng.uniform(0, 640, (C, N, 2)).astype(np.float32)
    sigma2 = (1.2 ** rng.randint(0, 8, (C, N))).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (ray_idx, valid, xy,
                                                       sigma2))


def _kernel_vs_plain(name, args):
    fn = getattr(intra_cuda, name)
    plain = getattr(intra_cuda, f"{name}_reference")
    ref = plain(*args)
    before = _build.LAUNCHES[name]
    runs = [fn(*args) for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES[name] == before + 2
    ref = ref if isinstance(ref, tuple) else (ref,)
    for got in runs:
        got = got if isinstance(got, tuple) else (got,)
        assert len(got) == len(ref)
        for k, (g, r) in enumerate(zip(got, ref)):
            assert g.dtype == r.dtype and g.shape == r.shape, (name, k)
            assert torch.equal(g, r), (name, k, int((g != r).sum()))


EDGE_SHAPES = [(C, N) for C in (2, 3, 5) for N in (1, 33, 129, 1000)]
F32 = torch.float32
TINY = 2.0 ** -149  # the least float32 subnormal


def _shapes_and(edges, C, N):
    """The shape cases (no edge), then each edge at (C, N)."""
    return ([pytest.param(c, n, None, id=f"{c}-{n}")
             for c, n in [(4, 768)] + EDGE_SHAPES]
            + [pytest.param(C, N, e, id=e) for e in edges])


def _f32_next(x, toward):
    return torch.nextafter(torch.tensor(x, dtype=F32),
                           torch.tensor(toward, dtype=F32))


def _gate_edge(edge, args):
    """intra_gate calls of an edge case, from _gate_inputs' (xy, fxycxy,
    E, thr2)."""
    xy, f, E, thr2 = args
    dev = xy.device
    if edge == "threshold":
        # thr2 on the quotient of a cell (its gate false), one ulp above
        # (true) and below, for cells at three quantiles of the quotients
        C = xy.shape[0]
        xn = intra_cuda.normalized(xy, f)
        pi, pj = intra_cuda.camera_pairs(C)
        num, den = intra_cuda.sampson_terms(xn[pi], xn[pj], E)
        q = (num / den).flatten()
        q = torch.sort(q[torch.isfinite(q) & (q > 0)]).values
        out = []
        for frac in (0.02, 0.3, 0.8):
            v = q[int(frac * (q.numel() - 1))].reshape(())
            out += [(xy, f, E, t) for t in (
                v, _f32_next(v.item(), np.inf).to(dev),
                _f32_next(v.item(), -np.inf).to(dev))]
        return out
    if edge == "tie":
        # cell (0, 0) of pair (0, 1): xi = (0, 0), xj = (1/8, 0) exactly,
        # so t = 3 2^-45 (t^2 = 9 2^-90) over den = (2^33 / 8)^2 = 2^60:
        # the quotient 9 2^-150 is a rounding tie between the subnormals 4
        # and 5 x 2^-149 (to 4, the even one); with E22 = 3 2^-10 the
        # quotient 9 2^-80 is a normal float, a cell on the threshold
        xy, E = xy.clone(), E.clone()
        xy[0, 0] = f[0, 2:]
        xy[1, 0] = f[1, 2:] + f[1, :2] * torch.tensor([0.125, 0.0],
                                                      device=dev)
        out = []
        for e22, thrs in ((2.0 ** -45 * 3, (4 * TINY, 5 * TINY)),
                          (2.0 ** -10 * 3, (9 * 2.0 ** -80,
                                            _f32_next(9 * 2.0 ** -80,
                                                      np.inf).item()))):
            Et = E.clone()
            Et[0] = 0.0
            Et[0, 0, 0] = 2.0 ** 33
            Et[0, 2, 2] = e22
            xn = intra_cuda.normalized(xy, f)
            num, den = intra_cuda.sampson_terms(xn[0:1, 0:1], xn[1:2, 0:1],
                                                Et[0:1])
            assert num.item() == (e22 * e22) and den.item() == 2.0 ** 60
            out += [(xy, f, Et, torch.tensor(t, dtype=F32, device=dev))
                    for t in thrs]
        return out
    if edge == "clamp":  # den below 1e-12 in most cells
        return [(xy, f, E * 1e-7, thr2)]
    if edge == "overflow":  # t^2 and den past float32's range in some cells
        return [(xy, f, E * s, thr2) for s in (3e18, 3e19)]
    if edge == "nan":  # NaN and infinite pixels in rows and columns
        xy = xy.clone()
        xy[0, :3, 0] = float("nan")
        xy[1, 5:8, 1] = float("nan")
        xy[2, 1, 0] = float("inf")
        return [(xy, f, E, thr2)]
    if edge == "thr2":  # thresholds outside the margins' range
        return [(xy, f, E, torch.tensor(t, dtype=F32, device=dev))
                for t in (0.0, -1.0, TINY, 2.0 ** -61, 2.0 ** -60, 2.0 ** 60,
                          2.0 ** 61, float("inf"), float("nan"))]
    raise ValueError(edge)


GATE_EDGES = ("threshold", "tie", "clamp", "overflow", "nan", "thr2")


@pytest.mark.gpu
@pytest.mark.parametrize("C,N,edge", _shapes_and(GATE_EDGES, 3, 200))
def test_intra_gate_matches_plain(cuda, C, N, edge):
    args = _gate_inputs(C * 1000 + N, C, N, cuda)
    for a in ([args] if edge is None else _gate_edge(edge, args)):
        _kernel_vs_plain("intra_gate", a)


def _groups_edge(edge, args):
    """intra_groups' inputs of an edge case, from _groups_inputs'."""
    parent, valid, response, desc = (x.clone() for x in args)
    C, N = valid.shape
    if edge == "invalid":
        valid[:] = False
    elif edge == "roots":
        parent = torch.arange(C * N, dtype=torch.int32,
                              device=parent.device).reshape(C, N)
        valid[:] = True
    elif edge == "shared":
        # most features of cameras 1 and 2 on one root each: the ray table
        # keeps the largest index of each camera
        parent[1, ::2] = 3
        parent[2, 1::3] = 3
        parent[2, ::3] = N + 7
        valid[0, 3] = valid[1, 7] = True
    elif edge == "ties":
        # one priority level: roots of one ray count tie across slices
        response[:] = 0.5
    else:
        raise ValueError(edge)
    return parent, valid, response, desc


GROUP_EDGES = ("invalid", "roots", "shared", "ties")


@pytest.mark.gpu
@pytest.mark.parametrize("C,N,edge", _shapes_and(GROUP_EDGES, 3, 333))
def test_intra_groups_matches_plain(cuda, C, N, edge):
    args = _groups_inputs(C * 1000 + N, C, N, cuda)
    if edge is not None:
        args = _groups_edge(edge, args)
    for max_out in (2048, max(1, C * N // 2)):
        _kernel_vs_plain("intra_groups", (*args, max_out))


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(4, 768)] + EDGE_SHAPES)
def test_tri_gather_matches_plain(cuda, C, N):
    _kernel_vs_plain("tri_gather", _tri_inputs(C * 1000 + N, C, N, 2048,
                                               cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("C,M", cs.TRI_EDGES + ((4, 2048),))
def test_tri_gather_odd_shapes_match_plain(cuda, C, M):
    """The lane-per-ray kernel at group counts that are no multiple of a
    block's or a warp's groups, at C that does not divide 32 (groups of a
    warp ending short of its last lanes) and above 32 (a group per warp,
    two rounds of lanes), with groups of no ray, one ray and every ray."""
    _kernel_vs_plain("tri_gather", cs.tri_gather_problem(
        np.random.RandomState(M * 100 + C), C, 97, M, cuda))


@pytest.mark.gpu
def test_intra_match_on_the_card_matches_the_cpu(cuda):
    """The three launches of intra_match and the stage after it on the
    card against the CPU's plain versions on the bench-shaped scene."""
    C, N = 4, 768
    desc, xy, valid, response = _scene(50, C, N)
    sig = (1.2 ** np.random.RandomState(50).randint(0, 4, (C, N))).astype(
        np.float32)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        rig = _rig(C, dev)
        xy_t = torch.from_numpy(xy).to(dev)
        g = intra.intra_match(hamming.desc_to_torch(desc, dev), xy_t,
                              torch.from_numpy(valid).to(dev),
                              torch.from_numpy(response).to(dev), rig)
        tri = frame._triangulate_stage(g, xy_t, torch.from_numpy(sig).to(dev),
                                       rig, 0.5, 40.0)
        outs.append([x.cpu() for x in (*g, *tri[1:])])
    for k, (a, b) in enumerate(zip(*outs)):
        assert torch.equal(a, b), k


@pytest.mark.gpu
def test_kernels_in_a_graph_match_plain(cuda):
    """The three launches captured in one CUDA graph: each of four replays
    equals the plain versions, also on new inputs copied into the captured
    ones (and back)."""
    C, N = 4, 768

    def inputs(seed):
        return (*_gate_inputs(seed, C, N, cuda)[:1],
                *_groups_inputs(seed, C, N, cuda),
                _tri_inputs(seed, C, N, 2048, cuda)[3])

    rig = _rig(C, cuda)
    pc = intra.pair_constants(rig)

    def step(xy, parent, valid, response, desc, sigma2):
        gate = intra_cuda.intra_gate(xy, rig.fxycxy, pc.E, pc.thr2)
        groups = intra_cuda.intra_groups(parent, valid, response, desc, 2048)
        tri = intra_cuda.tri_gather(groups[0], groups[2], xy, sigma2)
        return (gate, *groups, *tri)

    def plain(xy, parent, valid, response, desc, sigma2):
        gate = intra_cuda.intra_gate_reference(xy, rig.fxycxy, pc.E, pc.thr2)
        groups = intra_cuda.intra_groups_reference(parent, valid, response,
                                                   desc, 2048)
        tri = intra_cuda.tri_gather_reference(groups[0], groups[2], xy,
                                              sigma2)
        return (gate, *groups, *tri)

    static = inputs(60)
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        step(*static)
    torch.cuda.current_stream(cuda).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step(*static)
    for seed in (60, 61, 62, 60):
        new = inputs(seed)
        for x, y in zip(static, new):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(out, plain(*new))):
            assert torch.equal(a, b), (seed, k)
