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

`gpu` cases (they skip without a card) hold each kernel to its plain
version on the card with torch.equal at the frame's shape (C = 4, N =
768, max_out 2048), at C = 2, 3, 5 x N = 1, 33, 129, 1000 and through
two replays of a captured CUDA graph:
    python -m pytest --noconftest tests/test_torch_intra_glue.py -m gpu -q
(this file imports JAX only inside its CPU comparisons)."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import frame, intra, intra_cuda
from mcslam_tpu_torch.geometry import lie
from mcslam_tpu_torch.ops import hamming
from test_torch_intra_kernel import _rig, _scene

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


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(4, 768)] + EDGE_SHAPES)
def test_intra_gate_matches_plain(cuda, C, N):
    _kernel_vs_plain("intra_gate", _gate_inputs(C * 1000 + N, C, N, cuda))


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(4, 768)] + EDGE_SHAPES)
def test_intra_groups_matches_plain(cuda, C, N):
    args = _groups_inputs(C * 1000 + N, C, N, cuda)
    for max_out in (2048, max(1, C * N // 2)):
        _kernel_vs_plain("intra_groups", (*args, max_out))


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(4, 768)] + EDGE_SHAPES)
def test_tri_gather_matches_plain(cuda, C, N):
    _kernel_vs_plain("tri_gather", _tri_inputs(C * 1000 + N, C, N, 2048,
                                               cuda))


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
    """The three launches captured in one CUDA graph: each of two replays
    equals the plain versions, also on new inputs copied into the captured
    ones."""
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
    for seed in (60, 61):
        new = inputs(seed)
        for x, y in zip(static, new):
            x.copy_(y)
        graph.replay()
        torch.cuda.synchronize()
        for k, (a, b) in enumerate(zip(out, plain(*new))):
            assert torch.equal(a, b), (seed, k)
