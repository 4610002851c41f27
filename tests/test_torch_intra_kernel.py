"""The intra_pairs kernel of the port's intra-rig match
(frontend/intra_cuda, csrc/intra_match.cu).

On the CPU: frontend/intra_cuda.intra_pairs takes the plain version
(intra_pairs_reference) for CPU tensors without a launch and refuses
what it cannot take; the plain version gives the parent table of the
pair loop intra_match ran before the kernel (kept below as a copy), and
intra_match on it equals the JAX package's intra_match (ray_idx, desc,
valid, exactly) at C = 2, 3 and 4 cameras and N = 96 features. The
scenes, made with numpy from a seed, hold landmarks seen by several
cameras, exact duplicates of a feature (ties in a row's best and in a
column's argmin), pairs at exactly max_dist, masked rows, masked columns
and a column that the Sampson gate masks in every pair.

`gpu` cases (they skip without a card) hold the kernel's parent table to
the plain version's with torch.equal on the card, on those scenes, at C
= 5, at the bench frame's C = 4 x N = 768 and on random gates over a few
distinct descriptors (ties everywhere), equal across two runs and one
launch counted per call:
    python -m pytest --noconftest tests/test_torch_intra_kernel.py -m gpu -q
(this file imports JAX only inside the JAX comparison)."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.data import synthetic
from mcslam_tpu_torch.frontend import intra, intra_cuda
from mcslam_tpu_torch.ops import hamming, match
from mcslam_tpu_torch.utils import graphs

MAX_DIST, RATIO, SAMPSON_PX = 60, 0.85, 3.0


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _flip(rng, words, k):
    """Flip k distinct bits of one (8,) uint32 descriptor."""
    out = words.copy()
    for b in rng.choice(256, k, replace=False):
        out[b // 32] ^= np.uint32(1 << (b % 32))
    return out


def _scene(seed, C, N):
    """Features of C cameras of the synthetic rig (0.12 m along x, f =
    400, VGA): (desc (C, N, 8) uint32, xy (C, N, 2) f32, valid (C, N)
    bool, response (C, N) f32) as numpy."""
    rng = np.random.RandomState(seed)
    L = int(0.6 * N)
    P = np.stack([rng.uniform(-2, 2, L), rng.uniform(-1.5, 1.5, L),
                  rng.uniform(3, 8, L)], 1)
    base = rng.randint(0, 2**32, (L, 8), dtype=np.uint64).astype(np.uint32)
    kind = rng.randint(0, 8, L)  # 0: cam 0 exact, the others at max_dist
    desc = rng.randint(0, 2**32, (C, N, 8), dtype=np.uint64).astype(np.uint32)
    xy = np.stack([rng.uniform(0, 640, (C, N)), rng.uniform(0, 480, (C, N))],
                  -1)
    for c in range(C):
        slots = rng.permutation(N)
        for lm in range(L):
            if rng.rand() > 0.85:
                continue
            s = slots[lm]
            k = (0 if c == 0 else MAX_DIST) if kind[lm] == 0 \
                else rng.randint(0, 25)
            desc[c, s] = _flip(rng, base[lm], k)
            x = P[lm, 0] + 0.12 * c
            xy[c, s] = [400 * x / P[lm, 2] + 320, 400 * P[lm, 1] / P[lm, 2]
                        + 240]
        # exact duplicates of a feature (desc and pixel) in other slots
        for _ in range(3):
            a, b = rng.choice(N, 2, replace=False)
            desc[c, b] = desc[c, a]
            xy[c, b] = xy[c, a]
    xy = (xy + rng.normal(0, 0.3, xy.shape)).astype(np.float32)
    xy[:, -1, 1] = -400.0  # far off every epipolar line: a gated column
    valid = rng.rand(C, N) < 0.9
    response = rng.permutation(C * N).reshape(C, N).astype(np.float32) * 1e-3
    return desc, xy, valid, response


def _rig(C, device):
    return synthetic.make_synthetic_rig(
        synthetic.SyntheticRigSpec(num_cams=C), device=device)


def _inputs(scene, rig, dev):
    """The port's desc, valid and the Sampson gate of every pair."""
    desc, xy, valid, _ = scene
    C = desc.shape[0]
    d = hamming.desc_to_torch(desc, dev)
    xy_t = torch.from_numpy(xy).to(dev)
    f = rig.fxycxy[:, None, :]
    xn = (xy_t - f[..., 2:]) / f[..., :2]
    thr_n = SAMPSON_PX / torch.mean(rig.fxycxy[:, 0])
    pair_i, pair_j = intra_cuda.camera_pairs(C)
    E = torch.stack([intra.pair_essential(rig, i, j)
                     for i, j in zip(pair_i, pair_j)])
    pi = torch.tensor(pair_i, device=dev)
    pj = torch.tensor(pair_j, device=dev)
    gate = intra.sampson_gate(xn[pi], xn[pj], E, thr_n)
    return d, torch.from_numpy(valid).to(dev), gate


def _parent_before(desc, valid, gate, max_dist, ratio):
    """The pair loop of intra_match before the kernel, as it was."""
    C, N = desc.shape[:2]
    dev = desc.device
    planes = hamming.to_planes(desc.reshape(C * N, 8)).reshape(C, N, -1)
    flat_self = torch.arange(C * N, dtype=torch.int32, device=dev).reshape(C, N)
    pair_i = [i for i in range(C - 1) for _ in range(i + 1, C)]
    pair_j = [j for i in range(C - 1) for j in range(i + 1, C)]
    pi = graphs.values(tuple(pair_i), torch.int64, dev)
    pj = graphs.values(tuple(pair_j), torch.int64, dev)
    d = hamming.hamming_from_planes(planes.index_select(0, pi),
                                    planes.index_select(0, pj))
    cands = []
    for p, (i, j) in enumerate(zip(pair_i, pair_j)):
        res = match.match_mutual(
            d[p], row_mask=valid[i], col_mask=valid[j],
            max_dist=max_dist, ratio=ratio, pair_mask=gate[p],
        )
        eq = res.ok[:, None] & (
            res.idx[:, None] == torch.arange(N, device=dev)[None, :])
        row = torch.argmax(eq.to(torch.uint8), dim=0)
        cands.append(torch.where(
            torch.any(eq, dim=0), flat_self[i][row],
            torch.full_like(flat_self[i], C * N)))
    rows = [flat_self[0]]
    for j in range(1, C):
        sel = [p for p in range(len(pair_i)) if pair_j[p] == j]
        best = cands[sel[0]]
        for p in sel[1:]:
            best = torch.minimum(best, cands[p])
        rows.append(torch.where(best < flat_self[j], best, flat_self[j]))
    return torch.stack(rows)


@pytest.mark.parametrize("C", [2, 3, 4])
def test_reference_gives_the_parent_table_of_the_pair_loop(C):
    before = dict(_build.LAUNCHES)
    scene = _scene(C, C, 96)
    d, valid, gate = _inputs(scene, _rig(C, "cpu"), "cpu")
    want = _parent_before(d, valid, gate, MAX_DIST, RATIO)
    got = intra_cuda.intra_pairs(d, valid, gate, MAX_DIST, RATIO)
    assert torch.equal(intra_cuda.intra_pairs_reference(
        d, valid, gate, MAX_DIST, RATIO), want)
    assert torch.equal(got, want) and got.dtype == torch.int32
    # the scene links features across cameras, and not everything
    linked = int((want != torch.arange(C * 96).reshape(C, 96)).sum())
    assert 10 < linked < C * 96 // 2
    assert dict(_build.LAUNCHES) == before


def test_wrapper_refuses_what_it_cannot_take():
    d, valid, gate = _inputs(_scene(0, 3, 32), _rig(3, "cpu"), "cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        intra_cuda.intra_pairs(d.to("meta"), valid.to("meta"),
                               gate.to("meta"))
    with pytest.raises(ValueError, match="must be"):
        intra_cuda.intra_pairs(d, valid, gate[:2])
    with pytest.raises(ValueError, match=r"\(C, N, 8\)"):
        intra_cuda.intra_pairs(d[..., :4], valid, gate)


@pytest.mark.parametrize("C", [2, 3, 4])
def test_intra_match_matches_jax(C):
    import jax
    import jax.numpy as jnp
    from mcslam_tpu.data import synthetic as jsyn
    from mcslam_tpu.frontend import intra as jintra

    desc, xy, valid, response = _scene(C, C, 96)
    jrig = jsyn.make_synthetic_rig(jsyn.SyntheticRigSpec(num_cams=C))
    kw = dict(max_out=160, max_dist=MAX_DIST, ratio=RATIO,
              sampson_px=SAMPSON_PX)
    run = jax.jit(lambda *a: jintra.intra_match(*a, jrig, **kw))
    gj = run(jnp.asarray(desc), jnp.asarray(xy), jnp.asarray(valid),
             jnp.asarray(response))
    gt = intra.intra_match(hamming.desc_to_torch(desc, "cpu"),
                           torch.from_numpy(xy), torch.from_numpy(valid),
                           torch.from_numpy(response), _rig(C, "cpu"), **kw)
    np.testing.assert_array_equal(gt.ray_idx.numpy(), np.asarray(gj.ray_idx))
    np.testing.assert_array_equal(hamming.desc_to_numpy_u32(gt.desc),
                                  np.asarray(gj.desc))
    np.testing.assert_array_equal(gt.valid.numpy(), np.asarray(gj.valid))
    # groups of two rays and more were found
    assert int((np.asarray(gj.ray_idx) >= 0).sum(1).max()) >= 2


def _random_gate_inputs(seed, C, N, dev):
    """A few distinct descriptors (ties in every row and column), random
    validity and a random gate."""
    g = np.random.RandomState(seed)
    words = g.randint(0, 2**32, (6, 8), dtype=np.uint64).astype(np.uint32)
    desc = words[g.randint(0, 6, (C, N))]
    desc[..., 0] ^= g.randint(0, 4, (C, N)).astype(np.uint32)
    P = C * (C - 1) // 2
    return (hamming.desc_to_torch(desc, dev),
            torch.from_numpy(g.rand(C, N) < 0.9).to(dev),
            torch.from_numpy(g.rand(P, N, N) < 0.5).to(dev))


def _kernel_vs_plain(d, valid, gate, max_dist=MAX_DIST, ratio=RATIO):
    ref = intra_cuda.intra_pairs_reference(d, valid, gate, max_dist, ratio)
    before = _build.LAUNCHES["intra_pairs"]
    runs = [intra_cuda.intra_pairs(d, valid, gate, max_dist, ratio)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert _build.LAUNCHES["intra_pairs"] == before + 2
    for got in runs:
        assert torch.equal(got, ref), int((got != ref).sum())


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(2, 96), (3, 96), (4, 96), (5, 96),
                                 (4, 768), (3, 1000)])
def test_kernel_matches_plain_on_scenes(cuda, C, N):
    d, valid, gate = _inputs(_scene(C + N, C, N), _rig(C, cuda), cuda)
    _kernel_vs_plain(d, valid, gate)


@pytest.mark.gpu
@pytest.mark.parametrize("C,N", [(2, 33), (4, 768), (5, 200)])
def test_kernel_matches_plain_on_random_gates(cuda, C, N):
    d, valid, gate = _random_gate_inputs(C * N, C, N, cuda)
    _kernel_vs_plain(d, valid, gate)
    _kernel_vs_plain(d, valid, gate, max_dist=2, ratio=1.0)
