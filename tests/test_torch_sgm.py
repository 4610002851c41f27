"""The SGM scan of the port's disparity (ops/sgm_cuda, csrc/sgm_scan.cu).

On the CPU: ops/stereo.sgm_aggregate takes the plain version
(sgm_aggregate_reference) for a CPU volume without building or launching
anything, and equals the JAX package's jitted sgm_aggregate within
tests/test_torch_stereo.py's tolerance (1e-5 relative); a numpy model of
the kernel's order of work (tiles of 8 steps; each path cut at its middle
tile, the first part's front carried into the second; the three launches'
sums: a and b, then b + a / a + b, then (ab + c) + d with c or d from the
scratch volume) equals the plain version bit for bit, at shapes that cross
the tiles' edges (H and W one above and one below a multiple of 8, W < 8,
H = 1, W = 1, W % 4 != 0) and at each disparity count the kernel's
register slots take (D = 1, 33, 64, 96, 128), and NaN-aware on a volume
with NaNs (the same NaN positions, equal bits elsewhere); a non-floating,
empty or not 3-d volume raises, while a float64 volume or one with D >
128, which the kernel does not take, computes on the CPU.

`gpu` cases (they skip without a card) hold the kernel to the plain
version with torch.equal at VGA with D = 64 and at those edge shapes, on
uniform and on quantized (tied) costs, NaN-aware on the volume with NaNs,
with one launch counted per call, and a strided, float64 or D = 129
volume refused:
    python -m pytest --noconftest tests/test_torch_sgm.py -m gpu -q
(this file imports JAX only inside the JAX comparison)."""

import numpy as np
import pytest
import torch

from mcslam_tpu_torch import _build
from mcslam_tpu_torch.data import synthetic as tsyn
from mcslam_tpu_torch.ops import sgm_cuda, stereo

BIG = np.float32(1e9)


def _volume(D, H, W, kind="uniform", seed=0):
    rng = np.random.default_rng(seed)
    cv = rng.random((D, H, W), dtype=np.float32)
    if kind == "quantized":  # many equal costs: ties in every minimum
        cv = np.round(cv * 8.0).astype(np.float32) / np.float32(8.0)
    elif kind == "nan":  # a NaN in a few cells: it wins every minimum after
        cv.reshape(-1)[rng.choice(cv.size, 3, replace=False)] = np.nan
    return cv


STEPS = 8  # steps per tile of the kernel (csrc/sgm_scan.cu STEPS)


def _scan(seq, steps, prev, p1, p2):
    """The recursion over seq (S, D, N) at `steps`, in order, from the
    front prev (None: steps[0] starts the lines, its value the cost):
    {step: values (D, N)} and the last front."""
    res = {}
    for s in steps:
        if prev is None:
            prev = seq[s].copy()
        else:
            m = prev.min(axis=0)
            up = np.concatenate([prev[1:], np.full_like(prev[:1], BIG)])
            dn = np.concatenate([np.full_like(prev[:1], BIG), prev[:-1]])
            best = np.minimum(np.minimum(prev, m + p2),
                              np.minimum(up, dn) + p1)
            prev = (seq[s] + best) - m
        res[s] = prev
    return res, prev


def _kernel_model(cv, p1=0.03, p2=0.2):
    """The kernel's work in numpy float32, launch by launch. A path's S
    steps make n = ceil(S / STEPS) tiles, cut at h = n // 2: +x / +y run
    tiles [0, h) then [h, n), -x / -y tiles [h, n) then [0, h) backwards,
    the second part from the first's front. Launch 1 writes a and b into
    out and c and d into scratch; launch 2 out = out + (a or b); launch
    3 out = (out + c) + scratch's d below the cut, (out + scratch's c) + d
    above it."""
    p1, p2 = np.float32(p1), np.float32(p2)
    out, scratch = np.empty_like(cv), np.empty_like(cv)
    parts = {}
    for horizontal in (True, False):
        seq = cv.transpose(2, 0, 1) if horizontal else cv.transpose(1, 0, 2)
        S = seq.shape[0]
        n = -(-S // STEPS)
        cut = min((n // 2) * STEPS, S)
        lo, hi = list(range(cut)), list(range(cut, S))
        fwd1, front_f = _scan(seq, lo, None, p1, p2)
        bwd1, front_b = _scan(seq, hi[::-1], None, p1, p2)
        fwd2, _ = _scan(seq, hi, front_f if lo else None, p1, p2)
        bwd2, _ = _scan(seq, lo[::-1], front_b, p1, p2)
        parts[horizontal] = (fwd1, bwd1, fwd2, bwd2)

    def at(vol, horizontal, s):  # the (D, N) slab of step s of a path
        return vol[:, :, s] if horizontal else vol[:, s, :]

    fwd1, bwd1, fwd2, bwd2 = parts[True]
    for s, v in {**fwd1, **bwd1}.items():  # launch 1: a and b
        at(out, True, s)[...] = v
    fwd1, bwd1, _, _ = parts[False]
    for s, v in {**fwd1, **bwd1}.items():  # launch 1: c and d
        at(scratch, False, s)[...] = v
    _, _, fwd2, bwd2 = parts[True]
    for s, v in {**fwd2, **bwd2}.items():  # launch 2: b + a, a + b
        at(out, True, s)[...] = at(out, True, s) + v
    _, _, fwd2, bwd2 = parts[False]
    for s, v in fwd2.items():  # launch 3: (ab + c) + d
        at(out, False, s)[...] = (at(out, False, s) + v) + at(scratch, False, s)
    for s, v in bwd2.items():
        at(out, False, s)[...] = (at(out, False, s) + at(scratch, False, s)) + v
    return out


def _same(a, b):
    """Bit-equal, NaN-aware: the same NaN positions, equal values
    elsewhere."""
    a, b = np.asarray(a), np.asarray(b)
    na, nb = np.isnan(a), np.isnan(b)
    return bool(np.array_equal(na, nb) and np.array_equal(a[~na], b[~nb]))


def _blob_volume(D=24):
    """The cost volume of a blob pair at 160x120 (the stereo tests')."""
    rig = tsyn.make_synthetic_rig(tsyn.SyntheticRigSpec(
        num_cams=2, image_size=(160, 120), focal=130.0), device="cpu")
    poses = tsyn.smooth_trajectory(1)
    lms = tsyn.make_landmarks(400, seed=1, depth_range=(3.0, 8.0),
                              spread=(3.0, 2.0))
    imgs = tsyn.render_blob_images(rig, poses, lms, seed=2)[0]
    return stereo.cost_volume(torch.from_numpy(imgs[0]),
                              torch.from_numpy(imgs[1]), D)


def test_cpu_takes_the_plain_version(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU volume built or launched the kernel")

    monkeypatch.setattr(_build, "library", no_build)
    before = dict(_build.LAUNCHES)
    cv = _blob_volume()
    out = stereo.sgm_aggregate(cv)
    assert torch.equal(out, sgm_cuda.sgm_aggregate_reference(cv))
    assert dict(_build.LAUNCHES) == before


def test_matches_jax():
    import jax
    import jax.numpy as jnp

    from mcslam_tpu.ops import stereo as jstereo

    cv = _blob_volume()
    a = np.asarray(jax.jit(jstereo.sgm_aggregate)(jnp.asarray(cv.numpy())))
    b = stereo.sgm_aggregate(cv).numpy()
    np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)


# shapes that cross the kernel's tiles (8 lines x 8 steps) and register
# slots (D <= 32, 64, 96, 128): H and W one above and one below a multiple
# of 8, W < 8, H = 1, W = 1, W % 4 != 0, D = 1, 33 and 128
EDGE_SHAPES = [(16, 17, 23), (16, 15, 25), (8, 9, 5), (6, 1, 19),
               (6, 21, 1), (1, 9, 10), (33, 10, 12), (128, 9, 9),
               (20, 11, 13), (24, 8, 16)]


@pytest.mark.parametrize("shape,kind", [
    ((48, 37, 53), "uniform"), ((48, 37, 53), "quantized"),
    ((20, 9, 11), "uniform"), ((64, 12, 17), "quantized"),
    ((96, 7, 6), "uniform"), ((128, 5, 8), "uniform"), ((5, 1, 7), "uniform"),
    ((3, 6, 1), "uniform")]
    + [(shape, "uniform") for shape in EDGE_SHAPES]
    + [((33, 10, 12), "quantized"), ((16, 17, 23), "nan"),
       ((48, 37, 53), "nan")])
def test_kernel_order_equals_the_plain_version(shape, kind):
    cv = _volume(*shape, kind)
    want = sgm_cuda.sgm_aggregate_reference(torch.from_numpy(cv)).numpy()
    got = _kernel_model(cv)
    if kind == "nan":
        assert np.isnan(want).any() and not np.isnan(want).all()
        assert _same(got, want)
    else:
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cv", [
    torch.zeros(4, 5, 6, dtype=torch.int32), torch.zeros(5, 6),
    torch.zeros(0, 5, 6), torch.zeros(4, 5, 0), torch.zeros(1, 4, 5, 6)],
    ids=["int32", "2d", "d0", "w0", "4d"])
def test_bad_input_raises(cv):
    with pytest.raises(ValueError):
        stereo.sgm_aggregate(cv)


@pytest.mark.parametrize("shape,dtype", [
    ((6, 5, 7), torch.float64), ((129, 3, 4), torch.float32)],
    ids=["float64", "d129"])
def test_cpu_takes_what_the_kernel_does_not(shape, dtype):
    """The kernel's limits (float32, D <= 128) do not hold on the CPU: the
    plain version computes there, in the volume's dtype, and equals the
    float32 model of the kernel's order within float32 rounding."""
    cv = torch.from_numpy(_volume(*shape)).to(dtype)
    out = stereo.sgm_aggregate(cv)
    assert out.dtype == dtype and out.shape == cv.shape
    assert torch.equal(out, sgm_cuda.sgm_aggregate_reference(cv))
    want = _kernel_model(_volume(*shape))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


# -- on the card --------------------------------------------------------------

@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the SGM kernel against its plain "
                    "version)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 480, 640), (48, 37, 53)]
                         + EDGE_SHAPES + [(128, 64, 96), (33, 72, 128)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("kind", ["uniform", "quantized", "nan"])
def test_kernel_equals_the_plain_version(cuda, shape, kind):
    cv = torch.from_numpy(_volume(*shape, kind)).to(cuda)
    before = _build.LAUNCHES["sgm_scan"]
    out = sgm_cuda.sgm_aggregate(cv)
    again = stereo.sgm_aggregate(cv)
    plain = sgm_cuda.sgm_aggregate_reference(cv)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sgm_scan"] - before == 2
    if kind == "nan":
        assert _same(out.cpu(), plain.cpu()) and _same(again.cpu(), out.cpu())
    else:
        assert torch.equal(out, plain) and torch.equal(again, out)


@pytest.mark.gpu
@pytest.mark.parametrize("what", ["strided", "float64", "d129"])
def test_kernel_refuses_a_strided_volume(cuda, what):
    """...and a float64 one or one with D > 128, which the CPU takes."""
    cv = {"strided": lambda: torch.from_numpy(_volume(37, 53, 48)).to(
              cuda).permute(2, 0, 1),
          "float64": lambda: torch.zeros(4, 5, 6, dtype=torch.float64,
                                         device=cuda),
          "d129": lambda: torch.zeros(129, 3, 4, device=cuda)}[what]()
    before = _build.LAUNCHES["sgm_scan"]
    with pytest.raises(ValueError):
        sgm_cuda.sgm_aggregate(cv)
    assert _build.LAUNCHES["sgm_scan"] == before
