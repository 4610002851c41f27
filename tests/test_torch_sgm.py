"""The SGM scan of the port's disparity (ops/sgm_cuda, csrc/sgm_scan.cu).

On the CPU: ops/stereo.sgm_aggregate takes the plain version
(sgm_aggregate_reference) for a CPU volume without building or launching
anything, and equals the JAX package's jitted sgm_aggregate within
tests/test_torch_stereo.py's tolerance (1e-5 relative); a numpy model of
the kernel's order of work (one recursion per path and line, each path's
volume apart, then ((a + b) + c) + d) equals the plain version bit for
bit, at odd shapes and at each disparity count the kernel's register
slots take (D <= 32, 64, 96, 128); a non-floating, empty or not 3-d
volume raises, while a float64 volume or one with D > 128, which the
kernel does not take, computes on the CPU.

`gpu` cases (they skip without a card) hold the kernel to the plain
version with torch.equal at VGA with D = 64 and at D = 48, 37 x 53, on
uniform and on quantized (tied) costs, with one launch counted per call,
and a strided, float64 or D = 129 volume refused:
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
    return cv


def _kernel_model(cv, p1=0.03, p2=0.2):
    """The kernel's work in numpy float32: paths +x, -x, +y, -y, each a
    recursion over its lines with the 1e9 border, written to its own
    volume, then summed ((a + b) + c) + d."""
    p1, p2 = np.float32(p1), np.float32(p2)
    vols = []
    for path in range(4):
        horizontal, forward = path < 2, path % 2 == 0
        seq = cv.transpose(2, 0, 1) if horizontal else cv.transpose(1, 0, 2)
        if not forward:
            seq = seq[::-1]
        res = np.empty_like(seq)
        prev = res[0] = seq[0]
        for s in range(1, seq.shape[0]):
            m = prev.min(axis=0)
            up = np.concatenate([prev[1:], np.full_like(prev[:1], BIG)])
            dn = np.concatenate([np.full_like(prev[:1], BIG), prev[:-1]])
            best = np.minimum(np.minimum(prev, m + p2),
                              np.minimum(up, dn) + p1)
            prev = res[s] = (seq[s] + best) - m
        if not forward:
            res = res[::-1]
        vols.append(res.transpose(1, 2, 0) if horizontal
                    else res.transpose(1, 0, 2))
    return ((vols[0] + vols[1]) + vols[2]) + vols[3]


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


@pytest.mark.parametrize("shape,kind", [
    ((48, 37, 53), "uniform"), ((48, 37, 53), "quantized"),
    ((20, 9, 11), "uniform"), ((64, 12, 17), "quantized"),
    ((96, 7, 6), "uniform"), ((128, 5, 8), "uniform"), ((5, 1, 7), "uniform"),
    ((3, 6, 1), "uniform")])
def test_kernel_order_equals_the_plain_version(shape, kind):
    cv = _volume(*shape, kind)
    want = sgm_cuda.sgm_aggregate_reference(torch.from_numpy(cv)).numpy()
    assert np.array_equal(_kernel_model(cv), want)


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
@pytest.mark.parametrize("shape", [(64, 480, 640), (48, 37, 53)],
                         ids=["vga_d64", "d48_37x53"])
@pytest.mark.parametrize("kind", ["uniform", "quantized"])
def test_kernel_equals_the_plain_version(cuda, shape, kind):
    cv = torch.from_numpy(_volume(*shape, kind)).to(cuda)
    before = _build.LAUNCHES["sgm_scan"]
    out = sgm_cuda.sgm_aggregate(cv)
    again = stereo.sgm_aggregate(cv)
    plain = sgm_cuda.sgm_aggregate_reference(cv)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["sgm_scan"] - before == 2
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
