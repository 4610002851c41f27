"""The VIO window's factor linearization (backend/vio_cuda: csrc/vio_factors.cu
with the residuals on forward-mode duals in csrc/vio_dual.cuh).

On the CPU:
- (a) the plain version, vio_factors_reference, on the port's vision block
  against the JAX package's _assemble_vio (kf-blocked) on the same numpy
  inputs, K = 4 (3 IMU factors, one slot padded; 3 GPS factors, 2 valid;
  1 between factor): H and g within 1e-5 of their largest magnitude and
  the cost within 1e-4 relative (tests/test_torch_vio.py's bounds between
  the two packages: the port's Jacobians come from jacfwd in float64, the
  JAX package's in float32);
- (b) the wrapper on CPU tensors takes the plain version bit for bit and
  launches nothing;
- (c) a table of padded or invalid factors adds exactly 0, and an absent
  table gives the bits of a table of invalid factors;
- (d) where g++ is on PATH, csrc/vio_dual.cuh built as host C++ (ctypes,
  no torch headers) against torch.func.jacfwd of the port's residuals in
  float64, on random states and on states at the branches the kernel
  must take as torch.where does (so3_log's small branch at the truth, its
  near-pi branch, both at once at pi): r and J within 1e-12 of the
  largest magnitude of J (the residual at the truth is a difference of
  terms of the Jacobian's magnitude); its float64 operation counts,
  which chip_smoke.VIO_DUAL_OPS holds for the kernel's bound, and its
  critical path (depth, long-latency operations), chip_smoke.VIO_DUAL_DEPTH.
`gpu` cases (they skip without a card) hold the kernel to the plain
version on the card under chip_smoke.check_vio_factors' criteria, also
with a factor joining a keyframe to itself and with indices outside the
window:
    python -m pytest --noconftest tests/test_torch_vio_kernels.py -m gpu -q
(this file imports JAX only inside the JAX comparison).
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke as cs
from mcslam_tpu_torch import _build
from mcslam_tpu_torch.backend import ba, ba_vio, vio_cuda
from mcslam_tpu_torch.backend import imu as timu
from mcslam_tpu_torch.geometry import lie

D = ba_vio.D
PARAMS = dict(accel_noise=2e-3, gyro_noise=2e-4)
DUAL_REL = 1e-12


@pytest.fixture
def cuda():
    """The CUDA device; tests needing it skip where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel against its plain version)")
    return torch.device("cuda", 0)


def _se3(rng, rot, trans):
    xi = np.concatenate([rng.randn(3) * rot, rng.randn(3) * trans])
    return lie.se3_exp(torch.from_numpy(xi)).float().numpy()


def _samples(rng, S=20):
    dts = rng.uniform(0.003, 0.007, S).astype(np.float32)
    gyro = (rng.randn(S, 3) * 0.3).astype(np.float32)
    acc = (rng.randn(S, 3) * 0.5 + [0, 0, 9.81]).astype(np.float32)
    mask = np.ones(S, bool)
    mask[rng.choice(S, 2, replace=False)] = False
    bh = (rng.randn(6) * 0.01).astype(np.float32)
    return dts, gyro, acc, mask, bh


def _scene(seed=0):
    """tests/test_torch_vio.py's K = 4 scene (L = 32, C = 2, Ok = 16;
    random poses and validity), 3 IMU factors of random samples and a
    nonzero bias_hat (one padded slot), 3 GPS factors (2 valid) with a
    lever arm, 1 between factor, random E_T_V, velocities, biases and a
    diagonal prior -> (the problem's numpy fields, the IMU samples per
    pair)."""
    rng = np.random.RandomState(seed)
    K, L, C, Ok = 4, 32, 2, 16
    O = K * Ok
    poses = np.stack([_se3(rng, 0.05, 0.3) for _ in range(K)])
    lms = (rng.uniform(-3, 3, (L, 3)) + [0, 0, 8]).astype(np.float32)
    fxycxy = np.tile(np.array([[400., 400., 320., 240.]], np.float32), (C, 1))
    ctb = np.tile(np.eye(4, dtype=np.float32), (C, 1, 1))
    ctb[1, 0, 3] = -0.2
    obs = dict(kf=np.repeat(np.arange(K, dtype=np.int32), Ok),
               cam=rng.randint(0, C, O).astype(np.int32),
               lm=rng.randint(0, L, O).astype(np.int32),
               uv=rng.uniform(0, 640, (O, 2)).astype(np.float32),
               sigma2=np.ones(O, np.float32), valid=rng.rand(O) > 0.2)
    samples = [_samples(rng) for _ in range(3)]
    gps = dict(kf=np.array([0, 2, 3], np.int32),
               enu=(poses[[0, 2, 3], :3, 3] + rng.randn(3, 3) * 0.3
                    ).astype(np.float32),
               t_bg=np.array([0.1, 0.0, 0.05], np.float32),
               sigma=np.array([0.5, 0.3, 0.5], np.float32),
               valid=np.array([True, True, False]))
    rel = np.linalg.inv(poses[0]) @ poses[3] @ _se3(rng, 0.02, 0.02)
    btw = dict(i=np.array([0], np.int32), j=np.array([3], np.int32),
               rel=rel[None].astype(np.float32),
               sigma_rot=np.array([0.01], np.float32),
               sigma_trans=np.array([0.05], np.float32),
               valid=np.array([True]))
    N = K * D + 6
    state = dict(
        poses=poses.astype(np.float32),
        vels=(rng.randn(K, 3) * 0.5).astype(np.float32),
        biases=(rng.randn(K, 6) * 0.01).astype(np.float32),
        landmarks=lms, lm_valid=np.ones(L, bool), cam_T_body=ctb,
        fxycxy=fxycxy, E_T_V=_se3(rng, 0.1, 0.1),
        prior_H=np.diag(rng.uniform(1.0, 10.0, N)).astype(np.float32),
        prior_b=np.zeros(N, np.float32), kf_valid=np.ones(K, bool))
    return dict(obs=obs, gps=gps, between=btw, state=state), samples


PAIRS = [(0, 1), (1, 2), (2, 3)]


def _port_problem(fields, samples, device="cpu", **tables):
    """The scene as the port's VioProblem on `device`; tables (imu, gps,
    between) may be replaced (None drops one)."""
    p = timu.ImuParams(**PARAMS)
    recs = [timu.preintegrate(*(torch.from_numpy(a) for a in s), p)
            for s in samples]
    imu = ba_vio.make_imu_factors(recs, PAIRS, 4, p, device=device)
    t = dict(imu=imu,
             gps=ba_vio.factor_table(ba_vio.GpsFactors, device,
                                     **fields["gps"]),
             between=ba_vio.factor_table(ba_vio.BetweenFactors, device,
                                         **fields["between"]))
    t.update(tables)
    return ba_vio.problem_from_numpy(
        obs=ba.BAObservations(**fields["obs"]), device=device, **t,
        **fields["state"])


def _vision(problem):
    """The vision block's (Hpp, gp, cost) at the problem's state, by the
    kf-blocked system vio_solve uses."""
    sys_ = ba._blocked_system(ba_vio._vision_problem(problem), 2.5)
    (Hpp, gp, _, _, _), cost, _ = sys_((problem.poses, problem.landmarks),
                                       problem.obs.valid)
    return Hpp, gp, cost


def _state(p):
    return p.poses, p.vels, p.biases, p.E_T_V


def _rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_reference_matches_jax_assembly():
    import jax
    import jax.numpy as jnp

    from mcslam_tpu.backend import ba as jba
    from mcslam_tpu.backend import ba_vio as jvio
    from mcslam_tpu.backend import imu as jimu

    fields, samples = _scene()
    tp = _port_problem(fields, samples)
    H, g, cost = vio_cuda.vio_factors_reference(tp, *_state(tp),
                                                *_vision(tp))
    jp_ = jimu.ImuParams(**PARAMS)
    recs = [jimu.preintegrate(*(jnp.asarray(a) for a in s), jp_)
            for s in samples]
    jp = jvio.VioProblem(
        obs=jba.BAObservations(**{k: jnp.asarray(v)
                                  for k, v in fields["obs"].items()}),
        imu=jvio.make_imu_factors(recs, PAIRS, 4, jp_),
        gps=jvio.GpsFactors(**{k: jnp.asarray(v)
                               for k, v in fields["gps"].items()}),
        between=jvio.BetweenFactors(**{k: jnp.asarray(v) for k, v in
                                       fields["between"].items()}),
        **{k: jnp.asarray(v) for k, v in fields["state"].items()})
    jsys = jax.jit(jvio._assemble_vio, static_argnums=(1, 2))(jp, 2.5, True)
    for name, a, b in (("H", H, jsys[0]), ("g", g, jsys[1])):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b) <= 1e-5, (name, _rel(a.numpy(), b))
    c_t, c_j = float(cost), float(jsys[6])
    assert abs(c_t - c_j) <= 1e-4 * abs(c_j), (c_t, c_j)


def test_wrapper_takes_the_plain_version_on_the_cpu():
    fields, samples = _scene()
    tp = _port_problem(fields, samples)
    vis = _vision(tp)
    before = _build.LAUNCHES.get("vio_factors", 0)
    ref = vio_cuda.vio_factors_reference(tp, *_state(tp), *vis)
    prepared = vio_cuda.VioFactors(tp)
    out = prepared(*_state(tp), *vis)
    again = prepared(*_state(tp), *vis)
    assert _build.LAUNCHES.get("vio_factors", 0) == before
    assert prepared.scratch is None
    for a, b, c in zip(ref, out, again):
        assert torch.equal(a, b) and torch.equal(a, c)
    facs = vio_cuda.factors_reference(tp, *_state(tp))
    assert list(facs) == ["imu", "gps", "between"]
    N = tp.poses.shape[0] * D + 6
    for name, (J, r, w, sel) in facs.items():
        n, R = vio_cuda.SHAPES[name]
        F = getattr(tp, name).valid.shape[0]
        assert J.shape == (F, R, n) and r.shape == (F, R)
        assert w.shape == (F,) and sel.shape == (F, n, N)
        assert J.dtype == r.dtype == torch.float32
    # the solve's linearization is the wrapper's
    s = ba_vio._System(tp, 2.5, True)
    (Hs, gs, *_), cs_, _ = s((tp.poses, tp.vels, tp.biases, tp.landmarks,
                              tp.E_T_V), tp.obs.valid)
    assert torch.equal(Hs, ref[0]) and torch.equal(gs, ref[1])
    assert torch.equal(cs_, ref[2])


def test_padded_factors_add_zero_and_absent_tables_equal_invalid_ones():
    fields, samples = _scene()
    tp = _port_problem(fields, samples)
    # the IMU table's padded slot (i = j = 0, identity deltas, weight 0),
    # and every factor made invalid, add exactly zero
    imu = tp.imu
    assert not bool(imu.valid[3]) and int(imu.i[3]) == int(imu.j[3]) == 0
    for name, table in (("imu", imu), ("gps", tp.gps),
                        ("between", tp.between)):
        off = table._replace(valid=torch.zeros_like(table.valid))
        q = tp._replace(**{name: off})
        k = list(vio_cuda.SHAPES).index(name)
        fac, args = vio_cuda.factors(q, tp.poses.shape[0] * D + 6)[k]
        c_f, H_f, g_f = fac.linearize(*args(*_state(q)))
        assert float(c_f) == 0.0 and not H_f.any() and not g_f.any(), name
        J, r = fac.jacobian(*args(*_state(q)))
        assert torch.isfinite(J).all() and J.abs().max() > 0, name
    # the padded slot alone
    pad = tp._replace(imu=imu._replace(**{f: getattr(imu, f)[3:]
                                          for f in imu._fields}))
    fac, args = vio_cuda.factors(pad, tp.poses.shape[0] * D + 6)[0]
    c_f, H_f, g_f = fac.linearize(*args(*_state(pad)))
    assert float(c_f) == 0.0 and not H_f.any() and not g_f.any()
    # an absent table equals a table of invalid factors, bit for bit
    vis = _vision(tp)
    for name in ("imu", "gps", "between"):
        table = getattr(tp, name)
        off = tp._replace(**{name: table._replace(
            valid=torch.zeros_like(table.valid))})
        gone = tp._replace(**{name: None})
        a = vio_cuda.VioFactors(off)(*_state(tp), *vis)
        b = vio_cuda.VioFactors(gone)(*_state(tp), *vis)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


# ---- (d) csrc/vio_dual.cuh as host C++ against torch.func.jacfwd ----------

HOST_SHIM = r"""
#include <algorithm>
#include <cmath>
#include "vio_dual.cuh"

namespace cnt {
long long ops = 0;  // float64 operations: + - * / sqrt sin cos atan2 sincos
// a float64 value, the longest chain of operations that made it (each
// result one deeper than its deepest input; a constant or an input at 0)
// and the long-latency operations (/ sqrt sin cos atan2 sincos) on that
// chain
struct C {
  double x;
  int dep = 0, lng = 0;
  C() = default;
  C(double v) : x(v) {}
};
inline C deeper(double x, C a, C b, bool slow) {
  ++ops;
  const C& m = a.dep > b.dep || (a.dep == b.dep && a.lng >= b.lng) ? a : b;
  C r(x);
  r.dep = m.dep + 1;
  r.lng = m.lng + slow;
  return r;
}
inline C operator+(C a, C b) { return deeper(a.x + b.x, a, b, false); }
inline C operator-(C a, C b) { return deeper(a.x - b.x, a, b, false); }
inline C operator*(C a, C b) { return deeper(a.x * b.x, a, b, false); }
inline C operator/(C a, C b) { return deeper(a.x / b.x, a, b, true); }
inline C operator-(C a) { a.x = -a.x; return a; }  // a sign: no operation
inline bool operator<(C a, C b) { return a.x < b.x; }
inline bool operator>(C a, C b) { return a.x > b.x; }
inline bool operator<=(C a, C b) { return a.x <= b.x; }
inline bool operator>=(C a, C b) { return a.x >= b.x; }
inline C sqrt(C a) { return deeper(std::sqrt(a.x), a, a, true); }
inline C sin(C a) { return deeper(std::sin(a.x), a, a, true); }
inline C cos(C a) { return deeper(std::cos(a.x), a, a, true); }
inline C atan2(C a, C b) { return deeper(std::atan2(a.x, b.x), a, b, true); }
inline void sincos(C a, C* s, C* c) {
  *s = deeper(std::sin(a.x), a, a, true);
  *c = *s;
  c->x = std::cos(a.x);
}
inline C fabs(C a) { a.x = std::fabs(a.x); return a; }
}  // namespace cnt

// one factor's float32 inputs packed in its Inputs struct's order; out:
// the residual (R) and its derivative along e_dir (R)
template <class S>
void imu(const float* p, double g, int dir, S* out) {
  vio::ImuInputs in;
  const float** f[] = {&in.Ti, &in.vi, &in.bi, &in.Tj, &in.vj, &in.bj,
                       &in.dR, &in.dv, &in.dp, &in.dt, &in.dR_dbg,
                       &in.dv_dbg, &in.dv_dba, &in.dp_dbg, &in.dp_dba,
                       &in.bias_hat, &in.sqrt_info};
  const int size[] = {16, 3, 6, 16, 3, 6, 9, 3, 3, 1, 9, 9, 9, 9, 9, 6, 225};
  for (int k = 0; k < 17; ++k) { *f[k] = p; p += size[k]; }
  vio::Dual<S> r[15];
  vio::imu_residual<S>(in, S(g), dir, r);
  for (int k = 0; k < 15; ++k) { out[k] = r[k].v; out[15 + k] = r[k].d; }
}

template <class S>
void gps(const float* p, double, int dir, S* out) {
  vio::GpsInputs in{p, p + 16, p + 32, p + 35};
  vio::Dual<S> r[3];
  vio::gps_residual<S>(in, dir, r);
  for (int k = 0; k < 3; ++k) { out[k] = r[k].v; out[3 + k] = r[k].d; }
}

template <class S>
void between(const float* p, double, int dir, S* out) {
  vio::BetweenInputs in{p, p + 16, p + 32, p + 48, p + 49};
  vio::Dual<S> r[6];
  vio::between_residual<S>(in, dir, r);
  for (int k = 0; k < 6; ++k) { out[k] = r[k].v; out[6 + k] = r[k].d; }
}

// the count entries return the float64 operations of one direction's
// evaluation and put the deepest output's chain (depth, long-latency
// operations on it) into chain
#define ENTRY(name)                                                        \
  extern "C" void vio_##name(const float* p, double g, int dir,           \
                             double* out) { name<double>(p, g, dir, out); } \
  extern "C" long long vio_##name##_ops(const float* p, double g,         \
                                        int dir, int* chain) {            \
    cnt::C out[30];                                                       \
    cnt::ops = 0;                                                         \
    name<cnt::C>(p, g, dir, out);                                         \
    chain[0] = chain[1] = 0;                                              \
    for (const cnt::C& o : out)                                           \
      if (o.dep > chain[0] || (o.dep == chain[0] && o.lng > chain[1])) {  \
        chain[0] = o.dep;                                                 \
        chain[1] = o.lng;                                                 \
      }                                                                   \
    return cnt::ops;                                                      \
  }
ENTRY(imu)
ENTRY(gps)
ENTRY(between)
"""


@pytest.fixture(scope="module")
def host_dual(tmp_path_factory):
    """csrc/vio_dual.cuh built as host C++ with g++ into a shared library
    (ctypes); skips without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (csrc/vio_dual.cuh as host C++)")
    d = tmp_path_factory.mktemp("vio_dual")
    (d / "shim.cpp").write_text(HOST_SHIM)
    lib = d / "libviodual.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC",
                    "-shared", f"-I{_build.CSRC}", "-o", str(lib),
                    str(d / "shim.cpp")], check=True, capture_output=True)
    so = ctypes.CDLL(str(lib))
    P, Dd, I = ctypes.c_void_p, ctypes.c_double, ctypes.c_int
    for name in vio_cuda.SHAPES:
        getattr(so, f"vio_{name}").argtypes = [P, Dd, I, P]
        getattr(so, f"vio_{name}_ops").argtypes = [P, Dd, I, P]
        getattr(so, f"vio_{name}_ops").restype = ctypes.c_longlong
    return so


def _host(so, name, packed, g_norm=9.81):
    """(r (R,), J (R, n)) float64 of the host build, one call per
    tangent direction; the operations per direction; and the deepest
    chain per direction, (depth, long-latency operations on it)."""
    n, R = vio_cuda.SHAPES[name]
    buf = np.ascontiguousarray(packed, np.float32)
    out = np.zeros(2 * R, np.float64)
    chain = np.zeros(2, np.int32)
    J = np.zeros((R, n))
    ops, chains = [], []
    for t in range(n):
        getattr(so, f"vio_{name}")(buf.ctypes.data, g_norm, t,
                                   out.ctypes.data)
        J[:, t] = out[R:]
        ops.append(getattr(so, f"vio_{name}_ops")(buf.ctypes.data, g_norm,
                                                  t, chain.ctypes.data))
        chains.append(tuple(int(c) for c in chain))
    return out[:R].copy(), J, ops, chains


def _jacfwd(fn, n, args):
    """(r, J) float64 of fn(x, *args) at x = 0 by torch.func.jacfwd, the
    float32 args widened as the plain version widens them."""
    a64 = [torch.as_tensor(a).double() for a in args]

    def f(x):
        r = fn(x, *a64)
        return r, r

    J, r = torch.func.jacfwd(f, has_aux=True)(torch.zeros(n,
                                                          dtype=torch.float64))
    return r.numpy(), J.numpy()


def _imu_case(rng, at_truth):
    """One IMU factor's packed inputs and the residual's arguments: random
    states, or state j predicted from state i (r_dR at so3_log's small
    branch)."""
    s = _samples(rng, 30)
    p = timu.ImuParams(**PARAMS)
    pre = timu.preintegrate(*(torch.from_numpy(a) for a in s), p)
    Ti = torch.from_numpy(_se3(rng, 0.5, 2.0))
    vi = torch.from_numpy((rng.randn(3) * 0.5).astype(np.float32))
    bi = torch.from_numpy((rng.randn(6) * 0.01).astype(np.float32))
    if at_truth:
        nxt = timu.predict(timu.ImuState(Ti, vi, bi), pre, p)
        Tj, vj, bj = nxt.world_T_body, nxt.vel, nxt.bias
    else:
        Tj = torch.from_numpy(_se3(rng, 0.5, 2.0))
        vj = torch.from_numpy((rng.randn(3) * 0.5).astype(np.float32))
        bj = torch.from_numpy((rng.randn(6) * 0.01).astype(np.float32))
    info = timu.information(pre, p).double().numpy()
    sqrt_info = torch.from_numpy(np.linalg.cholesky(
        info + 1e-8 * np.eye(15)).T.astype(np.float32))
    args = [Ti, vi, bi, Tj, vj, bj, pre.dR, pre.dv, pre.dp, pre.dt,
            pre.dR_dbg, pre.dv_dbg, pre.dv_dba, pre.dp_dbg, pre.dp_dba,
            pre.bias_hat, sqrt_info]
    packed = np.concatenate([np.asarray(a, np.float32).ravel() for a in args])
    return packed, args


def _rot(axis, angle):
    a = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    return lie.so3_exp(torch.from_numpy(a * angle)).numpy()


def _between_case(rng, kind):
    """One between factor: rel random, rel = Ti^-1 Tj (so3_log small),
    rel turned by pi - 1e-4 (near pi) or by pi (near pi and small)."""
    Ti = _se3(rng, 0.5, 2.0)
    Tj = _se3(rng, 0.5, 2.0)
    rel = np.linalg.inv(Ti.astype(np.float64)) @ Tj
    if kind == "random":
        rel = rel @ _se3(rng, 0.3, 0.3)
    elif kind != "small":
        turn = np.eye(4)
        turn[:3, :3] = _rot(rng.randn(3),
                            np.pi - (1e-4 if kind == "near_pi" else 0.0))
        rel = rel @ np.linalg.inv(turn)
    rel = rel.astype(np.float32)
    sig = np.array([0.01, 0.05], np.float32)
    packed = np.concatenate([Ti.ravel(), Tj.ravel(), rel.ravel(), sig])
    args = [Ti, Tj, rel, sig[0], sig[1]]
    return packed, args


def _gps_case(rng):
    pose, E = _se3(rng, 0.5, 2.0), _se3(rng, 0.3, 5.0)
    enu = (pose[:3, 3] + rng.randn(3)).astype(np.float32)
    t_bg = np.array([0.1, 0.0, 0.05], np.float32)
    return np.concatenate([pose.ravel(), E.ravel(), enu, t_bg]), \
        [pose, E, enu, t_bg]


def _log_branch(R):
    """(small, near_pi) of so3_log's branches at the rotation R."""
    R = torch.as_tensor(R, dtype=torch.float64)
    w = lie.so3_vee(0.5 * (R - R.T))
    s2 = float(torch.sum(w * w))
    cos = float(torch.clamp((torch.trace(R) - 1.0) * 0.5, -1.0, 1.0))
    sin = 0.0 if s2 < 1e-10 else np.sqrt(s2)
    return s2 < 1e-10, sin < 1e-3 and np.arctan2(sin, cos) > 3.0


def _check_dual(host, ref):
    (r, J, _, _), (r_t, J_t) = host, ref
    scale = max(np.abs(J_t).max(), np.abs(r_t).max())
    assert np.abs(J - J_t).max() <= DUAL_REL * scale, np.abs(J - J_t).max()
    assert np.abs(r - r_t).max() <= DUAL_REL * scale, np.abs(r - r_t).max()


@pytest.mark.parametrize("at_truth", [False, True], ids=["random", "truth"])
def test_host_dual_imu_matches_jacfwd(host_dual, at_truth):
    rng = np.random.RandomState(11 + at_truth)
    for _ in range(3):
        packed, args = _imu_case(rng, at_truth)
        ref = _jacfwd(lambda x, *a: vio_cuda._imu_residual(x, *a, 9.81),
                      2 * D, args)
        _check_dual(_host(host_dual, "imu", packed), ref)
        # the rotation residual dR_c^T R_i^T R_j: at the truth on so3_log's
        # small branch
        Ti, Tj = (torch.as_tensor(args[k]).double() for k in (0, 3))
        dRc = torch.as_tensor(args[6]).double() @ lie.so3_exp(
            torch.as_tensor(args[10]).double()
            @ (torch.as_tensor(args[2]).double()
               - torch.as_tensor(args[15]).double())[:3])
        small, _ = _log_branch(dRc.T @ Ti[:3, :3].T @ Tj[:3, :3])
        assert small == at_truth


@pytest.mark.parametrize("kind", ["random", "small", "near_pi", "pi"])
def test_host_dual_between_matches_jacfwd(host_dual, kind):
    rng = np.random.RandomState(21)
    for _ in range(3):
        packed, args = _between_case(rng, kind)
        ref = _jacfwd(vio_cuda._between_residual, 12, args)
        _check_dual(_host(host_dual, "between", packed), ref)
        Ti, Tj, rel = (np.asarray(a, np.float64) for a in args[:3])
        E = np.linalg.inv(rel) @ np.linalg.inv(Ti) @ Tj
        small, near_pi = _log_branch(E[:3, :3])
        assert (small, near_pi) == {"random": (False, False),
                                    "small": (True, False),
                                    "near_pi": (False, True),
                                    "pi": (True, True)}[kind]


def test_host_dual_gps_matches_jacfwd(host_dual):
    rng = np.random.RandomState(31)
    for _ in range(3):
        packed, args = _gps_case(rng)
        ref = _jacfwd(vio_cuda._gps_residual, 12, args)
        _check_dual(_host(host_dual, "gps", packed), ref)


def _random_cases(so):
    rng = np.random.RandomState(41)
    return {"imu": _host(so, "imu", _imu_case(rng, False)[0]),
            "gps": _host(so, "gps", _gps_case(rng)[0]),
            "between": _host(so, "between", _between_case(rng, "random")[0])}


def test_host_dual_operation_counts(host_dual):
    """The float64 operations of one lane (one tangent direction) on the
    random cases, which chip_smoke.VIO_DUAL_OPS states: the same for
    every direction (the branches follow the primal)."""
    for name, (_, _, ops, _) in _random_cases(host_dual).items():
        assert len(set(ops)) == 1, (name, ops)
        assert ops[0] == cs.VIO_DUAL_OPS[name], (name, ops[0])


def test_host_dual_chain_depths(host_dual):
    """The float64 critical path of one lane on the random cases: the
    depth of the deepest output (each result one deeper than its deepest
    input) and the long-latency operations on that chain (/ sqrt sin cos
    atan2 sincos), which chip_smoke.VIO_DUAL_DEPTH states; the same for
    every direction. The source's operations, as written: the kernel's
    build may contract a multiply and an add into one FMA."""
    for name, (_, _, ops, chains) in _random_cases(host_dual).items():
        assert len(set(chains)) == 1, (name, chains)
        assert chains[0] == cs.VIO_DUAL_DEPTH[name], (name, chains[0])
        depth, slow = chains[0]
        assert 0 <= slow < depth < ops[0], (name, chains[0], ops[0])


# ---- gpu: the kernel against its plain version on the card ----------------


@pytest.mark.gpu
@pytest.mark.parametrize("case", cs.VIO_FACTOR_CASES)
def test_kernel_matches_plain_on_cuda(cuda, case):
    p = cs.vio_factors_problem(cuda, case)
    rep = cs.check_vio_factors(p, repeats=3)
    assert rep["launches"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["imu+gps+between", "K=12 imu+gps",
                                  "60 IMU slots+gps"])
def test_kernel_graph_replays_are_bit_equal(cuda, case):
    """Also at K = 12 (three factors a block) and with 60 IMU slots (the
    factors' blocks read from the scratch)."""
    p = cs.vio_factors_problem(cuda, case)
    cs.check_vio_factors(p, repeats=1, graph_replays=5)


@pytest.mark.gpu
def test_kernel_merges_a_keyframe_joined_to_itself_on_cuda(cuda):
    """A valid IMU factor from a keyframe to itself: its two halves'
    columns added, as the plain version's selection matrix adds them."""
    p = cs.vio_factors_problem(cuda, "imu+gps")
    j = p.imu.j.clone()
    j[2] = p.imu.i[2]
    p = p._replace(imu=p.imu._replace(j=j))
    assert bool(p.imu.valid[2])
    cs.check_vio_factors(p, repeats=2, graph_replays=2)


@pytest.mark.gpu
def test_kernel_clamps_indices_outside_the_window_on_cuda(cuda):
    """Invalid factors whose indices lie outside [0, K) (an IMU factor at
    (-3, K + 2), a GPS factor at K + 4, a between factor at (-1, K)) read
    keyframes 0 or K - 1 and add nothing: the launch equals, bit for bit,
    records included, the launch on the problem with those indices
    clamped, which check_vio_factors holds to the plain version (whose
    index_select faults on an index outside the window)."""
    import torch

    from mcslam_tpu_torch.backend import vio_cuda

    p = cs.vio_factors_problem(cuda, "imu+gps+between")
    K = p.poses.shape[0]

    def put(table, **cols):
        out = {}
        for name, (k, v) in cols.items():
            col = getattr(table, name).clone()
            col[k] = v
            out[name] = col
        valid = table.valid.clone()
        valid[next(iter(cols.values()))[0]] = False
        return table._replace(valid=valid, **out)

    bad = p._replace(imu=put(p.imu, i=(1, -3), j=(1, K + 2)),
                     gps=put(p.gps, kf=(0, K + 4)),
                     between=put(p.between, i=(3, -1), j=(3, K)))
    ok = p._replace(imu=put(p.imu, i=(1, 0), j=(1, K - 1)),
                    gps=put(p.gps, kf=(0, K - 1)),
                    between=put(p.between, i=(3, 0), j=(3, K - 1)))
    rep = cs.check_vio_factors(ok, repeats=1)
    vis = _vision(bad)
    prep = vio_cuda.VioFactors(bad)
    out = prep(*_state(bad), *vis)
    recs = vio_cuda.record_views(prep.scratch, prep.counts)
    torch.cuda.synchronize()
    want = rep["out"]
    assert all(cs.same_bits(a, b) for a, b in zip(out, want[:3]))
    for name, rec in recs.items():
        assert all(cs.same_bits(a, b) for a, b in zip(rec, want[3][name]))
