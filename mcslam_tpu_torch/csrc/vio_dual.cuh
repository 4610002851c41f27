// Forward-mode duals and the VIO window's factor residuals on them: the
// residual of one IMU, GPS or between factor of backend/ba_vio at a state
// retracted by a tangent x whose primal is 0 and whose derivative is the
// basis vector e_dir, so that each output's derivative is column `dir`
// of the Jacobian, as torch.func.jacfwd computes it (jvp of each basis
// vector under vmap).
//
// Written once for the kernel (csrc/vio_factors.cu, one lane a tangent
// direction) and for a host build (tests/test_torch_vio_kernels.py builds
// it with g++ and holds it to torch.func.jacfwd in float64): every
// function is a __host__ __device__ template on the scalar type S of the
// dual (double in the kernel; the host build also counts operations with
// a scalar type of its own).
//
// The counterparts, in the port's geometry/lie.py, backend/imu.py and
// backend/vio_cuda.py, follow torch's evaluation:
//  - a branch of torch.where is taken on the primal, and its derivative is
//    the taken branch's (the other branch's NaN never leaks): _theta_terms'
//    small = t2 < 1e-8 and sqrt(where(small, 1, t2)), so3_log's small =
//    s2 < 1e-10, its near_pi branch and sign selections, the safe sine of
//    so3_left_jacobian_inv; the retraction at the zero tangent, on the
//    Taylor branch, is written out (retract);
//  - torch's jvp rules: a * b -> b' a + a' b; a / b -> (a' - b' q) / b,
//    here with one reciprocal of b for q and the derivative; sqrt -> a' /
//    (2 sqrt a); sin, cos (one sincos for both); atan2(y, x) -> (-y x' +
//    x y') / (y^2 + x^2); clamp passes the derivative inside [lo, hi], bounds
//    included, and gives 0 outside; 1.0 / t is reciprocal(t) * 1.0, whose
//    derivative is -t' r^2;
//  - Python constants are doubles (t2 / 6.0, 1.0 / 6.0, 0.5 * g * t * t
//    as ((0.5 g) t) t), and the float32 inputs are widened to double, as
//    the plain version's a.double();
//  - sums run in index order and a 4x4 product T @ E with E's last row
//    [0 0 0 1] is the 3x3 block product plus T's translation column.
// The operation orders of torch's float64 matrix products are not
// repeatable, so this agrees with the plain version to float64 rounding,
// not bit for bit (the kernel's build also contracts multiply-adds into
// FMAs); after the cast to float32 most values are equal and the others
// 1 ulp apart.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define VIO_HD __host__ __device__ __forceinline__
#else
#define VIO_HD inline
#endif

namespace vio {

constexpr int D = 15;  // per-keyframe state dims: pose 6, vel 3, bias 6

template <class S>
struct Dual {
  S v, d;  // primal, derivative
};

template <class S>
VIO_HD Dual<S> cst(S v) {
  return {v, S(0)};
}

// component k of a tangent whose primal is 0 and derivative e_dir
template <class S>
VIO_HD Dual<S> basis(int k, int dir) {
  return {S(0), S(k == dir ? 1 : 0)};
}

template <class S>
VIO_HD Dual<S> operator+(Dual<S> a, Dual<S> b) {
  return {a.v + b.v, a.d + b.d};
}
template <class S>
VIO_HD Dual<S> operator-(Dual<S> a, Dual<S> b) {
  return {a.v - b.v, a.d - b.d};
}
template <class S>
VIO_HD Dual<S> operator-(Dual<S> a) {
  return {-a.v, -a.d};
}
template <class S>
VIO_HD Dual<S> operator*(Dual<S> a, Dual<S> b) {
  return {a.v * b.v, b.d * a.v + a.d * b.v};
}
template <class S>
VIO_HD Dual<S> operator/(Dual<S> a, Dual<S> b) {
  const S rb = S(1) / b.v;
  const S q = a.v * rb;
  return {q, (a.d - b.d * q) * rb};
}
// with a constant (a Python float or an input without derivative)
template <class S>
VIO_HD Dual<S> operator*(Dual<S> a, S c) {
  return {a.v * c, a.d * c};
}
template <class S>
VIO_HD Dual<S> operator*(S c, Dual<S> a) {
  return {c * a.v, c * a.d};
}
template <class S>
VIO_HD Dual<S> operator/(Dual<S> a, S c) {
  return {a.v / c, a.d / c};
}
template <class S>
VIO_HD Dual<S> operator+(Dual<S> a, S c) {
  return {a.v + c, a.d};
}
template <class S>
VIO_HD Dual<S> operator+(S c, Dual<S> a) {
  return {c + a.v, a.d};
}
template <class S>
VIO_HD Dual<S> operator-(S c, Dual<S> a) {
  return {c - a.v, -a.d};
}
template <class S>
VIO_HD Dual<S> operator-(Dual<S> a, S c) {
  return {a.v - c, a.d};
}

template <class S>
VIO_HD Dual<S> dsqrt(Dual<S> a) {
  const S r = sqrt(a.v);
  return {r, a.d / (S(2) * r)};
}
template <class S>
VIO_HD Dual<S> datan2(Dual<S> y, Dual<S> x) {
  return {atan2(y.v, x.v),
          (-y.v * x.d + x.v * y.d) / (y.v * y.v + x.v * x.v)};
}
// sin and cos of one angle by one sincos call: {sin a, a' cos a} and
// {cos a, a' (-sin a)}
template <class S>
VIO_HD void dsincos(Dual<S> a, Dual<S>* s, Dual<S>* c) {
  S sv, cv;
  sincos(a.v, &sv, &cv);
  *s = {sv, a.d * cv};
  *c = {cv, a.d * -sv};
}
// 1.0 / a as torch evaluates it: reciprocal(a) * 1.0
template <class S>
VIO_HD Dual<S> drecip(Dual<S> a) {
  const S r = S(1) / a.v;
  return {r, -a.d * (r * r)};
}
template <class S>
VIO_HD Dual<S> dclamp(Dual<S> a, S lo, S hi) {
  const bool in = a.v >= lo && a.v <= hi;
  return {a.v < lo ? lo : (a.v > hi ? hi : a.v), in ? a.d : S(0)};
}
template <class S>
VIO_HD Dual<S> where(bool c, Dual<S> a, Dual<S> b) {
  return c ? a : b;
}

template <class S>
struct V3 {
  Dual<S> x[3];
};
template <class S>
struct M3 {
  Dual<S> m[9];  // row-major
};

template <class S>
VIO_HD V3<S> vadd(const V3<S>& a, const V3<S>& b) {
  return {{a.x[0] + b.x[0], a.x[1] + b.x[1], a.x[2] + b.x[2]}};
}
template <class S>
VIO_HD V3<S> vsub(const V3<S>& a, const V3<S>& b) {
  return {{a.x[0] - b.x[0], a.x[1] - b.x[1], a.x[2] - b.x[2]}};
}
template <class S>
VIO_HD V3<S> vscale(const V3<S>& a, Dual<S> s) {
  return {{a.x[0] * s, a.x[1] * s, a.x[2] * s}};
}
template <class S>
VIO_HD Dual<S> sumsq(const V3<S>& a) {
  return (a.x[0] * a.x[0] + a.x[1] * a.x[1]) + a.x[2] * a.x[2];
}
// float32 inputs widened to double, without derivative
template <class S>
VIO_HD V3<S> vload(const float* p) {
  return {{cst<S>(p[0]), cst<S>(p[1]), cst<S>(p[2])}};
}
// the rotation block of a row-major (4, 4) pose, and its translation
template <class S>
VIO_HD M3<S> rot_of(const float* T) {
  M3<S> R;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) R.m[3 * i + j] = cst<S>(T[4 * i + j]);
  return R;
}
template <class S>
VIO_HD V3<S> trans_of(const float* T) {
  return {{cst<S>(T[3]), cst<S>(T[7]), cst<S>(T[11])}};
}
template <class S>
VIO_HD M3<S> mload(const float* p) {  // a row-major (3, 3)
  M3<S> R;
  for (int k = 0; k < 9; ++k) R.m[k] = cst<S>(p[k]);
  return R;
}

template <class S>
VIO_HD M3<S> mm(const M3<S>& A, const M3<S>& B) {
  M3<S> C;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      C.m[3 * i + j] = (A.m[3 * i] * B.m[j] + A.m[3 * i + 1] * B.m[3 + j]) +
                       A.m[3 * i + 2] * B.m[6 + j];
  return C;
}
template <class S>
VIO_HD V3<S> mv(const M3<S>& A, const V3<S>& v) {
  V3<S> r;
  for (int i = 0; i < 3; ++i)
    r.x[i] = (A.m[3 * i] * v.x[0] + A.m[3 * i + 1] * v.x[1]) +
             A.m[3 * i + 2] * v.x[2];
  return r;
}
template <class S>
VIO_HD M3<S> transpose(const M3<S>& A) {
  M3<S> T;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) T.m[3 * i + j] = A.m[3 * j + i];
  return T;
}

template <class S>
VIO_HD M3<S> hat(const V3<S>& w) {
  const Dual<S> z = cst<S>(S(0));
  return {{z, -w.x[2], w.x[1], w.x[2], z, -w.x[0], -w.x[1], w.x[0], z}};
}

// I + a W + b W2, summed as torch sums it: (I + a W) + b W2
template <class S>
VIO_HD M3<S> eye_plus(Dual<S> a, const M3<S>& W, Dual<S> b, const M3<S>& W2) {
  M3<S> R;
  for (int k = 0; k < 9; ++k)
    R.m[k] = (cst<S>(S(k % 4 == 0 ? 1 : 0)) + a * W.m[k]) + b * W2.m[k];
  return R;
}

// lie._theta_terms: t2, theta from a clamped t2, small
template <class S>
struct Theta {
  Dual<S> t2, theta;
  bool small;
};
template <class S>
VIO_HD Theta<S> theta_terms(const V3<S>& w) {
  Theta<S> t;
  t.t2 = sumsq(w);
  t.small = t.t2.v < S(1e-8);
  t.theta = dsqrt(where(t.small, cst<S>(S(1)), t.t2));
  return t;
}

// lie.so3_exp (Rodrigues, Taylor series in theta^2 when small)
template <class S>
VIO_HD M3<S> so3_exp(const V3<S>& w) {
  const Theta<S> t = theta_terms(w);
  const Dual<S> t2 = t.t2, th = t.theta;
  Dual<S> a, b;
  if (t.small) {
    a = (S(1) - t2 / S(6)) + (t2 * t2) / S(120);
    b = (S(0.5) - t2 / S(24)) + (t2 * t2) / S(720);
  } else {
    Dual<S> sn, cs;
    dsincos(th, &sn, &cs);
    a = sn / th;
    b = (S(1) - cs) / (th * th);
  }
  const M3<S> W = hat(w);
  return eye_plus(a, W, b, mm(W, W));
}

// lie.so3_left_jacobian_inv: I - W / 2 + coeff W2
template <class S>
VIO_HD M3<S> so3_left_jacobian_inv(const V3<S>& w) {
  const Theta<S> t = theta_terms(w);
  const Dual<S> t2 = t.t2, th = t.theta;
  Dual<S> coeff;
  if (t.small) {
    coeff = S(1.0 / 12.0) + t2 / S(720);
  } else {
    Dual<S> s, cs;
    dsincos(th, &s, &cs);
    const Dual<S> safe = fabs(s.v) < S(1e-12) ? cst<S>(S(1)) : s;
    coeff = drecip(th * th) * S(1) - (S(1) + cs) / ((S(2) * th) * safe);
  }
  const M3<S> W = hat(w);
  return eye_plus(cst<S>(S(-0.5)), W, coeff, mm(W, W));
}

// lie.so3_log: atan2 angle, Taylor scale when small, the diagonal axis
// near pi
template <class S>
VIO_HD V3<S> so3_log(const M3<S>& R) {
  const Dual<S> trace = (R.m[0] + R.m[4]) + R.m[8];
  const Dual<S> cos_t = dclamp((trace - S(1)) * S(0.5), S(-1), S(1));
  // vee(0.5 (R - R^T))
  const V3<S> w_sin = {{S(0.5) * (R.m[7] - R.m[5]), S(0.5) * (R.m[2] - R.m[6]),
                        S(0.5) * (R.m[3] - R.m[1])}};
  const Dual<S> s2 = sumsq(w_sin);
  const bool small = s2.v < S(1e-10);
  const Dual<S> sin_safe = dsqrt(where(small, cst<S>(S(1)), s2));
  const Dual<S> sin_t = where(small, cst<S>(S(0)), sin_safe);
  const Dual<S> theta = datan2(sin_t, cos_t);
  const bool near_pi = sin_t.v < S(1e-3) && theta.v > S(3);
  if (!near_pi) {
    const Dual<S> scale =
        small ? S(1) + s2 / S(6) : theta / sin_safe;
    return vscale(w_sin, scale);
  }
  // B = (R + I) * 0.5, axis from its clamped diagonal, signs from its
  // off-diagonal entries (no derivative)
  Dual<S> axis[3];
  for (int k = 0; k < 3; ++k)
    axis[k] = dsqrt(dclamp((R.m[4 * k] + S(1)) * S(0.5), S(0), S(1)));
  const S b01 = ((R.m[1] + S(0)) * S(0.5)).v;
  const S b02 = ((R.m[2] + S(0)) * S(0.5)).v;
  const S b12 = ((R.m[5] + S(0)) * S(0.5)).v;
  const S sx = S(1);
  const S sy = (b01 >= S(0) ? S(1) : S(-1)) * sx;
  S sz = (b02 >= S(0) ? S(1) : S(-1)) * sx;
  if (axis[0].v < S(1e-3)) sz = (b12 >= S(0) ? S(1) : S(-1)) * sy;
  return {{(axis[0] * sx) * theta, (axis[1] * sy) * theta,
           (axis[2] * sz) * theta}};
}

// an SE(3) pose as rotation and translation
template <class S>
struct Pose {
  M3<S> R;
  V3<S> t;
};

template <class S>
VIO_HD Pose<S> pose_of(const float* T) {
  return {rot_of<S>(T), trans_of<S>(T)};
}

// lie.se3_retract(T, xi) = T @ se3_exp(xi) at the tangent xi whose
// primal is 0 and whose derivative is e_dir's components off .. off + 5
// (omega, v), written out: se3_exp's Taylor branch at theta^2 = 0 gives
// R = T.R with derivative T.R hat(e_w), and t = T.t with derivative
// T.R e_v. Every term the generic evaluation adds besides these is an
// exact zero, so each value and derivative is that evaluation's, up to
// the sign of an exact zero
template <class S>
VIO_HD Pose<S> retract(const Pose<S>& T, int off, int dir) {
  S e[6];
  for (int k = 0; k < 6; ++k) e[k] = S(dir == off + k ? 1 : 0);
  const S h[9] = {S(0), -e[2], e[1], e[2], S(0), -e[0], -e[1], e[0], S(0)};
  Pose<S> P;
  for (int i = 0; i < 3; ++i) {
    const S a0 = T.R.m[3 * i].v, a1 = T.R.m[3 * i + 1].v,
            a2 = T.R.m[3 * i + 2].v;
    for (int j = 0; j < 3; ++j)
      P.R.m[3 * i + j] = {T.R.m[3 * i + j].v,
                          (a0 * h[j] + a1 * h[3 + j]) + a2 * h[6 + j]};
    P.t.x[i] = {T.t.x[i].v, (a0 * e[3] + a1 * e[4]) + a2 * e[5]};
  }
  return P;
}

// lie.se3_inverse
template <class S>
VIO_HD Pose<S> inverse(const Pose<S>& T) {
  const M3<S> Rt = transpose(T.R);
  const V3<S> t = mv(Rt, T.t);
  return {Rt, {{-t.x[0], -t.x[1], -t.x[2]}}};
}

// A @ B of two poses
template <class S>
VIO_HD Pose<S> compose(const Pose<S>& A, const Pose<S>& B) {
  return {mm(A.R, B.R), vadd(mv(A.R, B.t), A.t)};
}

// lie.se3_apply
template <class S>
VIO_HD V3<S> apply(const Pose<S>& T, const V3<S>& p) {
  return vadd(mv(T.R, p), T.t);
}

// lie.se3_log -> (omega, v)
template <class S>
VIO_HD void se3_log(const Pose<S>& T, Dual<S>* out) {
  const V3<S> w = so3_log(T.R);
  const V3<S> v = mv(so3_left_jacobian_inv(w), T.t);
  for (int k = 0; k < 3; ++k) {
    out[k] = w.x[k];
    out[3 + k] = v.x[k];
  }
}

// One IMU factor's rows (ImuFactors fields of one factor, float32) and
// its two keyframes' states.
struct ImuInputs {
  const float *Ti, *vi, *bi, *Tj, *vj, *bj;  // (4, 4), (3,), (6,) each
  const float *dR, *dv, *dp, *dt, *dR_dbg, *dv_dbg, *dv_dba, *dp_dbg,
      *dp_dba, *bias_hat, *sqrt_info;  // (3, 3) ... (15, 15)
};

// vio_cuda._imu_residual: sqrt_info @ imu.residual(state_i, state_j) at the
// states retracted by x = [xi_i (15), xi_j (15)] -> r (15)
template <class S>
VIO_HD void imu_residual(const ImuInputs& in, S g_norm, int dir,
                         Dual<S>* r) {
  const Pose<S> Pi = retract(pose_of<S>(in.Ti), 0, dir);
  const Pose<S> Pj = retract(pose_of<S>(in.Tj), D, dir);
  V3<S> vi, vj;
  Dual<S> bi[6], bj[6];
  for (int k = 0; k < 3; ++k) {
    vi.x[k] = cst<S>(in.vi[k]) + basis<S>(6 + k, dir);
    vj.x[k] = cst<S>(in.vj[k]) + basis<S>(D + 6 + k, dir);
  }
  for (int k = 0; k < 6; ++k) {
    bi[k] = cst<S>(in.bi[k]) + basis<S>(9 + k, dir);
    bj[k] = cst<S>(in.bj[k]) + basis<S>(D + 9 + k, dir);
  }
  // imu._corrected: the deltas corrected to first order for bias_i
  V3<S> dbg, dba;
  for (int k = 0; k < 3; ++k) {
    dbg.x[k] = bi[k] - cst<S>(in.bias_hat[k]);
    dba.x[k] = bi[3 + k] - cst<S>(in.bias_hat[3 + k]);
  }
  const M3<S> dRc = mm(mload<S>(in.dR), so3_exp(mv(mload<S>(in.dR_dbg), dbg)));
  const V3<S> dvc = vadd(vadd(vload<S>(in.dv), mv(mload<S>(in.dv_dbg), dbg)),
                         mv(mload<S>(in.dv_dba), dba));
  const V3<S> dpc = vadd(vadd(vload<S>(in.dp), mv(mload<S>(in.dp_dbg), dbg)),
                         mv(mload<S>(in.dp_dba), dba));
  // imu.residual: g = eye(3)[2] * -g_norm, t = dt
  const S t = S(in.dt[0]);
  const S g[3] = {S(0) * -g_norm, S(0) * -g_norm, S(1) * -g_norm};
  const M3<S> RiT = transpose(Pi.R);
  const V3<S> r_dR = so3_log(mm(transpose(dRc), mm(RiT, Pj.R)));
  V3<S> a, b;
  for (int k = 0; k < 3; ++k) {
    a.x[k] = (vj.x[k] - vi.x[k]) - g[k] * t;
    b.x[k] = ((Pj.t.x[k] - Pi.t.x[k]) - vi.x[k] * t) - ((S(0.5) * g[k]) * t) * t;
  }
  const V3<S> r_dv = vsub(mv(RiT, a), dvc);
  const V3<S> r_dp = vsub(mv(RiT, b), dpc);
  Dual<S> r15[15];
  for (int k = 0; k < 3; ++k) {
    r15[k] = r_dR.x[k];
    r15[3 + k] = r_dv.x[k];
    r15[6 + k] = r_dp.x[k];
  }
  for (int k = 0; k < 6; ++k) r15[9 + k] = bj[k] - bi[k];
  // whitening: sqrt_info @ r15, its zero entries (the lower triangle of
  // make_imu_factors' Cholesky factor) skipped: a product with 0 adds
  // nothing to a finite sum
  for (int i = 0; i < 15; ++i) {
    Dual<S> s = cst<S>(S(0));
    bool first = true;
    for (int k = 0; k < 15; ++k) {
      const float c = in.sqrt_info[15 * i + k];
      if (c == 0.f) continue;
      const Dual<S> t = r15[k] * S(c);
      s = first ? t : s + t;
      first = false;
    }
    r[i] = s;
  }
}

struct GpsInputs {
  const float *pose, *ETV, *enu, *t_bg;  // (4, 4), (4, 4), (3,), (3,)
};

// vio_cuda._gps_residual: E_T_V (pose t_bg) - enu at x = [xi_pose, xi_E]
template <class S>
VIO_HD void gps_residual(const GpsInputs& in, int dir, Dual<S>* r) {
  const V3<S> p_world =
      apply(retract(pose_of<S>(in.pose), 0, dir), vload<S>(in.t_bg));
  const V3<S> p = apply(retract(pose_of<S>(in.ETV), 6, dir), p_world);
  for (int k = 0; k < 3; ++k) r[k] = p.x[k] - cst<S>(in.enu[k]);
}

struct BetweenInputs {
  const float *Ti, *Tj, *rel, *sigma_rot, *sigma_trans;  // (4, 4) x 3, (), ()
};

// vio_cuda._between_residual: log(rel^-1 T_i^-1 T_j) whitened by
// 1 / clamp(sigma, 1e-6) at x = [xi_i, xi_j]
template <class S>
VIO_HD void between_residual(const BetweenInputs& in, int dir, Dual<S>* r) {
  const Pose<S> Pi = retract(pose_of<S>(in.Ti), 0, dir);
  const Pose<S> Pj = retract(pose_of<S>(in.Tj), 6, dir);
  const Pose<S> E =
      compose(inverse(pose_of<S>(in.rel)), compose(inverse(Pi), Pj));
  se3_log(E, r);
  const S sr = S(in.sigma_rot[0]), st = S(in.sigma_trans[0]);
  const S wr = (S(1) / (sr < S(1e-6) ? S(1e-6) : sr)) * S(1);
  const S wt = (S(1) / (st < S(1e-6) ? S(1e-6) : st)) * S(1);
  for (int k = 0; k < 3; ++k) {
    r[k] = r[k] * wr;
    r[3 + k] = r[3 + k] * wt;
  }
}

}  // namespace vio
