// The rigid plant's control tick (K6): every velocity-implicit substep of
// `sim/rigid_body._dynamics_step` for a batch of items, float32 and float64,
// sm_90a.
//
// It replaces no TPU kernel: the JAX package runs the plant's substep scan as
// plain XLA (`cmw_tpu/sim/rigid_body.py` dynamics_step). In PyTorch a substep
// ran as ~3,200 library kernels inside the controller's CUDA graph (FK joint
// by joint, the mass matrix as einsums over the links' CoM Jacobians, the bias
// forces by a jvp and two grads through all of that, two batched Cholesky
// solves), and the graph's nodes, not the work, set its time: 11.2 ms a tick
// at B = 256. Here a whole tick, every substep, is one launch.
//
// What bounds it. A substep of one item is at least ~87 kFLOP (`ops/roofline.py`
// rigid_step_work: one 32 x 32 factorisation and its J^T D J product most of
// it; a second where a corner drops) on ~1.2 KB of state: 45 MFLOP a tick at
// B = 256, 0.67 us at the f32 peak. The time the card really takes is the latency
// of each item's chain of dependent steps: ~16 block barriers a substep and the
// factorisations' 32 column steps, each a square root, a division and a
// warp-synchronous update.
//
// The arithmetic (the closed forms of the twin's autodiff terms):
//   - FK: each link walks its own path from the base (the joints on it in
//     index order, parents before children), so every link's pose is one
//     pass with no barrier per tree level; a link's pose is formed in the
//     twin's order (p += R_parent o, R = (R_parent O) Rj).
//   - M by the composite-rigid-body algorithm. Every link's spatial inertia is
//     taken about the base origin p0 in the world frame (m, h = m (c - p0),
//     Ib = Iw - m hat(c - p0)^2), so a subtree's composite is a plain sum over
//     its links. With S_j = [(pivot_j - p0) x a_j ; a_j] the motion of joint j
//     and F_j = Ic_{j+1} S_j: M_base,base = Ic_0, M_base,j = F_j, M_i,j =
//     S_i . F_j where joint i is on joint j's path (else 0), plus the
//     armature on the joint diagonal. This is the twin's mixed-representation
//     M (v_base and w_base in the world, v_base the base origin's velocity).
//   - b by one Newton-Euler pass at zero acceleration: each link walks its
//     path for w, the velocity-product part of its angular acceleration and of
//     its origin's acceleration, then its force m (cdd - g) and torque
//     Iw al + w x Iw w, as a wrench about p0; each joint's b is S_j . (the sum
//     of its subtree's wrenches), the base's that sum over the whole tree.
//     The twin differentiates M(x) in the chart R(x) = exp(hat(dth)) R, whose
//     rates are world angular velocities only at x = 0; its
//     Mdot nu - 1/2 d/dx (nu^T M nu) + dV/dx is this Newton-Euler bias plus
//     w_base x (M nu)[3:6] in the base's angular rows, which is added. (The
//     CPU tests hold the two equal to 1e-9 in f64 for an orthonormal base
//     rotation. Where f32 ticks have sheared it, |R^T R - I| ~ 1e-6, the
//     twin differentiates the sheared FK, in which a joint moves its subtree
//     by R hat(u) R^-1 and not by a rotation, and b parts from these forms by
//     ~1e-2 of the shear: below f32's rounding.)
//   - The contact, servo and solve exactly as the twin: M_srv + h J^T D J +
//     1e-9 I and its right-hand side, the active-set pass (the corners whose
//     trial normal force comes out negative dropped, then solved once more;
//     where none drops the second solve is the first's, bitwise, and is not
//     taken), the foot-level Coulomb cap, anchor relaxation and slip, the
//     servo with its clamps, and the integration (so3_exp of the base's
//     rotation, as `core/lie.so3_exp` forms it).
//
// Design: one thread block (256 threads) per item (grid B).
//   - The model's tables (axes, origins, inertias, the sole frames and
//     corners; parents and the path and subtree masks), the item's state and
//     every intermediate (link poses, composites, M, the factor, the corner
//     Jacobians) stay in shared memory across all substeps: ~24 KB in f32,
//     ~48 KB in f64 at the ergoCub sizes.
//   - Each phase gives one thread a link, a joint, a corner, a matrix entry or
//     a contact row; independent kinds of work share a phase on disjoint runs
//     of threads.
//   - The factorisation and both substitutions run in warp 0 alone, with
//     __syncwarp between the column steps instead of block barriers: the
//     right-looking Cholesky in shared memory (lanes over rows), the
//     substitutions with each lane's rows in registers and the solved entry
//     broadcast by a shuffle.
//   - ergoCub's joint count (nj = 26, so n = 32 and one row a lane) is
//     compiled as a constant: it is the one tree a configuration runs, and
//     `plan` and `run` refuse any other. The feet and their corners are
//     taken at run time, where the shared memory holds them.
//   - Nothing is atomic and every sum runs in a fixed order: launches on the
//     same inputs are bitwise equal.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;  // shared memory one H100 block may use
constexpr int kParams = 12;
constexpr int kNJ = 26;  // ergoCub's joints, the one tree the kernel is built for
// RigidDynParams, in its field order
enum { kKp, kKd, kMu, kKs, kKt, kRelaxTau, kServoKp, kServoKd, kServoKi, kIntMax, kTauMax, kJointDamping };

struct Sizes {
  int nj, nl, n, nfeet, ncor, ncr;
  int nint, nft;  // int64 and float table lengths
};

__host__ __device__ inline Sizes sizes(int nj, int nfeet, int ncor) {
  Sizes s;
  s.nj = nj;
  s.nl = nj + 1;
  s.n = 6 + nj;
  s.nfeet = nfeet;
  s.ncor = ncor;
  s.ncr = nfeet * ncor;
  s.nint = nj + 2 * s.nl + nfeet;
  s.nft = 15 * nj + 13 * s.nl + 12 * nfeet + 3 * s.ncr;
  return s;
}

// offsets into the float table (`ops/rigid_step.float_table_len`)
struct Model {
  int axis, opos, orot, mass, com, inertia, frot, fpos, corners;
};

__host__ __device__ inline Model model_offsets(const Sizes& s) {
  Model m;
  m.axis = 0;
  m.opos = 3 * s.nj;
  m.orot = 6 * s.nj;
  m.mass = 15 * s.nj;
  m.com = m.mass + s.nl;
  m.inertia = m.com + 3 * s.nl;
  m.frot = m.inertia + 9 * s.nl;
  m.fpos = m.frot + 9 * s.nfeet;
  m.corners = m.fpos + 3 * s.nfeet;
  return m;
}

// an item's working set (`ops/rigid_step.work_len`, in the same order)
struct Layout {
  int rb, pb, q, nu, fc, anch, sint, qcmd, fext, prm;  // state
  int rj, lR, lp, lI, cI, W, cW;                       // joints' rotations; links
  int ax, pv, S, F;                                    // joints
  int M, A, Mnu, bb, tau, x;                           // dense
  int pts, J, f0, Dc, anc0, act;                       // contact
  int misc, total;
};

struct Bump {  // hands out consecutive runs of a working set
  int at = 0;
  __host__ __device__ int operator()(int len) {
    const int o = at;
    at += len;
    return o;
  }
};

__host__ __device__ inline Layout layout(const Sizes& s) {
  Layout L;
  Bump take;
  L.rb = take(9);
  L.pb = take(3);
  L.q = take(s.nj);
  L.nu = take(s.n);
  L.fc = take(3 * s.ncr);
  L.anch = take(2 * s.ncr);
  L.sint = take(s.nj);
  L.qcmd = take(s.nj);
  L.fext = take(3);
  L.prm = take(kParams);
  L.rj = take(9 * s.nj);
  L.lR = take(9 * s.nl);
  L.lp = take(3 * s.nl);
  L.lI = take(10 * s.nl);  // m, h (3), Ib (xx yy zz xy xz yz)
  L.cI = take(10 * s.nl);
  L.W = take(6 * s.nl);
  L.cW = take(6 * s.nl);
  L.ax = take(3 * s.nj);
  L.pv = take(3 * s.nj);
  L.S = take(6 * s.nj);
  L.F = take(6 * s.nj);
  L.M = take(s.n * s.n);
  L.A = take(s.n * s.n);
  L.Mnu = take(s.n);
  L.bb = take(s.n);
  L.tau = take(s.n);
  L.x = take(s.n);
  L.pts = take(3 * s.ncr);
  L.J = take(3 * s.ncr * s.n);
  L.f0 = take(3 * s.ncr);
  L.Dc = take(3 * s.ncr);
  L.anc0 = take(2 * s.ncr);
  L.act = take(2 * s.ncr);  // the active set, then the active set after the pass
  L.misc = take(8);         // [0] d_srv
  L.total = take.at;
  return L;
}

// 0 where no launch holds the sizes
inline size_t smem_bytes(int nj, int nfeet, int ncor, size_t elem) {
  if (nj != kNJ || nfeet < 1 || ncor < 1) return 0;
  const Sizes s = sizes(nj, nfeet, ncor);
  const size_t bytes = 8 * static_cast<size_t>(s.nint) + elem * (s.nft + layout(s).total);
  return bytes <= kMaxSmem ? bytes : 0;
}

template <typename Real>
struct Args {
  const Real* ftab;
  const long long* itab;
  const Real *rot, *pos, *q, *nu, *fc, *anch, *sint, *prm, *qcmd, *fext;  // fext may be null
  Real *o_rot, *o_pos, *o_q, *o_nu, *o_fc, *o_anch, *o_sint;
  int nfeet, ncor, substeps;
  Real h, armature;
};

template <typename Real>
__device__ __forceinline__ void cross(const Real* a, const Real* b, Real* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename Real>
__device__ __forceinline__ void matvec3(const Real* R, const Real* v, Real* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

template <typename Real>
__device__ __forceinline__ void matmul3(const Real* A, const Real* B, Real* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) out[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

// core/lie.so3_exp: I + a W + b W^2, with its guarded small-angle series
template <typename Real>
__device__ __forceinline__ void so3_exp(const Real* w, Real* R) {
  const Real eps = Real(1e-8);
  const Real t2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const Real t = sqrt(t2 + eps * eps);
  const bool big = t2 > eps;
  const Real a = big ? sin(t) / t : Real(1) - t2 / Real(6);
  const Real b = big ? (Real(1) - cos(t)) / t2 : Real(0.5) - t2 / Real(24);
  const Real W[9] = {0, -w[2], w[1], w[2], 0, -w[0], -w[1], w[0], 0};
  Real W2[9];
  matmul3(W, W, W2);
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = ((k % 4 == 0) ? Real(1) : Real(0)) + a * W[k] + b * W2[k];
}

// the loop index of this thread for a task whose run of threads starts at `first`
__device__ __forceinline__ int from(int first) { return (static_cast<int>(threadIdx.x) + kThreads - first) % kThreads; }

template <typename Real>
struct Item {
  const Sizes s;
  const Layout L;
  const Model md;
  const Real* ft;        // the float table
  const long long* it;   // parent [nj], anc [nl], sub [nl], flink [nfeet]
  Real* w;               // the working set
  Real h, armature;

  __device__ int nj() const { return kNJ; }
  __device__ int nl() const { return nj() + 1; }
  __device__ int n() const { return nj() + 6; }
  __device__ unsigned long long anc(int l) const { return static_cast<unsigned long long>(it[nj() + l]); }
  __device__ unsigned long long sub(int l) const { return static_cast<unsigned long long>(it[nj() + nl() + l]); }
  __device__ int parent(int j) const { return static_cast<int>(it[j]); }
  __device__ int flink(int i) const { return static_cast<int>(it[nj() + 2 * nl() + i]); }
  __device__ Real prm(int k) const { return w[L.prm + k]; }

  // servo, joint rotations, the generalized torques without the contact
  __device__ void servo_and_rotations() {
    const Real* prm_ = w + L.prm;
    for (int j = threadIdx.x; j < nj(); j += kThreads) {
      Real ws[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) ws[k] = ft[md.axis + 3 * j + k] * w[L.q + j];
      so3_exp(ws, w + L.rj + 9 * j);
      const Real err = w[L.qcmd + j] - w[L.q + j];
      const Real imax = prm_[kIntMax], tmax = prm_[kTauMax];
      const Real si = fmin(fmax(w[L.sint + j] + prm_[kServoKi] * h * err, -imax), imax);
      w[L.sint + j] = si;
      w[L.tau + 6 + j] = fmin(fmax(prm_[kServoKp] * err + si, -tmax), tmax);
    }
    const int t = from(128);
    if (t < 3) {
      w[L.tau + t] = w[L.fext + t];
      w[L.tau + 3 + t] = Real(0);
    }
    if (t == 3) w[L.misc] = prm_[kServoKd] + prm_[kJointDamping] + h * prm_[kServoKp];
  }

  // every link's pose, each walking its path from the base
  __device__ void forward_kinematics() {
    for (int l = threadIdx.x; l < nl(); l += kThreads) {
      Real R[9], p[3], T[9], v[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = w[L.rb + k];
#pragma unroll
      for (int k = 0; k < 3; ++k) p[k] = w[L.pb + k];
      for (unsigned long long m = anc(l); m; m &= m - 1) {
        const int j = __ffsll(static_cast<long long>(m)) - 1;
        matvec3(R, ft + md.opos + 3 * j, v);
#pragma unroll
        for (int k = 0; k < 3; ++k) p[k] += v[k];
        matmul3(R, ft + md.orot + 9 * j, T);
        matmul3(T, w + L.rj + 9 * j, R);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) w[L.lR + 9 * l + k] = R[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) w[L.lp + 3 * l + k] = p[k];
    }
  }

  // joint j's world axis and pivot
  __device__ void joint_axis(int j, Real* ax, Real* pv) const {
    const Real* Rp = w + L.lR + 9 * parent(j);
    Real u[3];
    matvec3(ft + md.orot + 9 * j, ft + md.axis + 3 * j, u);
    matvec3(Rp, u, ax);
    matvec3(Rp, ft + md.opos + 3 * j, pv);
#pragma unroll
    for (int k = 0; k < 3; ++k) pv[k] += w[L.lp + 3 * parent(j) + k];
  }

  // per link: spatial inertia about p0 and its Newton-Euler wrench; per
  // joint: axis, pivot, motion S; per corner: its world point
  __device__ void link_terms() {
    const Real* p0 = w + L.pb;
    const Real* nu = w + L.nu;
    for (int l = threadIdx.x; l < nl(); l += kThreads) {
      const Real* R = w + L.lR + 9 * l;
      const Real m = ft[md.mass + l];
      Real e[3], r[3], T[9], Iw[9], Rt[9];
      matvec3(R, ft + md.com + 3 * l, e);
#pragma unroll
      for (int k = 0; k < 3; ++k) r[k] = w[L.lp + 3 * l + k] + e[k] - p0[k];
      matmul3(R, ft + md.inertia + 9 * l, T);
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) Rt[3 * a + b] = R[3 * b + a];
      matmul3(T, Rt, Iw);
      Real* I = w + L.lI + 10 * l;
      const Real rr = r[0] * r[0] + r[1] * r[1] + r[2] * r[2];
      I[0] = m;
#pragma unroll
      for (int k = 0; k < 3; ++k) I[1 + k] = m * r[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) I[4 + k] = Iw[4 * k] + m * (rr - r[k] * r[k]);
      I[7] = Iw[1] - m * r[0] * r[1];
      I[8] = Iw[2] - m * r[0] * r[2];
      I[9] = Iw[5] - m * r[1] * r[2];
      // Newton-Euler at zero acceleration along the path
      Real om[3] = {nu[3], nu[4], nu[5]}, al[3] = {0, 0, 0}, pdd[3] = {0, 0, 0};
      for (unsigned long long msk = anc(l); msk; msk &= msk - 1) {
        const int j = __ffsll(static_cast<long long>(msk)) - 1;
        Real ax[3], pv[3], d[3], t1[3], t2[3], t3[3];
        joint_axis(j, ax, pv);
#pragma unroll
        for (int k = 0; k < 3; ++k) d[k] = w[L.lp + 3 * (j + 1) + k] - w[L.lp + 3 * parent(j) + k];
        cross(al, d, t1);
        cross(om, d, t2);
        cross(om, t2, t3);
#pragma unroll
        for (int k = 0; k < 3; ++k) pdd[k] += t1[k] + t3[k];
        cross(om, ax, t1);
        const Real qd = nu[6 + j];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          al[k] += t1[k] * qd;
          om[k] += ax[k] * qd;
        }
      }
      Real t1[3], t2[3], t3[3], f[3], Iwa[3], Iww[3];
      cross(al, e, t1);
      cross(om, e, t2);
      cross(om, t2, t3);
#pragma unroll
      for (int k = 0; k < 3; ++k) f[k] = m * (pdd[k] + (t1[k] + t3[k]));
      f[2] += m * Real(9.80665);
      matvec3(Iw, al, Iwa);
      matvec3(Iw, om, Iww);
      cross(om, Iww, t1);
      cross(r, f, t2);
      Real* W = w + L.W + 6 * l;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        W[k] = f[k];
        W[3 + k] = Iwa[k] + t1[k] + t2[k];
      }
    }
    for (int j = from(64); j < nj(); j += kThreads) {
      Real ax[3], pv[3], d[3], sl[3];
      joint_axis(j, ax, pv);
#pragma unroll
      for (int k = 0; k < 3; ++k) d[k] = pv[k] - p0[k];
      cross(d, ax, sl);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w[L.ax + 3 * j + k] = ax[k];
        w[L.pv + 3 * j + k] = pv[k];
        w[L.S + 6 * j + k] = sl[k];
        w[L.S + 6 * j + 3 + k] = ax[k];
      }
    }
    for (int c = from(128); c < s.ncr; c += kThreads) {
      const int i = c / s.ncor, fl = flink(i);
      const Real* R = w + L.lR + 9 * fl;
      Real fR[9], fp[3], v[3];
      matmul3(R, ft + md.frot + 9 * i, fR);
      matvec3(R, ft + md.fpos + 3 * i, fp);
      matvec3(fR, ft + md.corners + 3 * c, v);
#pragma unroll
      for (int k = 0; k < 3; ++k) w[L.pts + 3 * c + k] = w[L.lp + 3 * fl + k] + fp[k] + v[k];
    }
  }

  // subtree sums; the corners' Jacobian rows; the contact's explicit part
  __device__ void composites_and_contact() {
    const int nl_ = nl(), n_ = n();
    for (int e = threadIdx.x; e < 16 * nl_; e += kThreads) {
      const int l = e / 16, k = e % 16;
      Real acc = 0;
      if (k < 10) {
        for (unsigned long long m = sub(l); m; m &= m - 1) acc += w[L.lI + 10 * (__ffsll(static_cast<long long>(m)) - 1) + k];
        w[L.cI + 10 * l + k] = acc;
      } else {
        for (unsigned long long m = sub(l); m; m &= m - 1) acc += w[L.W + 6 * (__ffsll(static_cast<long long>(m)) - 1) + k - 10];
        w[L.cW + 6 * l + k - 10] = acc;
      }
    }
    const Real* p0 = w + L.pb;
    for (int e = from(176); e < s.ncr * n_; e += kThreads) {
      const int c = e / n_, col = e % n_;
      const Real* pt = w + L.pts + 3 * c;
      Real v[3];
      if (col < 3) {
#pragma unroll
        for (int x = 0; x < 3; ++x) v[x] = x == col ? Real(1) : Real(0);
      } else if (col < 6) {  // -hat(pt - p0), column col - 3
        const Real d0 = pt[0] - p0[0], d1 = pt[1] - p0[1], d2 = pt[2] - p0[2];
        const Real m[9] = {0, d2, -d1, -d2, 0, d0, d1, -d0, 0};
#pragma unroll
        for (int x = 0; x < 3; ++x) v[x] = m[3 * x + col - 3];
      } else {
        const int j = col - 6;
        if (anc(flink(c / s.ncor)) >> j & 1ull) {
          Real d[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) d[k] = pt[k] - w[L.pv + 3 * j + k];
          cross(w + L.ax + 3 * j, d, v);
        } else {
          v[0] = v[1] = v[2] = Real(0);
        }
      }
#pragma unroll
      for (int x = 0; x < 3; ++x) w[L.J + (3 * c + x) * n_ + col] = v[x];
    }
    for (int c = from(224); c < s.ncr; c += kThreads) {
      const int i = c / s.ncor;
      bool down = false;
      for (int k = 0; k < s.ncor; ++k) down |= -w[L.pts + 3 * (i * s.ncor + k) + 2] > Real(0);
      const Real* pt = w + L.pts + 3 * c;
      const Real pen = fmax(-pt[2], Real(0));
      const Real act = pen > Real(0) ? Real(1) : Real(0);
      const Real tau = prm(kRelaxTau);
      const Real relax = tau > Real(0) ? h / fmax(tau, Real(1e-6)) : Real(0);
      Real a0[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        a0[k] = down ? w[L.anch + 2 * c + k] : pt[k];
        a0[k] = a0[k] + (pt[k] - a0[k]) * relax;
        w[L.anc0 + 2 * c + k] = a0[k];
        w[L.f0 + 3 * c + k] = -prm(kKs) * (pt[k] - a0[k]) * act;
      }
      w[L.f0 + 3 * c + 2] = prm(kKp) * pen * act;
      const Real dt = prm(kKt) + h * prm(kKs), dz = prm(kKd) + h * prm(kKp);
      w[L.Dc + 3 * c] = dt;
      w[L.Dc + 3 * c + 1] = dt;
      w[L.Dc + 3 * c + 2] = dz;
      w[L.act + c] = act;
    }
  }

  // F_j = Ic_{j+1} S_j, the joints' bias rows, M's base block and the base's bias rows
  __device__ void forces() {
    for (int e = threadIdx.x; e < 6 * nj(); e += kThreads) {
      const int j = e / 6, k = e % 6;
      const Real* I = w + L.cI + 10 * (j + 1);
      const Real* S = w + L.S + 6 * j;
      const Real* hh = I + 1;
      const Real Ib[9] = {I[4], I[7], I[8], I[7], I[5], I[9], I[8], I[9], I[6]};
      Real v;
      if (k < 3) {  // m s_lin - h x s_ang
        const int a = (k + 1) % 3, b = (k + 2) % 3;
        v = I[0] * S[k] - (hh[a] * S[3 + b] - hh[b] * S[3 + a]);
      } else {  // h x s_lin + Ib s_ang
        const int x = k - 3, a = (x + 1) % 3, b = (x + 2) % 3;
        v = (hh[a] * S[b] - hh[b] * S[a]) + (Ib[3 * x] * S[3] + Ib[3 * x + 1] * S[4] + Ib[3 * x + 2] * S[5]);
      }
      w[L.F + e] = v;
    }
    for (int j = from(160); j < nj(); j += kThreads) {
      const Real* S = w + L.S + 6 * j;
      const Real* W = w + L.cW + 6 * (j + 1);
      Real acc = 0;
#pragma unroll
      for (int k = 0; k < 6; ++k) acc += S[k] * W[k];
      w[L.bb + 6 + j] = acc;
    }
    const int t = from(192);
    if (t < 36) {
      const int r = t / 6, c = t % 6;
      const Real* I = w + L.cI;
      const Real m[36] = {I[0], 0, 0, 0, I[3], -I[2],
                          0, I[0], 0, -I[3], 0, I[1],
                          0, 0, I[0], I[2], -I[1], 0,
                          0, -I[3], I[2], I[4], I[7], I[8],
                          I[3], 0, -I[1], I[7], I[5], I[9],
                          -I[2], I[1], 0, I[8], I[9], I[6]};
      w[L.M + r * n() + c] = m[t];
    } else if (t < 42) {
      w[L.bb + t - 36] = w[L.cW + t - 36];
    }
  }

  // M's entries past its base block
  __device__ void mass_matrix() {
    const int n_ = n();
    for (int e = threadIdx.x; e < n_ * n_; e += kThreads) {
      const int r = e / n_, c = e % n_;
      if (r < 6 && c < 6) continue;
      Real v;
      if (r < 6) {
        v = w[L.F + 6 * (c - 6) + r];
      } else if (c < 6) {
        v = w[L.F + 6 * (r - 6) + c];
      } else {
        const int lo = min(r, c) - 6, hi = max(r, c) - 6;
        v = Real(0);
        if (anc(hi + 1) >> lo & 1ull) {
          const Real* S = w + L.S + 6 * lo;
          const Real* F = w + L.F + 6 * hi;
#pragma unroll
          for (int k = 0; k < 6; ++k) v += S[k] * F[k];
        }
        if (r == c) v += armature;
      }
      w[L.M + e] = v;
    }
  }

  // M nu, and the chart's w_base x (M nu)[3:6] on the base's angular bias rows
  __device__ void momentum() {
    const int n_ = n();
    const Real* nu = w + L.nu;
    for (int r = threadIdx.x; r < n_; r += kThreads) {
      Real acc = 0;
      for (int c = 0; c < n_; ++c) acc += w[L.M + r * n_ + c] * nu[c];
      w[L.Mnu + r] = acc;
      if (r >= 3 && r < 6) {
        Real Lm[3], t[3];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          Real a = 0;
          for (int c = 0; c < n_; ++c) a += w[L.M + (3 + k) * n_ + c] * nu[c];
          Lm[k] = a;
        }
        cross(nu + 3, Lm, t);
        w[L.bb + r] += t[r - 3];
      }
    }
  }

  // the implicit solve with the active set `a` (L.act + a ncr): nu+ into x,
  // the corners' forces into fc
  __device__ void solve(int set) {
    const int n_ = n(), rows = 3 * s.ncr;
    const Real* act = w + L.act + set * s.ncr;
    Real* A = w + L.A;
    const Real dsrv = w[L.misc];
    for (int e = threadIdx.x; e < n_ * n_; e += kThreads) {
      const int i = e / n_, j = e % n_;
      if (j > i) continue;
      Real jdj = 0;
      for (int r = 0; r < rows; ++r) jdj += w[L.J + r * n_ + i] * (w[L.Dc + r] * act[r / 3]) * w[L.J + r * n_ + j];
      Real m = w[L.M + e];
      if (i == j && i >= 6) m += h * dsrv;
      Real v = m + h * jdj;
      if (i == j) v += Real(1e-9);
      A[e] = v;
    }
    __syncthreads();
    if (threadIdx.x < 32) warp_solve(act);
    __syncthreads();
    for (int r = threadIdx.x; r < rows; r += kThreads) {
      Real v = 0;
      for (int c = 0; c < n_; ++c) v += w[L.J + r * n_ + c] * w[L.x + c];
      const Real a = act[r / 3];
      w[L.fc + r] = w[L.f0 + r] * a - (w[L.Dc + r] * a) * v;
    }
    __syncthreads();
  }

  // warp 0: the right-hand side, the Cholesky factor of A (lower, in place)
  // and both substitutions
  __device__ void warp_solve(const Real* act) {
    constexpr int kR = (kNJ + 6 + 31) / 32;  // rows a lane holds
    const int n_ = n(), rows = 3 * s.ncr;
    const unsigned full = 0xffffffffu;
    const int lane = threadIdx.x;
    Real* A = w + L.A;
    Real y[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = lane + 32 * k;
      y[k] = Real(0);
      if (i < n_) {
        Real jf = 0;
        for (int r = 0; r < rows; ++r) jf += w[L.J + r * n_ + i] * (w[L.f0 + r] * act[r / 3]);
        y[k] = w[L.Mnu + i] + h * ((w[L.tau + i] - w[L.bb + i]) + jf);
      }
    }
    for (int k = 0; k < n_; ++k) {
      const Real d = sqrt(A[k * n_ + k]);
      __syncwarp();
      if (lane == 0) A[k * n_ + k] = d;
      for (int i = k + 1 + lane; i < n_; i += 32) A[i * n_ + k] = A[i * n_ + k] / d;
      __syncwarp();
      for (int i = k + 1 + lane; i < n_; i += 32) {
        const Real lik = A[i * n_ + k];
        for (int j = k + 1; j <= i; ++j) A[i * n_ + j] -= lik * A[j * n_ + k];
      }
      __syncwarp();
    }
    for (int c = 0; c < n_; ++c) {  // L y = rhs
      Real own = y[0];
#pragma unroll
      for (int k = 1; k < kR; ++k)
        if (c >> 5 == k) own = y[k];
      const Real yc = __shfl_sync(full, own, c & 31) / A[c * n_ + c];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = lane + 32 * k;
        if (i == c) y[k] = yc;
        else if (i > c && i < n_) y[k] -= A[i * n_ + c] * yc;
      }
    }
    for (int c = n_ - 1; c >= 0; --c) {  // L^T x = y
      Real own = y[0];
#pragma unroll
      for (int k = 1; k < kR; ++k)
        if (c >> 5 == k) own = y[k];
      const Real xc = __shfl_sync(full, own, c & 31) / A[c * n_ + c];
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        const int i = lane + 32 * k;
        if (i == c) y[k] = xc;
        else if (i < c) y[k] -= A[c * n_ + i] * xc;
      }
    }
#pragma unroll
    for (int k = 0; k < kR; ++k) {
      const int i = lane + 32 * k;
      if (i < n_) w[L.x + i] = y[k];
    }
  }

  // the Coulomb cap, the anchors, and the integration
  __device__ void finish(int set) {
    const Real* act = w + L.act + set * s.ncr;
    for (int i = threadIdx.x; i < s.nfeet; i += kThreads) {
      Real ftx = 0, fty = 0, fzs = 0;
      bool down = false;
      for (int k = 0; k < s.ncor; ++k) {
        const int c = i * s.ncor + k;
        ftx += w[L.fc + 3 * c];
        fty += w[L.fc + 3 * c + 1];
        fzs += fmax(w[L.fc + 3 * c + 2], Real(0)) * act[c];
        down |= act[c] > Real(0);
      }
      const Real norm = sqrt(ftx * ftx + fty * fty), safe = fmax(norm, Real(1e-9));
      const Real scale = fmin(prm(kMu) * fzs / safe, Real(1));
      const Real mag = (Real(1) - scale) * norm / prm(kKs) / Real(4);
      const Real slip[2] = {-(ftx / safe) * mag, -(fty / safe) * mag};
      for (int k = 0; k < s.ncor; ++k) {
        const int c = i * s.ncor + k;
        Real* f = w + L.fc + 3 * c;
        f[0] = f[0] * scale;
        f[1] = f[1] * scale;
        f[2] = fmax(f[2], Real(0)) * act[c];
#pragma unroll
        for (int x = 0; x < 2; ++x)
          w[L.anch + 2 * c + x] = (down && scale < Real(1)) ? w[L.anc0 + 2 * c + x] + slip[x] : w[L.anc0 + 2 * c + x];
      }
    }
    const int n_ = n();
    for (int k = from(32); k < n_; k += kThreads) {
      const Real v = w[L.x + k];
      w[L.nu + k] = v;
      if (k >= 6) w[L.q + k - 6] += h * v;
      if (k < 3) w[L.pb + k] += h * v;
    }
    if (from(160) == 0) {
      Real wh[3], E[9], R[9];
#pragma unroll
      for (int k = 0; k < 3; ++k) wh[k] = h * w[L.x + 3 + k];
      so3_exp(wh, E);
      matmul3(E, w + L.rb, R);
#pragma unroll
      for (int k = 0; k < 9; ++k) w[L.rb + k] = R[k];
    }
  }

  __device__ void substep() {
    servo_and_rotations();
    __syncthreads();
    forward_kinematics();
    __syncthreads();
    link_terms();
    __syncthreads();
    composites_and_contact();
    __syncthreads();
    forces();
    __syncthreads();
    mass_matrix();
    __syncthreads();
    momentum();
    __syncthreads();
    solve(0);
    // the active-set pass: drop the corners whose trial normal force is negative
    int dropped = 0;
    for (int c = threadIdx.x; c < s.ncr; c += kThreads) {
      const Real a = w[L.act + c] * (w[L.fc + 3 * c + 2] > Real(0) ? Real(1) : Real(0));
      w[L.act + s.ncr + c] = a;
      dropped |= a != w[L.act + c];
    }
    if (__syncthreads_or(dropped)) solve(1);
    finish(1);
    __syncthreads();
  }
};

template <typename Real>
__global__ void __launch_bounds__(kThreads) rigid_step_kernel(const Args<Real> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Sizes s = sizes(kNJ, a.nfeet, a.ncor);
  long long* it = reinterpret_cast<long long*>(smem);
  Real* ft = reinterpret_cast<Real*>(smem + 8 * static_cast<size_t>(s.nint));
  Item<Real> item{s, layout(s), model_offsets(s), ft, it, ft + s.nft, a.h, a.armature};
  const Layout& L = item.L;
  Real* w = item.w;
  const size_t b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int i = tid; i < s.nint; i += kThreads) it[i] = a.itab[i];
  for (int i = tid; i < s.nft; i += kThreads) ft[i] = a.ftab[i];
  for (int i = tid; i < 9; i += kThreads) w[L.rb + i] = a.rot[9 * b + i];
  for (int i = tid; i < 3; i += kThreads) {
    w[L.pb + i] = a.pos[3 * b + i];
    w[L.fext + i] = a.fext ? a.fext[3 * b + i] : Real(0);
  }
  for (int i = tid; i < s.nj; i += kThreads) {
    w[L.q + i] = a.q[b * s.nj + i];
    w[L.sint + i] = a.sint[b * s.nj + i];
    w[L.qcmd + i] = a.qcmd[b * s.nj + i];
  }
  for (int i = tid; i < s.n; i += kThreads) w[L.nu + i] = a.nu[b * s.n + i];
  for (int i = tid; i < 3 * s.ncr; i += kThreads) w[L.fc + i] = a.fc[b * 3 * s.ncr + i];
  for (int i = tid; i < 2 * s.ncr; i += kThreads) w[L.anch + i] = a.anch[b * 2 * s.ncr + i];
  for (int i = tid; i < kParams; i += kThreads) w[L.prm + i] = a.prm[b * kParams + i];
  __syncthreads();
  for (int k = 0; k < a.substeps; ++k) item.substep();
  for (int i = tid; i < 9; i += kThreads) a.o_rot[9 * b + i] = w[L.rb + i];
  for (int i = tid; i < 3; i += kThreads) a.o_pos[3 * b + i] = w[L.pb + i];
  for (int i = tid; i < s.nj; i += kThreads) {
    a.o_q[b * s.nj + i] = w[L.q + i];
    a.o_sint[b * s.nj + i] = w[L.sint + i];
  }
  for (int i = tid; i < s.n; i += kThreads) a.o_nu[b * s.n + i] = w[L.nu + i];
  for (int i = tid; i < 3 * s.ncr; i += kThreads) a.o_fc[b * 3 * s.ncr + i] = w[L.fc + i];
  for (int i = tid; i < 2 * s.ncr; i += kThreads) a.o_anch[b * 2 * s.ncr + i] = w[L.anch + i];
}

template <typename Real>
int launch(const Args<Real>& a, int batch, size_t smem, cudaStream_t stream) {
  const auto kernel = rigid_step_kernel<Real>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<batch, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename Real>
int run(const Real* ftab, const long long* itab, const Real* rot, const Real* pos, const Real* q, const Real* nu,
        const Real* fc, const Real* anch, const Real* sint, const Real* prm, const Real* qcmd, const Real* fext,
        Real* o_rot, Real* o_pos, Real* o_q, Real* o_nu, Real* o_fc, Real* o_anch, Real* o_sint, int batch, int nj,
        int nfeet, int ncor, int substeps, int smem, double h, double armature, cudaStream_t stream) {
  const size_t need = smem_bytes(nj, nfeet, ncor, sizeof(Real));
  if (batch <= 0 || substeps < 0 || need == 0 || static_cast<size_t>(smem) != need)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args<Real> a{ftab, itab, rot, pos, q, nu, fc, anch, sint, prm, qcmd, fext, o_rot, o_pos, o_q, o_nu, o_fc,
                     o_anch, o_sint, nfeet, ncor, substeps, static_cast<Real>(h), static_cast<Real>(armature)};
  return launch<Real>(a, batch, need, stream);
}

}  // namespace

extern "C" int cmw_rigid_step_f32(const float* ftab, const long long* itab, const float* rot, const float* pos,
                                  const float* q, const float* nu, const float* fc, const float* anch,
                                  const float* sint, const float* prm, const float* qcmd, const float* fext,
                                  float* o_rot, float* o_pos, float* o_q, float* o_nu, float* o_fc, float* o_anch,
                                  float* o_sint, int batch, int nj, int nfeet, int ncor, int substeps, int smem,
                                  double h, double armature, cudaStream_t stream) {
  return run<float>(ftab, itab, rot, pos, q, nu, fc, anch, sint, prm, qcmd, fext, o_rot, o_pos, o_q, o_nu, o_fc,
                    o_anch, o_sint, batch, nj, nfeet, ncor, substeps, smem, h, armature, stream);
}

extern "C" int cmw_rigid_step_f64(const double* ftab, const long long* itab, const double* rot, const double* pos,
                                  const double* q, const double* nu, const double* fc, const double* anch,
                                  const double* sint, const double* prm, const double* qcmd, const double* fext,
                                  double* o_rot, double* o_pos, double* o_q, double* o_nu, double* o_fc,
                                  double* o_anch, double* o_sint, int batch, int nj, int nfeet, int ncor,
                                  int substeps, int smem, double h, double armature, cudaStream_t stream) {
  return run<double>(ftab, itab, rot, pos, q, nu, fc, anch, sint, prm, qcmd, fext, o_rot, o_pos, o_q, o_nu, o_fc,
                     o_anch, o_sint, batch, nj, nfeet, ncor, substeps, smem, h, armature, stream);
}
