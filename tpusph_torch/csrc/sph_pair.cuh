// Pair physics shared by the strip, column, band and compacted sweeps
// (strip_sweeps.cu, column_sweeps.cu, band_sweeps.cu, compact_force.cu): the
// smoothing kernels, the equations of state, and for each sweep how a block
// stages one j row in shared memory, what one (i, j) pair adds to i's sums,
// and how i's sums are written. The forms
// mirror tpusph_torch/ops/tile_physics.py term by term; every kernel that
// includes this header is held against the plain PyTorch version built on
// that module. Compiled without fast-math: IEEE divides and square roots;
// the smoothing kernels' divides by per type-pair constants are done once
// per block (load_tables), not once per pair.
#pragma once

#include <cuda_runtime.h>

namespace sph {

// packed field rows (tpusph_torch/ops/rows.py)
enum { RX = 0, RY, RZ, RM, RTYPE, RRHO, RSLOT, RMIX, RVX, RVY, RVZ, RE,
       RCGX, RCGY, RCGZ, RCV };
// output rows
enum { OFX = 0, OFY, OFZ, ODRHO, ODE, ORHO, OCGX, OCGY };
// TABLES_2D order
enum { T_CUT = 0, T_VISC, T_HEATD, T_CUTHEAT, T_SIGMA, T_CUTTEN, T_CUTRHO,
       T_TSAT };
// TABLES_1D order
enum { V_RHO0 = 0, V_TAITB, V_C0, V_GAMMA, V_COLOR };
// spec flag bits (strip_pair._FLAG_BITS)
enum { FL_ND = 1, FL_TAIT = 2, FL_MORRIS = 4, FL_IDEAL = 8, FL_LJ = 16,
       FL_HEAT = 32, FL_HEATPC = 64, FL_ST = 128, FL_CONT = 256,
       FL_VIRIAL = 512 };
// kernels.py ids
enum { K_LUCY = 0, K_CUBIC, K_QUINTIC, K_WENDLAND };

constexpr double kPi = 3.14159265358979323846;
constexpr float LJ_VDW_A = 4.6709f;
constexpr float LJ_VDW_B = 1.0549f;
constexpr float LJ_DENOM_FLOOR = 0.05f;
// staged position of a row that is no candidate: every cutoff test fails
// (its rsq stays finite, ~1e36)
constexpr float kFar = 1e18f;

enum Sweep { SW_RHO = 0, SW_CGRAD = 1, SW_FORCE = 2 };

// staged j fields per sweep; the first three are the shifted position
enum { SR_X = 0, SR_Y, SR_Z, SR_M, SR_TYPE, SR_NF };
enum { SC_X = 0, SC_Y, SC_Z, SC_TYPE, SC_MRHO, SC_NF };
enum { SF_X = 0, SF_Y, SF_Z, SF_VX, SF_VY, SF_VZ, SF_RHO, SF_E, SF_M,
       SF_TYPE, SF_IRHO, SF_FJ, SF_CJ, SF_CGX, SF_CGY, SF_CGZ, SF_INR,
       SF_AJ, SF_NF };

template <int SWEEP>
struct NumFields;
template <> struct NumFields<SW_RHO> { static constexpr int v = SR_NF; };
template <> struct NumFields<SW_CGRAD> { static constexpr int v = SC_NF; };
template <> struct NumFields<SW_FORCE> { static constexpr int v = SF_NF; };

struct Phys {
  int dim, kern, flags, T1;
  float cutmax2;  // the sweep's largest squared cutoff
};

// ---- smoothing kernels: tpusph/kernels.py forms, float32 ----------------

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ float pos5(float x) {
  float p = fmaxf(x, 0.f), p2 = p * p;
  return p2 * p2 * p;
}

__device__ __forceinline__ float pos4(float x) {
  float p = fmaxf(x, 0.f), p2 = p * p;
  return p2 * p2;
}

// Per type-pair constants of one cutoff table, cached in shared memory by
// load_tables: every value that kern_w / kern_wfd derive from the cutoff
// alone, each formed with the float32 expression, in the order, of the
// per-pair form (tpusph/kernels.py), so the cached value is expected to be
// bit for bit the one a pair would compute (a product the per-pair form let
// the compiler contract into an FMA could differ; the sweeps are held to
// their plain versions' tolerance bars). What is left per pair is the
// r-dependent arithmetic (and, for the spline kernels, the divides by h and
// h*h whose operands depend on r: replacing them by reciprocals would
// change the bits).
//   cut   fmaxf(table cut, 1e-30): the smoothing length the kernels take
//   cut2  table cut squared where the cut is positive, else 0: the pair's
//         cutoff test (the pair is live, so rsq > 1e-12 > 0 fails it)
//   Lucy      k0 s6 = ((s/cut)/cut)/cut   k1 1/cut   k2 (s5/cut)/cut
//   cubic     k0 s                        k1 h       k2 h*h
//   quintic   k0 s                        k1 h       k2 h*h
//   Wendland  k0 s4 = (((s/cut)/cut)/cut)/cut   k1 1/cut   k2 s5/cut
struct KConst {
  float cut, cut2, k0, k1, k2;
};
enum { KC_NF = 5 };
// the cutoff tables the sweeps read, in cache order
enum { KC_CUT = 0, KC_HEAT, KC_TEN, KC_RHO, KC_NT };

__device__ inline KConst make_kconst(int kern, int dim, float raw) {
  KConst c;
  const float cut = fmaxf(raw, 1e-30f);
  c.cut = cut;
  c.cut2 = raw > 0.f ? raw * raw : 0.f;
  if (kern == K_LUCY) {
    const float s = dim == 3
        ? (float)(105.0 / (16.0 * kPi)) / (cut * cut * cut)
        : (float)(5.0 / kPi) / (cut * cut);
    const float s5 = ((-12.f * s) / cut) / cut;
    c.k0 = ((s / cut) / cut) / cut;
    c.k1 = 1.f / cut;
    c.k2 = (s5 / cut) / cut;
  } else if (kern == K_CUBIC) {
    const float h = cut / 2.f;
    c.k0 = dim == 3 ? 1.f / ((float)kPi * h * h * h)
                    : 10.f / ((float)(7.0 * kPi) * h * h);
    c.k1 = h;
    c.k2 = h * h;
  } else if (kern == K_QUINTIC) {
    const float h = cut / 3.f;
    c.k0 = dim == 3 ? 1.f / ((float)(120.0 * kPi) * h * h * h)
                    : 7.f / ((float)(478.0 * kPi) * h * h);
    c.k1 = h;
    c.k2 = h * h;
  } else {
    const float s = dim == 3
        ? (float)(21.0 / (2.0 * kPi)) / (cut * cut * cut)
        : (float)(7.0 / kPi) / (cut * cut);
    const float s5 = ((((-20.f * s) / cut) / cut) / cut) / cut;
    c.k0 = (((s / cut) / cut) / cut) / cut;
    c.k1 = 1.f / cut;
    c.k2 = s5 / cut;
  }
  return c;
}

__device__ inline float kern_w(int kern, float r, const KConst& c) {
  const float cut = c.cut;
  if (kern == K_LUCY) {
    const float q = clampf(r * c.k1, 0.f, 1.f);
    const float d = fmaxf(cut - r, 0.f);
    return r < cut ? c.k0 * (1.f + 3.f * q) * d * d * d : 0.f;
  }
  if (kern == K_CUBIC) {
    const float u = clampf(r / c.k1, 0.f, 2.f);
    const float inner = 1.f - 1.5f * u * u + 0.75f * u * u * u;
    const float tmu = 2.f - u;
    const float outer = 0.25f * tmu * tmu * tmu;
    return r < cut ? c.k0 * (u <= 1.f ? inner : outer) : 0.f;
  }
  if (kern == K_QUINTIC) {
    const float u = clampf(r / c.k1, 0.f, 3.f);
    const float val = pos5(3.f - u) - 6.f * pos5(2.f - u)
        + 15.f * pos5(1.f - u);
    return r < cut ? c.k0 * val : 0.f;
  }
  // Wendland C2
  const float q = clampf(r * c.k1, 0.f, 1.f);
  const float d = fmaxf(cut - r, 0.f);
  const float d2 = d * d;
  return r < cut ? c.k0 * d2 * d2 * (4.f * q + 1.f) : 0.f;
}

__device__ inline float kern_wfd(int kern, float r, const KConst& c) {
  const float cut = c.cut;
  if (kern == K_LUCY) {
    const float d = fmaxf(cut - r, 0.f);
    return r < cut ? c.k2 * (d * d) : 0.f;
  }
  if (kern == K_CUBIC) {
    const float h = c.k1;
    const float u = clampf(r / h, 0.f, 2.f);
    const float tmu = 2.f - u;
    const float inner = c.k0 * (-3.f + 2.25f * u) / c.k2;
    const float r_safe = r > 0.f ? r : 1.f;
    const float outer = c.k0 * (-0.75f * tmu * tmu) / (h * r_safe);
    return r < cut ? (u <= 1.f ? inner : outer) : 0.f;
  }
  if (kern == K_QUINTIC) {
    const float u = clampf(r / c.k1, 0.f, 3.f);
    const float dwdu = -5.f * (pos4(3.f - u) - 6.f * pos4(2.f - u)
                               + 15.f * pos4(1.f - u));
    const float ratio = u > 1e-6f ? dwdu / u : -120.f;
    return r < cut ? c.k0 * ratio / c.k2 : 0.f;
  }
  const float d = fmaxf(cut - r, 0.f);
  return r < cut ? c.k2 * d * d * d : 0.f;
}

// ---- equation of state (tile_physics.eos_over_rhosq) ---------------------

__device__ __forceinline__ bool gas_eos(int flags) {
  return (flags & FL_LJ) || ((flags & FL_IDEAL) && !(flags & FL_TAIT));
}

__device__ __forceinline__ bool has_eos(int flags) {
  return flags & (FL_TAIT | FL_MORRIS | FL_IDEAL | FL_LJ);
}

__device__ inline float eos_over_rhosq(int flags, float rho, float e, float m,
                                       float rho0, float b, float gamma) {
  float p;
  if (flags & FL_LJ) {
    float t = (gamma - 1.f) * e / m;
    float denom = fmaxf(1.f - LJ_VDW_B * rho, LJ_DENOM_FLOOR);
    p = rho * t / denom - LJ_VDW_A * rho * rho;
  } else if ((flags & FL_IDEAL) && !(flags & FL_TAIT)) {
    p = (gamma - 1.f) * rho * e / m;
  } else {
    float q = rho / rho0;
    float q3 = q * q * q;
    p = b * (q3 * q3 * q - 1.f);
  }
  return p / (rho * rho);
}

__device__ inline float gas_sound_speed(int flags, float rho, float e,
                                        float m, float gamma) {
  if (flags & FL_LJ) {
    float t = (gamma - 1.f) * e / m;
    float denom = fmaxf(1.f - LJ_VDW_B * rho, LJ_DENOM_FLOOR);
    return sqrtf(fmaxf(gamma * t / (denom * denom) - 2.f * LJ_VDW_A * rho,
                       0.f));
  }
  return sqrtf(fmaxf(gamma * (gamma - 1.f) * e / m, 0.f));
}

// ---- coefficient tables in shared memory --------------------------------

__host__ __device__ __forceinline__ int table_floats(int T1) {
  return 8 * T1 * T1 + 5 * T1 + KC_NF * KC_NT * T1 * T1;
}

// tab2 [8][T1][T1] and tab1 [5][T1] (params.DeviceTables) in shared memory,
// and the smoothing-kernel constants of the four cutoff tables,
// [KC_NF][KC_NT][T1][T1]
struct Tables {
  const float* t2;
  const float* t1;
  const float* kt;
  int T1;
  __device__ __forceinline__ float c2(int t, int a, int b) const {
    return t2[(t * T1 + a) * T1 + b];
  }
  __device__ __forceinline__ float c1(int t, int a) const {
    return t1[t * T1 + a];
  }
  __device__ __forceinline__ KConst kc(int t, int a, int b) const {
    const int stride = KC_NT * T1 * T1;
    const float* e = kt + (t * T1 + a) * T1 + b;
    return KConst{e[0], e[stride], e[2 * stride], e[3 * stride],
                  e[4 * stride]};
  }
};

// Copies the tables to the start of `smem` and derives the kernel constants
// from them; the caller's next barrier publishes both.
__device__ __forceinline__ Tables load_tables(float* smem, const float* tab2g,
                                              const float* tab1g,
                                              const Phys& p) {
  const int T1 = p.T1;
  float* t2 = smem;
  float* t1 = smem + 8 * T1 * T1;
  float* kt = t1 + 5 * T1;
  for (int k = threadIdx.x; k < 8 * T1 * T1; k += blockDim.x) t2[k] = tab2g[k];
  for (int k = threadIdx.x; k < 5 * T1; k += blockDim.x) t1[k] = tab1g[k];
  const int stride = KC_NT * T1 * T1;
  for (int k = threadIdx.x; k < stride; k += blockDim.x) {
    const int t = k / (T1 * T1), ab = k - t * T1 * T1;
    const int src = t == KC_CUT ? T_CUT
                  : t == KC_HEAT ? T_CUTHEAT
                  : t == KC_TEN ? T_CUTTEN : T_CUTRHO;
    const KConst c = make_kconst(p.kern, p.dim, tab2g[src * T1 * T1 + ab]);
    kt[k] = c.cut;
    kt[stride + k] = c.cut2;
    kt[2 * stride + k] = c.k0;
    kt[3 * stride + k] = c.k1;
    kt[4 * stride + k] = c.k2;
  }
  return Tables{t2, t1, kt, T1};
}

// ---- the i row: values hoisted out of the candidate loop ----------------
// (tile_physics.hoist_i)

struct IRow {
  int t;
  float x, y, z, m, rho, inv_rho;
  float vx, vy, vz, e, cv, fi, ci;  // force
  float color;                      // cgrad
  float cgx, cgy, cgz, a, b;        // force, capillary terms
  bool st;                          // capillary terms on
};

template <int SWEEP>
__device__ __forceinline__ IRow load_i(const float* __restrict__ fld, int n,
                                       int i, const Tables& tb,
                                       const Phys& p, bool st) {
  IRow r{};
  r.t = (int)fld[RTYPE * n + i];
  r.x = fld[RX * n + i];
  r.y = fld[RY * n + i];
  r.z = fld[RZ * n + i];
  r.m = fld[RM * n + i];
  r.rho = fld[RRHO * n + i];
  r.inv_rho = 1.f / r.rho;
  r.st = st;
  if (SWEEP == SW_FORCE) {
    r.vx = fld[RVX * n + i];
    r.vy = fld[RVY * n + i];
    r.vz = fld[RVZ * n + i];
    r.e = fld[RE * n + i];
    r.cv = fld[RCV * n + i];
    if (has_eos(p.flags)) {
      r.fi = eos_over_rhosq(p.flags, r.rho, r.e, r.m, tb.c1(V_RHO0, r.t),
                            tb.c1(V_TAITB, r.t), tb.c1(V_GAMMA, r.t));
      r.ci = gas_eos(p.flags) ? gas_sound_speed(p.flags, r.rho, r.e, r.m,
                                                tb.c1(V_GAMMA, r.t))
                              : tb.c1(V_C0, r.t);
    }
    if (st) {
      r.cgx = fld[RCGX * n + i];
      r.cgy = fld[RCGY * n + i];
      r.cgz = fld[RCGZ * n + i];
      float cg2 = r.cgx * r.cgx + r.cgy * r.cgy + r.cgz * r.cgz;
      float inv_nr = 1.f / (sqrtf(fmaxf(cg2, 1e-12f)) * r.rho * r.rho);
      r.a = cg2 * inv_nr / (float)p.dim;
      r.b = inv_nr;
    }
  }
  if (SWEEP == SW_CGRAD) r.color = tb.c1(V_COLOR, r.t);
  return r;
}

// ---- staging: row j of fld into column k of win ([NF][ld] floats) -------
// The image shift (sx, sy, sz) is added to the position here, so a pair's
// dx = x_i - (x_j + shift) is formed as x_i - staged, in that order. A row
// that is no candidate (`live` false) is staged at kFar; its other fields
// are not read.

template <int SWEEP>
__device__ __forceinline__ void stage_j(float* __restrict__ win, int ld, int k,
                                        const float* __restrict__ fld, int n,
                                        int j, float sx, float sy, float sz,
                                        bool live, const Tables& tb,
                                        const Phys& p) {
  if (!live) {
    win[0 * ld + k] = kFar;
    win[1 * ld + k] = kFar;
    win[2 * ld + k] = kFar;
    return;
  }
  win[0 * ld + k] = fld[RX * n + j] + sx;
  win[1 * ld + k] = fld[RY * n + j] + sy;
  win[2 * ld + k] = fld[RZ * n + j] + sz;
  const float tj_f = fld[RTYPE * n + j];
  if (SWEEP == SW_RHO) {
    win[SR_M * ld + k] = fld[RM * n + j];
    win[SR_TYPE * ld + k] = tj_f;
  } else if (SWEEP == SW_CGRAD) {
    win[SC_TYPE * ld + k] = tj_f;
    win[SC_MRHO * ld + k] = fld[RM * n + j] * (1.f / fld[RRHO * n + j]);
  } else {
    const int tj = (int)tj_f;
    const float rho_j = fld[RRHO * n + j], e_j = fld[RE * n + j],
                m_j = fld[RM * n + j];
    win[SF_VX * ld + k] = fld[RVX * n + j];
    win[SF_VY * ld + k] = fld[RVY * n + j];
    win[SF_VZ * ld + k] = fld[RVZ * n + j];
    win[SF_RHO * ld + k] = rho_j;
    win[SF_E * ld + k] = e_j;
    win[SF_M * ld + k] = m_j;
    win[SF_TYPE * ld + k] = tj_f;
    win[SF_IRHO * ld + k] = 1.f / rho_j;
    float fj = 0.f, cj = 0.f;
    if (has_eos(p.flags)) {
      fj = eos_over_rhosq(p.flags, rho_j, e_j, m_j, tb.c1(V_RHO0, tj),
                          tb.c1(V_TAITB, tj), tb.c1(V_GAMMA, tj));
      cj = gas_eos(p.flags) ? gas_sound_speed(p.flags, rho_j, e_j, m_j,
                                              tb.c1(V_GAMMA, tj))
                            : tb.c1(V_C0, tj);
    }
    win[SF_FJ * ld + k] = fj;
    win[SF_CJ * ld + k] = cj;
    if (p.flags & FL_ST) {
      const float gx = fld[RCGX * n + j], gy = fld[RCGY * n + j],
                  gz = fld[RCGZ * n + j];
      const float cg2 = gx * gx + gy * gy + gz * gz;
      const float inr = 1.f / (sqrtf(fmaxf(cg2, 1e-12f)) * rho_j * rho_j);
      win[SF_CGX * ld + k] = gx;
      win[SF_CGY * ld + k] = gy;
      win[SF_CGZ * ld + k] = gz;
      win[SF_INR * ld + k] = inr;
      win[SF_AJ * ld + k] = cg2 * inr / (float)p.dim;
    }
  }
}

// ---- one pair: staged row k's contribution to i's sums ------------------
// acc: rho [0]; cgrad [0..2] the colour gradient; force [0..5] f, drho, de,
// virial. A candidate is live when 1e-12 < rsq < the sweep's largest
// squared cutoff (pair_live: a self-pair, a far-staged row and a row beyond
// every cutoff fail it); pair_body adds a live pair's terms. pair_sum is
// both, for the kernels that test every candidate in the body's loop
// (the one-pass check kernels, the compacted sweep over its survivors);
// the filtered sweeps test first and run the body on the live pairs
// (warp_filter.cuh). Both paths form dx and rsq with pair_rsq, so they
// keep the same pairs and sum the same bits.

__device__ __forceinline__ float pair_rsq(const float* __restrict__ win,
                                          int ld, int k, const IRow& ir,
                                          float& dx0, float& dx1,
                                          float& dx2) {
  dx0 = ir.x - win[0 * ld + k];
  dx1 = ir.y - win[1 * ld + k];
  dx2 = ir.z - win[2 * ld + k];
  return dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
}

__device__ __forceinline__ bool pair_live(float rsq, float cutmax2) {
  return rsq > 1e-12f && rsq < cutmax2;
}

template <int SWEEP>
__device__ __forceinline__ void pair_body(const float* __restrict__ win,
                                          int ld, int k, const IRow& ir,
                                          const Tables& tb, const Phys& p,
                                          float dx0, float dx1, float dx2,
                                          float rsq, float acc[6]) {
  const float r = sqrtf(fmaxf(rsq, 1e-30f));
  const int flags = p.flags;
  const int ti = ir.t;

  if (SWEEP == SW_RHO) {
    const int tj = (int)win[SR_TYPE * ld + k];
    const KConst kc = tb.kc(KC_RHO, ti, tj);
    if (rsq < kc.cut2) {
      const float mass = (flags & FL_ND) ? 1.f : win[SR_M * ld + k];
      acc[0] += mass * kern_w(p.kern, r, kc);
    }
  } else if (SWEEP == SW_CGRAD) {
    const int tj = (int)win[SC_TYPE * ld + k];
    // a pair of one colour adds exactly zero
    const float dcolor = tb.c1(V_COLOR, tj) - ir.color;
    if (dcolor == 0.f) return;
    const KConst kc = tb.kc(KC_TEN, ti, tj);
    if (rsq < kc.cut2) {
      const float wfd = kern_wfd(p.kern, r, kc);
      const float coef = tb.c2(T_SIGMA, ti, tj) * win[SC_MRHO * ld + k]
          * dcolor * wfd;
      acc[0] += coef * dx0;
      acc[1] += coef * dx1;
      acc[2] += coef * dx2;
    }
  } else {
    const int tj = (int)win[SF_TYPE * ld + k];
    const float rho_j = win[SF_RHO * ld + k];
    const float m_j = win[SF_M * ld + k];
    const float inv_rho_j = win[SF_IRHO * ld + k];
    const float m_i = ir.m, rho_i = ir.rho, inv_rho_i = ir.inv_rho;
    const float dv0 = ir.vx - win[SF_VX * ld + k];
    const float dv1 = ir.vy - win[SF_VY * ld + k];
    const float dv2 = ir.vz - win[SF_VZ * ld + k];
    const float dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2;
    float f0 = 0.f, f1 = 0.f, f2 = 0.f, drho = 0.f, de = 0.f;
    if (has_eos(flags)) {
      const KConst kc = tb.kc(KC_CUT, ti, tj);
      if (rsq < kc.cut2) {
        const float wfd = kern_wfd(p.kern, r, kc);
        const float fj = win[SF_FJ * ld + k];
        const float visc = tb.c2(T_VISC, ti, tj);
        if (flags & FL_MORRIS) {
          const float fvisc =
              (m_i * inv_rho_i) * (m_j * inv_rho_j) * 2.f * visc * wfd;
          const float fpair = -m_i * m_j * (ir.fi + fj) * wfd;
          f0 += fpair * dx0 + fvisc * dv0;
          f1 += fpair * dx1 + fvisc * dv1;
          f2 += fpair * dx2 + fvisc * dv2;
          const float dvsq = dv0 * dv0 + dv1 * dv1 + dv2 * dv2;
          de += -0.5f * (fpair * dvdr + fvisc * dvsq);
        } else {
          const float h_ij = kc.cut;
          const float cj = win[SF_CJ * ld + k];
          // mu and the Monaghan prefactor fused into one divide
          const float fvisc = dvdr < 0.f
              ? -visc * (ir.ci + cj) * h_ij * dvdr
                    / ((rsq + 0.01f * h_ij * h_ij) * (rho_i + rho_j))
              : 0.f;
          const float fpair = -m_i * m_j * (ir.fi + fj + fvisc) * wfd;
          f0 += fpair * dx0;
          f1 += fpair * dx1;
          f2 += fpair * dx2;
          de += -0.5f * fpair * dvdr;
        }
        if (flags & FL_CONT) drho += m_j * dvdr * wfd;
      }
    }
    if (flags & (FL_HEAT | FL_HEATPC)) {
      const KConst kc = tb.kc(KC_HEAT, ti, tj);
      if (rsq < kc.cut2) {
        const float wfd = kern_wfd(p.kern, r, kc);
        const float coef = (2.f * m_i * m_j / (m_i + m_j))
            * (inv_rho_i + inv_rho_j);
        float ediff = ir.e - win[SF_E * ld + k];
        if (flags & FL_HEATPC) {
          // tsat > 0 pairs conduct against cv_i*T_sat
          const float tsat = tb.c2(T_TSAT, ti, tj);
          if (tsat > 0.f) ediff = ir.e - ir.cv * tsat;
        }
        de += coef * tb.c2(T_HEATD, ti, tj) * ediff * wfd;
      }
    }
    if (ir.st) {
      const KConst kc = tb.kc(KC_TEN, ti, tj);
      if (rsq < kc.cut2) {
        const float wfd = kern_wfd(p.kern, r, kc);
        const float coef = m_i * m_j * wfd;
        const float gx = win[SF_CGX * ld + k];
        const float gy = win[SF_CGY * ld + k];
        const float gz = win[SF_CGZ * ld + k];
        const float inr = win[SF_INR * ld + k];
        const float aij = ir.a + win[SF_AJ * ld + k];
        const float cdi = (ir.cgx * dx0 + ir.cgy * dx1 + ir.cgz * dx2) * ir.b;
        const float cdj = (gx * dx0 + gy * dx1 + gz * dx2) * inr;
        f0 += coef * (aij * dx0 - cdi * ir.cgx - cdj * gx);
        f1 += coef * (aij * dx1 - cdi * ir.cgy - cdj * gy);
        f2 += coef * (aij * dx2 - cdi * ir.cgz - cdj * gz);
      }
    }
    acc[0] += f0;
    acc[1] += f1;
    acc[2] += f2;
    acc[3] += drho;
    acc[4] += de;
    // pair virial f_ij . r_ij of the pair's summed terms
    if (flags & FL_VIRIAL) acc[5] += f0 * dx0 + f1 * dx1 + f2 * dx2;
  }
}

template <int SWEEP>
__device__ __forceinline__ void pair_sum(const float* __restrict__ win,
                                         int ld, int k, const IRow& ir,
                                         const Tables& tb, const Phys& p,
                                         float acc[6]) {
  float dx0, dx1, dx2;
  const float rsq = pair_rsq(win, ld, k, ir, dx0, dx1, dx2);
  if (!pair_live(rsq, p.cutmax2)) return;
  pair_body<SWEEP>(win, ld, k, ir, tb, p, dx0, dx1, dx2, rsq, acc);
}

// ---- i's sums to its output rows ------------------------------------------
// rho adds the rhosum self term W(0, cut_rho[t][t]) (x m_i for the mass
// form); an inactive row writes zeros.

template <int SWEEP>
__device__ __forceinline__ void write_out(float* __restrict__ out, int n,
                                          int i, bool active, const IRow& ir,
                                          const Tables& tb, const Phys& p,
                                          const float acc[6]) {
  if (SWEEP == SW_RHO) {
    float self = 0.f;
    if (active) {
      const float w0 = tb.c2(T_CUTRHO, ir.t, ir.t) > 0.f
          ? kern_w(p.kern, 0.f, tb.kc(KC_RHO, ir.t, ir.t)) : 0.f;
      self = (p.flags & FL_ND) ? w0 : ir.m * w0;
    }
    out[ORHO * n + i] = active ? acc[0] + self : 0.f;
  } else if (SWEEP == SW_CGRAD) {
    out[OCGX * n + i] = active ? acc[0] : 0.f;
    out[OCGY * n + i] = active ? acc[1] : 0.f;
    out[ODE * n + i] = active ? acc[2] : 0.f;
  } else {
    out[OFX * n + i] = acc[0];
    out[OFY * n + i] = acc[1];
    out[OFZ * n + i] = acc[2];
    out[ODRHO * n + i] = acc[3];
    out[ODE * n + i] = acc[4];
    out[ORHO * n + i] = acc[5];
  }
}

}  // namespace sph
