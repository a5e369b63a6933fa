// Strip pair sweeps (rho, colour gradient, force) and the phase-change vapor
// query for Hopper (sm_90a).
//
// The three pair sweeps replace the Pallas TPU kernel
// tpusph/ops/strip_pair.py::make_strip_kernel (the pl.pallas_call at
// strip_pair.py:1233), one launcher per sweep; the vapor sweep at the end of
// this file replaces make_vapor_kernel. The
// physics mirrors tpusph/ops/tile_physics.py term by term; the plain
// PyTorch version in tpusph_torch/ops/strip_pair.py::plain_sweep is the
// reference these kernels are held against.
//
// Layout. fld is the (16, n_slots) float32 field matrix (rows as R* in
// tpusph_torch/ops/pallas_pair.py), slot = column * col_cap + row. The
// output is the (8, n_slots) matrix with the O* row meanings.
//
// Work split. One thread per i-row, one block per (column c, block b) of
// t_blk tiles of ts rows. For neighbour offset kk the j-column is
// perm[c][kk] (-1: none), the retargeted block is
// bb = clip(b + delta[c][kk][b], 0, nblocks-1), and tile t = b*t_blk + tt
// reads the rank window of tile t' = bb*t_blk + tt:
// rows [ts*t' - ch*mlo, ts*t' + ts + ch*mhi) clipped to the column.
// All tiles of a block share bb, so the block stages the union of its
// tiles' windows in shared memory once per offset; each thread then scans
// exactly its own tile's window.
//
// What bounds it: instruction throughput. Each i-row scans nnbr*W candidates
// (about 3.5k at the 1M bench geometry) of which a few percent lie within
// the cutoff. A candidate is rejected after three shared loads and one
// compare against the sweep's largest squared cutoff; per-j terms (EOS
// p/rho^2, sound speed, 1/rho, tension norms) are computed once while
// staging rather than once per pair; coefficient tables sit in shared
// memory. Tiles whose mixed-phase flag shows the capillary terms are
// exactly zero skip them (force), or write zeros (cgrad), as the TPU
// kernel does. Built without fast-math: IEEE divides and square roots.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 128;

// packed field rows (pallas_pair.py)
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

enum Sweep { SW_RHO = 0, SW_CGRAD = 1, SW_FORCE = 2 };

// staged j fields per sweep
enum { SR_X = 0, SR_Y, SR_Z, SR_M, SR_TYPE, SR_NF };
enum { SC_X = 0, SC_Y, SC_Z, SC_TYPE, SC_MRHO, SC_NF };
enum { SF_X = 0, SF_Y, SF_Z, SF_VX, SF_VY, SF_VZ, SF_RHO, SF_E, SF_M,
       SF_TYPE, SF_IRHO, SF_FJ, SF_CJ, SF_CGX, SF_CGY, SF_CGZ, SF_INR,
       SF_AJ, SF_NF };

struct Geo {
  int n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr;
};

struct Phys {
  int dim, kern, flags, T1;
  float cutmax2;
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

__device__ float kern_w(int kern, int dim, float r, float cut) {
  if (kern == K_LUCY) {
    float s = dim == 3 ? (float)(105.0 / (16.0 * kPi)) / (cut * cut * cut)
                       : (float)(5.0 / kPi) / (cut * cut);
    float icut = 1.f / cut;
    float q = clampf(r * icut, 0.f, 1.f);
    float s6 = ((s / cut) / cut) / cut;
    float d = fmaxf(cut - r, 0.f);
    return r < cut ? s6 * (1.f + 3.f * q) * d * d * d : 0.f;
  }
  if (kern == K_CUBIC) {
    float h = cut / 2.f;
    float u = clampf(r / h, 0.f, 2.f);
    float s = dim == 3 ? 1.f / ((float)kPi * h * h * h)
                       : 10.f / ((float)(7.0 * kPi) * h * h);
    float inner = 1.f - 1.5f * u * u + 0.75f * u * u * u;
    float tmu = 2.f - u;
    float outer = 0.25f * tmu * tmu * tmu;
    return r < cut ? s * (u <= 1.f ? inner : outer) : 0.f;
  }
  if (kern == K_QUINTIC) {
    float h = cut / 3.f;
    float u = clampf(r / h, 0.f, 3.f);
    float s = dim == 3 ? 1.f / ((float)(120.0 * kPi) * h * h * h)
                       : 7.f / ((float)(478.0 * kPi) * h * h);
    float val = pos5(3.f - u) - 6.f * pos5(2.f - u) + 15.f * pos5(1.f - u);
    return r < cut ? s * val : 0.f;
  }
  // Wendland C2
  float s = dim == 3 ? (float)(21.0 / (2.0 * kPi)) / (cut * cut * cut)
                     : (float)(7.0 / kPi) / (cut * cut);
  float icut = 1.f / cut;
  float q = clampf(r * icut, 0.f, 1.f);
  float s4 = (((s / cut) / cut) / cut) / cut;
  float d = fmaxf(cut - r, 0.f);
  float d2 = d * d;
  return r < cut ? s4 * d2 * d2 * (4.f * q + 1.f) : 0.f;
}

__device__ float kern_wfd(int kern, int dim, float r, float cut) {
  if (kern == K_LUCY) {
    float s = dim == 3 ? (float)(105.0 / (16.0 * kPi)) / (cut * cut * cut)
                       : (float)(5.0 / kPi) / (cut * cut);
    float s5 = ((-12.f * s) / cut) / cut;
    float d = fmaxf(cut - r, 0.f);
    return r < cut ? (s5 / cut) / cut * (d * d) : 0.f;
  }
  if (kern == K_CUBIC) {
    float h = cut / 2.f;
    float u = clampf(r / h, 0.f, 2.f);
    float s = dim == 3 ? 1.f / ((float)kPi * h * h * h)
                       : 10.f / ((float)(7.0 * kPi) * h * h);
    float tmu = 2.f - u;
    float inner = s * (-3.f + 2.25f * u) / (h * h);
    float r_safe = r > 0.f ? r : 1.f;
    float outer = s * (-0.75f * tmu * tmu) / (h * r_safe);
    return r < cut ? (u <= 1.f ? inner : outer) : 0.f;
  }
  if (kern == K_QUINTIC) {
    float h = cut / 3.f;
    float u = clampf(r / h, 0.f, 3.f);
    float s = dim == 3 ? 1.f / ((float)(120.0 * kPi) * h * h * h)
                       : 7.f / ((float)(478.0 * kPi) * h * h);
    float dwdu = -5.f * (pos4(3.f - u) - 6.f * pos4(2.f - u)
                         + 15.f * pos4(1.f - u));
    float ratio = u > 1e-6f ? dwdu / u : -120.f;
    return r < cut ? s * ratio / (h * h) : 0.f;
  }
  float s = dim == 3 ? (float)(21.0 / (2.0 * kPi)) / (cut * cut * cut)
                     : (float)(7.0 / kPi) / (cut * cut);
  float s5 = ((((-20.f * s) / cut) / cut) / cut) / cut;
  float d = fmaxf(cut - r, 0.f);
  return r < cut ? (s5 / cut) * d * d * d : 0.f;
}

// ---- equation of state (tile_physics._eos_over_rhosq) --------------------

__device__ __forceinline__ bool gas_eos(int flags) {
  return (flags & FL_LJ) || ((flags & FL_IDEAL) && !(flags & FL_TAIT));
}

__device__ float eos_over_rhosq(int flags, float rho, float e, float m,
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

__device__ float gas_sound_speed(int flags, float rho, float e, float m,
                                 float gamma) {
  if (flags & FL_LJ) {
    float t = (gamma - 1.f) * e / m;
    float denom = fmaxf(1.f - LJ_VDW_B * rho, LJ_DENOM_FLOOR);
    return sqrtf(fmaxf(gamma * t / (denom * denom) - 2.f * LJ_VDW_A * rho,
                       0.f));
  }
  return sqrtf(fmaxf(gamma * (gamma - 1.f) * e / m, 0.f));
}

template <int SWEEP>
struct NumFields;
template <> struct NumFields<SW_RHO> { static constexpr int v = SR_NF; };
template <> struct NumFields<SW_CGRAD> { static constexpr int v = SC_NF; };
template <> struct NumFields<SW_FORCE> { static constexpr int v = SF_NF; };

__host__ __device__ __forceinline__ int max_window_rows(const Geo& g) {
  return g.t_blk * g.ts + g.ch * (g.mlo + g.mhi);
}

template <int SWEEP>
__global__ void __launch_bounds__(kMaxThreads)
strip_sweep_kernel(const float* __restrict__ fld,
                   const int* __restrict__ perm,
                   const float* __restrict__ shift,
                   const int* __restrict__ delta,
                   const float* __restrict__ tab2g,
                   const float* __restrict__ tab1g, Geo g, Phys p,
                   float* __restrict__ out) {
  extern __shared__ float smem[];
  const int T1 = p.T1;
  float* tab2 = smem;                        // [8][T1][T1]
  float* tab1 = tab2 + 8 * T1 * T1;          // [5][T1]
  float* win = tab1 + 5 * T1;                // [NF][maxrows]
  const int maxrows = max_window_rows(g);
  for (int k = threadIdx.x; k < 8 * T1 * T1; k += blockDim.x)
    tab2[k] = tab2g[k];
  for (int k = threadIdx.x; k < 5 * T1; k += blockDim.x) tab1[k] = tab1g[k];
#define TAB2(t, a, b) tab2[((t) * T1 + (a)) * T1 + (b)]
#define TAB1(t, a) tab1[(t) * T1 + (a)]

  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int brows = g.t_blk * g.ts;
  const int tt = threadIdx.x / g.ts;
  const int i = c * g.col_cap + b * brows + threadIdx.x;
  const int flags = p.flags;

  const float type_i = fld[RTYPE * n + i];
  const bool alive = type_i > 0.5f;
  const float mix_i = fld[RMIX * n + i];
  bool active = alive;
  if (SWEEP == SW_CGRAD) active = alive && mix_i > 0.75f;
  // (also the barrier that publishes the tables)
  if (!__syncthreads_or(active)) {
    if (SWEEP == SW_RHO) {
      out[ORHO * n + i] = 0.f;
    } else if (SWEEP == SW_CGRAD) {
      out[OCGX * n + i] = 0.f;
      out[OCGY * n + i] = 0.f;
      out[ODE * n + i] = 0.f;
    } else {
      for (int o = OFX; o <= ORHO; ++o) out[o * n + i] = 0.f;
    }
    return;
  }

  const int ti = (int)type_i;
  const float xi = fld[RX * n + i], yi = fld[RY * n + i],
              zi = fld[RZ * n + i];
  const float m_i = fld[RM * n + i];
  const float rho_i = fld[RRHO * n + i];
  const float inv_rho_i = 1.f / rho_i;
  // i-side hoists (tile_physics.hoist_i)
  float vxi = 0.f, vyi = 0.f, vzi = 0.f, e_i = 0.f, cv_i = 0.f;
  float fi = 0.f, ci = 0.f, color_i = 0.f;
  float cgx_i = 0.f, cgy_i = 0.f, cgz_i = 0.f, a_i = 0.f, b_i = 0.f;
  const bool eos = flags & (FL_TAIT | FL_MORRIS | FL_IDEAL | FL_LJ);
  // the tile's flag says whether any candidate carries a colour gradient
  const bool st = (flags & FL_ST) && mix_i > 0.25f;
  if (SWEEP == SW_FORCE) {
    vxi = fld[RVX * n + i];
    vyi = fld[RVY * n + i];
    vzi = fld[RVZ * n + i];
    e_i = fld[RE * n + i];
    cv_i = fld[RCV * n + i];
    if (eos) {
      fi = eos_over_rhosq(flags, rho_i, e_i, m_i, TAB1(V_RHO0, ti),
                          TAB1(V_TAITB, ti), TAB1(V_GAMMA, ti));
      ci = gas_eos(flags) ? gas_sound_speed(flags, rho_i, e_i, m_i,
                                            TAB1(V_GAMMA, ti))
                          : TAB1(V_C0, ti);
    }
    if (st) {
      cgx_i = fld[RCGX * n + i];
      cgy_i = fld[RCGY * n + i];
      cgz_i = fld[RCGZ * n + i];
      float cg2 = cgx_i * cgx_i + cgy_i * cgy_i + cgz_i * cgz_i;
      float inv_nr = 1.f / (sqrtf(fmaxf(cg2, 1e-12f)) * rho_i * rho_i);
      a_i = cg2 * inv_nr / (float)p.dim;
      b_i = inv_nr;
    }
  }
  if (SWEEP == SW_CGRAD) color_i = TAB1(V_COLOR, ti);

  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f, acc4 = 0.f,
        acc5 = 0.f;

  for (int kk = 0; kk < g.nnbr; ++kk) {
    const int jc = perm[c * g.nnbr + kk];
    if (jc < 0) continue;  // uniform over the block
    int bb = b + delta[(c * g.nnbr + kk) * g.nblocks + b];
    bb = min(max(bb, 0), g.nblocks - 1);
    const int ulo = max(bb * brows - g.ch * g.mlo, 0);
    const int uhi = min((bb + 1) * brows + g.ch * g.mhi, g.col_cap);
    const float sx = shift[(c * g.nnbr + kk) * 2];
    const float sy = shift[(c * g.nnbr + kk) * 2 + 1];

    __syncthreads();  // the previous offset's readers are done
    for (int k = threadIdx.x; k < uhi - ulo; k += blockDim.x) {
      const int j = jc * g.col_cap + ulo + k;
      const float tj_f = fld[RTYPE * n + j];
      win[0 * maxrows + k] = fld[RX * n + j];
      win[1 * maxrows + k] = fld[RY * n + j];
      win[2 * maxrows + k] = fld[RZ * n + j];
      if (SWEEP == SW_RHO) {
        win[SR_M * maxrows + k] = fld[RM * n + j];
        win[SR_TYPE * maxrows + k] = tj_f;
      } else if (SWEEP == SW_CGRAD) {
        win[SC_TYPE * maxrows + k] = tj_f;
        win[SC_MRHO * maxrows + k] =
            fld[RM * n + j] * (1.f / fld[RRHO * n + j]);
      } else {
        const int tj = (int)tj_f;
        const float rho_j = fld[RRHO * n + j], e_j = fld[RE * n + j],
                    m_j = fld[RM * n + j];
        win[SF_VX * maxrows + k] = fld[RVX * n + j];
        win[SF_VY * maxrows + k] = fld[RVY * n + j];
        win[SF_VZ * maxrows + k] = fld[RVZ * n + j];
        win[SF_RHO * maxrows + k] = rho_j;
        win[SF_E * maxrows + k] = e_j;
        win[SF_M * maxrows + k] = m_j;
        win[SF_TYPE * maxrows + k] = tj_f;
        win[SF_IRHO * maxrows + k] = 1.f / rho_j;
        float fj = 0.f, cj = 0.f;
        if (eos) {
          fj = eos_over_rhosq(flags, rho_j, e_j, m_j, TAB1(V_RHO0, tj),
                              TAB1(V_TAITB, tj), TAB1(V_GAMMA, tj));
          cj = gas_eos(flags) ? gas_sound_speed(flags, rho_j, e_j, m_j,
                                                TAB1(V_GAMMA, tj))
                              : TAB1(V_C0, tj);
        }
        win[SF_FJ * maxrows + k] = fj;
        win[SF_CJ * maxrows + k] = cj;
        if (flags & FL_ST) {
          const float gx = fld[RCGX * n + j], gy = fld[RCGY * n + j],
                      gz = fld[RCGZ * n + j];
          const float cg2 = gx * gx + gy * gy + gz * gz;
          const float inr = 1.f / (sqrtf(fmaxf(cg2, 1e-12f)) * rho_j * rho_j);
          win[SF_CGX * maxrows + k] = gx;
          win[SF_CGY * maxrows + k] = gy;
          win[SF_CGZ * maxrows + k] = gz;
          win[SF_INR * maxrows + k] = inr;
          win[SF_AJ * maxrows + k] = cg2 * inr / (float)p.dim;
        }
      }
    }
    __syncthreads();
    if (!active) continue;

    const int tp = bb * g.t_blk + tt;
    const int wlo = max(tp * g.ts - g.ch * g.mlo, 0) - ulo;
    const int whi = min(tp * g.ts + g.ts + g.ch * g.mhi, g.col_cap) - ulo;
    for (int k = wlo; k < whi; ++k) {
      const float dx0 = xi - (win[0 * maxrows + k] + sx);
      const float dx1 = yi - (win[1 * maxrows + k] + sy);
      const float dx2 = zi - win[2 * maxrows + k];
      const float rsq = dx0 * dx0 + dx1 * dx1 + dx2 * dx2;
      // sentinel-dead liveness, then the sweep's largest cutoff
      if (!(rsq > 1e-12f) || !(rsq < p.cutmax2)) continue;
      const float r = sqrtf(fmaxf(rsq, 1e-30f));

      if (SWEEP == SW_RHO) {
        const int tj = (int)win[SR_TYPE * maxrows + k];
        const float cut = TAB2(T_CUTRHO, ti, tj);
        if (rsq < cut * cut && cut > 0.f) {
          const float mass = (flags & FL_ND) ? 1.f : win[SR_M * maxrows + k];
          acc0 += mass * kern_w(p.kern, p.dim, r, fmaxf(cut, 1e-30f));
        }
      } else if (SWEEP == SW_CGRAD) {
        const int tj = (int)win[SC_TYPE * maxrows + k];
        const float cut = TAB2(T_CUTTEN, ti, tj);
        if (rsq < cut * cut && cut > 0.f) {
          const float wfd = kern_wfd(p.kern, p.dim, r, fmaxf(cut, 1e-30f));
          const float coef = TAB2(T_SIGMA, ti, tj)
              * win[SC_MRHO * maxrows + k]
              * (TAB1(V_COLOR, tj) - color_i) * wfd;
          acc0 += coef * dx0;
          acc1 += coef * dx1;
          acc2 += coef * dx2;
        }
      } else {
        const int tj = (int)win[SF_TYPE * maxrows + k];
        const float rho_j = win[SF_RHO * maxrows + k];
        const float m_j = win[SF_M * maxrows + k];
        const float inv_rho_j = win[SF_IRHO * maxrows + k];
        const float dv0 = vxi - win[SF_VX * maxrows + k];
        const float dv1 = vyi - win[SF_VY * maxrows + k];
        const float dv2 = vzi - win[SF_VZ * maxrows + k];
        const float dvdr = dv0 * dx0 + dv1 * dx1 + dv2 * dx2;
        float f0 = 0.f, f1 = 0.f, f2 = 0.f, drho = 0.f, de = 0.f;
        if (eos) {
          const float cut = TAB2(T_CUT, ti, tj);
          if (rsq < cut * cut && cut > 0.f) {
            const float wfd = kern_wfd(p.kern, p.dim, r, fmaxf(cut, 1e-30f));
            const float fj = win[SF_FJ * maxrows + k];
            const float visc = TAB2(T_VISC, ti, tj);
            if (flags & FL_MORRIS) {
              const float fvisc =
                  (m_i * inv_rho_i) * (m_j * inv_rho_j) * 2.f * visc * wfd;
              const float fpair = -m_i * m_j * (fi + fj) * wfd;
              f0 += fpair * dx0 + fvisc * dv0;
              f1 += fpair * dx1 + fvisc * dv1;
              f2 += fpair * dx2 + fvisc * dv2;
              const float dvsq = dv0 * dv0 + dv1 * dv1 + dv2 * dv2;
              de += -0.5f * (fpair * dvdr + fvisc * dvsq);
            } else {
              const float h_ij = fmaxf(cut, 1e-30f);
              const float cj = win[SF_CJ * maxrows + k];
              // mu and the Monaghan prefactor fused into one divide
              const float fvisc = dvdr < 0.f
                  ? -visc * (ci + cj) * h_ij * dvdr
                        / ((rsq + 0.01f * h_ij * h_ij) * (rho_i + rho_j))
                  : 0.f;
              const float fpair = -m_i * m_j * (fi + fj + fvisc) * wfd;
              f0 += fpair * dx0;
              f1 += fpair * dx1;
              f2 += fpair * dx2;
              de += -0.5f * fpair * dvdr;
            }
            if (flags & FL_CONT) drho += m_j * dvdr * wfd;
          }
        }
        if (flags & (FL_HEAT | FL_HEATPC)) {
          const float cut = TAB2(T_CUTHEAT, ti, tj);
          if (rsq < cut * cut && cut > 0.f) {
            const float wfd = kern_wfd(p.kern, p.dim, r, fmaxf(cut, 1e-30f));
            const float coef = (2.f * m_i * m_j / (m_i + m_j))
                * (inv_rho_i + inv_rho_j);
            float ediff = e_i - win[SF_E * maxrows + k];
            if (flags & FL_HEATPC) {
              // tsat > 0 pairs conduct against cv_i*T_sat
              const float tsat = TAB2(T_TSAT, ti, tj);
              if (tsat > 0.f) ediff = e_i - cv_i * tsat;
            }
            de += coef * TAB2(T_HEATD, ti, tj) * ediff * wfd;
          }
        }
        if (st) {
          const float cut = TAB2(T_CUTTEN, ti, tj);
          if (rsq < cut * cut && cut > 0.f) {
            const float wfd = kern_wfd(p.kern, p.dim, r, fmaxf(cut, 1e-30f));
            const float coef = m_i * m_j * wfd;
            const float gx = win[SF_CGX * maxrows + k];
            const float gy = win[SF_CGY * maxrows + k];
            const float gz = win[SF_CGZ * maxrows + k];
            const float inr = win[SF_INR * maxrows + k];
            const float aij = a_i + win[SF_AJ * maxrows + k];
            const float cdi = (cgx_i * dx0 + cgy_i * dx1 + cgz_i * dx2) * b_i;
            const float cdj = (gx * dx0 + gy * dx1 + gz * dx2) * inr;
            f0 += coef * (aij * dx0 - cdi * cgx_i - cdj * gx);
            f1 += coef * (aij * dx1 - cdi * cgy_i - cdj * gy);
            f2 += coef * (aij * dx2 - cdi * cgz_i - cdj * gz);
          }
        }
        acc0 += f0;
        acc1 += f1;
        acc2 += f2;
        acc3 += drho;
        acc4 += de;
        // pair virial f_ij . r_ij of the pair's summed terms
        if (flags & FL_VIRIAL) acc5 += f0 * dx0 + f1 * dx1 + f2 * dx2;
      }
    }
  }

  if (SWEEP == SW_RHO) {
    float self = 0.f;
    if (active) {
      // rhosum self term: W(0, cut_rho[t][t]), x m_i for the mass form
      const float cut = TAB2(T_CUTRHO, ti, ti);
      const float w0 = cut > 0.f
          ? kern_w(p.kern, p.dim, 0.f, fmaxf(cut, 1e-30f)) : 0.f;
      self = (flags & FL_ND) ? w0 : m_i * w0;
    }
    out[ORHO * n + i] = active ? acc0 + self : 0.f;
  } else if (SWEEP == SW_CGRAD) {
    out[OCGX * n + i] = active ? acc0 : 0.f;
    out[OCGY * n + i] = active ? acc1 : 0.f;
    out[ODE * n + i] = active ? acc2 : 0.f;
  } else {
    out[OFX * n + i] = acc0;
    out[OFY * n + i] = acc1;
    out[OFZ * n + i] = acc2;
    out[ODRHO * n + i] = acc3;
    out[ODE * n + i] = acc4;
    out[ORHO * n + i] = acc5;
  }
#undef TAB2
#undef TAB1
}

template <int SWEEP>
int launch(const float* fld, const int* perm, const float* shift,
           const int* delta, const float* tab2, const float* tab1,
           float* out, int n_slots, int ncols, int col_cap, int ts, int ch,
           int t_blk, int nblocks, int mlo, int mhi, int nnbr, int dim,
           int kern, int flags, int T1, float cutmax2, void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  Phys p{dim, kern, flags, T1, cutmax2};
  const int threads = t_blk * ts;
  if (threads > kMaxThreads || threads < 1 || nblocks < 1 || ncols < 1 ||
      T1 < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float)
      * (8 * T1 * T1 + 5 * T1 + NumFields<SWEEP>::v * max_window_rows(g));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        strip_sweep_kernel<SWEEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ncols, nblocks);
  strip_sweep_kernel<SWEEP><<<grid, threads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, tab2, tab1, g, p, out);
  return (int)cudaGetLastError();
}

// ---- the vapor sweep: the fix phase_change interface query ---------------
//
// Replaces tpusph/ops/strip_pair.py::make_vapor_kernel (strip_pair.py:1251,
// the pl.pallas_call at :1348); the plain version it is held against is
// tpusph_torch/ops/strip_pair.py::plain_vapor_sweep. Same windows and work
// split as strip_sweep_kernel. Per i-row it writes the count of type-vtype
// neighbours with 1e-12 < rsq < cut2 (row ORHO), the nearest one's slot and
// rsq (OCGX, OCGY) and the nearest owned one's (OFX, OFY); 0 / kVaporBig
// where there is none. Field row RSLOT carries each slot sign-encoded
// (slot when owned, -(slot+1) for a seam ghost); slots are exact floats
// below 2^24 (the wrapper checks).
//
// Tie rule, the TPU kernel's: per offset the smallest |slot| among the rows
// at the minimum rsq, and across offsets a strictly smaller rsq replaces
// the running best, so the winner is the lexicographic minimum of
// (rsq, kk, |slot|). rsq is formed with round-to-nearest intrinsics in the
// plain version's order, ((dx0*dx0 + dx1*dx1) + dx2*dx2), never contracted
// into FMAs, so the kernel and the plain version agree bit for bit.
//
// What bounds it: instruction throughput over nnbr*W candidates per row,
// about 5 x 4 bytes read from shared memory per candidate. The design stages
// x, y, z, type and the encoded slot of the block's union window once per
// offset, rejects a candidate of another type after one shared load and
// before any arithmetic (most candidates are liquid), and keeps both running
// argmins in registers. The query runs once every `every` steps.

constexpr float kVaporBig = 1e30f;
enum { SV_X = 0, SV_Y, SV_Z, SV_TYPE, SV_SLOT, SV_NF };

__global__ void __launch_bounds__(kMaxThreads)
strip_vapor_kernel(const float* __restrict__ fld,
                   const int* __restrict__ perm,
                   const float* __restrict__ shift,
                   const int* __restrict__ delta, Geo g, int vtype,
                   float cut2, float* __restrict__ out) {
  extern __shared__ float win[];  // [SV_NF][maxrows]
  const int maxrows = max_window_rows(g);
  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int brows = g.t_blk * g.ts;
  const int tt = threadIdx.x / g.ts;
  const int i = c * g.col_cap + b * brows + threadIdx.x;
  const bool alive = fld[RTYPE * n + i] > 0.5f;

  float cnt = 0.f;
  float acc_mn = kVaporBig, acc_sl = 0.f;
  float acc_mn_o = kVaporBig, acc_sl_o = 0.f;
  if (__syncthreads_or(alive)) {
    const float xi = fld[RX * n + i], yi = fld[RY * n + i],
                zi = fld[RZ * n + i];
    const float vlo = (float)vtype - 0.5f, vhi = (float)vtype + 0.5f;
    for (int kk = 0; kk < g.nnbr; ++kk) {
      const int jc = perm[c * g.nnbr + kk];
      if (jc < 0) continue;  // uniform over the block
      int bb = b + delta[(c * g.nnbr + kk) * g.nblocks + b];
      bb = min(max(bb, 0), g.nblocks - 1);
      const int ulo = max(bb * brows - g.ch * g.mlo, 0);
      const int uhi = min((bb + 1) * brows + g.ch * g.mhi, g.col_cap);
      const float sx = shift[(c * g.nnbr + kk) * 2];
      const float sy = shift[(c * g.nnbr + kk) * 2 + 1];

      __syncthreads();  // the previous offset's readers are done
      for (int k = threadIdx.x; k < uhi - ulo; k += blockDim.x) {
        const int j = jc * g.col_cap + ulo + k;
        win[SV_X * maxrows + k] = fld[RX * n + j];
        win[SV_Y * maxrows + k] = fld[RY * n + j];
        win[SV_Z * maxrows + k] = fld[RZ * n + j];
        win[SV_TYPE * maxrows + k] = fld[RTYPE * n + j];
        win[SV_SLOT * maxrows + k] = fld[RSLOT * n + j];
      }
      __syncthreads();
      if (!alive) continue;

      const int tp = bb * g.t_blk + tt;
      const int wlo = max(tp * g.ts - g.ch * g.mlo, 0) - ulo;
      const int whi = min(tp * g.ts + g.ts + g.ch * g.mhi, g.col_cap) - ulo;
      float mn = kVaporBig, sl = kVaporBig;
      float mn_o = kVaporBig, sl_o = kVaporBig;
      for (int k = wlo; k < whi; ++k) {
        const float tj = win[SV_TYPE * maxrows + k];
        if (!(tj > vlo && tj < vhi)) continue;
        const float xj = __fadd_rn(win[SV_X * maxrows + k], sx);
        const float yj = __fadd_rn(win[SV_Y * maxrows + k], sy);
        const float dx0 = __fsub_rn(xi, xj);
        const float dx1 = __fsub_rn(yi, yj);
        const float dx2 = __fsub_rn(zi, win[SV_Z * maxrows + k]);
        const float rsq = __fadd_rn(
            __fadd_rn(__fmul_rn(dx0, dx0), __fmul_rn(dx1, dx1)),
            __fmul_rn(dx2, dx2));
        if (!(rsq > 1e-12f) || !(rsq < cut2)) continue;
        cnt += 1.f;
        const float enc = win[SV_SLOT * maxrows + k];
        const float sa = enc >= 0.f ? enc : -enc - 1.f;
        if (rsq < mn || (rsq == mn && sa < sl)) {
          mn = rsq;
          sl = sa;
        }
        if (enc >= 0.f && (rsq < mn_o || (rsq == mn_o && sa < sl_o))) {
          mn_o = rsq;
          sl_o = sa;
        }
      }
      if (mn < acc_mn) {
        acc_mn = mn;
        acc_sl = sl;
      }
      if (mn_o < acc_mn_o) {
        acc_mn_o = mn_o;
        acc_sl_o = sl_o;
      }
    }
  }
  out[ORHO * n + i] = cnt;
  out[OCGX * n + i] = acc_sl;
  out[OCGY * n + i] = acc_mn;
  out[OFX * n + i] = acc_sl_o;
  out[OFY * n + i] = acc_mn_o;
}

}  // namespace

#define STRIP_ARGS                                                           \
  const float *fld, const int *perm, const float *shift, const int *delta,  \
      const float *tab2, const float *tab1, float *out, int n_slots,        \
      int ncols, int col_cap, int ts, int ch, int t_blk, int nblocks,       \
      int mlo, int mhi, int nnbr, int dim, int kern, int flags, int T1,     \
      float cutmax2, void *stream
#define STRIP_PASS                                                           \
  fld, perm, shift, delta, tab2, tab1, out, n_slots, ncols, col_cap, ts, ch, \
      t_blk, nblocks, mlo, mhi, nnbr, dim, kern, flags, T1, cutmax2, stream

extern "C" int strip_rho_launch(STRIP_ARGS) {
  return launch<SW_RHO>(STRIP_PASS);
}

extern "C" int strip_cgrad_launch(STRIP_ARGS) {
  return launch<SW_CGRAD>(STRIP_PASS);
}

extern "C" int strip_force_launch(STRIP_ARGS) {
  return launch<SW_FORCE>(STRIP_PASS);
}

extern "C" int strip_vapor_launch(const float* fld, const int* perm,
                                  const float* shift, const int* delta,
                                  float* out, int n_slots, int ncols,
                                  int col_cap, int ts, int ch, int t_blk,
                                  int nblocks, int mlo, int mhi, int nnbr,
                                  int vtype, float cut2, void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  const int threads = t_blk * ts;
  if (threads > kMaxThreads || threads < 1 || nblocks < 1 || ncols < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float) * SV_NF * max_window_rows(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        strip_vapor_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ncols, nblocks);
  strip_vapor_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, g, vtype, cut2, out);
  return (int)cudaGetLastError();
}

extern "C" const char* strip_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
