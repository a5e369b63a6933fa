// Strip pair sweeps (rho, colour gradient, force) and the phase-change vapor
// query for Hopper (sm_90a).
//
// The three pair sweeps replace the Pallas TPU kernel
// tpusph/ops/strip_pair.py::make_strip_kernel (the pl.pallas_call at
// strip_pair.py:1233), one launcher per sweep; the vapor sweep at the end of
// this file replaces make_vapor_kernel. The pair physics (staging, the
// per-pair terms, the output rows) is sph_pair.cuh's, shared with the
// column sweeps; the plain PyTorch version in
// tpusph_torch/ops/strip_pair.py::plain_sweep is the reference these
// kernels are held against.
//
// Layout. fld is the (16, n_slots) float32 field matrix (rows as R* in
// tpusph_torch/ops/rows.py), slot = column * col_cap + row. The
// output is the (8, n_slots) matrix with the O* row meanings.
//
// Work split. One thread per i-row, one block per (column c, block b) of
// t_blk tiles of ts rows. For neighbour offset kk the j-column is
// perm[c][kk] (-1: none), the retargeted block is
// bb = clip(b + delta[c][kk][b], 0, nblocks-1), and tile t = b*t_blk + tt
// reads the rank window of tile t' = bb*t_blk + tt:
// rows [ts*t' - ch*mlo, ts*t' + ts + ch*mhi) clipped to the column.
// All tiles of a block share bb, so the block stages the union of its
// tiles' windows in shared memory once per offset, with the per-j terms
// (EOS p/rho^2, sound speed, 1/rho, tension norms) computed once there.
//
// All three sweeps filter, then compute (strip_filter_kernel). Of the
// nnbr*W window rows a thread's windows hold (2.3k-4.6k at the 1M bench
// geometry) about 100 lie within the cutoff, and a warp's 32 rows (about
// two z-layers of one strip column) share most of them. Testing every
// candidate in every lane and running the pair body in lockstep wherever
// any lane had a live pair left ~75% of the lanes masked in the body. Per
// offset, each warp runs warp_filter.cuh's filter_window over its lanes'
// union window: (a) a row per lane against the warp's box, (b) each lane's
// exact test of the survivors, (c) force: the warp pair queue, each owner
// adding its pairs in queue order; rho and the colour gradient add a live
// pair in (b) at once. Each i row sums its pairs in (offset, row) order, as
// the one-pass scan did, so the sums keep their bits. Per-lane lists, each
// lane running its own, would still step to the longest list, and a lane's
// live pairs in one neighbour column depend on where in its column it sits
// (PERF.md, Findings).
//
// The colour gradient sums the rows of mixed tiles only (RMIX > 0.75, the
// TPU kernel's test), and only their pairs of unlike colour add anything
// (pair_body returns first on one colour): 4.6-6.9 such pairs a summed
// row of ~100 live at 1M (PERF.md, Findings). So its warp box is that of the warp's active rows, and
// it gates as the cell sweeps do (cell_sweep.cuh): the warp's colour gate
// (unlike_types of its active rows' types) in its box test, and the
// block's gate and box, the union of its warps', at staging: a window row
// the block's gate drops, or outside its box, is staged as no candidate
// without its terms, and an offset none of whose rows is a candidate is
// skipped by the staging barrier's vote. The one-pass scan
// (strip_sweep_kernel) stays as the check kernel strip_cgrad_scan_launch,
// on no path.
//
// What bounds it: instruction throughput and latency of the live pairs'
// body (a few percent of the candidates), then the per-offset barriers and
// staging; the smoothing kernels read their per type-pair constants from
// shared memory (sph_pair.cuh, load_tables). Registers, spills and shared
// memory per launch are in the -Xptxas -v log cuda_build keeps; the
// measured times and the counts of the phases are in PERF.md. Tiles whose
// mixed-phase flag shows the capillary terms are exactly zero skip them
// (force), or write zeros (cgrad), as the TPU kernel does. Built without
// fast-math: IEEE divides and square roots.

#include <cuda_runtime.h>

#include "sph_pair.cuh"
#include "warp_filter.cuh"

namespace {

using namespace sph;

constexpr int kMaxThreads = 128;

struct Geo {
  int n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr;
};

__host__ __device__ __forceinline__ int max_window_rows(const Geo& g) {
  return g.t_blk * g.ts + g.ch * (g.mlo + g.mhi);
}

// The block's retargeted window for offset kk: the union [ulo, uhi) the
// block stages, and this thread's tile window [wlo, whi) relative to ulo.
struct Window {
  int jc, ulo, uhi, wlo, whi;
  float sx, sy;
};

__device__ __forceinline__ Window offset_window(
    const Geo& g, const int* __restrict__ perm,
    const float* __restrict__ shift, const int* __restrict__ delta, int c,
    int b, int tt, int kk) {
  Window w;
  const int brows = g.t_blk * g.ts;
  w.jc = perm[c * g.nnbr + kk];
  int bb = b + delta[(c * g.nnbr + kk) * g.nblocks + b];
  bb = min(max(bb, 0), g.nblocks - 1);
  w.ulo = max(bb * brows - g.ch * g.mlo, 0);
  w.uhi = min((bb + 1) * brows + g.ch * g.mhi, g.col_cap);
  w.sx = shift[(c * g.nnbr + kk) * 2];
  w.sy = shift[(c * g.nnbr + kk) * 2 + 1];
  const int tp = bb * g.t_blk + tt;
  w.wlo = max(tp * g.ts - g.ch * g.mlo, 0) - w.ulo;
  w.whi = min(tp * g.ts + g.ts + g.ch * g.mhi, g.col_cap) - w.ulo;
  return w;
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
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  float* win = smem + table_floats(p.T1);    // [NF][maxrows]
  const int maxrows = max_window_rows(g);

  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int brows = g.t_blk * g.ts;
  const int tt = threadIdx.x / g.ts;
  const int i = c * g.col_cap + b * brows + threadIdx.x;

  const bool alive = fld[RTYPE * n + i] > 0.5f;
  const float mix_i = fld[RMIX * n + i];
  bool active = alive;
  if (SWEEP == SW_CGRAD) active = alive && mix_i > 0.75f;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // (also the barrier that publishes the tables)
  if (!__syncthreads_or(active)) {
    write_out<SWEEP>(out, n, i, false, IRow{}, tb, p, acc);
    return;
  }
  // the tile's flag says whether any candidate carries a colour gradient
  const bool st = (p.flags & FL_ST) && mix_i > 0.25f;
  const IRow ir = load_i<SWEEP>(fld, n, i, tb, p, st);

  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block

    __syncthreads();  // the previous offset's readers are done
    // dead slots carry the far sentinel position (sentinel-dead layout),
    // so every row of the window is staged as a candidate
    for (int k = threadIdx.x; k < w.uhi - w.ulo; k += blockDim.x) {
      stage_j<SWEEP>(win, maxrows, k, fld, n, w.jc * g.col_cap + w.ulo + k,
                     w.sx, w.sy, 0.f, true, tb, p);
    }
    __syncthreads();
    if (!active) continue;

    for (int k = w.wlo; k < w.whi; ++k) {
      pair_sum<SWEEP>(win, maxrows, k, ir, tb, p, acc);
    }
  }
  write_out<SWEEP>(out, n, i, active, ir, tb, p, acc);
}

// ---- the three sweeps: filter, then compute --------------------------------

template <int SWEEP, int MIN_BLOCKS>
__global__ void __launch_bounds__(kMaxThreads, MIN_BLOCKS)
strip_filter_kernel(const float* __restrict__ fld,
                    const int* __restrict__ perm,
                    const float* __restrict__ shift,
                    const int* __restrict__ delta,
                    const float* __restrict__ tab2g,
                    const float* __restrict__ tab1g, Geo g, Phys p,
                    float* __restrict__ out) {
  constexpr bool kQueued = SWEEP == SW_FORCE;
  constexpr bool kGate = SWEEP == SW_CGRAD;
  constexpr int kWarps = kMaxThreads / 32;
  extern __shared__ float smem[];
  // cgrad: each warp's box and types, and the block's box and gate
  __shared__ float wbox[kGate ? kWarps : 1][6];
  __shared__ unsigned wtypes[kGate ? kWarps : 1];
  __shared__ WarpBox bbox;
  __shared__ unsigned bgate;
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  const int maxrows = max_window_rows(g);
  float* win = smem + table_floats(p.T1);    // [NF][maxrows]
  float* sir = win + NumFields<SWEEP>::v * maxrows;  // queue_floats (force)

  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int brows = g.t_blk * g.ts;
  const int tt = threadIdx.x / g.ts;
  const int i = c * g.col_cap + b * brows + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nlanes = min(32, brows - warp * 32);
  const unsigned wmask = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1u;

  const bool alive = fld[RTYPE * n + i] > 0.5f;
  const float mix_i = fld[RMIX * n + i];
  // the rows whose sums the sweep forms: cgrad those of mixed tiles
  const bool active = alive && (!kGate || mix_i > 0.75f);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // (also the barrier that publishes the tables)
  if (!__syncthreads_or(active)) {
    write_out<SWEEP>(out, n, i, false, IRow{}, tb, p, acc);
    return;
  }
  const bool st = (p.flags & FL_ST) && mix_i > 0.25f;
  const IRow ir = load_i<SWEEP>(fld, n, i, tb, p, st);
  WarpQueue wq{};
  if (kQueued) {
    put_irow(sir, brows, threadIdx.x, ir);
    wq = warp_queue(sir, brows, warp, lane);
  }
  const bool warp_alive = __any_sync(wmask, active);
  const float rc = sqrtf(p.cutmax2);
  const WarpBox bx = warp_box(ir, active, wmask, rc);
  unsigned wgate = ~0u;
  if (kGate) {
    const unsigned wset =
        __reduce_or_sync(wmask, active ? type_bit(ir.t) : 0u);
    wgate = unlike_types(wset, tb);
    if (lane == 0) {
      put_box(wbox[warp], bx);
      wtypes[warp] = wset;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // published by the first offset's barrier
      const int nwarps = (brows + 31) / 32;
      unsigned bset = 0u;
      for (int q = 0; q < nwarps; ++q) bset |= wtypes[q];
      bbox = union_box(wbox, nwarps, rc);
      bgate = unlike_types(bset, tb);
    }
  }

  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block

    __syncthreads();  // the previous offset's readers are done
    bool staged = false;
    for (int k = threadIdx.x; k < w.uhi - w.ulo; k += blockDim.x) {
      const int j = w.jc * g.col_cap + w.ulo + k;
      // rho, force: dead slots carry the far sentinel position
      // (sentinel-dead layout), so every row is staged as a candidate;
      // cgrad: an alive row of a type the block's gate keeps, inside its
      // box
      bool live = true;
      if (kGate) {
        const float tj = fld[RTYPE * n + j];
        live = tj > 0.5f && gate_keeps(bgate, tj) &&
               bbox.holds(fld[RX * n + j] + w.sx, fld[RY * n + j] + w.sy,
                          fld[RZ * n + j]);
        staged = staged || live;
      }
      stage_j<SWEEP>(win, maxrows, k, fld, n, j, w.sx, w.sy, 0.f, live, tb,
                     p);
    }
    if (kGate) {
      // an offset with no candidate row is skipped (uniform: the vote)
      if (!__syncthreads_or(staged)) continue;
    } else {
      __syncthreads();
    }
    if (!warp_alive) continue;

    // the warp's lanes may lie in two tiles: scan the union of their
    // windows, each lane keeping only rows of its own
    const int klo = __reduce_min_sync(wmask, w.wlo);
    const int khi = __reduce_max_sync(wmask, w.whi);
    const bool one_tile = __all_sync(wmask, w.wlo == klo && w.whi == khi);
    filter_window<SWEEP>(win, maxrows, klo, khi, one_tile, w.wlo, w.whi, bx,
                         ir, active, wmask, lane, nlanes, wq, sir, warp * 32,
                         tb, p, acc, wgate);
  }
  write_out<SWEEP>(out, n, i, active, ir, tb, p, acc);
}

using SweepFn = void (*)(const float*, const int*, const float*, const int*,
                        const float*, const float*, Geo, Phys, float*);

// Launches a sweep's filtered kernel or (SCAN) its one-pass check kernel.
template <int SWEEP, bool SCAN = false>
int launch(const float* fld, const int* perm, const float* shift,
           const int* delta, const float* tab2, const float* tab1,
           float* out, int n_slots, int ncols, int col_cap, int ts, int ch,
           int t_blk, int nblocks, int mlo, int mhi, int nnbr, int dim,
           int kern, int flags, int T1, float cutmax2, void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  Phys p{dim, kern, flags, T1, cutmax2};
  const int threads = t_blk * ts;
  if (threads > kMaxThreads || threads < 1 || nblocks < 1 || ncols < 1 ||
      T1 < 1 || max_window_rows(g) > 65536) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float)
      * (table_floats(T1) + NumFields<SWEEP>::v * max_window_rows(g)
         + (SWEEP == SW_FORCE && !SCAN ? queue_floats(threads) : 0));
  cudaError_t err = cudaSuccess;
  SweepFn kernel;
  if constexpr (SCAN) {
    kernel = strip_sweep_kernel<SWEEP>;
  } else if constexpr (SWEEP == SW_RHO) {
    kernel = strip_filter_kernel<SWEEP, 1>;
  } else if constexpr (SWEEP == SW_CGRAD) {
    kernel = pick_build<SweepFn>(strip_filter_kernel<SW_CGRAD, 12>,
                                 strip_filter_kernel<SW_CGRAD, 16>, threads,
                                 smem, &err);
  } else {
    kernel = pick_build<SweepFn>(strip_filter_kernel<SW_FORCE, 4>,
                                 strip_filter_kernel<SW_FORCE, 5>, threads,
                                 smem, &err);
  }
  if (err != cudaSuccess) return (int)err;
  // always: another geometry's pick may have set it lower
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ncols, nblocks);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, tab2, tab1, g, p, out);
  return (int)cudaGetLastError();
}

// ---- the vapor sweep: the fix phase_change interface query ---------------
//
// Replaces tpusph/ops/strip_pair.py::make_vapor_kernel (strip_pair.py:1251,
// the pl.pallas_call at :1348); the plain version it is held against is
// tpusph_torch/ops/strip_pair.py::plain_vapor_sweep. Same windows and work
// split as the sweeps. Per i-row it writes the count of type-vtype
// neighbours with 1e-12 < rsq < cut2 (row ORHO), the nearest one's slot and
// rsq (OCGX, OCGY) and the nearest owned one's (OFX, OFY); 0 / kVaporBig
// where there is none (every row, alive or not, is written). Field row
// RSLOT carries each slot sign-encoded (slot when owned, -(slot+1) for a
// seam ghost); slots are exact floats below 2^24 (the wrapper checks).
//
// Tie rule, the TPU kernel's: per offset the smallest |slot| among the rows
// at the minimum rsq, and across offsets a strictly smaller rsq replaces
// the running best, so the winner is the lexicographic minimum of
// (rsq, kk, |slot|), whatever order an offset's rows are visited in. rsq
// is formed with round-to-nearest intrinsics in the plain version's order,
// ((dx0*dx0 + dx1*dx1) + dx2*dx2), never contracted into FMAs, so the
// kernel and the plain version agree bit for bit.
//
// The design (strip_vapor_filter_kernel): a row adds anything only with a
// vapour row within cut2, and the vapour sphere (r = L/5, ~3% of the box)
// and the inserted rows are a small part of any window. So the block
// stages a window row as a candidate only when its type lies in
// (vtype - 0.5, vtype + 0.5) (the type gate) and it lies in the block's
// box (the union of its warps' boxes of alive rows, radius sqrt(cut2), by
// WarpBox's rule); the others are staged at the far position without their
// slot, and an offset with no candidate is skipped by the staging
// barrier's vote. Each warp then tests the staged rows against its own box,
// a row per lane, and each lane tests the survivors exactly, in row order,
// keeping both running argmins in registers. What bounds it: the staging
// pass's type read of every window row; the exact tests follow the vapour
// rows near the block. The one-pass scan (strip_vapor_scan_kernel: every
// row tests every window row's type) stays as the check kernel
// strip_vapor_scan_launch, on no path. The query runs once every `every`
// steps.

constexpr float kVaporBig = 1e30f;

// one candidate: 1e-12 < rsq < cut2 counts, and the running argmins of
// (rsq, |slot|) over all candidates and over owned ones (enc >= 0)
__device__ __forceinline__ void vapor_pair(float xi, float yi, float zi,
                                           float xj, float yj, float zj,
                                           float enc, float cut2, float& cnt,
                                           float& mn, float& sl, float& mn_o,
                                           float& sl_o) {
  const float dx0 = __fsub_rn(xi, xj);
  const float dx1 = __fsub_rn(yi, yj);
  const float dx2 = __fsub_rn(zi, zj);
  const float rsq = __fadd_rn(
      __fadd_rn(__fmul_rn(dx0, dx0), __fmul_rn(dx1, dx1)),
      __fmul_rn(dx2, dx2));
  if (!(rsq > 1e-12f) || !(rsq < cut2)) return;
  cnt += 1.f;
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

__device__ __forceinline__ void write_vapor(float* __restrict__ out, int n,
                                            int i, float cnt, float sl,
                                            float mn, float sl_o,
                                            float mn_o) {
  out[ORHO * n + i] = cnt;
  out[OCGX * n + i] = sl;
  out[OCGY * n + i] = mn;
  out[OFX * n + i] = sl_o;
  out[OFY * n + i] = mn_o;
}

// staged fields of the filtered kernel: the shifted position, the slot
enum { VF_X = 0, VF_Y, VF_Z, VF_SLOT, VF_NF };

__global__ void __launch_bounds__(kMaxThreads)
strip_vapor_filter_kernel(const float* __restrict__ fld,
                          const int* __restrict__ perm,
                          const float* __restrict__ shift,
                          const int* __restrict__ delta, Geo g, int vtype,
                          float cut2, float* __restrict__ out) {
  extern __shared__ float win[];  // [VF_NF][maxrows]
  __shared__ float wbox[kMaxThreads / 32][6];
  __shared__ WarpBox bbox;
  const int maxrows = max_window_rows(g);
  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int brows = g.t_blk * g.ts;
  const int tt = threadIdx.x / g.ts;
  const int i = c * g.col_cap + b * brows + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nlanes = min(32, brows - warp * 32);
  const unsigned wmask = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1u;
  const bool alive = fld[RTYPE * n + i] > 0.5f;

  float cnt = 0.f;
  float acc_mn = kVaporBig, acc_sl = 0.f;
  float acc_mn_o = kVaporBig, acc_sl_o = 0.f;
  if (!__syncthreads_or(alive)) {
    write_vapor(out, n, i, cnt, acc_sl, acc_mn, acc_sl_o, acc_mn_o);
    return;
  }
  const float xi = fld[RX * n + i], yi = fld[RY * n + i],
              zi = fld[RZ * n + i];
  const float vlo = (float)vtype - 0.5f, vhi = (float)vtype + 0.5f;
  const float rc = sqrtf(cut2);
  const bool warp_alive = __any_sync(wmask, alive);
  const WarpBox bx = warp_box_at(xi, yi, zi, alive, wmask, rc);
  if (lane == 0) put_box(wbox[warp], bx);
  __syncthreads();
  // published by the first offset's barrier
  if (threadIdx.x == 0) bbox = union_box(wbox, (brows + 31) / 32, rc);

  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block

    __syncthreads();  // the previous offset's readers are done
    bool staged = false;
    for (int k = threadIdx.x; k < w.uhi - w.ulo; k += blockDim.x) {
      const int j = w.jc * g.col_cap + w.ulo + k;
      const float tj = fld[RTYPE * n + j];
      float xj = kFar, yj = kFar, zj = kFar;
      bool cand = tj > vlo && tj < vhi;
      if (cand) {
        xj = __fadd_rn(fld[RX * n + j], w.sx);
        yj = __fadd_rn(fld[RY * n + j], w.sy);
        zj = fld[RZ * n + j];
        cand = bbox.holds(xj, yj, zj);
      }
      win[VF_X * maxrows + k] = cand ? xj : kFar;
      win[VF_Y * maxrows + k] = cand ? yj : kFar;
      win[VF_Z * maxrows + k] = cand ? zj : kFar;
      if (cand) win[VF_SLOT * maxrows + k] = fld[RSLOT * n + j];
      staged = staged || cand;
    }
    // an offset with no candidate row is skipped (uniform: the vote)
    if (!__syncthreads_or(staged) || !warp_alive) continue;

    // the warp's lanes may lie in two tiles: scan the union of their
    // windows, each lane keeping only rows of its own
    const int klo = __reduce_min_sync(wmask, w.wlo);
    const int khi = __reduce_max_sync(wmask, w.whi);
    float mn = kVaporBig, sl = kVaporBig;
    float mn_o = kVaporBig, sl_o = kVaporBig;
    for (int k0 = klo; k0 < khi; k0 += nlanes) {
      const int kb = k0 + lane;
      // a row per lane against the warp's box
      const bool in = kb < khi && bx.holds(win[VF_X * maxrows + kb],
                                           win[VF_Y * maxrows + kb],
                                           win[VF_Z * maxrows + kb]);
      for (unsigned surv = __ballot_sync(wmask, in); surv;
           surv &= surv - 1u) {
        // each lane's exact test of the survivors, in row order
        const int k = k0 + __ffs(surv) - 1;
        if (alive && k >= w.wlo && k < w.whi) {
          vapor_pair(xi, yi, zi, win[VF_X * maxrows + k],
                     win[VF_Y * maxrows + k], win[VF_Z * maxrows + k],
                     win[VF_SLOT * maxrows + k], cut2, cnt, mn, sl, mn_o,
                     sl_o);
        }
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
  write_vapor(out, n, i, cnt, acc_sl, acc_mn, acc_sl_o, acc_mn_o);
}

// The one-pass vapor scan, the check kernel: every alive row tests every
// row of its windows, rejecting another type after one shared load.
enum { SV_X = 0, SV_Y, SV_Z, SV_TYPE, SV_SLOT, SV_NF };

__global__ void __launch_bounds__(kMaxThreads)
strip_vapor_scan_kernel(const float* __restrict__ fld,
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
      const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
      if (w.jc < 0) continue;  // uniform over the block

      __syncthreads();  // the previous offset's readers are done
      for (int k = threadIdx.x; k < w.uhi - w.ulo; k += blockDim.x) {
        const int j = w.jc * g.col_cap + w.ulo + k;
        win[SV_X * maxrows + k] = fld[RX * n + j];
        win[SV_Y * maxrows + k] = fld[RY * n + j];
        win[SV_Z * maxrows + k] = fld[RZ * n + j];
        win[SV_TYPE * maxrows + k] = fld[RTYPE * n + j];
        win[SV_SLOT * maxrows + k] = fld[RSLOT * n + j];
      }
      __syncthreads();
      if (!alive) continue;

      float mn = kVaporBig, sl = kVaporBig;
      float mn_o = kVaporBig, sl_o = kVaporBig;
      for (int k = w.wlo; k < w.whi; ++k) {
        const float tj = win[SV_TYPE * maxrows + k];
        if (!(tj > vlo && tj < vhi)) continue;
        vapor_pair(xi, yi, zi, __fadd_rn(win[SV_X * maxrows + k], w.sx),
                   __fadd_rn(win[SV_Y * maxrows + k], w.sy),
                   win[SV_Z * maxrows + k], win[SV_SLOT * maxrows + k], cut2,
                   cnt, mn, sl, mn_o, sl_o);
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
  write_vapor(out, n, i, cnt, acc_sl, acc_mn, acc_sl_o, acc_mn_o);
}

using VaporFn = void (*)(const float*, const int*, const float*, const int*,
                         Geo, int, float, float*);

int launch_vapor(VaporFn kernel, int nf, const float* fld, const int* perm,
                 const float* shift, const int* delta, float* out,
                 int n_slots, int ncols, int col_cap, int ts, int ch,
                 int t_blk, int nblocks, int mlo, int mhi, int nnbr,
                 int vtype, float cut2, void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  const int threads = t_blk * ts;
  if (threads > kMaxThreads || threads < 1 || nblocks < 1 || ncols < 1) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float) * nf * max_window_rows(g);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ncols, nblocks);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, g, vtype, cut2, out);
  return (int)cudaGetLastError();
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

// the one-pass colour-gradient scan: a check kernel, on no path
extern "C" int strip_cgrad_scan_launch(STRIP_ARGS) {
  return launch<SW_CGRAD, true>(STRIP_PASS);
}

#define VAPOR_ARGS                                                           \
  const float *fld, const int *perm, const float *shift, const int *delta,  \
      float *out, int n_slots, int ncols, int col_cap, int ts, int ch,      \
      int t_blk, int nblocks, int mlo, int mhi, int nnbr, int vtype,        \
      float cut2, void *stream
#define VAPOR_PASS                                                           \
  fld, perm, shift, delta, out, n_slots, ncols, col_cap, ts, ch, t_blk,     \
      nblocks, mlo, mhi, nnbr, vtype, cut2, stream

extern "C" int strip_vapor_launch(VAPOR_ARGS) {
  return launch_vapor(strip_vapor_filter_kernel, VF_NF, VAPOR_PASS);
}

// the one-pass vapor scan: a check kernel, on no path
extern "C" int strip_vapor_scan_launch(VAPOR_ARGS) {
  return launch_vapor(strip_vapor_scan_kernel, SV_NF, VAPOR_PASS);
}

extern "C" const char* strip_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
