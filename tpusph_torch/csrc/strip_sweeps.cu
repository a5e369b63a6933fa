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
// Rho and force: filter, then compute (strip_filter_kernel). Of the
// nnbr*W window rows a thread's windows hold (2.3k-4.6k at the 1M bench
// geometry) about 100 lie within the cutoff, and a warp's 32 rows (about
// two z-layers of one strip column) share most of them. Testing every
// candidate in every lane and running the pair body in lockstep wherever
// any lane had a live pair left ~75% of the lanes masked in the body.
// Per offset, each warp now:
//   (a) tests its lanes' union window a row per lane at a time,
//       against its box: the squared distance to the bounding box of its
//       alive i-rows below the cutoff plus a float32 rounding margin
//       (WarpBox); a ballot gives the survivors (the TPU's 128-row window
//       padding, dead rows at the far sentinel and most of the z-margin
//       drop here: one test per row per warp instead of one per lane);
//   (b) walks the survivors in increasing row order, each lane testing its
//       own pair with pair_live, the test pair_sum applies;
//   (c) force: the live pairs of a survivor join the warp's pair queue in
//       lane order (kQueue entries in shared memory); when the next
//       survivor's could overfill it, and at the end of the offset, the
//       warp runs the queue 32 pairs a pass, every lane on a pair with its
//       owner's i row from shared memory, and each owner adds its pairs'
//       contributions in queue order. Rho runs its short body on the live
//       pair in (b) directly.
// Each i row sums its pairs in (offset, row) order, as the one-pass scan
// did, and each pair's terms are the same arithmetic, so the sums keep
// their bits. The body passes per offset fall from the rows any lane pairs
// with (lockstep) to ceil(the warp's live pairs / 32); per-lane lists,
// each lane running its own, would still step to the longest list, and a
// lane's live pairs in one neighbour column depend on where in its column
// it sits (PERF.md, Findings). Colour gradient keeps the one-pass scan
// (strip_sweep_kernel): its body runs on mixed tiles only.
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

namespace {

using namespace sph;

constexpr int kMaxThreads = 128;

// Queued pairs per warp (PERF.md, Findings: a longer queue measured no
// faster).
constexpr int kQueue = 128;
// a flush runs whole passes and keeps under a pass of pairs: room for the
// next step's up to 64
static_assert(kQueue >= 96 && kQueue % 32 == 0, "queue length");
constexpr float kBoxFar = 1e30f;              // box bound of a dead warp

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

// ---- rho and force: filter, then compute -----------------------------------

// A float's order-preserving int key and back: the warp's min / max of a
// float through __reduce_min_sync / __reduce_max_sync, which take a partial
// warp's mask.
__device__ __forceinline__ int float_key(float v) {
  const int b = __float_as_int(v);
  return b >= 0 ? b : b ^ 0x7fffffff;
}

__device__ __forceinline__ float key_float(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

// The warp's filter: the bounding box of its alive i-rows (dead rows carry
// the far sentinel and are left out), and rp^2 with rp = rc + 1e-5 * (rc +
// the box's largest coordinate magnitude), rc = sqrt(cutmax2). A staged row
// survives when its squared distance to the box, (gx*gx + gy*gy) + gz*gz
// with per-axis gaps max(max(lo - x, x - hi), 0), is below rp^2. The gap
// never exceeds |dx| of the pair with any row of the box, and float32
// rounding moves either by a few ulp, far inside the margin, so every live
// pair's row survives. Formed with round-to-nearest intrinsics (never
// contracted) so the plain count (strip_pair.warp_pass_counts) forms the
// same filter.
struct WarpBox {
  float lo[3], hi[3], r2;
  __device__ __forceinline__ static float gap(float x, float lo, float hi) {
    return fmaxf(fmaxf(__fsub_rn(lo, x), __fsub_rn(x, hi)), 0.f);
  }
  __device__ __forceinline__ bool holds(float x, float y, float z) const {
    const float gx = gap(x, lo[0], hi[0]);
    const float gy = gap(y, lo[1], hi[1]);
    const float gz = gap(z, lo[2], hi[2]);
    return __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                     __fmul_rn(gz, gz)) < r2;
  }
};

__device__ __forceinline__ WarpBox warp_box(const IRow& ir, bool alive,
                                            unsigned wmask, float rc) {
  WarpBox bx;
  const float xs[3] = {ir.x, ir.y, ir.z};
  float mag = 0.f;
  for (int a = 0; a < 3; ++a) {
    bx.lo[a] = key_float(__reduce_min_sync(
        wmask, float_key(alive ? xs[a] : kBoxFar)));
    bx.hi[a] = key_float(__reduce_max_sync(
        wmask, float_key(alive ? xs[a] : -kBoxFar)));
    mag = fmaxf(mag, fmaxf(fabsf(bx.lo[a]), fabsf(bx.hi[a])));
  }
  const float rp = __fadd_rn(rc, __fmul_rn(1e-5f, __fadd_rn(rc, mag)));
  bx.r2 = __fmul_rn(rp, rp);
  return bx;
}

// The i rows' hoisted values in shared memory, [IR_NF][threads]: the lane
// that runs a queued pair reads its owner's.
enum { IR_T = 0, IR_X, IR_Y, IR_Z, IR_M, IR_RHO, IR_IRHO, IR_VX, IR_VY,
       IR_VZ, IR_E, IR_CV, IR_FI, IR_CI, IR_CGX, IR_CGY, IR_CGZ, IR_A, IR_B,
       IR_ST, IR_NF };

__device__ __forceinline__ void put_irow(float* s, int ld, int slot,
                                         const IRow& r) {
  const float v[IR_NF] = {__int_as_float(r.t), r.x, r.y, r.z, r.m, r.rho,
                          r.inv_rho, r.vx, r.vy, r.vz, r.e, r.cv, r.fi, r.ci,
                          r.cgx, r.cgy, r.cgz, r.a, r.b, r.st ? 1.f : 0.f};
  for (int f = 0; f < IR_NF; ++f) s[f * ld + slot] = v[f];
}

__device__ __forceinline__ IRow get_irow(const float* s, int ld, int slot) {
  const float* e = s + slot;
  IRow r{};
  r.t = __float_as_int(e[IR_T * ld]);
  r.x = e[IR_X * ld];
  r.y = e[IR_Y * ld];
  r.z = e[IR_Z * ld];
  r.m = e[IR_M * ld];
  r.rho = e[IR_RHO * ld];
  r.inv_rho = e[IR_IRHO * ld];
  r.vx = e[IR_VX * ld];
  r.vy = e[IR_VY * ld];
  r.vz = e[IR_VZ * ld];
  r.e = e[IR_E * ld];
  r.cv = e[IR_CV * ld];
  r.fi = e[IR_FI * ld];
  r.ci = e[IR_CI * ld];
  r.cgx = e[IR_CGX * ld];
  r.cgy = e[IR_CGY * ld];
  r.cgz = e[IR_CGZ * ld];
  r.a = e[IR_A * ld];
  r.b = e[IR_B * ld];
  r.st = e[IR_ST * ld] != 0.f;
  return r;
}

// Shared floats of a block's i rows and, per warp, the pair queue (kQueue
// entries: row k in the low 16 bits, the owner lane above), one pass's
// contributions [6][32] and, per owner lane, the mask of the pass's lanes
// that ran its pairs.
constexpr int kWarpQueueFloats = kQueue + 6 * 32 + 32;

__host__ __device__ constexpr int queue_floats(int threads) {
  return IR_NF * threads + (threads + 31) / 32 * kWarpQueueFloats;
}

struct WarpQueue {
  unsigned* q;
  float* contrib;
  unsigned* owned;
};

// (c): the warp runs the first n queued pairs, a pair per lane a pass,
// each with its owner's i row; then each owner adds its pairs'
// contributions in queue order, which is (offset, row) order per owner.
template <int SWEEP>
__device__ __forceinline__ void run_queue(const WarpQueue& wq, int n,
                                          unsigned wmask, int lane,
                                          int nlanes,
                                          const float* __restrict__ sir,
                                          int wbase,
                                          const float* __restrict__ win,
                                          int ld, const Tables& tb,
                                          const Phys& p, float acc[6]) {
  __syncwarp(wmask);  // the queue entries are written
  for (int p0 = 0; p0 < n; p0 += nlanes) {
    const bool has = p0 + lane < n;
    const unsigned item = has ? wq.q[p0 + lane] : 0u;
    const int k = (int)(item & 0xffffu), owner = (int)(item >> 16);
    float f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (has) {
      const IRow ir = get_irow(sir, blockDim.x, wbase + owner);
      float dx0, dx1, dx2;
      const float rsq = pair_rsq(win, ld, k, ir, dx0, dx1, dx2);
      pair_body<SWEEP>(win, ld, k, ir, tb, p, dx0, dx1, dx2, rsq, f);
    }
    for (int r = 0; r < 6; ++r) wq.contrib[r * 32 + lane] = f[r];
    const unsigned same = __match_any_sync(wmask, has ? owner : 32);
    if (has && lane == __ffs(same) - 1) wq.owned[owner] = same;
    __syncwarp(wmask);
    for (unsigned m = wq.owned[lane]; m; m &= m - 1u) {
      const int j = __ffs(m) - 1;
      for (int r = 0; r < 6; ++r) acc[r] += wq.contrib[r * 32 + j];
    }
    wq.owned[lane] = 0u;
    __syncwarp(wmask);
  }
}

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
  extern __shared__ float smem[];
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
  float* wsh = sir + IR_NF * brows + warp * kWarpQueueFloats;
  const WarpQueue wq{reinterpret_cast<unsigned*>(wsh), wsh + kQueue,
                     reinterpret_cast<unsigned*>(wsh + kQueue + 6 * 32)};

  const bool alive = fld[RTYPE * n + i] > 0.5f;
  const float mix_i = fld[RMIX * n + i];
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  // (also the barrier that publishes the tables)
  if (!__syncthreads_or(alive)) {
    write_out<SWEEP>(out, n, i, false, IRow{}, tb, p, acc);
    return;
  }
  const bool st = (p.flags & FL_ST) && mix_i > 0.25f;
  const IRow ir = load_i<SWEEP>(fld, n, i, tb, p, st);
  if (kQueued) {
    put_irow(sir, brows, threadIdx.x, ir);
    wq.owned[lane] = 0u;
  }
  const bool warp_alive = __any_sync(wmask, alive);
  const WarpBox bx = warp_box(ir, alive, wmask, sqrtf(p.cutmax2));
  const unsigned lanes_below = (1u << lane) - 1u;

  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block

    __syncthreads();  // the previous offset's readers are done
    for (int k = threadIdx.x; k < w.uhi - w.ulo; k += blockDim.x) {
      stage_j<SWEEP>(win, maxrows, k, fld, n, w.jc * g.col_cap + w.ulo + k,
                     w.sx, w.sy, 0.f, true, tb, p);
    }
    __syncthreads();
    if (!warp_alive) continue;

    // the warp's lanes may lie in two tiles: scan the union of their
    // windows, each lane keeping only rows of its own
    const int klo = __reduce_min_sync(wmask, w.wlo);
    const int khi = __reduce_max_sync(wmask, w.whi);
    const bool one_tile = __all_sync(wmask, w.wlo == klo && w.whi == khi);
    int queued = 0;
    for (int k0 = klo; k0 < khi; k0 += nlanes) {
      const int kb = k0 + lane;
      // (a) one row per lane against the warp's box
      const bool in = kb < khi &&
          bx.holds(win[0 * maxrows + kb], win[1 * maxrows + kb],
                   win[2 * maxrows + kb]);
      unsigned surv = __ballot_sync(wmask, in);
      while (surv) {
        // (b) each lane's exact test of the next survivors, in row order:
        // force two a step (two independent chains in flight), rho one
        const int ka = k0 + __ffs(surv) - 1;
        surv &= surv - 1u;
        const bool two = kQueued && surv != 0u;
        const int kb = two ? k0 + __ffs(surv) - 1 : ka;
        if (two) surv &= surv - 1u;
        float a0, a1, a2, b0, b1, b2;
        const float rsa = pair_rsq(win, maxrows, ka, ir, a0, a1, a2);
        const float rsb = pair_rsq(win, maxrows, kb, ir, b0, b1, b2);
        const bool la = alive && (one_tile || (ka >= w.wlo && ka < w.whi))
                        && pair_live(rsa, p.cutmax2);
        const bool lb = two && alive
                        && (one_tile || (kb >= w.wlo && kb < w.whi))
                        && pair_live(rsb, p.cutmax2);
        if (!kQueued) {
          // rho: its few operations at once
          if (la) {
            pair_body<SWEEP>(win, maxrows, ka, ir, tb, p, a0, a1, a2, rsa,
                             acc);
          }
          continue;
        }
        // force: the live pairs into the queue
        const unsigned ma = __ballot_sync(wmask, la);
        const unsigned mb = __ballot_sync(wmask, lb);
        const int na = __popc(ma), nb = __popc(mb);
        if (na + nb == 0) continue;
        if (queued + na + nb > kQueue) {
          // run the whole passes; the rest moves to the queue's front
          const int full = queued - queued % nlanes;
          run_queue<SWEEP>(wq, full, wmask, lane, nlanes, sir, warp * 32,
                           win, maxrows, tb, p, acc);
          const bool moves = lane < queued - full;
          const unsigned rest = moves ? wq.q[full + lane] : 0u;
          __syncwarp(wmask);
          if (moves) wq.q[lane] = rest;
          queued -= full;
        }
        const unsigned tag = (unsigned)lane << 16;
        if (la) wq.q[queued + __popc(ma & lanes_below)] = (unsigned)ka | tag;
        if (lb) {
          wq.q[queued + na + __popc(mb & lanes_below)] = (unsigned)kb | tag;
        }
        queued += na + nb;
      }
    }
    if (kQueued) {
      run_queue<SWEEP>(wq, queued, wmask, lane, nlanes, sir, warp * 32, win,
                       maxrows, tb, p, acc);
    }
  }
  write_out<SWEEP>(out, n, i, alive, ir, tb, p, acc);
}

using SweepFn = void (*)(const float*, const int*, const float*, const int*,
                        const float*, const float*, Geo, Phys, float*);

// The force kernel's build for a block size and shared memory: the 5-block
// __launch_bounds__ build (96 registers, some spilled) where the occupancy
// API finds it keeps more blocks resident than the 4-block one (no spill),
// else the 4-block one (PERF.md, Findings: each wins on one bench layout).
// Picked once per (threads, smem) and kept in a small table.
SweepFn force_build(int threads, size_t smem, cudaError_t* err) {
  struct Pick {
    int threads;
    size_t smem;
    SweepFn fn;
  };
  static Pick picks[16];
  static int npicks = 0;
  for (int q = 0; q < npicks; ++q) {
    if (picks[q].threads == threads && picks[q].smem == smem) {
      return picks[q].fn;
    }
  }
  SweepFn four = strip_filter_kernel<SW_FORCE, 4>;
  SweepFn five = strip_filter_kernel<SW_FORCE, 5>;
  int n4 = 0, n5 = 0;
  for (SweepFn k : {four, five}) {
    *err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err != cudaSuccess) return nullptr;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        k == four ? &n4 : &n5, k, threads, smem);
    if (*err != cudaSuccess) return nullptr;
  }
  SweepFn fn = n5 > n4 ? five : four;
  picks[npicks % 16] = Pick{threads, smem, fn};
  npicks = npicks < 16 ? npicks + 1 : 16;
  return fn;
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
      T1 < 1 || max_window_rows(g) > 65536) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float)
      * (table_floats(T1) + NumFields<SWEEP>::v * max_window_rows(g)
         + (SWEEP == SW_FORCE ? queue_floats(threads) : 0));
  SweepFn kernel;
  if constexpr (SWEEP == SW_CGRAD) {
    kernel = strip_sweep_kernel<SWEEP>;
  } else if constexpr (SWEEP == SW_RHO) {
    kernel = strip_filter_kernel<SWEEP, 1>;
  } else {
    cudaError_t err = cudaSuccess;
    kernel = force_build(threads, smem, &err);
    if (err != cudaSuccess) return (int)err;
  }
  // (force: always, since another geometry's pick may have set it lower)
  if (smem > 48 * 1024 || SWEEP == SW_FORCE) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
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
      const Window w = offset_window(g, perm, shift, delta, c, b, tt, kk);
      if (w.jc < 0) continue;  // uniform over the block
      const float sx = w.sx, sy = w.sy;

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
