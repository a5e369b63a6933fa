// The compacted force sweep over the strip windows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// tpusph/ops/mxu_compact.py::make_compact_force_kernel (the pl.pallas_call
// at mxu_compact.py:277). The pair physics (staging, the per-pair terms) is
// sph_pair.cuh's, shared with the strip, column and band sweeps, and the
// warp box filter and pair queue are warp_filter.cuh's, shared with the
// strip, column and band force sweeps; the plain PyTorch version
// tpusph_torch/ops/mxu_compact.py::plain_compact_force is the reference
// this kernel is held against.
//
// Layout and windows: the strip sweep's (strip_sweeps.cu). fld is the
// (16, n_slots) float32 field matrix, slot = column * col_cap + row; for
// i-tile t of column c (block b = t / t_blk) and neighbour offset kk the j
// rows are the rank window [ts*t' - ch*mlo, ts*t' + ts + ch*mhi) of tile
// t' = clip(b + delta[c][kk][b]) * t_blk + t mod t_blk of column
// perm[c][kk], clipped to the column, with the plane image shift; the
// column-axis wrap is already in the seam-ghost rows. The output is the
// (8, n_slots) matrix: OFX..ODE, rows 5-6 zero (no virial row), and row
// OCNT the tile's compaction overflow.
//
// Contract (the reference's, mxu_compact.py:123-292). Per i-tile:
//   * the bounding box of the current positions of the tile's ALIVE rows;
//   * a window row survives if it is alive (type > 0.5) and its squared
//     distance to the box, (gx*gx + gy*gy) + gz*gz with per-axis gaps
//     max(max(lo - x, x - hi), 0), is below cut2 = cut^2, cut the tables'
//     largest cutoff;
//   * survivors are numbered in (kk, row) order and the first P are kept;
//     every row of the tile writes max(survivors - P, 0) to OCNT;
//   * the force physics (sph_pair.cuh) sums each alive i over the kept
//     survivors, the capillary terms on every pair (no RMIX gate, as in
//     the band and column sweeps);
//   * a tile without an alive row writes zeros.
// The filter forms positions and gaps with round-to-nearest intrinsics,
// never contracted into FMAs, so it keeps exactly the survivors the plain
// version keeps, and overflow counts agree exactly.
//
// What it does not carry over: the one-hot MXU gather, the triangular
// prefix matmul and the bbox-centre position shift, which exist because
// the TPU gathers by matmul in bf16 passes. Here a survivor is copied to
// shared memory exactly, and dx = x_i - (x_j + shift) is formed in
// sph_pair.cuh's order.
//
// Work split (compact_filter_kernel, compact_force_launch). One block of
// 64 threads per (column, tile), thread r < ts holding i row r; a warp's
// rows lie in one tile. Two passes, in turns:
//   (a) compaction: for each offset the block strides over the tile's
//       window kStep rows at a time, each thread testing kRowsPerThread
//       rows (four global loads each, issued together, and the ball-box
//       test); a ballot per row set and warp, a shared count per (row set,
//       warp) and a running count number the step's survivors in row
//       order, with one barrier a step. Kept survivors are staged by the
//       thread that found them, with their per-j terms (stage_j), into a
//       chunk of kStage rows. Counting goes on past P, for OCNT.
//   (b) when a step's kept survivors would overfill the chunk, and at the
//       end, each warp with an alive row sums the chunk through
//       warp_filter.cuh's filter_window: a row per lane against the box of
//       the warp's alive rows (the cutoff plus the float32 margin of
//       WarpBox), each lane's exact test of the box's survivors, and the
//       warp pair queue, each owner adding its pairs in queue order.
// Chunks are staged in (kk, row) order and each i row adds its pairs in
// that order through the same pair_rsq / pair_body, so the sums keep the
// bits of the one-pass check kernel (compact_scan_kernel,
// compact_force_scan_launch, on no path): its every alive i runs pair_sum
// over every staged survivor in lockstep, the body wherever any lane of
// the warp has a live pair (on the 1M `dynamic` layout a row has ~110 live
// pairs among its tile's ~750 kept rows, and a warp's body runs for ~430
// of them; the queue runs ~113 passes). The tile's exact test decides
// the kept set; a warp's box only drops rows that hold no live pair of its
// rows, so a warp with no alive row sums nothing and writes zeros.
//
// What bounds it: the chunks' box, exact-test and queue passes, most of a
// thread's cycles, then the compaction's barrier steps (nnbr*W / kStep a
// tile, 27 at W 384); the body passes follow the warp's live pairs / 32
// rather than every kept row any lane pairs with
// (mxu_compact.compact_pass_counts counts both on any device). Shared
// memory: the tables, a chunk of kStage staged rows (18 floats each) and the
// i rows and pair queues, ~18 KB a block; ten blocks an SM at 96 registers
// a thread. Larger chunks mean fewer chunk passes and barriers but fewer
// blocks an SM, and the shapes measured trade the two differently on the
// two bench layouts: one build, the fastest shape on the `dynamic` layout
// (W 384), where none was faster on both (python -m
// tpusph_torch.compact_shapes times the others against it; a pick by the
// occupancy API, as pick_build makes, cannot see the chunk count). Built
// without fast-math: IEEE divides and square roots.

#include <cuda_runtime.h>

#include "sph_pair.cuh"
#include "warp_filter.cuh"

namespace {

using namespace sph;

constexpr int kThreads = 64;                // one block per i-tile, ts <= 64
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e30f;               // bbox fill of a dead row
enum { OCNT = 7 };
// the check kernel: a window row per thread a step, chunks of 256 staged
// survivors, 64 registers a thread (sixteen blocks an SM)
constexpr int kScanStage = 256;
constexpr int kScanBlocks = 16;
// the filtered kernel: kRowsPerThread window rows per thread a step,
// chunks of kStage staged survivors, ten blocks an SM (96 registers a
// thread): the shape chosen by tpusph_torch/compact_shapes.py (above)
constexpr int kRowsPerThread = 2;
constexpr int kStep = kThreads * kRowsPerThread;
constexpr int kStage = 128;
constexpr int kFilterBlocks = 10;
// a step's kept survivors fit an emptied chunk
static_assert(kStep <= kStage, "chunk length");

struct Geo {
  int n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr;
};

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The ball-box gap of one axis: max(max(lo - x, x - hi), 0).
__device__ __forceinline__ float box_gap(float x, float lo, float hi) {
  return fmaxf(fmaxf(__fsub_rn(lo, x), __fsub_rn(x, hi)), 0.f);
}

// Whether window row j (alive, image shift (sx, sy)) survives the tile's
// box [lo, hi]: its squared distance below cut2, formed as the plain
// version forms it.
__device__ __forceinline__ bool survives(float t, float x, float y, float z,
                                         float sx, float sy,
                                         const float lo[3],
                                         const float hi[3], float cut2) {
  const float gx = box_gap(__fadd_rn(x, sx), lo[0], hi[0]);
  const float gy = box_gap(__fadd_rn(y, sy), lo[1], hi[1]);
  const float gz = box_gap(z, lo[2], hi[2]);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)),
                             __fmul_rn(gz, gz));
  return t > 0.5f && d2 < cut2;
}

// The tile's box over its alive rows (every thread of the block takes
// part), then whether the tile has an alive row (the barrier that also
// publishes the tables); a tile without one writes zeros.
__device__ __forceinline__ bool tile_box(const float* __restrict__ fld,
                                         int n, int i, bool has_i,
                                         bool alive, float (*s_box)[kWarps],
                                         float lo[3], float hi[3],
                                         float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float v[6];
  for (int a = 0; a < 3; ++a) {
    const float x = alive ? fld[(RX + a) * n + i] : 0.f;
    v[a] = warp_min(alive ? x : kBig);
    v[3 + a] = warp_max(alive ? x : -kBig);
  }
  if (lane == 0) {
    for (int a = 0; a < 6; ++a) s_box[a][warp] = v[a];
  }
  if (!__syncthreads_or(alive)) {
    if (has_i) {
      for (int r = 0; r < 8; ++r) out[r * n + i] = 0.f;
    }
    return false;
  }
  for (int a = 0; a < 3; ++a) {
    lo[a] = s_box[a][0];
    hi[a] = s_box[3 + a][0];
    for (int w = 1; w < kWarps; ++w) {
      lo[a] = fminf(lo[a], s_box[a][w]);
      hi[a] = fmaxf(hi[a], s_box[3 + a][w]);
    }
  }
  return true;
}

// Tile t's window of offset kk: column jc (-1: none), rows [wlo, whi).
struct Window {
  int jc, wlo, whi;
  float sx, sy;
};

__device__ __forceinline__ Window tile_window(const Geo& g,
                                              const int* __restrict__ perm,
                                              const float* __restrict__ shift,
                                              const int* __restrict__ delta,
                                              int c, int b, int tt, int kk) {
  Window w;
  w.jc = perm[c * g.nnbr + kk];
  int bb = b + delta[(c * g.nnbr + kk) * g.nblocks + b];
  bb = min(max(bb, 0), g.nblocks - 1);
  const int tp = bb * g.t_blk + tt;
  w.wlo = max(tp * g.ts - g.ch * g.mlo, 0);
  w.whi = min(tp * g.ts + g.ts + g.ch * g.mhi, g.col_cap);
  w.sx = shift[(c * g.nnbr + kk) * 2];
  w.sy = shift[(c * g.nnbr + kk) * 2 + 1];
  return w;
}

__device__ __forceinline__ void write_rows(float* __restrict__ out, int n,
                                           int i, const float acc[6],
                                           int over) {
  out[OFX * n + i] = acc[0];
  out[OFY * n + i] = acc[1];
  out[OFZ * n + i] = acc[2];
  out[ODRHO * n + i] = acc[3];
  out[ODE * n + i] = acc[4];
  out[ORHO * n + i] = 0.f;
  out[OCGX * n + i] = 0.f;
  out[OCNT * n + i] = (float)over;
}

// ---- the check kernel: every alive i over every staged survivor ----------

// Every alive i row's sums over the staged rows [0, nstaged).
__device__ __forceinline__ void sum_staged(const float* __restrict__ win,
                                           int nstaged,
                                           const float* __restrict__ fld,
                                           int n, int i, bool alive,
                                           const Tables& tb, const Phys& p,
                                           float acc[6]) {
  if (!alive) return;
  const IRow ir = load_i<SW_FORCE>(fld, n, i, tb, p, (p.flags & FL_ST) != 0);
  for (int k = 0; k < nstaged; ++k) {
    pair_sum<SW_FORCE>(win, kScanStage, k, ir, tb, p, acc);
  }
}

// The one-pass kernel, kept to hold the filtered kernel to: a window row per
// thread a step (one barrier a step); when the chunk could not take
// another step's survivors, every alive i runs pair_sum over it.
__global__ void __launch_bounds__(kThreads, kScanBlocks)
compact_scan_kernel(const float* __restrict__ fld,
                    const int* __restrict__ perm,
                    const float* __restrict__ shift,
                    const int* __restrict__ delta,
                    const float* __restrict__ tab2g,
                    const float* __restrict__ tab1g, Geo g, Phys p, int P,
                    float cut2, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_box[6][kWarps];
  __shared__ int s_cnt[2][kWarps];
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  float* win = smem + table_floats(p.T1);    // [SF_NF][kScanStage]

  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = t / g.t_blk;
  const int tt = t - b * g.t_blk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_i = threadIdx.x < g.ts;
  const int i = c * g.col_cap + t * g.ts + threadIdx.x;
  const bool alive = has_i && fld[RTYPE * n + i] > 0.5f;
  float lo[3], hi[3];
  if (!tile_box(fld, n, i, has_i, alive, s_box, lo, hi, out)) return;

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int found = 0;   // survivors so far, all offsets (uniform)
  int staged = 0;  // kept survivors staged and not yet summed (uniform)
  int par = 0;     // which s_cnt row this step writes
  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = tile_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block
    for (int r0 = w.wlo; r0 < w.whi; r0 += kThreads) {
      if (staged > kScanStage - kThreads) {
        __syncthreads();  // the staged rows are written
        sum_staged(win, staged, fld, n, i, alive, tb, p, acc);
        __syncthreads();  // and read
        staged = 0;
      }
      const int row = r0 + threadIdx.x;
      const int j = w.jc * g.col_cap + row;
      const bool keep = row < w.whi &&
          survives(fld[RTYPE * n + j], fld[RX * n + j], fld[RY * n + j],
                   fld[RZ * n + j], w.sx, w.sy, lo, hi, cut2);
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_cnt[par][warp] = __popc(bal);
      __syncthreads();
      // s_cnt[par] is written again two steps on, after every thread has
      // passed the next step's barrier, so one barrier per step suffices
      int off = __popc(bal & ((1u << lane) - 1u));
      int total = 0;
      for (int q = 0; q < kWarps; ++q) {
        const int cw = s_cnt[par][q];
        off += q < warp ? cw : 0;
        total += cw;
      }
      if (keep && found + off < P) {
        stage_j<SW_FORCE>(win, kScanStage, staged + off, fld, n, j, w.sx,
                          w.sy, 0.f, true, tb, p);
      }
      staged += max(min(found + total, P) - found, 0);
      found += total;
      par ^= 1;
    }
  }
  __syncthreads();
  sum_staged(win, staged, fld, n, i, alive, tb, p, acc);
  if (has_i) write_rows(out, n, i, acc, max(found - P, 0));
}

// ---- the filtered kernel: compaction, then the warp box filter and queue --

__global__ void __launch_bounds__(kThreads, kFilterBlocks)
compact_filter_kernel(const float* __restrict__ fld,
                      const int* __restrict__ perm,
                      const float* __restrict__ shift,
                      const int* __restrict__ delta,
                      const float* __restrict__ tab2g,
                      const float* __restrict__ tab1g, Geo g, Phys p, int P,
                      float cut2, float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ float s_box[6][kWarps];
  __shared__ int s_cnt[2][kRowsPerThread][kWarps];
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  float* win = smem + table_floats(p.T1);    // [SF_NF][kStage]
  float* sir = win + SF_NF * kStage;         // queue_floats(kThreads)

  const int n = g.n_slots;
  const int c = blockIdx.x;
  const int t = blockIdx.y;
  const int b = t / g.t_blk;
  const int tt = t - b * g.t_blk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool has_i = threadIdx.x < g.ts;
  const int i = c * g.col_cap + t * g.ts + threadIdx.x;
  const bool alive = has_i && fld[RTYPE * n + i] > 0.5f;
  float lo[3], hi[3];
  if (!tile_box(fld, n, i, has_i, alive, s_box, lo, hi, out)) return;

  // the warp's rows (a partial warp at ts 16 or 48): their box, their
  // hoisted values in shared memory, their pair queue
  const int nlanes = min(max(g.ts - warp * 32, 0), 32);
  const unsigned wmask = nlanes == 32 ? 0xffffffffu : (1u << nlanes) - 1u;
  IRow ir{};
  WarpBox bx{};
  WarpQueue wq{};
  bool sums = false;  // the lane's warp has an alive row
  if (has_i) {
    ir = load_i<SW_FORCE>(fld, n, i, tb, p, (p.flags & FL_ST) != 0);
    put_irow(sir, kThreads, threadIdx.x, ir);
    wq = warp_queue(sir, kThreads, warp, lane);
    sums = __any_sync(wmask, alive);
    bx = warp_box(ir, alive, wmask, sqrtf(p.cutmax2));
  }

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const unsigned lanes_below = (1u << lane) - 1u;
  int found = 0;   // survivors so far, all offsets (uniform)
  int staged = 0;  // kept survivors staged and not yet summed (uniform)
  int par = 0;     // which s_cnt row this step writes
  for (int kk = 0; kk < g.nnbr; ++kk) {
    const Window w = tile_window(g, perm, shift, delta, c, b, tt, kk);
    if (w.jc < 0) continue;  // uniform over the block
    for (int r0 = w.wlo; r0 < w.whi; r0 += kStep) {
      // (a) rows r0 + q*64 + thread: all loads first, then the tests
      int j[kRowsPerThread];
      float f[kRowsPerThread][4];
      for (int q = 0; q < kRowsPerThread; ++q) {
        const int row = r0 + q * kThreads + threadIdx.x;
        j[q] = w.jc * g.col_cap + row;
        for (int a = 0; a < 4; ++a) {
          f[q][a] = row < w.whi ? fld[(a < 3 ? RX + a : RTYPE) * n + j[q]]
                                : 0.f;
        }
      }
      bool keep[kRowsPerThread];
      unsigned bal[kRowsPerThread];
      for (int q = 0; q < kRowsPerThread; ++q) {
        keep[q] = survives(f[q][3], f[q][0], f[q][1], f[q][2], w.sx, w.sy,
                           lo, hi, cut2);
        bal[q] = __ballot_sync(0xffffffffu, keep[q]);
        if (lane == 0) s_cnt[par][q][warp] = __popc(bal[q]);
      }
      __syncthreads();
      // numbered in row order: row set q, then warp, then lane; s_cnt[par]
      // is written again two steps on, after every thread has passed the
      // next step's barrier, so one barrier a step suffices
      int off[kRowsPerThread];
      int total = 0;
      for (int q = 0; q < kRowsPerThread; ++q) {
        for (int v = 0; v < kWarps; ++v) {
          if (v == warp) off[q] = total + __popc(bal[q] & lanes_below);
          total += s_cnt[par][q][v];
        }
      }
      const int nkeep = max(min(found + total, P) - found, 0);
      if (staged + nkeep > kStage) {
        // (b) the chunk, staged before this step's barrier, is full
        if (sums) {
          filter_window<SW_FORCE>(win, kStage, 0, staged, true, 0, 0, bx,
                                  ir, alive, wmask, lane, nlanes, wq, sir,
                                  warp * 32, tb, p, acc);
        }
        __syncthreads();  // and read
        staged = 0;
      }
      for (int q = 0; q < kRowsPerThread; ++q) {
        if (keep[q] && found + off[q] < P) {
          stage_j<SW_FORCE>(win, kStage, staged + off[q], fld, n, j[q], w.sx,
                            w.sy, 0.f, true, tb, p);
        }
      }
      staged += nkeep;
      found += total;
      par ^= 1;
    }
  }
  __syncthreads();  // the last chunk is staged
  if (sums && staged > 0) {
    filter_window<SW_FORCE>(win, kStage, 0, staged, true, 0, 0, bx, ir,
                            alive, wmask, lane, nlanes, wq, sir, warp * 32,
                            tb, p, acc);
  }
  if (has_i) write_rows(out, n, i, acc, max(found - P, 0));
}

using CompactFn = void (*)(const float*, const int*, const float*,
                           const int*, const float*, const float*, Geo, Phys,
                           int, float, float*);

// Launches the filtered kernel or (SCAN) its one-pass check kernel.
template <bool SCAN>
int launch(const float* fld, const int* perm, const float* shift,
           const int* delta, const float* tab2, const float* tab1, float* out,
           int n_slots, int ncols, int col_cap, int ts, int ch, int t_blk,
           int nblocks, int mlo, int mhi, int nnbr, int dim, int kern,
           int flags, int T1, int P, float cutmax2, float cut2,
           void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  // no virial row: its sum is not formed
  Phys p{dim, kern, flags & ~FL_VIRIAL, T1, cutmax2};
  if (ts < 1 || ts > kThreads || col_cap % ts != 0 || ncols < 1 ||
      nblocks < 1 || col_cap / ts > 65535 || T1 < 1 || P < 0) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const CompactFn kernel = SCAN ? compact_scan_kernel : compact_filter_kernel;
  const size_t smem = sizeof(float)
      * (table_floats(T1) + (SCAN ? SF_NF * kScanStage
                                  : SF_NF * kStage + queue_floats(kThreads)));
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(ncols, col_cap / ts);
  kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, tab2, tab1, g, p, P, cut2, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define COMPACT_ARGS                                                        \
  const float *fld, const int *perm, const float *shift, const int *delta, \
      const float *tab2, const float *tab1, float *out, int n_slots,       \
      int ncols, int col_cap, int ts, int ch, int t_blk, int nblocks,      \
      int mlo, int mhi, int nnbr, int dim, int kern, int flags, int T1,    \
      int P, float cutmax2, float cut2, void *stream
#define COMPACT_PASS                                                     \
  fld, perm, shift, delta, tab2, tab1, out, n_slots, ncols, col_cap, ts, \
      ch, t_blk, nblocks, mlo, mhi, nnbr, dim, kern, flags, T1, P, cutmax2, \
      cut2, stream

extern "C" int compact_force_launch(COMPACT_ARGS) {
  return launch<false>(COMPACT_PASS);
}

// the one-pass kernel: a check kernel, on no path
extern "C" int compact_force_scan_launch(COMPACT_ARGS) {
  return launch<true>(COMPACT_PASS);
}

extern "C" const char* compact_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
