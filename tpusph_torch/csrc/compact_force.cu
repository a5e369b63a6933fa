// The compacted force sweep over the strip windows for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// tpusph/ops/mxu_compact.py::make_compact_force_kernel (the pl.pallas_call
// at mxu_compact.py:277). The pair physics (staging, the per-pair terms) is
// sph_pair.cuh's, shared with the strip, column and band sweeps; the plain
// PyTorch version tpusph_torch/ops/mxu_compact.py::plain_compact_force is
// the reference this kernel is held against.
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
// Work split. One block of 64 threads per (column, tile), thread r < ts
// holding i row r. For each offset the block strides over the tile's
// window, 64 rows at a time: each thread tests one row (four global loads
// and the ball-box test), a warp ballot and the population count of the
// lower lanes give its position among the step's survivors, a shared
// count per warp orders the two warps, and a running count orders the
// steps. Kept survivors are staged by the thread that found them, with
// their per-j terms (stage_j), into a shared buffer of kStage rows; when it
// could not take another step's survivors, every alive i sums over it and
// it empties. Counting goes on past P, for OCNT.
//
// What bounds it: instruction throughput. Of the nnbr*W window rows per i
// row (about 3.5k at W 384) a few percent are live; here each window row is
// tested once per tile, not once per i row, and an i row's pair loop runs
// over the tile's survivors only (about P). Shared
// memory is a fixed kStage rows, whatever P is; registers are capped at 64
// a thread (sixteen 64-thread blocks per SM), as in the other sweeps.
// Built without fast-math: IEEE divides and square roots.

#include <cuda_runtime.h>

#include "sph_pair.cuh"

namespace {

using namespace sph;

constexpr int kThreads = 64;                // one block per i-tile, ts <= 64
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 256;                 // staged survivors per chunk
constexpr int kMinBlocks = 16;              // 64 registers a thread
constexpr float kBig = 1e30f;               // bbox fill of a dead row
enum { OCNT = 7 };

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
    pair_sum<SW_FORCE>(win, kStage, k, ir, tb, p, acc);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
compact_force_kernel(const float* __restrict__ fld,
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
  float* win = smem + table_floats(p.T1);    // [SF_NF][kStage]

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

  // the tile's bounding box over its alive rows' current positions
  {
    float v[6];
    for (int a = 0; a < 3; ++a) {
      const float x = alive ? fld[(RX + a) * n + i] : 0.f;
      v[a] = warp_min(alive ? x : kBig);
      v[3 + a] = warp_max(alive ? x : -kBig);
    }
    if (lane == 0) {
      for (int a = 0; a < 6; ++a) s_box[a][warp] = v[a];
    }
  }
  // (also the barrier that publishes the tables and the box)
  if (!__syncthreads_or(alive)) {
    if (has_i) {
      for (int r = 0; r < 8; ++r) out[r * n + i] = 0.f;
    }
    return;
  }
  float lo[3], hi[3];
  for (int a = 0; a < 3; ++a) {
    lo[a] = s_box[a][0];
    hi[a] = s_box[3 + a][0];
    for (int w = 1; w < kWarps; ++w) {
      lo[a] = fminf(lo[a], s_box[a][w]);
      hi[a] = fmaxf(hi[a], s_box[3 + a][w]);
    }
  }

  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int found = 0;   // survivors so far, all offsets (uniform)
  int staged = 0;  // kept survivors staged and not yet summed (uniform)
  int par = 0;     // which s_cnt row this step writes
  for (int kk = 0; kk < g.nnbr; ++kk) {
    const int jc = perm[c * g.nnbr + kk];
    if (jc < 0) continue;  // uniform over the block
    int bb = b + delta[(c * g.nnbr + kk) * g.nblocks + b];
    bb = min(max(bb, 0), g.nblocks - 1);
    const int tp = bb * g.t_blk + tt;
    const int wlo = max(tp * g.ts - g.ch * g.mlo, 0);
    const int whi = min(tp * g.ts + g.ts + g.ch * g.mhi, g.col_cap);
    const float sx = shift[(c * g.nnbr + kk) * 2];
    const float sy = shift[(c * g.nnbr + kk) * 2 + 1];
    for (int r0 = wlo; r0 < whi; r0 += kThreads) {
      if (staged > kStage - kThreads) {
        __syncthreads();  // the staged rows are written
        sum_staged(win, staged, fld, n, i, alive, tb, p, acc);
        __syncthreads();  // and read
        staged = 0;
      }
      const int row = r0 + threadIdx.x;
      const int j = jc * g.col_cap + row;
      bool keep = false;
      if (row < whi && fld[RTYPE * n + j] > 0.5f) {
        const float gx = box_gap(__fadd_rn(fld[RX * n + j], sx), lo[0],
                                 hi[0]);
        const float gy = box_gap(__fadd_rn(fld[RY * n + j], sy), lo[1],
                                 hi[1]);
        const float gz = box_gap(fld[RZ * n + j], lo[2], hi[2]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(gx, gx),
                                             __fmul_rn(gy, gy)),
                                   __fmul_rn(gz, gz));
        keep = d2 < cut2;
      }
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_cnt[par][warp] = __popc(bal);
      __syncthreads();
      // s_cnt[par] is written again two steps on, after every thread has
      // passed the next step's barrier, so one barrier per step suffices
      int off = __popc(bal & ((1u << lane) - 1u));
      int total = 0;
      for (int w = 0; w < kWarps; ++w) {
        const int cw = s_cnt[par][w];
        off += w < warp ? cw : 0;
        total += cw;
      }
      if (keep && found + off < P) {
        stage_j<SW_FORCE>(win, kStage, staged + off, fld, n, j, sx, sy, 0.f,
                          true, tb, p);
      }
      staged += max(min(found + total, P) - found, 0);
      found += total;
      par ^= 1;
    }
  }
  __syncthreads();
  sum_staged(win, staged, fld, n, i, alive, tb, p, acc);
  if (has_i) {
    out[OFX * n + i] = acc[0];
    out[OFY * n + i] = acc[1];
    out[OFZ * n + i] = acc[2];
    out[ODRHO * n + i] = acc[3];
    out[ODE * n + i] = acc[4];
    out[ORHO * n + i] = 0.f;
    out[OCGX * n + i] = 0.f;
    out[OCNT * n + i] = (float)max(found - P, 0);
  }
}

}  // namespace

extern "C" int compact_force_launch(const float* fld, const int* perm,
                                    const float* shift, const int* delta,
                                    const float* tab2, const float* tab1,
                                    float* out, int n_slots, int ncols,
                                    int col_cap, int ts, int ch, int t_blk,
                                    int nblocks, int mlo, int mhi, int nnbr,
                                    int dim, int kern, int flags, int T1,
                                    int P, float cutmax2, float cut2,
                                    void* stream) {
  Geo g{n_slots, ncols, col_cap, ts, ch, t_blk, nblocks, mlo, mhi, nnbr};
  // no virial row: its sum is not formed
  Phys p{dim, kern, flags & ~FL_VIRIAL, T1, cutmax2};
  if (ts < 1 || ts > kThreads || col_cap % ts != 0 || ncols < 1 ||
      nblocks < 1 || col_cap / ts > 65535 || T1 < 1 || P < 0) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float) * (table_floats(T1) + SF_NF * kStage);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        compact_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(ncols, col_cap / ts);
  compact_force_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      fld, perm, shift, delta, tab2, tab1, g, p, P, cut2, out);
  return (int)cudaGetLastError();
}

extern "C" const char* compact_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
