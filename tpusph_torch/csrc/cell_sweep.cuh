// The rho, colour-gradient and force sweeps over the cell layouts, filter
// then compute: one kernel for the column kernel's cell grid
// (column_sweeps.cu) and the band's slot-resident sub-cells
// (band_sweeps.cu).
//
// The two layouts are one shape. fld is the (16, n_slots) float32 field
// matrix with slot = (column * nsub_pad + sub) * c + rank: columns tile the
// plane (xy in 3D, x in 2D), each is cut into nsub_pad sub-cells of c slots
// along the column axis (z in 3D, y in 2D), and a group of G sub-cells is
// one i group whose window in each of the 9 (3D) / 3 (2D) neighbour columns
// is its G sub-cells and k margin sub-cells on each side. The column grid
// is that layout with G = 1, k = 1, c = cap and nsub_pad = ncz. One kernel
// serves both because the two differences between them do not reach it:
// empty column slots (zero, type 0) and dead band slots (far sentinel,
// type 0) are both staged as no candidate by their type, and a periodic
// column axis shorter than the window (the column grid's ncz < 3) stages
// one sub-cell more than once under different shifts, as the one-pass scan
// does (the band launcher refuses it, as before). The layout tag only
// names the kernel in a profile.
//
// Work split. One block per (column, group, chunk of up to kCellThreads
// slots of the group), one thread per i slot: a group's alive rows sit at
// the low ranks of its sub-cells, so the chunks past them hold no alive row
// and exit at their first barrier, and the block's warps are those of the
// live ranks, not of the whole cap (the one-pass scan's blocks span the
// group: at cap 280 and ~64 rows a cell, 7 of its 9 warps hold no alive
// row). For each neighbour column the block finds the live reach of each
// staged sub-cell (one past its last candidate rank; on the column grid
// from the cell's alive prefix, below), and stages the
// staged sub-cells' rows below their reach, in (sub-cell, rank) order, at
// most `ld` rows a round, with the image shift added to the positions and
// the per-j terms computed once. A row outside the block's box (the union
// of its warps' WarpBox, which keeps every row any warp box keeps) is
// staged as no candidate without its terms. Each warp then runs
// warp_filter.cuh's filter_window over the round: its box test, then each
// lane's exact test of the survivors; force queues its live pairs in the
// warp pair queue, flushed before the next round is staged, while rho and
// the colour gradient add each live pair at once (their body is a few
// operations).
//
// The live reach on the column grid. The band reads the type of every
// slot of every staged sub-cell (its slots are sentinel-dead, in no
// order), in a ballot pass per neighbour column. A column cell's alive
// rows are a prefix, and the reach comes from it without reading the cap:
// grid.build sorts a cell's alive rows to ranks [0, count) and sends dead
// rows to the sentinel cell; pack_dense drops rows that are not alive and
// ranks at or above the cap; and an insertion by fix phase_change forces
// a rebuild before the next force pass (its new rows, still in the
// sentinel cell, are not packed before it). So at every sweep a cell's
// alive slots are exactly its first min(count, cap) ranks, and the
// kernel relies on it. Before its first neighbour column the block takes
// the alive prefix of all 27 (3D) / 9 (2D) staged cells, one thread a cell
// by a binary search over type > 0.5 (ceil(log2(cap + 1)) reads, 7 at cap
// 112, 9 at cap 280, against the cap's 112 or 280): rho and force stage
// each cell to its prefix, the ballot pass's reach. The colour gradient
// then runs the ballot pass for its gate over the prefixes only, every
// neighbour column in one pass (~1,700 type reads a block at 1M, ~64 rows
// a cell, against 27 x cap), and skips the neighbour columns left with no
// candidate without a barrier.
//
// The colour gate (colour gradient only). A pair of one colour adds
// exactly zero (pair_body returns first), and at 1M after the band path
// 0.56% of the live pairs are of unlike types (a thin shell about the
// vapour sphere). The block forms the set of its alive rows' types and the
// types whose colour differs from one of theirs (unlike_types); a j row of
// another type is no candidate: the live reach counts only candidates, so
// a neighbour column with none is not staged, and a block with none in any
// neighbour column exits without writing (the wrapper zeroes `out`; the
// one-pass scan writes +0.0 on such rows). Each warp's box test applies
// the same gate with its own types.
//
// Bits. A row sums its pairs in (neighbour column, sub-cell, rank) order,
// the order of the one-pass scan (column_sweeps.cu / band_sweeps.cu's
// *_sweep_kernel, kept as the check kernels *_scan_launch), with the same
// pair arithmetic (a queued pair's terms are pair_body's into zeros, added
// by its owner in queue order): the sums are the one-pass scan's, bit for
// bit.
//
// What bounds it: instruction throughput and latency of the live pairs'
// body (force: 32 pairs a pass; rho and cgrad: in lockstep where any lane
// has a live pair), then the box filter's exact tests (a warp of rows
// spread over a whole cell keeps 410-620 rows at 1M) and the staging,
// which each chunk repeats for its group's window (read from L2); most of
// the gated colour gradient's blocks read only their windows' types (on
// the column grid only their alive prefixes').
// Resident warps decide the speed. Force stages 18 floats a row and its
// queue: 256 rows a round (~36 KB a block) and the five- or six-block
// build (88 or 80 registers); rho and cgrad stage 5 floats and no queue:
// 512 rows (~11 KB, a band window in one round) and the twelve- or
// sixteen-block build (40 or 32 registers). The occupancy API picks the
// build (warp_filter.cuh, pick_build); other budgets and builds measured
// slower on the 1M bench layouts (PERF.md, Findings). Built without
// fast-math: IEEE divides and square roots.
#pragma once

#include <cuda_runtime.h>

#include "sph_pair.cuh"
#include "warp_filter.cuh"

namespace sph {

constexpr int kCellThreads = 128;    // i slots per block (a chunk)
constexpr int kMaxStagedCells = 96;  // staged sub-cells G + 2k
constexpr int kColStaged = 27;       // column: 9 neighbour columns x 3 cells
enum { L_COLUMN = 0, L_BAND = 1 };

// Per sweep: staged rows per round, at most, and the two builds (blocks an
// SM) the occupancy API picks from.
template <int SWEEP>
struct CellBuild {
  static constexpr int rows = 512, fewer = 12, more = 16;
};
template <>
struct CellBuild<SW_FORCE> {
  static constexpr int rows = 256, fewer = 5, more = 6;
};

struct CellGeo {
  int n_slots, ncx, ncy, nsub_pad, G, c, k, dim;
  int per_x, per_y, per_col;  // periodic plane axes, periodic column axis
  float lx, ly, lcol;         // box lengths: plane x, plane y, column axis
};

// Staged sub-cell `sub` (in [-k, nsub_pad + k)) of a neighbour column: its
// sub-cell in the layout and the column-axis shift, or false past a
// non-periodic column end. k <= nsub_pad: one wrap reaches the other end.
__device__ __forceinline__ bool wrap_sub(const CellGeo& g, int& sub,
                                         float& sz) {
  sz = 0.f;
  if (sub >= 0 && sub < g.nsub_pad) return true;
  if (!g.per_col) return false;
  sz = sub < 0 ? -g.lcol : g.lcol;
  sub = sub < 0 ? sub + g.nsub_pad : sub - g.nsub_pad;
  return true;
}

// Neighbour column (ox, oy) of the plane column (cx, cy): its first slot
// and plane shift, or false past a non-periodic plane edge.
__device__ __forceinline__ bool nbr_column(const CellGeo& g, int cx, int cy,
                                           int ox, int oy, int& jbase,
                                           float& sx, float& sy) {
  int nx = cx + ox, ny = cy + oy;
  sx = 0.f;
  sy = 0.f;
  if (nx < 0 || nx >= g.ncx) {
    if (!g.per_x) return false;
    sx = nx < 0 ? -g.lx : g.lx;
    nx = nx < 0 ? nx + g.ncx : nx - g.ncx;
  }
  if (g.dim == 3 && (ny < 0 || ny >= g.ncy)) {
    if (!g.per_y) return false;
    sy = ny < 0 ? -g.ly : g.ly;
    ny = ny < 0 ? ny + g.ncy : ny - g.ncy;
  }
  jbase = (g.dim == 3 ? nx * g.ncy + ny : nx) * g.nsub_pad * g.c;
  return true;
}

// The length of a column cell's alive prefix (`ty`: its c type slots),
// which is one past its last alive rank: a binary search over type > 0.5,
// ceil(log2(c + 1)) reads at most. It rests on the column layout's
// invariant (see the kernel).
__device__ __forceinline__ int alive_prefix(const float* __restrict__ ty,
                                            int c) {
  int lo = 0, hi = c;  // ranks below lo alive, ranks from hi on dead
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ty[mid] > 0.5f) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

template <int SWEEP, int LAYOUT, int MIN_BLOCKS>
__global__ void __launch_bounds__(kCellThreads, MIN_BLOCKS)
cell_sweep_kernel(const float* __restrict__ fld,
                  const float* __restrict__ tab2g,
                  const float* __restrict__ tab1g, CellGeo g, Phys p,
                  int ld, float* __restrict__ out) {
  constexpr bool kQueued = SWEEP == SW_FORCE;
  constexpr bool kGate = SWEEP == SW_CGRAD;
  constexpr bool kCol = LAYOUT == L_COLUMN;
  extern __shared__ float smem[];
  // band: per staged sub-cell of the current neighbour column its live
  // reach, and their running sum (a round's rows are the (sub-cell, rank)
  // sequence's [base, base + ld))
  __shared__ int reach[kCol ? 1 : kMaxStagedCells];
  __shared__ int off[kCol ? 1 : kMaxStagedCells + 1];
  // column: the live reach of every staged cell of the block, all
  // neighbour columns at once; cgrad also each cell's first slot and the
  // running sum of the cells' alive prefixes
  __shared__ int creach[kCol ? kColStaged : 1];
  __shared__ int cfirst[kCol && kGate ? kColStaged : 1];
  __shared__ int cpre[kCol && kGate ? kColStaged + 1 : 1];
  __shared__ float wbox[kCellThreads / 32][6];
  __shared__ unsigned wtypes[kCellThreads / 32];
  __shared__ WarpBox bbox;
  __shared__ unsigned bgate;  // the block's colour gate
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  float* win = smem + table_floats(p.T1);       // [NumFields<SWEEP>][ld]
  float* sir = win + NumFields<SWEEP>::v * ld;  // force: queue_floats

  const int n = g.n_slots;
  const int col = blockIdx.x;
  const int grp = blockIdx.y;
  const int gc = g.G * g.c;
  const int col_slots = g.nsub_pad * g.c;
  const int s = blockIdx.z * blockDim.x + threadIdx.x;  // slot in the group
  const int i = col * col_slots + grp * gc + s;
  const bool alive = s < gc && fld[RTYPE * n + i] > 0.5f;
  // a chunk without an alive slot writes nothing (also the barrier that
  // publishes the tables)
  if (!__syncthreads_or(alive)) return;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned wmask = 0xffffffffu;
  const bool dim3 = g.dim == 3;
  const int cx = dim3 ? col / g.ncy : col;
  const int cy = dim3 ? col - cx * g.ncy : 0;
  const int oy_reach = dim3 ? 1 : 0;
  const int nsw = g.G + 2 * g.k;
  const int sub0 = grp * g.G - g.k;  // first staged sub-cell
  const int ncs = kCol ? (dim3 ? 9 : 3) * 3 : 0;  // column: staged cells
  if (kCol) {
    // each staged cell's alive prefix, one thread a cell (published by the
    // barrier below); 0 past a non-periodic edge
    for (int t = threadIdx.x; t < ncs; t += blockDim.x) {
      const int kk = t / 3;
      int jbase = 0, sub = sub0 + t - 3 * kk;
      float sx, sy, sz;
      const bool ok = nbr_column(g, cx, cy, dim3 ? kk / 3 - 1 : kk - 1,
                                 dim3 ? kk % 3 - 1 : 0, jbase, sx, sy) &&
                      wrap_sub(g, sub, sz);
      const int first = ok ? jbase + sub * g.c : 0;
      creach[t] = ok ? alive_prefix(fld + RTYPE * n + first, g.c) : 0;
      if (kGate) cfirst[t] = first;
    }
  }
  IRow ir{};
  if (alive) {
    ir = load_i<SWEEP>(fld, n, i, tb, p, (p.flags & FL_ST) != 0);
  }
  WarpQueue wq{};
  if (kQueued) {
    put_irow(sir, blockDim.x, threadIdx.x, ir);
    wq = warp_queue(sir, blockDim.x, warp, lane);
  }
  const bool warp_alive = __any_sync(wmask, alive);
  const float rc = sqrtf(p.cutmax2);
  const WarpBox bx = warp_box(ir, alive, wmask, rc);
  unsigned wgate = ~0u;
  if (kGate) {
    const unsigned wset =
        __reduce_or_sync(wmask, alive ? type_bit(ir.t) : 0u);
    wgate = unlike_types(wset, tb);
    if (lane == 0) wtypes[warp] = wset;
  }
  if (lane == 0) put_box(wbox[warp], bx);
  __syncthreads();
  if (threadIdx.x == 0) {
    // the block's box: the union of its warps' (a dead warp's is empty),
    // and its colour gate from the union of their types; the first
    // barrier after it publishes both
    bbox = union_box(wbox, blockDim.x / 32, rc);
    if (kGate) {
      unsigned bset = 0u;
      for (int w = 0; w < (int)blockDim.x / 32; ++w) bset |= wtypes[w];
      bgate = unlike_types(bset, tb);
    }
    if (kCol && kGate) {
      // the alive prefixes' running sum; the pass below takes each cell's
      // reach anew
      cpre[0] = 0;
      for (int t = 0; t < ncs; ++t) {
        cpre[t + 1] = cpre[t] + creach[t];
        creach[t] = 0;
      }
    }
  }
  if (kCol && kGate) {
    // column cgrad: per staged cell one past the last rank of its alive
    // prefix that the block's gate keeps, per warp and cell from its
    // highest such lane; the prefixes of all neighbour columns in one pass
    __syncthreads();
    const int total = cpre[ncs];
    for (int w0 = 0; w0 < total; w0 += blockDim.x) {
      const int w = w0 + threadIdx.x;
      int t = -1, r = 0;
      bool live = false;
      if (w < total) {
        int lo = 0, hi = ncs;  // cpre[lo] <= w < cpre[hi]
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (cpre[mid] <= w) lo = mid; else hi = mid;
        }
        t = lo;
        r = w - cpre[lo];
        const float tj = fld[RTYPE * n + cfirst[t] + r];
        live = tj > 0.5f && gate_keeps(bgate, tj);
      }
      const unsigned same = __match_any_sync(wmask, t);
      const unsigned hit = __ballot_sync(wmask, live) & same;
      if (live && lane == 31 - __clz(hit)) atomicMax(&creach[t], r + 1);
    }
    __syncthreads();
  }
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  bool staged = false;  // any candidate row in any neighbour column

  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -oy_reach; oy <= oy_reach; ++oy) {
      // the neighbour column and its plane shift (uniform over the block)
      int jbase;
      float sx, sy;
      if (!nbr_column(g, cx, cy, ox, oy, jbase, sx, sy)) continue;
      int total, c1 = 0, c2 = 0;
      if (kCol) {
        // its three staged cells' reach, as running sums; a column with
        // no candidate is skipped (uniform over the block)
        const int* rr = creach + 3 * ((ox + 1) * (2 * oy_reach + 1) + oy +
                                      oy_reach);
        c1 = rr[0];
        c2 = c1 + rr[1];
        total = c2 + rr[2];
        if (total == 0) continue;
        __syncthreads();  // the previous column's readers are done
      } else {
        __syncthreads();  // the previous column's readers are done
        for (int d = threadIdx.x; d < nsw; d += blockDim.x) reach[d] = 0;
        __syncthreads();
        // live reach: per warp and staged sub-cell, its highest candidate
        // lane (a candidate: alive and, for cgrad, kept by the block's
        // gate)
        for (int w0 = 0; w0 < nsw * g.c; w0 += blockDim.x) {
          const int w = w0 + threadIdx.x;
          const int d = w / g.c;
          const int r = w - d * g.c;
          int sub = sub0 + d;
          float sz;
          bool live = w < nsw * g.c && wrap_sub(g, sub, sz);
          if (live) {
            const float tj = fld[RTYPE * n + jbase + sub * g.c + r];
            live = tj > 0.5f && (!kGate || gate_keeps(bgate, tj));
          }
          const unsigned same =
              __match_any_sync(wmask, w < nsw * g.c ? d : -1);
          const unsigned hit = __ballot_sync(wmask, live) & same;
          if (live && lane == 31 - __clz(hit)) atomicMax(&reach[d], r + 1);
        }
        __syncthreads();
        if (threadIdx.x == 0) {
          off[0] = 0;
          for (int d = 0; d < nsw; ++d) off[d + 1] = off[d] + reach[d];
        }
        __syncthreads();
        total = off[nsw];
      }
      staged = staged || total > 0;
      for (int base = 0; base < total; base += ld) {
        const int rows = min(ld, total - base);
        if (base > 0) __syncthreads();  // the previous round's readers
        for (int q = threadIdx.x; q < rows; q += blockDim.x) {
          // the staged sub-cell of sequence row base + q, and its rank
          const int pos = base + q;
          int lo, r;
          if (kCol) {
            lo = (pos >= c1) + (pos >= c2);
            r = pos - (lo == 0 ? 0 : lo == 1 ? c1 : c2);
          } else {
            int hi = nsw;  // off[lo] <= pos < off[hi]
            lo = 0;
            while (hi - lo > 1) {
              const int mid = (lo + hi) >> 1;
              if (off[mid] <= pos) lo = mid; else hi = mid;
            }
            r = pos - off[lo];
          }
          int sub = sub0 + lo;
          float sz;
          wrap_sub(g, sub, sz);
          const int j = jbase + sub * g.c + r;
          // 3D: the column axis is z; 2D: it is y, and z is not shifted
          const float shy = dim3 ? sy : sz, shz = dim3 ? sz : 0.f;
          const float tj = fld[RTYPE * n + j];
          const bool live = tj > 0.5f &&
              (!kGate || gate_keeps(bgate, tj)) &&
              bbox.holds(fld[RX * n + j] + sx, fld[RY * n + j] + shy,
                         fld[RZ * n + j] + shz);
          stage_j<SWEEP>(win, ld, q, fld, n, j, sx, shy, shz, live, tb, p);
        }
        __syncthreads();
        if (warp_alive) {
          filter_window<SWEEP>(win, ld, 0, rows, true, 0, rows, bx, ir,
                               alive, wmask, lane, 32, wq, sir, warp * 32,
                               tb, p, acc, wgate);
        }
      }
    }
  }
  // a gated block with no candidate anywhere: its rows stay the wrapper's
  // zeros (rho and force always stage the block's own rows)
  if (!staged) return;
  if (s < gc) write_out<SWEEP>(out, n, i, alive, ir, tb, p, acc);
}

// Launches one filtered sweep on a cell layout; returns the CUDA error.
template <int SWEEP, int LAYOUT>
int launch_cell_sweep(const CellGeo& g, const Phys& p, const float* fld,
                      const float* tab2, const float* tab1, float* out,
                      void* stream) {
  using Fn = void (*)(const float*, const float*, const float*, CellGeo, Phys,
                      int, float*);
  using B = CellBuild<SWEEP>;
  const int gc = g.G * g.c;
  const int nsw = g.G + 2 * g.k;
  const long long ncols = g.dim == 3 ? (long long)g.ncx * g.ncy : g.ncx;
  const int ngroups = g.G > 0 ? g.nsub_pad / g.G : 0;
  if (g.G < 1 || g.c < 1 || g.k < 0 || ngroups < 1 ||
      ngroups * g.G != g.nsub_pad || nsw > kMaxStagedCells || ncols < 1 ||
      ngroups > 65535 || p.T1 < 1 || ncols * g.nsub_pad * g.c != g.n_slots ||
      (g.dim != 2 && g.dim != 3) || (g.dim == 2 && g.ncy != 1) ||
      (g.per_col && g.k > g.nsub_pad)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const int threads = gc < kCellThreads ? (gc + 31) / 32 * 32
                                         : kCellThreads;
  const int nchunks = (gc + threads - 1) / threads;
  const int ld = nsw * g.c < B::rows ? nsw * g.c : B::rows;
  const size_t smem = sizeof(float) *
      (table_floats(p.T1) + (size_t)NumFields<SWEEP>::v * ld +
       (SWEEP == SW_FORCE ? queue_floats(threads) : 0));
  cudaError_t err = cudaSuccess;
  const Fn kernel = pick_build<Fn>(
      cell_sweep_kernel<SWEEP, LAYOUT, B::fewer>,
      cell_sweep_kernel<SWEEP, LAYOUT, B::more>, threads, smem, &err);
  if (err != cudaSuccess) return (int)err;
  // always: another geometry's pick may have set it lower
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)ncols, (unsigned)ngroups, (unsigned)nchunks);
  kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(fld, tab2, tab1, g, p,
                                                         ld, out);
  return (int)cudaGetLastError();
}

}  // namespace sph
