// Column pair sweeps (rho, colour gradient, force) over the sorted cell grid
// for Hopper (sm_90a).
//
// They replace the Pallas TPU kernel
// tpusph/ops/pallas_pair.py::make_column_kernel (the pl.pallas_call at
// pallas_pair.py:542), one launcher per sweep. The pair physics (staging,
// the per-pair terms, the output rows) is sph_pair.cuh's, shared with the
// strip sweeps; the plain PyTorch version
// tpusph_torch/ops/pallas_pair.py::plain_column_sweep is the reference
// these kernels are held against.
//
// Layout. fld is the (16, n_slots) float32 field matrix (rows as R* in
// tpusph_torch/ops/rows.py) with slot = cell * cap + rank and
// cell = column * ncz + cz, the reference's flat cell id: cells run along
// the innermost axis (z in 3D, y in 2D) within a column. Empty slots are
// zero with type 0. The output is the (8, n_slots) matrix with the O* row
// meanings; the wrapper zeroes it, and an empty i cell writes nothing.
//
// Work split. All three sweeps: cell_sweep.cuh's filtered sweep, the
// layout with G = 1, k = 1, c = cap and nsub_pad = ncz (a block per cell
// and chunk of up to 128 ranks; each staged cell's live reach from its
// alive prefix, a binary search over its types, and for the colour
// gradient the colour gate's ballot pass over those prefixes; per
// neighbour column the three cells staged to their reach, each warp's box
// filter and exact tests; force then runs the warp pair queue, rho and
// the colour gradient add each live pair at once). The one-pass scan
// below, column_sweep_kernel, serves only the check kernels
// column_{rho,cgrad,force}_scan_launch, which the filtered sweeps are
// held to bit for bit (chip_smoke.py, the card tests); no path of the
// port launches them. It runs one block per i cell, one thread per slot
// of the cell (blockDim = cap rounded up to a warp). For each of the 9
// (3D) / 3 (2D) neighbour columns the block stages the three cells cz-1,
// cz, cz+1 of that column (3*cap rows) in shared memory, with the image
// shift added to the positions: the plane shift of a periodic wrap across
// x (and y in 3D), and the column-axis shift of a periodic wrap in cz. A
// neighbour column past a non-periodic plane edge is skipped (the
// reference reads an all-dead sentinel column there), and a cell past a
// non-periodic column end is staged as no candidate (the reference's
// zvalid mask). Every thread then scans the staged rows for its own slot,
// each cell's only as far as its last live row.
//
// Pair mask, the TPU kernel's: type_i > 0.5, type_j > 0.5, rsq > 1e-12.
// Rows that are no candidate (dead slots, cells past an edge) are staged at
// a far position, so one rsq compare rejects them.
//
// What bounds it: instruction throughput. Each i row has 27 cells of
// candidates (~1,700 live-reach rows at the 1M bench's ~64 rows a cell),
// of which ~110 lie within the cutoff. The one-pass scan tests every
// candidate in every lane and runs the pair body in lockstep wherever any
// lane of the warp has a live pair; its blocks are as wide as the cap, so
// at cap 280 most of their warps hold no alive row, and it reads the
// types of 3 x cap slots per neighbour column. The filtered sweeps run in
// blocks cut to the live ranks, read ~7-9 types a staged cell to find its
// reach, test a warp's box before the exact tests, and the colour
// gradient stages only rows near an interface (cell_sweep.cuh). Per-j
// terms (EOS p/rho^2, sound speed, 1/rho, tension norms) are computed
// once while staging; coefficient tables sit in shared memory. Built
// without fast-math: IEEE divides and square roots.

#include <cuda_runtime.h>

#include "cell_sweep.cuh"
#include "sph_pair.cuh"

namespace {

using namespace sph;

constexpr int kMaxThreads = 512;  // the largest cell capacity taken
// Registers: at most 64 a thread (two blocks of 512 threads per SM). Left
// free, ptxas gave the one-pass force sweep 99, which halved the warps
// resident on an SM; on the 1M boiling bench's main path it then took
// 27.9 ms per launch against 16.0 ms at 64 (profile_step, NVIDIA H100
// 80GB HBM3, 700 W). It is bound by latency and needs the warps.
constexpr int kMinBlocks = 2;

struct ColGeo {
  int n_slots, ncx, ncy, ncz, cap, dim;
  int per_x, per_y, per_col;  // periodic plane axes, periodic column axis
  float lx, ly, lcol;         // box lengths: plane x, plane y, column axis
};

template <int SWEEP>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
column_sweep_kernel(const float* __restrict__ fld,
                    const float* __restrict__ tab2g,
                    const float* __restrict__ tab1g, ColGeo g, Phys p,
                    float* __restrict__ out) {
  extern __shared__ float smem[];
  // per staged cell, one past its last live row
  __shared__ int reach[3];
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  float* win = smem + table_floats(p.T1);  // [NF][3 * cap]
  const int ld = 3 * g.cap;

  const int n = g.n_slots;
  const int cell = blockIdx.x;
  const int col = cell / g.ncz;
  const int cz = cell - col * g.ncz;
  const int s = threadIdx.x;
  const int i = cell * g.cap + s;
  const bool alive = s < g.cap && fld[RTYPE * n + i] > 0.5f;
  // an empty i cell writes nothing (also the barrier that publishes the
  // tables)
  if (!__syncthreads_or(alive)) return;
  IRow ir{};
  if (alive) ir = load_i<SWEEP>(fld, n, i, tb, p, (p.flags & FL_ST) != 0);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  const bool dim3 = g.dim == 3;
  const int cx = dim3 ? col / g.ncy : col;
  const int cy = dim3 ? col - cx * g.ncy : 0;
  const int oy_reach = dim3 ? 1 : 0;
  for (int ox = -1; ox <= 1; ++ox) {
    for (int oy = -oy_reach; oy <= oy_reach; ++oy) {
      // the neighbour column and its plane shift (uniform over the block)
      int nx = cx + ox, ny = cy + oy;
      float sx = 0.f, sy = 0.f;
      if (nx < 0 || nx >= g.ncx) {
        if (!g.per_x) continue;
        sx = nx < 0 ? -g.lx : g.lx;
        nx = nx < 0 ? nx + g.ncx : nx - g.ncx;
      }
      if (dim3 && (ny < 0 || ny >= g.ncy)) {
        if (!g.per_y) continue;
        sy = ny < 0 ? -g.ly : g.ly;
        ny = ny < 0 ? ny + g.ncy : ny - g.ncy;
      }
      const int jcol = dim3 ? nx * g.ncy + ny : nx;

      __syncthreads();  // the previous column's readers are done
      if (threadIdx.x < 3) reach[threadIdx.x] = 0;
      __syncthreads();
      for (int k = threadIdx.x; k < ld; k += blockDim.x) {
        const int dz = k / g.cap - 1;
        const int r = k - (dz + 1) * g.cap;
        int zz = cz + dz;
        float sz = 0.f;
        bool valid = true;
        if (zz < 0 || zz >= g.ncz) {
          if (g.per_col) {
            sz = zz < 0 ? -g.lcol : g.lcol;
            zz = zz < 0 ? zz + g.ncz : zz - g.ncz;
          } else {
            valid = false;
            zz = 0;
          }
        }
        const int j = (jcol * g.ncz + zz) * g.cap + r;
        const bool live = valid && fld[RTYPE * n + j] > 0.5f;
        if (live) atomicMax(&reach[dz + 1], r + 1);
        // 3D: the column axis is z; 2D: it is y, and z is not shifted
        if (dim3) {
          stage_j<SWEEP>(win, ld, k, fld, n, j, sx, sy, sz, live, tb, p);
        } else {
          stage_j<SWEEP>(win, ld, k, fld, n, j, sx, sz, 0.f, live, tb, p);
        }
      }
      __syncthreads();
      if (!alive) continue;
      for (int d = 0; d < 3; ++d) {
        const int end = d * g.cap + reach[d];
        for (int k = d * g.cap; k < end; ++k) {
          pair_sum<SWEEP>(win, ld, k, ir, tb, p, acc);
        }
      }
    }
  }
  if (s < g.cap) write_out<SWEEP>(out, n, i, alive, ir, tb, p, acc);
}

template <int SWEEP>
int launch(const float* fld, const float* tab2, const float* tab1,
           float* out, int n_slots, int ncx, int ncy, int ncz, int cap,
           int dim, int per_x, int per_y, int per_col, int kern, int flags,
           int T1, float lx, float ly, float lcol, float cutmax2,
           void* stream) {
  ColGeo g{n_slots, ncx, ncy, ncz, cap, dim, per_x, per_y, per_col,
           lx, ly, lcol};
  Phys p{dim, kern, flags, T1, cutmax2};
  const int threads = (cap + 31) / 32 * 32;
  const long long ncells = (long long)ncx * ncy * ncz;
  if (cap < 1 || threads > kMaxThreads || ncells < 1 || T1 < 1 ||
      ncells * cap != n_slots || (dim != 2 && dim != 3) ||
      (dim == 2 && ncy != 1)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem =
      sizeof(float) * (table_floats(T1) + NumFields<SWEEP>::v * 3 * cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        column_sweep_kernel<SWEEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  column_sweep_kernel<SWEEP>
      <<<(unsigned)ncells, threads, smem, (cudaStream_t)stream>>>(
          fld, tab2, tab1, g, p, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define COLUMN_ARGS                                                          \
  const float *fld, const float *tab2, const float *tab1, float *out,       \
      int n_slots, int ncx, int ncy, int ncz, int cap, int dim, int per_x,  \
      int per_y, int per_col, int kern, int flags, int T1, float lx,        \
      float ly, float lcol, float cutmax2, void *stream
#define COLUMN_PASS                                                          \
  fld, tab2, tab1, out, n_slots, ncx, ncy, ncz, cap, dim, per_x, per_y,     \
      per_col, kern, flags, T1, lx, ly, lcol, cutmax2, stream

// the filtered sweeps (cell_sweep.cuh) under the one-pass launcher's
// limits (launch_cell_sweep checks the rest)
template <int SWEEP>
int launch_filtered(COLUMN_ARGS) {
  const long long ncells = (long long)ncx * ncy * ncz;
  if (cap < 1 || cap > kMaxThreads || ncells * cap != n_slots) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const CellGeo g{n_slots, ncx, ncy, ncz, 1, cap, 1, dim, per_x, per_y,
                  per_col, lx, ly, lcol};
  return launch_cell_sweep<SWEEP, L_COLUMN>(
      g, Phys{dim, kern, flags, T1, cutmax2}, fld, tab2, tab1, out, stream);
}

extern "C" int column_rho_launch(COLUMN_ARGS) {
  return launch_filtered<SW_RHO>(COLUMN_PASS);
}

extern "C" int column_cgrad_launch(COLUMN_ARGS) {
  return launch_filtered<SW_CGRAD>(COLUMN_PASS);
}

extern "C" int column_force_launch(COLUMN_ARGS) {
  return launch_filtered<SW_FORCE>(COLUMN_PASS);
}

// the one-pass scans: the checks the filtered sweeps are held to
extern "C" int column_rho_scan_launch(COLUMN_ARGS) {
  return launch<SW_RHO>(COLUMN_PASS);
}

extern "C" int column_cgrad_scan_launch(COLUMN_ARGS) {
  return launch<SW_CGRAD>(COLUMN_PASS);
}

extern "C" int column_force_scan_launch(COLUMN_ARGS) {
  return launch<SW_FORCE>(COLUMN_PASS);
}

extern "C" const char* column_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
