// Band pair sweeps (rho, colour gradient, force) over the slot-resident
// sub-cell layout for Hopper (sm_90a).
//
// They replace the Pallas TPU kernel
// tpusph/ops/band_pair.py::make_band_kernel (the pl.pallas_call at
// band_pair.py:554), one launcher per sweep. The pair physics (staging, the
// per-pair terms, the output rows) is sph_pair.cuh's, shared with the strip
// and column sweeps; the plain PyTorch version
// tpusph_torch/ops/band_pair.py::plain_band_sweep is the reference these
// kernels are held against.
//
// Layout. fld is the (16, n_slots) float32 field matrix (rows as R* in
// tpusph_torch/ops/rows.py) with slot = (column * nsub_pad + sub) * c + rank:
// columns tile the plane (xy in 3D, x in 2D) and each is cut into nsub_pad
// sub-cells of c slots along the column axis (z in 3D, y in 2D). A group of
// G sub-cells is one i-block of G*c slots. Dead slots hold the far sentinel
// position with type 0. The output is the (8, n_slots) matrix with the O* row
// meanings; the wrapper zeroes it, and a group without an alive slot writes
// nothing (the reference's pl.when at band_pair.py:533).
//
// Work split. All three sweeps: cell_sweep.cuh's filtered sweep (a block
// per group and chunk of up to 128 slots; per neighbour column the group's
// G + 2k staged sub-cells to their live reach, each warp's box filter and
// exact tests; a warp whose lanes lie in two sub-cells shares their
// group's window, so it needs no union); force then runs the warp pair
// queue, rho and the colour gradient add each live pair at once, and the
// colour gradient stages only the rows of a colour unlike one of the
// block's (and warp's) alive rows. The one-pass scan below,
// band_sweep_kernel, serves only the check kernels
// band_{rho,cgrad,force}_scan_launch: one block per (column, group) on a
// (ncols, ngroups) grid, one thread per i slot of the group (blockDim =
// G*c rounded up to a warp). For each of the 9 (3D) / 3 (2D) neighbour
// columns the block stages the group's window in shared memory: the rows
// [(g*G - k) * c, (g*G + G + k) * c) of that column, i.e. the group's G
// sub-cells and k margin sub-cells on each side, with the image shift
// added to the positions: the plane shift of a periodic wrap across x (and
// y in 3D), and on a periodic column axis the wrap modulo nsub_pad
// sub-cells with -L on the column coordinate for group 0's low margin and
// +L for the last group's high margin (the reference's band_row). On a
// non-periodic column axis the outside margins are staged as no candidate,
// and a neighbour column past a non-periodic plane edge is skipped (the
// reference reads an all-dead sentinel column there). The reference
// pre-gathers these windows into a band array because Mosaic cannot slice
// lanes dynamically; here each block reads them straight from fld. Every
// thread then scans the staged rows for its own slot, each staged sub-cell
// only as far as its last live rank. The filtered sweeps are held to it
// bit for bit (chip_smoke.py, the card tests); no path of the port
// launches it.
//
// Pair mask: type_i > 0.5, type_j > 0.5, rsq > 1e-12; rows that are no
// candidate are staged at a far position, so one rsq compare rejects them.
// The band has no mixed-phase flag: the colour gradient and the capillary
// terms run on every pair (the reference's _mixed_flags returns None and
// its kernel always runs the capillary terms), as in column_sweeps.cu. The
// rho sweep folds the self term in (write_out).
//
// What bounds them: instruction throughput. Each i row has 9*(G+2k)
// sub-cells of candidates (~3,500 live-reach rows on the 1M bench's
// lattice at G 4, c 128, k 1, ~65 particles a sub-cell), of which ~110 lie
// within the cutoff. The one-pass scan tests every candidate in every lane
// and runs the pair body in lockstep wherever any lane of the warp has a
// live pair, in blocks as wide as the group (at c 128 about half of a
// sub-cell's warps hold no alive row). The filtered sweeps run in blocks
// cut to the live ranks, and a warp's box drops the staged sub-cells
// beyond its own +-k before the exact tests; the queued force then runs
// the body 32 live pairs a pass, the colour gradient only on blocks near
// an interface (cell_sweep.cuh). Built without fast-math: IEEE divides
// and square roots.

#include <cuda_runtime.h>

#include "cell_sweep.cuh"
#include "sph_pair.cuh"

namespace {

using namespace sph;

constexpr int kMaxThreads = 512;  // the chooser's largest group, G*c <= 512
// Registers: at most 64 a thread (two blocks of 512 threads per SM), as in
// column_sweeps.cu, whose one-pass force sweep took 99 registers left free
// and ran at half the resident warps.
constexpr int kMinBlocks = 2;

struct BandGeo {
  int n_slots, ncx, ncy, nsub_pad, G, c, k, dim;
  int per_x, per_y, per_col;  // periodic plane axes, periodic column axis
  float lx, ly, lcol;         // box lengths: plane x, plane y, column axis
};

// The one-pass scan: only the check kernels band_*_scan_launch run it.
template <int SWEEP>
__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
band_sweep_kernel(const float* __restrict__ fld,
                  const float* __restrict__ tab2g,
                  const float* __restrict__ tab1g, BandGeo g, Phys p,
                  float* __restrict__ out) {
  extern __shared__ float smem[];
  // per staged sub-cell, one past its last live rank
  __shared__ int reach[kMaxStagedCells];
  const Tables tb = load_tables(smem, tab2g, tab1g, p);
  const int nsw = g.G + 2 * g.k;
  const int ld = nsw * g.c;
  float* win = smem + table_floats(p.T1);  // [NF][ld]

  const int n = g.n_slots;
  const int col = blockIdx.x;
  const int grp = blockIdx.y;
  const int gc = g.G * g.c;
  const int col_slots = g.nsub_pad * g.c;
  const int s = threadIdx.x;
  const int i = col * col_slots + grp * gc + s;
  const bool alive = s < gc && fld[RTYPE * n + i] > 0.5f;
  // a group without an alive slot writes nothing (also the barrier that
  // publishes the tables)
  if (!__syncthreads_or(alive)) return;
  IRow ir{};
  if (alive) ir = load_i<SWEEP>(fld, n, i, tb, p, (p.flags & FL_ST) != 0);
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  const bool dim3 = g.dim == 3;
  const int cx = dim3 ? col / g.ncy : col;
  const int cy = dim3 ? col - cx * g.ncy : 0;
  const int oy_reach = dim3 ? 1 : 0;
  const int sub0 = grp * g.G - g.k;  // first staged sub-cell
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
      for (int d = threadIdx.x; d < nsw; d += blockDim.x) reach[d] = 0;
      __syncthreads();
      for (int w = threadIdx.x; w < ld; w += blockDim.x) {
        const int d = w / g.c;
        const int r = w - d * g.c;
        int sub = sub0 + d;
        float sz = 0.f;
        bool valid = true;
        if (sub < 0 || sub >= g.nsub_pad) {
          if (g.per_col) {
            // k <= G <= nsub_pad - 2k: one wrap reaches the other end
            sz = sub < 0 ? -g.lcol : g.lcol;
            sub = sub < 0 ? sub + g.nsub_pad : sub - g.nsub_pad;
          } else {
            valid = false;
            sub = 0;
          }
        }
        const int j = jcol * col_slots + sub * g.c + r;
        const bool live = valid && fld[RTYPE * n + j] > 0.5f;
        if (live) atomicMax(&reach[d], r + 1);
        // 3D: the column axis is z; 2D: it is y, and z is not shifted
        if (dim3) {
          stage_j<SWEEP>(win, ld, w, fld, n, j, sx, sy, sz, live, tb, p);
        } else {
          stage_j<SWEEP>(win, ld, w, fld, n, j, sx, sz, 0.f, live, tb, p);
        }
      }
      __syncthreads();
      if (!alive) continue;
      for (int d = 0; d < nsw; ++d) {
        const int end = d * g.c + reach[d];
        for (int kk = d * g.c; kk < end; ++kk) {
          pair_sum<SWEEP>(win, ld, kk, ir, tb, p, acc);
        }
      }
    }
  }
  if (s < gc) write_out<SWEEP>(out, n, i, alive, ir, tb, p, acc);
}

template <int SWEEP>
int launch(const float* fld, const float* tab2, const float* tab1,
           float* out, int n_slots, int ncx, int ncy, int nsub_pad, int G,
           int c, int k, int dim, int per_x, int per_y, int per_col,
           int kern, int flags, int T1, float lx, float ly, float lcol,
           float cutmax2, void* stream) {
  BandGeo g{n_slots, ncx, ncy, nsub_pad, G, c, k, dim, per_x, per_y,
            per_col, lx, ly, lcol};
  Phys p{dim, kern, flags, T1, cutmax2};
  const int threads = (G * c + 31) / 32 * 32;
  const long long ncols = dim == 3 ? (long long)ncx * ncy : ncx;
  const int ngroups = G > 0 ? nsub_pad / G : 0;
  if (G < 1 || c < 1 || k < 0 || ngroups < 1 || ngroups * G != nsub_pad ||
      G + 2 * k > kMaxStagedCells || threads > kMaxThreads || ncols < 1 ||
      ngroups > 65535 || T1 < 1 || ncols * nsub_pad * c != n_slots ||
      (dim != 2 && dim != 3) || (dim == 2 && ncy != 1) ||
      (per_col && G + 2 * k > nsub_pad)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const size_t smem = sizeof(float) *
      (table_floats(T1) + (size_t)NumFields<SWEEP>::v * (G + 2 * k) * c);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        band_sweep_kernel<SWEEP>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)ncols, (unsigned)ngroups);
  band_sweep_kernel<SWEEP><<<grid, threads, smem, (cudaStream_t)stream>>>(
      fld, tab2, tab1, g, p, out);
  return (int)cudaGetLastError();
}

}  // namespace

#define BAND_ARGS                                                            \
  const float *fld, const float *tab2, const float *tab1, float *out,       \
      int n_slots, int ncx, int ncy, int nsub_pad, int G, int c, int k,     \
      int dim, int per_x, int per_y, int per_col, int kern, int flags,      \
      int T1, float lx, float ly, float lcol, float cutmax2, void *stream
#define BAND_PASS                                                            \
  fld, tab2, tab1, out, n_slots, ncx, ncy, nsub_pad, G, c, k, dim, per_x,   \
      per_y, per_col, kern, flags, T1, lx, ly, lcol, cutmax2, stream

// the filtered sweeps (cell_sweep.cuh) under the one-pass launcher's
// limits (launch_cell_sweep checks the rest)
template <int SWEEP>
int launch_filtered(BAND_ARGS) {
  if (G * c > kMaxThreads || (per_col && G + 2 * k > nsub_pad)) {
    return (int)cudaErrorInvalidConfiguration;
  }
  const CellGeo g{n_slots, ncx, ncy, nsub_pad, G, c, k, dim, per_x, per_y,
                  per_col, lx, ly, lcol};
  return launch_cell_sweep<SWEEP, L_BAND>(
      g, Phys{dim, kern, flags, T1, cutmax2}, fld, tab2, tab1, out, stream);
}

extern "C" int band_rho_launch(BAND_ARGS) {
  return launch_filtered<SW_RHO>(BAND_PASS);
}

extern "C" int band_cgrad_launch(BAND_ARGS) {
  return launch_filtered<SW_CGRAD>(BAND_PASS);
}

extern "C" int band_force_launch(BAND_ARGS) {
  return launch_filtered<SW_FORCE>(BAND_PASS);
}

// the one-pass scans: the checks the filtered sweeps are held to
extern "C" int band_rho_scan_launch(BAND_ARGS) {
  return launch<SW_RHO>(BAND_PASS);
}

extern "C" int band_cgrad_scan_launch(BAND_ARGS) {
  return launch<SW_CGRAD>(BAND_PASS);
}

extern "C" int band_force_scan_launch(BAND_ARGS) {
  return launch<SW_FORCE>(BAND_PASS);
}

extern "C" const char* band_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
