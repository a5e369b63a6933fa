// The warp box filter and the warp pair queue, shared by the strip sweeps
// (strip_sweeps.cu's strip_filter_kernel: rho, colour gradient and force;
// its vapor sweep takes the box alone) and the cell sweeps (cell_sweep.cuh's
// cell_sweep_kernel: the three sweeps on the column and band layouts).
//
// A warp of i rows sweeps a window of staged j rows ([NF][ld] floats in
// shared memory, sph_pair.cuh's staging) in three phases (filter_window):
//   (a) each staged row is tested once, a row per lane, against the warp's
//       box: the squared distance to the bounding box of the warp's alive
//       i rows below the cutoff plus a float32 rounding margin (WarpBox); a
//       ballot gives the survivors;
//   (b) each lane tests its own pair with each survivor, in increasing row
//       order, with pair_live, the test pair_sum applies;
//   (c) force: the live pairs of a survivor join the warp's pair queue in
//       lane order (kQueue entries in shared memory); when the next
//       survivors' could overfill it, and at the end of the window, the
//       warp runs the queue 32 pairs a pass, every lane on a pair with its
//       owner's i row from shared memory (put_irow / get_irow), and each
//       owner adds its pairs' contributions in queue order (run_queue).
//       Rho and the colour gradient run their short body on the live
//       pair in (b) directly; the colour gradient's (a) also drops the
//       rows of a colour no alive row of the warp pairs with (the colour
//       gate, unlike_types).
// Each i row sums its pairs in (window, row) order, as the one-pass scan
// does, and each pair's terms are the same arithmetic, so the sums keep
// the one-pass scan's bits. The body passes per window fall from the rows
// any lane pairs with (lockstep) to ceil(the warp's live pairs / 32).
#pragma once

#include <cuda_runtime.h>

#include "sph_pair.cuh"

namespace sph {

// Queued pairs per warp (PERF.md, Findings: a longer queue measured no
// faster).
constexpr int kQueue = 128;
// a flush runs whole passes and keeps under a pass of pairs: room for the
// next step's up to 64
static_assert(kQueue >= 96 && kQueue % 32 == 0, "queue length");
constexpr float kBoxFar = 1e30f;              // box bound of a dead warp

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

// The filter: the bounding box of a set of alive i-rows (dead rows carry
// the far sentinel and are left out), and rp^2 with rp = rc + 1e-5 * (rc +
// the box's largest coordinate magnitude), rc = sqrt(cutmax2). A staged row
// survives when its squared distance to the box, (gx*gx + gy*gy) + gz*gz
// with per-axis gaps max(max(lo - x, x - hi), 0), is below rp^2. The gap
// never exceeds |dx| of the pair with any row of the box, and float32
// rounding moves either by a few ulp, far inside the margin, so every live
// pair's row survives. A box that contains another, with the larger
// magnitude's margin, keeps every row the smaller keeps. Formed with
// round-to-nearest intrinsics (never contracted) so the plain counts
// (strip_pair.warp_pass_counts, cell_filter.cell_pass_counts) form the
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
  // r2 from the bounds and rc
  __device__ __forceinline__ void set_radius(float rc) {
    float mag = 0.f;
    for (int a = 0; a < 3; ++a) {
      mag = fmaxf(mag, fmaxf(fabsf(lo[a]), fabsf(hi[a])));
    }
    const float rp = __fadd_rn(rc, __fmul_rn(1e-5f, __fadd_rn(rc, mag)));
    r2 = __fmul_rn(rp, rp);
  }
};

// The colour gate of the colour-gradient sweep: a pair whose two colours
// are equal adds exactly zero (pair_body returns before it adds), so a set
// of i rows needs only the j rows whose colour differs from one of theirs.
// A set of types is a bit mask, bit min(t, kGateBits); the last bit stands
// for every type from kGateBits up and keeps all of their rows.
constexpr int kGateBits = 31;

__device__ __forceinline__ unsigned type_bit(int t) {
  return 1u << min(t, kGateBits);
}

// The types whose rows a set of i-row types `tset` keeps: tj where
// c(tj) - c(ti) == 0 fails for some ti of the set (pair_body's own test).
__device__ __forceinline__ unsigned unlike_types(unsigned tset,
                                                 const Tables& tb) {
  if (tset >> kGateBits) return ~0u;
  unsigned keep = 1u << kGateBits;
  const int nt = min(tb.T1, kGateBits);
  for (int tj = 0; tj < nt; ++tj) {
    const float cj = tb.c1(V_COLOR, tj);
    for (unsigned s = tset; s; s &= s - 1u) {
      if (!(cj - tb.c1(V_COLOR, __ffs(s) - 1) == 0.f)) {
        keep |= 1u << tj;
        break;
      }
    }
  }
  return keep;
}

__device__ __forceinline__ bool gate_keeps(unsigned keep, float type) {
  return (keep & type_bit((int)type)) != 0u;
}

// The box of the warp's alive lanes' points (x, y, z), radius from rc.
__device__ __forceinline__ WarpBox warp_box_at(float x, float y, float z,
                                               bool alive, unsigned wmask,
                                               float rc) {
  WarpBox bx;
  const float xs[3] = {x, y, z};
  for (int a = 0; a < 3; ++a) {
    bx.lo[a] = key_float(__reduce_min_sync(
        wmask, float_key(alive ? xs[a] : kBoxFar)));
    bx.hi[a] = key_float(__reduce_max_sync(
        wmask, float_key(alive ? xs[a] : -kBoxFar)));
  }
  bx.set_radius(rc);
  return bx;
}

__device__ __forceinline__ WarpBox warp_box(const IRow& ir, bool alive,
                                            unsigned wmask, float rc) {
  return warp_box_at(ir.x, ir.y, ir.z, alive, wmask, rc);
}

// The block's box from its warps' bounds ([nwarps][6] in shared memory,
// lo then hi; a warp with no alive row holds the empty box): their union,
// with its own radius from rc, so it keeps every row any warp box keeps.
__device__ __forceinline__ WarpBox union_box(const float (*wbox)[6],
                                             int nwarps, float rc) {
  WarpBox bx;
  for (int a = 0; a < 3; ++a) {
    bx.lo[a] = kBoxFar;
    bx.hi[a] = -kBoxFar;
  }
  for (int w = 0; w < nwarps; ++w) {
    for (int a = 0; a < 3; ++a) {
      bx.lo[a] = fminf(bx.lo[a], wbox[w][a]);
      bx.hi[a] = fmaxf(bx.hi[a], wbox[w][3 + a]);
    }
  }
  bx.set_radius(rc);
  return bx;
}

__device__ __forceinline__ void put_box(float* wb, const WarpBox& bx) {
  for (int a = 0; a < 3; ++a) {
    wb[a] = bx.lo[a];
    wb[3 + a] = bx.hi[a];
  }
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

// The warp's queue in the block's queue area `sir` (queue_floats(rows)
// floats: the i rows, then a queue per warp); clears its owner masks.
__device__ __forceinline__ WarpQueue warp_queue(float* sir, int rows,
                                                int warp, int lane) {
  float* wsh = sir + IR_NF * rows + warp * kWarpQueueFloats;
  const WarpQueue wq{reinterpret_cast<unsigned*>(wsh), wsh + kQueue,
                     reinterpret_cast<unsigned*>(wsh + kQueue + 6 * 32)};
  wq.owned[lane] = 0u;
  return wq;
}

// (c): the warp runs the first n queued pairs, a pair per lane a pass,
// each with its owner's i row; then each owner adds its pairs'
// contributions in queue order, which is (window, row) order per owner.
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

// Phases (a)-(c) of one warp over the staged rows [klo, khi) of `win`.
// A lane keeps a survivor k as its candidate only where `own_all`, or
// where k lies in its own window [wlo, whi) (a strip warp across two tiles
// scans the union of their windows). Force queues its live pairs and runs
// the queue before it returns, so `win` may then be restaged; rho and the
// colour gradient add each live pair at once. `sir` / `wbase`: the block's
// i rows and the warp's first (force). The colour gradient's (a) also
// drops the rows of a type outside `tgate` (unlike_types of the warp's
// types): their pairs add nothing.
template <int SWEEP>
__device__ __forceinline__ void filter_window(
    const float* __restrict__ win, int ld, int klo, int khi, bool own_all,
    int wlo, int whi, const WarpBox& bx, const IRow& ir, bool alive,
    unsigned wmask, int lane, int nlanes, const WarpQueue& wq,
    const float* __restrict__ sir, int wbase, const Tables& tb,
    const Phys& p, float acc[6], unsigned tgate = ~0u) {
  constexpr bool kQueued = SWEEP == SW_FORCE;
  const unsigned lanes_below = (1u << lane) - 1u;
  int queued = 0;
  for (int k0 = klo; k0 < khi; k0 += nlanes) {
    const int kb = k0 + lane;
    // (a) one row per lane against the warp's box (and colour gate)
    bool in = kb < khi &&
        bx.holds(win[0 * ld + kb], win[1 * ld + kb], win[2 * ld + kb]);
    if (SWEEP == SW_CGRAD && in) {
      in = gate_keeps(tgate, win[SC_TYPE * ld + kb]);
    }
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
      const float rsa = pair_rsq(win, ld, ka, ir, a0, a1, a2);
      const float rsb = pair_rsq(win, ld, kb, ir, b0, b1, b2);
      const bool la = alive && (own_all || (ka >= wlo && ka < whi))
                      && pair_live(rsa, p.cutmax2);
      const bool lb = two && alive
                      && (own_all || (kb >= wlo && kb < whi))
                      && pair_live(rsb, p.cutmax2);
      if (!kQueued) {
        // rho, colour gradient: their few operations at once
        if (la) {
          pair_body<SWEEP>(win, ld, ka, ir, tb, p, a0, a1, a2, rsa, acc);
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
        run_queue<SWEEP>(wq, full, wmask, lane, nlanes, sir, wbase, win, ld,
                         tb, p, acc);
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
    run_queue<SWEEP>(wq, queued, wmask, lane, nlanes, sir, wbase, win, ld,
                     tb, p, acc);
  }
}

// The force build for a block size and shared memory, of two
// __launch_bounds__ builds of one kernel: `more`, built for more blocks an
// SM (fewer registers, maybe a spill), where the occupancy API finds it
// keeps more blocks resident than `fewer`, else `fewer` (PERF.md,
// Findings: the strip's four- and five-block builds each win on one
// layout). It sets the shared-memory limit on both builds, on the current
// device (the caller's device guard: the tensors' card); the pick is kept
// per (device, build pair, threads, smem) in a small table (the oldest
// entry replaced when it is full), so each card of a node runs the
// occupancy query and sets the limits itself. The launch must set the
// picked build's limit again: another geometry's pick may have lowered
// it.
template <typename Fn>
Fn pick_build(Fn fewer, Fn more, int threads, size_t smem, cudaError_t* err) {
  struct Pick {
    int device;
    Fn fewer;
    int threads;
    size_t smem;
    Fn fn;
  };
  static Pick picks[64];
  static int npicks = 0, next = 0;
  int device = 0;
  *err = cudaGetDevice(&device);
  if (*err != cudaSuccess) return nullptr;
  for (int q = 0; q < npicks; ++q) {
    if (picks[q].device == device && picks[q].fewer == fewer &&
        picks[q].threads == threads && picks[q].smem == smem) {
      return picks[q].fn;
    }
  }
  int nf = 0, nm = 0;
  for (Fn k : {fewer, more}) {
    *err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (*err != cudaSuccess) return nullptr;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        k == fewer ? &nf : &nm, k, threads, smem);
    if (*err != cudaSuccess) return nullptr;
  }
  Fn fn = nm > nf ? more : fewer;
  picks[next] = Pick{device, fewer, threads, smem, fn};
  next = (next + 1) % 64;
  npicks = npicks < 64 ? npicks + 1 : 64;
  return fn;
}

}  // namespace sph
