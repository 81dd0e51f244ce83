// K4: the anastomosis distance scan of one growth step.
//
// Replaces the TPU kernel mycelium_tpu/growth/pallas_anast.py::_scan_kernel
// (called at growth/neighbors.py:501). The TPU kernel pairs every tip plane
// with every candidate plane over whole (g, g) faces, banded over rows,
// because the TPU wants dense (8, 128) tiles and has no cheap gather. Here
// the work goes by corner cell: a warp takes a cell's tips and its 2x2
// window's candidates.
//
// Layout (mycelium_tpu_torch/growth/neighbors.py):
// - tip_cell[h]: the corner cell cx*g + cy of hypha h's active tip, -1 if
//   h is not in the tip table; tip_slot[h] its segment slot;
// - the tip table by corner cell: cell m's tip_count[m] (<= 32) hyphae are
//   tip_order[tip_start[m] + t], in row order;
// - the persistent grid, cell-major: entry k of cell m at m*cap + k, with
//   gids[e] the segment slot and ggeo[e] 8 floats (a, ab = end - start,
//   r = 1/|ab|^2, pad), gcount[m] <= cap entries;
// - the tip overlay: slots sorted by cell, cell m's ov_count[m] entries
//   from ov_start[m]; their geometry is read by slot from start/end.
//
// The function: per hypha in the table, visit (dr, dc) in (-1,-1), (-1,0),
// (0,-1), (0,0) (cells outside the face hold nothing), in each the grid's
// entries then the overlay's, in rank order; skip the tip's own slot and
// ids >= n_slots; keep the strictly smallest d^2 with its segment
// parameter tt and slot. That is the XLA scan's nesting (neighbors.py:
// 585-620), so ties between candidates at equal distance resolve as the
// JAX package's XLA path does. A hypha outside the table, or with no
// candidate, gets (inf, 0, n_slots).
//
// Arithmetic: the same operations as the plain PyTorch version
// (kernels/anast.py), with the fused multiply-adds XLA's CPU backend
// contracts written out as __fmaf_rn; the library is built with
// -fmad=false, so nothing else is contracted, and with IEEE division.
//
// Its least time on this card is bytes. A candidate is 32 bytes of grid
// entry (or a 4-byte overlay id and 24 bytes of segment geometry) for ~25
// flops, far below the card's float32 balance point; the least time is
// the needed bytes of the visited cells' entries read once, over 3.35
// TB/s. The first form ran one thread per hypha row (2^18 at xlarge, most
// of them idle), each walking its four cells' entries as chains of
// dependent, uncoalesced loads, and the tips of one cell (up to 16) each
// read the window again: 11x its bound.
//
// Design. One launch, a warp a corner cell. Every thread first writes
// (inf, 0, n_slots) to its rows of the hypha range that are outside the
// table. Then each warp walks the corner cells (a persistent grid; an
// empty cell costs one broadcast load). Lane t < nt loads the cell's tip
// t; lanes 0..7 read the counts of the window's 8 (offset, source) runs
// and a warp scan lays them end to end in visiting order; the warp takes
// the window's candidates 32 at a time, one a lane: a grid entry is two
// coalesced 16-byte loads, an overlay candidate's (a, ab, 1/|ab|^2) are
// computed once by the same instructions as before, for all the cell's
// tips. For each tip, every lane computes its candidate's d^2 and a warp
// reduction picks the chunk's winner by (d^2, position): ties go to the
// earliest position, and across chunks a strict < keeps the earlier one.
// That is the sequential strict-< scan's answer bit for bit; a NaN d^2 is
// read as +inf, which the scan never keeps either. 32-bit indices (the
// wrapper checks the sizes), 32 registers a thread. No shared memory, no
// atomics.
//
// What was learned on the card (NVIDIA H100 80GB HBM3, the xlarge state
// after 150 steps: 157,423 tips in 119,167 occupied cells, 6.2 million
// distance pairs): a warp's time goes to chains of dependent loads (a
// cell's tips, its run counts, its candidates) and to the reductions'
// shuffles, and the launch is as fast as the number of warps in flight.
// Walking 32 cells a warp at 64 registers was no faster than one thread a
// hypha; taking the tips and counts of 32 cells in one round trip, or
// prefetching the next chunk, cost registers and was slower still; fewer
// cells a warp, 32-bit indices and 32 registers (64 warps an SM) each made
// it faster.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void seg_dist(float p0, float p1, float p2,
                                         float a0, float a1, float a2,
                                         float b0, float b1, float b2,
                                         float r, float& d2, float& tt) {
  float ap0 = p0 - a0, ap1 = p1 - a1, ap2 = p2 - a2;
  float apab = __fmaf_rn(ap2, b2, __fmaf_rn(ap0, b0, ap1 * b1));
  float t = fminf(fmaxf(apab * r, 0.0f), 1.0f);
  float e0 = __fmaf_rn(-t, b0, ap0);
  float e1 = __fmaf_rn(-t, b1, ap1);
  float e2 = __fmaf_rn(-t, b2, ap2);
  d2 = __fmaf_rn(e2, e2, __fmaf_rn(e0, e0, e1 * e1));
  tt = t;
}

struct Args {
  const int* tip_slot;
  const int* tip_cell;
  const int* tip_order;
  const int* tip_start;
  const int* tip_count;
  const float* start;
  const float* end;
  const int* gids;
  const float4* ggeo;
  const int* gcount;
  const int* ov_slot;
  const int* ov_start;
  const int* ov_count;
  float* d2_out;
  float* tt_out;
  int* id_out;
  int H, cap, g, n_slots;   // the wrapper checks M*cap, 3*n_slots < 2^31
};

// Cell m's nt tips against its window's candidates; every lane of the
// warp calls it with the same m and nt.
__device__ void scan_cell(const Args& a, int m, int nt, int lane) {
  const float inf = __int_as_float(0x7f800000);
  // lane t < nt holds the cell's tip t: row h, slot, end point p
  int h = -1, slot = -1;
  float p0 = 0.0f, p1 = 0.0f, p2 = 0.0f;
  if (lane < nt) {
    h = a.tip_order[a.tip_start[m] + lane];
    slot = a.tip_slot[h];
    p0 = a.end[3 * slot];
    p1 = a.end[3 * slot + 1];
    p2 = a.end[3 * slot + 2];
  }
  // lane s < 8: run s = 2·offset + source (grid, overlay) of the window,
  // its length and first entry; a warp scan lays the runs end to end in
  // visiting order
  const int cx = m / a.g, cy = m - cx * a.g;
  int n = 0, base = 0;
  if (lane < 8) {
    const int o = lane >> 1;
    const int x = cx + (o < 2 ? -1 : 0);
    const int y = cy + ((o & 1) ? 0 : -1);
    if (x >= 0 && y >= 0) {
      const int c = x * a.g + y;
      if (lane & 1) {
        n = a.ov_count[c];
        base = a.ov_start[c];
      } else {
        n = a.gcount[c];
        base = c * a.cap;
      }
    }
  }
  int incl = n;
  for (int d = 1; d < 8; d *= 2) {
    const int t = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += t;
  }
  int end_s[8], base_s[8];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    end_s[s] = __shfl_sync(kFull, incl, s);
    base_s[s] = __shfl_sync(kFull, base, s);
  }
  const int total = end_s[7];

  float best = inf, btt = 0.0f;
  int bid = a.n_slots;
  for (int k0 = 0; k0 < total; k0 += 32) {
    // this lane's candidate: position k of the window's visiting order
    const int k = k0 + lane;
    int id = a.n_slots;
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, b0 = 0.0f, b1 = 0.0f, b2 = 0.0f;
    float r = 0.0f;
    if (k < total) {
      int lo = 0, e = 0;
      bool ov = false;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        if (k >= lo && k < end_s[s]) {
          e = base_s[s] + (k - lo);
          ov = s & 1;
        }
        lo = end_s[s];
      }
      if (!ov) {
        id = a.gids[e];
        const float4 q0 = a.ggeo[2 * e];
        const float4 q1 = a.ggeo[2 * e + 1];
        a0 = q0.x; a1 = q0.y; a2 = q0.z;
        b0 = q0.w; b1 = q1.x; b2 = q1.y;
        r = q1.z;
      } else {
        id = a.ov_slot[e];
        if (id < a.n_slots) {
          a0 = a.start[3 * id];
          a1 = a.start[3 * id + 1];
          a2 = a.start[3 * id + 2];
          b0 = a.end[3 * id] - a0;
          b1 = a.end[3 * id + 1] - a1;
          b2 = a.end[3 * id + 2] - a2;
          const float ab2 = __fmaf_rn(b2, b2, __fmaf_rn(b0, b0, b1 * b1));
          r = ab2 < 1e-12f ? 0.0f : 1.0f / fmaxf(ab2, 1e-12f);
        }
      }
    }
    // per tip: every lane's d^2, then the chunk's least (d^2, position)
    for (int t = 0; t < nt; ++t) {
      const float q0 = __shfl_sync(kFull, p0, t);
      const float q1 = __shfl_sync(kFull, p1, t);
      const float q2 = __shfl_sync(kFull, p2, t);
      const int ts = __shfl_sync(kFull, slot, t);
      float d2 = inf, tt = 0.0f;
      if (id < a.n_slots && id != ts) {
        seg_dist(q0, q1, q2, a0, a1, a2, b0, b1, b2, r, d2, tt);
        if (!(d2 == d2)) d2 = inf;
      }
      float wd = d2;
      int wl = lane;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float od = __shfl_xor_sync(kFull, wd, off);
        const int ol = __shfl_xor_sync(kFull, wl, off);
        if (od < wd || (od == wd && ol < wl)) {
          wd = od;
          wl = ol;
        }
      }
      const float wtt = __shfl_sync(kFull, tt, wl);
      const int wid = __shfl_sync(kFull, id, wl);
      if (lane == t && wd < best) {
        best = wd;
        btt = wtt;
        bid = wid;
      }
    }
  }
  if (lane < nt) {
    a.d2_out[h] = best;
    a.tt_out[h] = btt;
    a.id_out[h] = bid;
  }
}

// 32 registers a thread, so 64 warps an SM: the warps wait on loads, and
// more of them in flight is what shortens the launch
__global__ void __launch_bounds__(kThreads, 8) anast_scan_kernel(Args a) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nth = gridDim.x * blockDim.x;
  for (int h = tid; h < a.H; h += nth) {
    if (a.tip_cell[h] < 0) {
      a.d2_out[h] = __int_as_float(0x7f800000);
      a.tt_out[h] = 0.0f;
      a.id_out[h] = a.n_slots;
    }
  }
  const int lane = threadIdx.x & 31;
  const int M = a.g * a.g;
  for (int m = tid >> 5; m < M; m += nth >> 5) {
    const int nt = a.tip_count[m];
    if (nt > 0) scan_cell(a, m, nt, lane);
  }
}

}  // namespace

extern "C" int anast_scan_f32(
    const int* tip_slot, const int* tip_cell, const int* tip_order,
    const int* tip_start, const int* tip_count, const float* start,
    const float* end, const int* gids, const float* ggeo, const int* gcount,
    const int* ov_slot, const int* ov_start, const int* ov_count,
    float* d2_out, float* tt_out, int* id_out, long long H, int cap, int g,
    int n_slots, cudaStream_t stream) {
  if (H <= 0) return 0;
  const long long lim = 1LL << 31;   // the kernel indexes with 32 bits
  if (H >= lim || (long long)g * g * cap >= lim || 3LL * n_slots >= lim)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // a warp a corner cell, at most 64 blocks an SM's worth, looping
  const long long M = (long long)g * g;
  long long blocks = (M + kThreads / 32 - 1) / (kThreads / 32);
  if (blocks > 64LL * sms) blocks = 64LL * sms;
  if (blocks < 1) blocks = 1;
  Args a{tip_slot, tip_cell, tip_order, tip_start, tip_count, start, end,
         gids, reinterpret_cast<const float4*>(ggeo), gcount, ov_slot,
         ov_start, ov_count, d2_out, tt_out, id_out, (int)H, cap, g, n_slots};
  anast_scan_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
