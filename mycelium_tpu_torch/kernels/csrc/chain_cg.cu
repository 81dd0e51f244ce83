// K5: the whole preconditioned CG solve in one launch.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_cg.py::_cg_kernel (B5):
// B1's operator, 3x3 block-Jacobi plus an additive coarse correction over
// clusters of `width` consecutive chain positions (dense ainv matvec, const
// or linear basis), stop on r·r <= rtol²·|free·b|², no atol, no stall exit,
// no restarts. It does not copy B5's (3·NB, 128) plane layout, its rolls or
// its one-hot MXU selections: vectors are the port's (3, N) chain-ordered
// component planes and the operator is K1's per-position body
// (chain_op::matvec_node), so K1 and K5 compute it with the same
// instructions.
//
// What bounds it on the card: neither bytes nor operations, but the
// grid-wide barriers. One CG iteration touches ~240 bytes a position (the
// operator's tables and p, x, r, ap, z, the block inverse) plus the dense
// coarse inverse (4·nc² bytes), ~1.9 MB at 22k DOF, which the 50 MB L2
// holds: ~0.6 µs of HBM time an iteration against four grid.sync() (a few
// µs each). The design keeps the host out of the loop (one launch per solve,
// the stop test on the device) and keeps barriers few: four an iteration.
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel,
// grid = SMs x the occupancy the calculator reports, all blocks resident).
// Phases between barriers:
//   1. ap = A p per position (grid-stride), partial p·ap;
//   2. per cluster, one warp: x += alpha p, r -= alpha ap, partial r·r, and
//      the cluster sums of free·r (and ramp·free·r) into rc;
//   3. per cluster, one warp: the cluster's rows of zc = ainv·rc (one warp a
//      row, lanes over the columns), then z = c9·r + free·(zc + ramp·zc')
//      for its positions, partial r·z;
//   4. p = z + beta p per position.
// Dots are deterministic: each block writes its partial sum to its own
// slot; after the barrier every block sums all slots in the same fixed
// order, so every block holds bit-identical alpha, beta and r·r and takes
// the same stop decision with no further barrier. No float atomics: a rerun
// on the same inputs gives the same x. Every sum (the dots, the cluster
// sums, the rows of ainv·rc) takes exact float64 products of the float32
// terms and adds them in float64 before one rounding to float32; the plain
// version does the same, so the two round their sums alike whatever the
// order, and their trajectories stay together for hundreds of iterations.
// Scratch comes from the caller; the kernel allocates nothing. Built with
// -fmad=false, as K1-K4 are.

#include <cooperative_groups.h>

#include "chain_matvec.cuh"
#include "grid_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

using grid_reduce::FULL;
using grid_reduce::THREADS;
using grid_reduce::WARPS;
using grid_reduce::block_sum;
using grid_reduce::grid_total;
using grid_reduce::prod;
using grid_reduce::put_partial;
using grid_reduce::warp_sum0;

struct CgArgs {
  chain_op::Tables t;
  const float* uk;
  const float* x0;
  const float* c9;     // (9, N) row-major 3x3 block-Jacobi inverse
  const float* ainv;   // (nc, nc)
  float* x;
  float* stats;        // [iterations, |r|, tol]
  float* r;
  float* z;
  float* p;
  float* ap;
  float* rc;           // (nc,) restricted residual
  double* part;        // 4 x gridDim.x per-block partial sums
  long long nbc;
  long long width;
  int use_ramp;
  float rtol;
  int max_iter;
};

// a row of the coarse inverse times rc, one warp; every lane gets it
__device__ __forceinline__ float warp_row(const float* row, const float* v,
                                          long long len, int lane) {
  double s = 0.0;
  for (long long j = lane; j < len; j += 32) s += prod(row[j], v[j]);
  return (float)__shfl_sync(FULL, warp_sum0(s), 0);
}

__device__ __forceinline__ float ramp_at(const CgArgs& a, long long i) {
  return ((float)i - 0.5f * (float)(a.width - 1)) / (0.5f * (float)a.width);
}

// phase 2: with `update`, x += alpha p and r -= alpha ap; then the cluster
// sums of free·r (and ramp·free·r) into rc. Returns the thread's part of
// r·r (after the update).
__device__ double cluster_restrict(const CgArgs& a, float alpha, bool update,
                                   long long warp, long long nwarps,
                                   int lane) {
  const long long n = a.t.n;
  double srr = 0.0;
  for (long long cl = warp; cl < a.nbc; cl += nwarps) {
    double s0[3] = {0.0, 0.0, 0.0}, s1[3] = {0.0, 0.0, 0.0};
    const long long base = cl * a.width;
    for (long long i = lane; i < a.width; i += 32) {
      const long long q = base + i;
      if (q >= n) break;
      const float f = a.t.freem[q];
      const float ramp = ramp_at(a, i);
      for (int c = 0; c < 3; ++c) {
        const long long e = c * n + q;
        float rv = a.r[e];
        if (update) {
          a.x[e] = a.x[e] + alpha * a.p[e];
          rv = rv - alpha * a.ap[e];
          a.r[e] = rv;
          srr += prod(rv, rv);
        }
        const float rf = rv * f;
        s0[c] += (double)rf;
        s1[c] += (double)(rf * ramp);
      }
    }
    for (int c = 0; c < 3; ++c) {
      const float t0 = (float)warp_sum0(s0[c]);
      const float t1 = (float)warp_sum0(s1[c]);
      if (lane == 0) {
        a.rc[c * a.nbc + cl] = t0;
        if (a.use_ramp) a.rc[3 * a.nbc + c * a.nbc + cl] = t1;
      }
    }
  }
  return srr;
}

// phase 3: z = c9·r + free·(zc + ramp·zc') per cluster (and p = z on the
// first call). Returns the thread's part of r·z.
__device__ double cluster_precond(const CgArgs& a, bool first,
                                  long long warp, long long nwarps,
                                  int lane) {
  const long long n = a.t.n;
  const long long nc3 = 3 * a.nbc;
  const long long nc = (a.use_ramp ? 2 : 1) * nc3;
  double srz = 0.0;
  for (long long cl = warp; cl < a.nbc; cl += nwarps) {
    float zc0[3], zc1[3] = {0.0f, 0.0f, 0.0f};
    for (int c = 0; c < 3; ++c) {
      zc0[c] = warp_row(a.ainv + (c * a.nbc + cl) * nc, a.rc, nc, lane);
      if (a.use_ramp)
        zc1[c] = warp_row(a.ainv + (nc3 + c * a.nbc + cl) * nc, a.rc, nc,
                          lane);
    }
    const long long base = cl * a.width;
    for (long long i = lane; i < a.width; i += 32) {
      const long long q = base + i;
      if (q >= n) break;
      const float f = a.t.freem[q];
      const float ramp = ramp_at(a, i);
      const float rv[3] = {a.r[q], a.r[n + q], a.r[2 * n + q]};
      for (int c = 0; c < 3; ++c) {
        const float zb = a.c9[(3 * c) * n + q] * rv[0] +
                         a.c9[(3 * c + 1) * n + q] * rv[1] +
                         a.c9[(3 * c + 2) * n + q] * rv[2];
        float cc = zc0[c];
        if (a.use_ramp) cc = cc + zc1[c] * ramp;
        cc = cc * f;
        const float zv = zb + cc;
        a.z[c * n + q] = zv;
        if (first) a.p[c * n + q] = zv;
        srz += prod(rv[c], zv);
      }
    }
  }
  return srz;
}

__global__ void __launch_bounds__(THREADS) chain_cg_kernel(CgArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[WARPS + 1];
  const chain_op::Tables& t = a.t;
  const long long n = t.n;
  const int G = gridDim.x;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)G * THREADS;
  const long long warp = tid >> 5, nwarps = nthr >> 5;
  const int lane = threadIdx.x & 31;
  double* part_pap = a.part;
  double* part_rr = a.part + G;
  double* part_rz = a.part + 2 * G;
  double* part_bb = a.part + 3 * G;

  // x = free·x0 + pin·uk
  for (long long q = tid; q < n; q += nthr) {
    const float f = t.freem[q], pin = 1.0f - f;
    for (int c = 0; c < 3; ++c)
      a.x[c * n + q] = f * a.x0[c * n + q] + pin * a.uk[c * n + q];
  }
  grid.sync();

  // r = b - A x, with b = pin·uk - free·(K uk) (raw K: pinned columns kept)
  double sbb = 0.0, srr = 0.0;
  for (long long q = tid; q < n; q += nthr) {
    float ku[3], ax[3];
    chain_op::matvec_node(a.uk, t, 0, q, ku);
    chain_op::matvec_node(a.x, t, 1, q, ax);
    const float f = t.freem[q], pin = 1.0f - f;
    for (int c = 0; c < 3; ++c) {
      const float b = pin * a.uk[c * n + q] - f * ku[c];
      const float fb = f * b;
      sbb += prod(fb, fb);
      const float rv = b - ax[c];
      a.r[c * n + q] = rv;
      srr += prod(rv, rv);
    }
  }
  put_partial(sbb, part_bb, sh);
  put_partial(srr, part_rr, sh);
  grid.sync();
  cluster_restrict(a, 0.0f, false, warp, nwarps, lane);
  grid.sync();
  put_partial(cluster_precond(a, true, warp, nwarps, lane), part_rz, sh);
  grid.sync();

  const float tol2 = a.rtol * a.rtol * grid_total(part_bb, sh);
  float rr = grid_total(part_rr, sh);
  float rz = grid_total(part_rz, sh);
  int k = 0;
  while (k < a.max_iter && rr > tol2) {
    double spap = 0.0;
    for (long long q = tid; q < n; q += nthr) {
      float o[3];
      chain_op::matvec_node(a.p, t, 1, q, o);
      for (int c = 0; c < 3; ++c) {
        a.ap[c * n + q] = o[c];
        spap += prod(a.p[c * n + q], o[c]);
      }
    }
    put_partial(spap, part_pap, sh);
    grid.sync();

    const float pap = grid_total(part_pap, sh);
    const float alpha = pap > 0.0f ? rz / pap : 0.0f;
    put_partial(cluster_restrict(a, alpha, true, warp, nwarps, lane), part_rr,
                sh);
    grid.sync();

    put_partial(cluster_precond(a, false, warp, nwarps, lane), part_rz, sh);
    grid.sync();

    const float rz_new = grid_total(part_rz, sh);
    rr = grid_total(part_rr, sh);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
    for (long long q = tid; q < n; q += nthr)
      for (int c = 0; c < 3; ++c)
        a.p[c * n + q] = a.z[c * n + q] + beta * a.p[c * n + q];
    rz = rz_new;
    ++k;
    grid.sync();
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.stats[0] = (float)k;
    a.stats[1] = sqrtf(rr);
    a.stats[2] = sqrtf(tol2);
  }
}

}  // namespace

// Blocks of the cooperative grid: SMs x blocks per SM, all co-resident.
// Fails on a card without cooperative launch.
extern "C" int chain_cg_grid_blocks(int* out) {
  int dev = 0, coop = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, chain_cg_kernel,
                                                    THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (per < 1) return (int)cudaErrorLaunchOutOfResources;
  *out = sms * per;
  return 0;
}

extern "C" int chain_cg_f32(
    const float* uk, const float* x0, const float* freem, const float* cact,
    const float* jact, const float* cn, const float* ckax, const float* ckbd,
    const float* jn, const float* jkax, const float* jkbd, const long long* ja,
    const long long* jb, long long jp, const long long* jptr,
    const long long* jent, const float* c9, const float* ainv, float* x,
    float* stats, float* work, double* part, long long n, long long nbc, long long width,
    int use_ramp, float rtol, float reg, int max_iter, int grid_blocks,
    cudaStream_t stream) {
  if (n <= 0 || nbc <= 0 || width <= 0 || grid_blocks <= 0)
    return (int)cudaErrorInvalidValue;
  CgArgs a;
  a.t = chain_op::Tables{freem, cact, jact, cn, ckax, ckbd, jn, jkax, jkbd,
                         ja, jb, jp, jptr, jent, n, reg};
  a.uk = uk;
  a.x0 = x0;
  a.c9 = c9;
  a.ainv = ainv;
  a.x = x;
  a.stats = stats;
  a.r = work;
  a.z = work + 3 * n;
  a.p = work + 6 * n;
  a.ap = work + 9 * n;
  a.rc = work + 12 * n;
  a.part = part;
  a.nbc = nbc;
  a.width = width;
  a.use_ramp = use_ramp;
  a.rtol = rtol;
  a.max_iter = max_iter;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)chain_cg_kernel, dim3(grid_blocks), dim3(THREADS), args,
      0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
