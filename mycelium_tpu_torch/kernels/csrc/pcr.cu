// K2 and K3: one level of the spanning-forest preconditioner's parallel
// cyclic reduction (PCR) on 3x3 block-tridiagonal systems.
//
// Replaces the TPU kernels in mycelium_tpu/fea/pallas_factor.py:
//   K2 pcr_factor_f32 <- _factor_kernel (pcr_level_kernel): per round
//      k (s = 2^k) a = L·inv(D[i-s]), b = R·inv(D[i+s]),
//      D -= a·R[i-s] + b·L[i+s], L = -a·L[i-s], R = -b·R[i+s]; the 18
//      corner planes (unit right-hand sides at every path's first and last
//      slot) ride along as r -= a·r[i-s] + b·r[i+s]; finally
//      dinv = inv(D) and the corner solution x = dinv·r.
//   K3 pcr_apply_f32 <- _apply_kernel / _apply_kernel_chunked
//      (pcr_apply_planes_kernel): u = T^-1 r from K2's coefficients.
//
// Layout: a 3x3 block batch is 9 contiguous (S,) component planes in
// row-major component order (00, 01, 02, 10, ...); a 3-vector batch is 3
// planes. Coefficients are (steps, 9, S). Slots outside [0, S) read as
// zero; the TPU versions roll instead, and both are exact because the
// couplings are zero at every path end.
//
// What bounds them on the card. K2 runs once per level per factorization
// (the hybrid route's). Its least time is bytes: D and B in, the round
// coefficients, dinv and the corner solutions out, ~(72·steps + 184) B a
// slot (~0.01 ms at the 309k plan's largest level). What held the global
// form back was everything else: steps + 2 launches, the 45 state planes
// read and written through device memory every round (~250 B a slot a
// round), and the wrapper's 18 corner planes built by 7 PyTorch
// operations.
//
// The per-slot bodies live in pcr.cuh, which the whole-solve kernel K6
// (tree_cg.cu) shares.
//
// Design. K2 takes a level cut into K6's path-aligned windows
// (fea/tree_factor.py::path_windows: runs of whole paths of at most
// TREE_CG_WINDOW slots; PCR never couples two paths, so a window's rounds
// need nothing outside it): one launch, one block a window. The block
// forms its state as it loads D and B (L = B^T, R = B[s+1]) and the corner
// right-hand sides from a per-slot flag (a path's first and last slot),
// runs every round in shared memory (90 planes of the window, 92 KB, two
// blocks an SM) with pcr.cuh's factor_rounds_window, K6's own code, writes
// each round's coefficients as they are formed, and dinv and the corner
// solution once. The results are the whole level's up to the sign of a
// zero. A level with a path longer than the window keeps the global form:
// one launch per round over all S slots with the state in global ping-pong
// buffers, each thread recomputing the two neighbour inverses it needs
// instead of storing dinv. The bound launch (kernels/pcr.py::
// PcrFactorLaunch) holds the windows, flags, outputs and work space, so a
// factorization allocates nothing and reads nothing back.
//
// K3 runs twice per PCR level in every CG iteration and streams 18
// coefficient planes a round plus 9 for dinv: ~(72·steps + 36) bytes a
// slot, e.g. 540 B at steps = 7. It is one launch per level: each
// block owns a chunk of CHUNK central slots, loads the residual over the
// chunk plus a halo of 2^steps - 1 slots on both sides into shared memory,
// runs every round there (coefficients stream from global memory, each
// read once per block), and writes only its central slots. The halo is the
// PCR dependence distance, so central results are exact; the redundant
// halo work is 2·(2^steps - 1)/CHUNK of the total (25% at steps = 7).
//
// Arithmetic order follows the plain PyTorch versions term by term, and
// the library is built with -fmad=false, so the kernels round as the plain
// versions do.

#include "pcr.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;
#ifndef TREE_CG_WINDOW
#error "TREE_CG_WINDOW (slots of a path-aligned window) is set by the build"
#endif
constexpr int kWindow = TREE_CG_WINDOW;   // K6's path-aligned windows

// The state of slot s at index i of the 45 planes `st_` (stride st): D,
// L = B^T, R = B[s+1] (zero past the level's end) and the corner right-hand
// sides, unit columns 0:3 at a path's first slot (corner bit 0) and 3:6 at
// its last (bit 1)
__device__ __forceinline__ void init_slot(const float* __restrict__ D,
                                          const float* __restrict__ B,
                                          const int* __restrict__ corner,
                                          long long S, long long s,
                                          float* st_, long long st,
                                          long long i) {
  const int T[9] = {0, 3, 6, 1, 4, 7, 2, 5, 8};
  for (int c = 0; c < 9; ++c) {
    st_[c * st + i] = D[c * S + s];
    st_[(9 + c) * st + i] = B[T[c] * S + s];
    st_[(18 + c) * st + i] = (s + 1 < S) ? B[c * S + s + 1] : 0.0f;
  }
  const int k = corner[s];
  for (int q = 0; q < 3; ++q)
    for (int j = 0; j < 6; ++j) {
      const bool one = j < 3 ? ((k & 1) && q == j) : ((k & 2) && q == j - 3);
      st_[(27 + 6 * q + j) * st + i] = one ? 1.0f : 0.0f;
    }
}

__global__ void pcr_init_kernel(const float* __restrict__ D,
                                const float* __restrict__ B,
                                const int* __restrict__ corner,
                                float* __restrict__ w, long long S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  init_slot(D, B, corner, S, i, w, S, i);
}

__device__ __forceinline__ void store_final(const float* cur, long long st,
                                            long long len, long long i,
                                            float* __restrict__ dinv,
                                            float* __restrict__ xc,
                                            long long S, long long s) {
  float d[9], x[18];
  pcr::final_slot(cur, st, len, i, d, x);
  for (int c = 0; c < 9; ++c) dinv[c * S + s] = d[c];
  for (int c = 0; c < 18; ++c) xc[c * S + s] = x[c];
}

// K2 on a level cut into path-aligned windows: one block a window, every
// round in shared memory (pcr.cuh's factor_rounds_window, K6's code), the
// round coefficients written as they are formed, dinv and the corner
// solution once at the end
__global__ void __launch_bounds__(kThreads) pcr_factor_window_kernel(
    const float* __restrict__ D, const float* __restrict__ B,
    const int* __restrict__ corner, const int* __restrict__ win_start,
    const int* __restrict__ win_len, float* al, float* be,
    float* __restrict__ dinv, float* __restrict__ xc, long long S,
    int steps) {
  extern __shared__ float smem[];
  float* cur = smem;
  float* nxt = smem + pcr::kStatePlanes * kWindow;
  const long long ws = win_start[blockIdx.x];
  const int wl = win_len[blockIdx.x];
  for (int i = threadIdx.x; i < wl; i += blockDim.x)
    init_slot(D, B, corner, S, ws + i, cur, kWindow, i);
  __syncthreads();
  const float* fin = pcr::factor_rounds_window(cur, nxt, kWindow, wl, steps,
                                               al + ws, be + ws, S);
  for (int i = threadIdx.x; i < wl; i += blockDim.x)
    store_final(fin, kWindow, wl, i, dinv, xc, S, ws + i);
}

__global__ void pcr_round_kernel(const float* cur, float* nxt, float* al,
                                 float* be, long long S, long long s) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  pcr::round_slot(cur, nxt, al, be, S, S, S, i, s);
}

__global__ void pcr_final_kernel(const float* cur, float* __restrict__ dinv,
                                 float* __restrict__ xc, long long S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  store_final(cur, S, S, i, dinv, xc, S, i);
}

__global__ void pcr_apply_kernel(const float* al, const float* be,
                                 const float* __restrict__ dinv,
                                 const float* __restrict__ r,
                                 float* __restrict__ u, long long S,
                                 int steps, int halo) {
  extern __shared__ float smem[];
  const int W = kChunk + 2 * halo;
  float* cur = smem;
  float* nxt = smem + 3 * W;
  long long base = (long long)blockIdx.x * kChunk - halo;

  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    long long pos = base + w;
    bool in = pos >= 0 && pos < S;
    for (int c = 0; c < 3; ++c) cur[c * W + w] = in ? r[c * S + pos] : 0.0f;
  }
  __syncthreads();

  cur = pcr::apply_rounds(cur, nxt, W, base, S, steps, al, be, S);

  for (int w = halo + threadIdx.x; w < halo + kChunk; w += blockDim.x) {
    long long pos = base + w;
    if (pos >= S) break;
    float v0 = cur[w], v1 = cur[W + w], v2 = cur[2 * W + w];
    for (int q = 0; q < 3; ++q)
      u[q * S + pos] = dinv[(3 * q) * S + pos] * v0 +
                       dinv[(3 * q + 1) * S + pos] * v1 +
                       dinv[(3 * q + 2) * S + pos] * v2;
  }
}

}  // namespace

// corner (S,): bit 0 a path's first slot, bit 1 its last. With n_win > 0
// windows (level-local first slots and lengths, each at most kWindow whole
// paths) one launch; else the global rounds on work, 90 planes of S floats
// (two sets of D, L, R (9 each) + r (18)): steps + 2 launches.
extern "C" int pcr_factor_f32(const float* D, const float* B,
                              const int* corner, float* al, float* be,
                              float* dinv, float* xc, float* work,
                              const int* win_start, const int* win_len,
                              int n_win, long long S, int steps,
                              cudaStream_t stream) {
  if (S <= 0) return 0;
  if (n_win > 0) {
    const int smem = (int)(sizeof(float) * 2 * pcr::kStatePlanes * kWindow);
    static bool attr = false;   // raised once: lowering it would hurt later
    if (!attr) {
      cudaError_t e = cudaFuncSetAttribute(
          pcr_factor_window_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
      attr = true;
    }
    pcr_factor_window_kernel<<<n_win, kThreads, smem, stream>>>(
        D, B, corner, win_start, win_len, al, be, dinv, xc, S, steps);
    return (int)cudaGetLastError();
  }
  unsigned blocks = (unsigned)((S + kThreads - 1) / kThreads);
  float* set[2] = {work, work + 45 * S};
  pcr_init_kernel<<<blocks, kThreads, 0, stream>>>(D, B, corner, set[0], S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long s = 1;
  for (int k = 0; k < steps; ++k) {
    float* c = set[k & 1];
    float* n = set[(k + 1) & 1];
    pcr_round_kernel<<<blocks, kThreads, 0, stream>>>(
        c, n, al + (long long)k * 9 * S, be + (long long)k * 9 * S, S, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    s *= 2;
  }
  float* c = set[steps & 1];
  pcr_final_kernel<<<blocks, kThreads, 0, stream>>>(c, dinv, xc, S);
  return (int)cudaGetLastError();
}

// shared memory: 2 * 3 * (kChunk + 2 * halo) floats, halo = 2^steps - 1
extern "C" int pcr_apply_f32(const float* al, const float* be,
                             const float* dinv, const float* r, float* u,
                             long long S, int steps, cudaStream_t stream) {
  if (S <= 0) return 0;
  int halo = (1 << steps) - 1;
  size_t shmem = sizeof(float) * 6 * (size_t)(kChunk + 2 * halo);
  unsigned blocks = (unsigned)((S + kChunk - 1) / kChunk);
  pcr_apply_kernel<<<blocks, kThreads, shmem, stream>>>(al, be, dinv, r, u, S,
                                                        steps, halo);
  return (int)cudaGetLastError();
}

extern "C" int pcr_apply_max_steps() {
  // largest steps whose window fits the 48 KB of static shared memory
  int steps = 0;
  while (sizeof(float) * 6 * (size_t)(kChunk + 2 * ((1 << (steps + 1)) - 1)) <=
         48 * 1024)
    ++steps;
  return steps;
}
