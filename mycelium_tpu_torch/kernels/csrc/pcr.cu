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
//   K3 pcr_sweep_f32 <- _apply_kernel / _apply_kernel_chunked
//      (pcr_apply_planes_kernel): u = T^-1 r from K2's coefficients, fused
//      with the hybrid's forward or backward sweep over one level;
//      pcr_apply_f32 the same apply alone (unbound).
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
// (tree_cg.cu) shares: the rounds, the backward sweep's right-hand side and
// the block-vector products of the stores.
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
// PcrLaunch) holds the windows, flags, outputs and work space, so a
// factorization allocates nothing and reads nothing back.
//
// K3 runs twice per PCR level in every preconditioner apply of the hybrid
// and streams 18 coefficient planes a round plus 9 for dinv: ~(72·steps +
// 36) bytes a slot, e.g. 540 B at steps = 7; with the fused sweep's own
// traffic (12 B of right-hand side in and 12 of solution out a slot, 12 a
// path end's attachment product, written once and read once, and the
// attachment couplings and tables) ~(72·steps + 96) B a slot.
//
// What held its first cut back was neither bytes nor operations. It took
// ceil(S/1024) blocks (53 of 132 SMs at the 309k plan's largest level, 2
// at 22k), each recomputing a halo of 2·(2^steps - 1) slots (25% at steps
// = 7), each thread 4-5 slots deep behind 7 barriers; and around each
// launch the hybrid ran ~20 PyTorch operations a level and sweep (the
// right-hand side's ordered sum, the gathers of the path ends, the
// attachment products, the writes into their buffer, the zeros and the
// index_add_ of the backward right-hand side, the subtraction).
//
// Design (kernels/pcr.py::PcrLaunch, bound once per model): one launch a
// level and sweep, on the same path-aligned windows as K2 (one block a
// window, one slot a thread; PCR never couples two paths, so no halo). The
// launch does the whole level of the sweep:
//   forward (pcr_sweep_forward_kernel): a slot's right-hand side is the
//     residual plus the negated attachment products of earlier levels'
//     path ends that attach to it, added in the order of the plan's
//     attachment CSR (level, side, path), the order of the plain version's
//     ordered sum; the rounds run in shared memory (pcr.cuh's
//     apply_rounds); the store writes y = dinv·v into the result and, at a
//     path's first and last slot, that path end's product -(ab·y), which a
//     later level's load (and the dense tail's right-hand side, one
//     ordered sum) reads: each product is formed once, by its producer;
//   backward (pcr_sweep_backward_kernel): a slot's right-hand side is
//     ab^T·u[junction] of the paths that start or end at it (side 0, then
//     side 1, the order of the plain version's two index_add_ into zeros);
//     the store writes u = y - dinv·v in place of y.
// A level with a path longer than the window keeps the halo form inside
// the same kernels: chunks of kChunk central slots plus a halo of
// 2^steps - 1 on both sides, the same fused load and store. The unbound
// pcr_apply_f32 (a level's rounds alone, halo form) stays for K6's plain
// version on the card and the unbound wrapper. Every term is the plain
// version's, in its order, so the bound sweep equals the plain sweep on
// the CPU bit for bit (up to the sign of a zero).
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
      u[q * S + pos] = pcr::dot3(dinv + 3 * q * S + pos, S, v0, v1, v2);
  }
}


// ---------------------------------------------------------------------------
// K3 bound: one level of the hybrid's forward or backward sweep
// ---------------------------------------------------------------------------

struct Sweep {
  const float* al;           // (steps, 9, S) the level's coefficients
  const float* be;
  const float* dinv;         // (9, S)
  const int* win_start;      // (n_win) level-local; null: the halo form
  const int* win_len;
  const int* att_ptr;        // (S + 1) the level's slots in the plan's CSR
  const int* att_ent;        // entries 2·path + side
  const int* first_path;     // (S) the path that starts at the slot, -1
  const int* last_path;      // (S) the path that ends at it, -1
  const int* att_tgt;        // (2P) junction slot, >= S_tot for none
  const float* ab;           // (2P, 9) row-major attachment couplings
  const float* rp;           // residual planes, row stride rs
  float* u;                  // (3, S_tot) result planes, row stride us
  float* nv;                 // (2P, 3) negated attachment products
  long long rs, us, s0, S, S_tot;
  int steps, halo;
};

// The block's window: level slots [base, base + W), of which it stores
// [base + lo, base + hi)
__device__ __forceinline__ void sweep_window(const Sweep& a, long long& base,
                                             int& W, int& lo, int& hi) {
  if (a.win_start) {
    base = a.win_start[blockIdx.x];
    W = a.win_len[blockIdx.x];
    lo = 0;
    hi = W;
  } else {
    base = (long long)blockIdx.x * kChunk - a.halo;
    W = kChunk + 2 * a.halo;
    lo = a.halo;
    const long long end = a.S - base;
    hi = (int)(end < a.halo + kChunk ? end : a.halo + kChunk);
  }
}

// forward: v = r[s] + sum over the CSR's entries of the negated products
__device__ __forceinline__ void forward_rhs(const Sweep& a, long long s,
                                            float v[3]) {
  const long long g = a.s0 + s;
  for (int c = 0; c < 3; ++c) v[c] = a.rp[c * a.rs + g];
  for (int e = a.att_ptr[s]; e < a.att_ptr[s + 1]; ++e) {
    const float* m = a.nv + 3 * (long long)a.att_ent[e];
    for (int c = 0; c < 3; ++c) v[c] = v[c] + m[c];
  }
}

// forward: y = dinv·v into the result, and -(ab·y) of the path ends here
__device__ __forceinline__ void forward_store(const Sweep& a, long long s,
                                              float v0, float v1, float v2) {
  const long long g = a.s0 + s;
  float y[3];
  for (int q = 0; q < 3; ++q) {
    y[q] = pcr::dot3(a.dinv + 3 * q * a.S + s, a.S, v0, v1, v2);
    a.u[q * a.us + g] = y[q];
  }
  const int ends[2] = {a.first_path[s], a.last_path[s]};
  for (int side = 0; side < 2; ++side) {
    if (ends[side] < 0) continue;
    const long long ent = 2 * (long long)ends[side] + side;
    const float* m = a.ab + 9 * ent;
    for (int q = 0; q < 3; ++q)
      a.nv[3 * ent + q] = -pcr::dot3(m + 3 * q, 1, y[0], y[1], y[2]);
  }
}

// backward: u = y - dinv·v, y being what the forward sweep stored there
__device__ __forceinline__ void backward_store(const Sweep& a, long long s,
                                               float v0, float v1,
                                               float v2) {
  const long long g = a.s0 + s;
  for (int q = 0; q < 3; ++q) {
    const float o = pcr::dot3(a.dinv + 3 * q * a.S + s, a.S, v0, v1, v2);
    a.u[q * a.us + g] = a.u[q * a.us + g] - o;
  }
}

template <bool kBackward>
__global__ void __launch_bounds__(kThreads) pcr_sweep_kernel(Sweep a) {
  extern __shared__ float smem[];
  long long base;
  int W, lo, hi;
  sweep_window(a, base, W, lo, hi);
  float* buf0 = smem;
  float* buf1 = smem + 3 * W;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const long long pos = base + w;
    float v[3] = {0.0f, 0.0f, 0.0f};
    if (pos >= 0 && pos < a.S) {
      if (kBackward)
        pcr::backward_rhs(a.first_path[pos], a.last_path[pos], a.att_tgt,
                          a.ab, a.u, a.us, a.S_tot, v);
      else
        forward_rhs(a, pos, v);
    }
    for (int c = 0; c < 3; ++c) buf0[c * W + w] = v[c];
  }
  __syncthreads();
  const float* cur = pcr::apply_rounds(buf0, buf1, W, base, a.S, a.steps,
                                       a.al, a.be, a.S);
  for (int w = lo + threadIdx.x; w < hi; w += blockDim.x) {
    if (kBackward)
      backward_store(a, base + w, cur[w], cur[W + w], cur[2 * W + w]);
    else
      forward_store(a, base + w, cur[w], cur[W + w], cur[2 * W + w]);
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

// One level of the hybrid's forward (backward = 0) or backward sweep. With
// n_win > 0 windows (level-local first slots and lengths, each at most
// kWindow whole paths) one block a window; else the halo form, chunks of
// kChunk slots (steps at most pcr_apply_max_steps()). rp: residual planes
// of row stride rs (read by the forward sweep at slots s0..s0+S); u: the
// result planes of row stride us (the level writes its slots s0..s0+S);
// nv (2P, 3): the forward sweep writes its paths' ends, reads earlier
// levels'. att_ptr: the level's S + 1 pointers into att_ent.
extern "C" int pcr_sweep_f32(int backward, const float* al, const float* be,
                             const float* dinv, const int* win_start,
                             const int* win_len, int n_win,
                             const int* att_ptr, const int* att_ent,
                             const int* first_path, const int* last_path,
                             const int* att_tgt, const float* ab,
                             const float* rp, long long rs, float* u,
                             long long us, float* nv, long long s0,
                             long long S, long long S_tot, int steps,
                             cudaStream_t stream) {
  if (S <= 0) return 0;
  Sweep a;
  a.al = al;
  a.be = be;
  a.dinv = dinv;
  a.win_start = n_win > 0 ? win_start : nullptr;
  a.win_len = n_win > 0 ? win_len : nullptr;
  a.att_ptr = att_ptr;
  a.att_ent = att_ent;
  a.first_path = first_path;
  a.last_path = last_path;
  a.att_tgt = att_tgt;
  a.ab = ab;
  a.rp = rp;
  a.u = u;
  a.nv = nv;
  a.rs = rs;
  a.us = us;
  a.s0 = s0;
  a.S = S;
  a.S_tot = S_tot;
  a.steps = steps;
  a.halo = (1 << steps) - 1;
  const int W = n_win > 0 ? kWindow : kChunk + 2 * a.halo;
  const size_t shmem = sizeof(float) * 6 * (size_t)W;
  const unsigned blocks =
      n_win > 0 ? (unsigned)n_win : (unsigned)((S + kChunk - 1) / kChunk);
  if (backward)
    pcr_sweep_kernel<true><<<blocks, kThreads, shmem, stream>>>(a);
  else
    pcr_sweep_kernel<false><<<blocks, kThreads, shmem, stream>>>(a);
  return (int)cudaGetLastError();
}
