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
// What bounds them on the card: bytes. K2 reads and writes 45 planes of
// state plus 18 coefficient planes a round (~250 B a slot a round) and
// runs once per factorization. K3 runs twice per PCR level in every CG
// iteration and streams 18 coefficient planes a round plus 9 for dinv:
// ~(72·steps + 36) bytes a slot, e.g. 540 B at steps = 7.
//
// Design. K2 launches once per round over all S slots with the state in
// global ping-pong buffers (the wrapper allocates them): each thread
// recomputes the two neighbour inverses it needs instead of storing dinv,
// which saves a plane pass per round. K3 is one launch per level: each
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

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;

__device__ __forceinline__ void load9(const float* __restrict__ m,
                                      long long S, long long i, float o[9]) {
  if (i >= 0 && i < S) {
    for (int c = 0; c < 9; ++c) o[c] = m[c * S + i];
  } else {
    for (int c = 0; c < 9; ++c) o[c] = 0.0f;
  }
}

// adjugate inverse, det == 0 -> det = 1 (so inv(0) == 0), as _inv9
__device__ __forceinline__ void inv9(const float m[9], float o[9]) {
  float a = m[0], b = m[1], c = m[2], d = m[3], e = m[4], f = m[5],
        g = m[6], h = m[7], i = m[8];
  float A = e * i - f * h;
  float B = -(d * i - f * g);
  float C = d * h - e * g;
  float det = a * A + b * B + c * C;
  det = (det != 0.0f) ? det : 1.0f;
  o[0] = A / det;
  o[1] = -(b * i - c * h) / det;
  o[2] = (b * f - c * e) / det;
  o[3] = B / det;
  o[4] = (a * i - c * g) / det;
  o[5] = -(a * f - c * d) / det;
  o[6] = C / det;
  o[7] = -(a * h - b * g) / det;
  o[8] = (a * e - b * d) / det;
}

__device__ __forceinline__ void mm9(const float a[9], const float b[9],
                                    float o[9]) {
  for (int i = 0; i < 3; ++i)
    for (int k = 0; k < 3; ++k)
      o[3 * i + k] = a[3 * i] * b[k] + a[3 * i + 1] * b[3 + k] +
                     a[3 * i + 2] * b[6 + k];
}

// L = B^T, R = B[i+1]; state D and the corner right-hand sides copied in
__global__ void pcr_init_kernel(const float* __restrict__ D,
                                const float* __restrict__ B,
                                const float* __restrict__ rhs,
                                float* __restrict__ Dw, float* __restrict__ Lw,
                                float* __restrict__ Rw, float* __restrict__ rw,
                                long long S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  const int T[9] = {0, 3, 6, 1, 4, 7, 2, 5, 8};
  for (int c = 0; c < 9; ++c) {
    Dw[c * S + i] = D[c * S + i];
    Lw[c * S + i] = B[T[c] * S + i];
    Rw[c * S + i] = (i + 1 < S) ? B[c * S + i + 1] : 0.0f;
  }
  for (int c = 0; c < 18; ++c) rw[c * S + i] = rhs[c * S + i];
}

__global__ void pcr_round_kernel(
    const float* __restrict__ D, const float* __restrict__ L,
    const float* __restrict__ R, const float* __restrict__ r,
    float* __restrict__ Dn, float* __restrict__ Ln, float* __restrict__ Rn,
    float* __restrict__ rn, float* __restrict__ al, float* __restrict__ be,
    long long S, long long s) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  float t[9], dm[9], dp[9], Li[9], Ri[9], a[9], b[9], x[9], y[9];
  load9(D, S, i - s, t);
  inv9(t, dm);
  load9(D, S, i + s, t);
  inv9(t, dp);
  load9(L, S, i, Li);
  load9(R, S, i, Ri);
  mm9(Li, dm, a);
  mm9(Ri, dp, b);

  float Rm[9], Lp[9], Lm[9], Rp[9];
  load9(R, S, i - s, Rm);
  load9(L, S, i + s, Lp);
  load9(L, S, i - s, Lm);
  load9(R, S, i + s, Rp);
  mm9(a, Rm, x);
  mm9(b, Lp, y);
  for (int c = 0; c < 9; ++c) Dn[c * S + i] = D[c * S + i] - (x[c] + y[c]);
  mm9(a, Lm, x);
  for (int c = 0; c < 9; ++c) Ln[c * S + i] = -x[c];
  mm9(b, Rp, y);
  for (int c = 0; c < 9; ++c) Rn[c * S + i] = -y[c];
  for (int c = 0; c < 9; ++c) {
    al[c * S + i] = a[c];
    be[c * S + i] = b[c];
  }

  // corner columns: plane 6*i + j is component i of unit column j
  bool hm = i - s >= 0, hp = i + s < S;
  for (int j = 0; j < 6; ++j) {
    float rm[3], rp[3];
    for (int q = 0; q < 3; ++q) {
      rm[q] = hm ? r[(6 * q + j) * S + i - s] : 0.0f;
      rp[q] = hp ? r[(6 * q + j) * S + i + s] : 0.0f;
    }
    for (int q = 0; q < 3; ++q) {
      float am = a[3 * q] * rm[0] + a[3 * q + 1] * rm[1] +
                 a[3 * q + 2] * rm[2];
      float bp = b[3 * q] * rp[0] + b[3 * q + 1] * rp[1] +
                 b[3 * q + 2] * rp[2];
      rn[(6 * q + j) * S + i] = r[(6 * q + j) * S + i] - (am + bp);
    }
  }
}

__global__ void pcr_final_kernel(const float* __restrict__ D,
                                 const float* __restrict__ r,
                                 float* __restrict__ dinv,
                                 float* __restrict__ xc, long long S) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= S) return;
  float t[9], d[9];
  load9(D, S, i, t);
  inv9(t, d);
  for (int c = 0; c < 9; ++c) dinv[c * S + i] = d[c];
  for (int j = 0; j < 6; ++j) {
    float v[3];
    for (int q = 0; q < 3; ++q) v[q] = r[(6 * q + j) * S + i];
    for (int q = 0; q < 3; ++q)
      xc[(6 * q + j) * S + i] =
          d[3 * q] * v[0] + d[3 * q + 1] * v[1] + d[3 * q + 2] * v[2];
  }
}

__global__ void pcr_apply_kernel(const float* __restrict__ al,
                                 const float* __restrict__ be,
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

  int s = 1;
  for (int k = 0; k < steps; ++k) {
    const float* ak = al + (long long)k * 9 * S;
    const float* bk = be + (long long)k * 9 * S;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      long long pos = base + w;
      if (pos < 0 || pos >= S) {
        for (int c = 0; c < 3; ++c) nxt[c * W + w] = 0.0f;
        continue;
      }
      float rm[3], rp[3];
      for (int c = 0; c < 3; ++c) {
        rm[c] = (w - s >= 0) ? cur[c * W + w - s] : 0.0f;
        rp[c] = (w + s < W) ? cur[c * W + w + s] : 0.0f;
      }
      for (int q = 0; q < 3; ++q) {
        float am = ak[(3 * q) * S + pos] * rm[0] +
                   ak[(3 * q + 1) * S + pos] * rm[1] +
                   ak[(3 * q + 2) * S + pos] * rm[2];
        float bp = bk[(3 * q) * S + pos] * rp[0] +
                   bk[(3 * q + 1) * S + pos] * rp[1] +
                   bk[(3 * q + 2) * S + pos] * rp[2];
        nxt[q * W + w] = cur[q * W + w] - (am + bp);
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
    s *= 2;
  }

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

// work: 90 planes of S floats (two sets of D, L, R (9 each) + r (18))
extern "C" int pcr_factor_f32(const float* D, const float* B, const float* rhs,
                              float* al, float* be, float* dinv, float* xc,
                              float* work, long long S, int steps,
                              cudaStream_t stream) {
  if (S <= 0) return 0;
  unsigned blocks = (unsigned)((S + kThreads - 1) / kThreads);
  float* set[2] = {work, work + 45 * S};
  pcr_init_kernel<<<blocks, kThreads, 0, stream>>>(
      D, B, rhs, set[0], set[0] + 9 * S, set[0] + 18 * S, set[0] + 27 * S, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  long long s = 1;
  for (int k = 0; k < steps; ++k) {
    float* c = set[k & 1];
    float* n = set[(k + 1) & 1];
    pcr_round_kernel<<<blocks, kThreads, 0, stream>>>(
        c, c + 9 * S, c + 18 * S, c + 27 * S, n, n + 9 * S, n + 18 * S,
        n + 27 * S, al + (long long)k * 9 * S, be + (long long)k * 9 * S, S,
        s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    s *= 2;
  }
  float* c = set[steps & 1];
  pcr_final_kernel<<<blocks, kThreads, 0, stream>>>(c, c + 27 * S, dinv, xc,
                                                    S);
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
