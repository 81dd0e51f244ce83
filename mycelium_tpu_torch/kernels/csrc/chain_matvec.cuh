// The chain-ordered stiffness matvec as device functions shared by K1
// (chain_matvec.cu), K5 (chain_cg.cu) and K6 (tree_cg.cu), so all three
// compute the operator with the same instructions: matvec_tile, a block's
// tile of positions through shared memory (K1, K6), and matvec_node, one
// position a thread (K5).
//
// Layout: u and the result are three contiguous (N,) component planes,
// position p being chain position p. Chain edge p joins positions p and
// p+1, with unit direction cn[:, p] and stiffnesses ckax[p], ckbd[p]; jump
// edge j joins ja[j] and jb[j]. The jumps of a position are its rows of a
// per-node CSR (jptr/jent, entry 2j + side), summed in that fixed order: no
// atomics.
//
// Arithmetic order follows the plain PyTorch version term by term; the
// library is built with -fmad=false so products are not contracted into
// fused multiply-adds and the kernels round as the plain versions do.
//
// u carries no __restrict__: K5 and K6 write the vector they multiply
// between grid-wide barriers, so its loads must not go through the
// read-only (non-coherent) data path.

#pragma once

#include <cuda_runtime.h>

namespace chain_op {

// ---- the tile form (K1, K6): 32-bit indices, packed static tables ----

struct Packed {
  const float* freem;    // (N) per-solve masks
  const float* cact;     // (N)
  const float* jact;     // (Jp)
  const float4* cpack;   // (N) n0, n1, n2, kax of chain slot p
  const float* ckbd;     // (N)
  const float4* jpack;   // (Jp)
  const float* jkbd;     // (Jp)
  const int* ja;         // (Jp)
  const int* jb;
  const int* jptr;       // (N + 1)
  const int* jent;       // (2J)
  int n;
  float reg;
};

// floats of shared memory a tile of T positions needs: free·u on T + 2
// positions and the forces of T + 1 slots, three planes each
template <int T>
struct Tile {
  static constexpr int floats = 3 * (T + 2) + 3 * (T + 1);
};

// force of one chain or jump edge from the difference d of its ends'
// values: (kax·(n·d)·n + kbd·(d − (n·d)·n))·act
__device__ __forceinline__ void edge_force(const float d[3], float4 nk,
                                           float kbd, float act,
                                           float f[3]) {
  const float nn[3] = {nk.x, nk.y, nk.z};
  const float nd = nn[0] * d[0] + nn[1] * d[1] + nn[2] * d[2];
  const float kax_nd = nk.w * nd;
  for (int c = 0; c < 3; ++c)
    f[c] = (kax_nd * nn[c] + kbd * (d[c] - nd * nn[c])) * act;
}

// out = (A u)[q0 + threadIdx.x] for the T positions from q0 (bc = 1 the
// boundary-conditioned operator free·(K(free·u) + reg·free·u) + (1 − free)·u,
// bc = 0 the raw K·u). Every thread of a block of T threads calls it; sm
// holds Tile<T>::floats floats. free·u is loaded once for the tile and its
// two neighbours, each of the T + 1 slot forces is computed once into shared
// memory and differenced; the positions that have jumps (a few percent)
// add them from the CSR. A thread whose position is past the end gets 0.
template <int T>
__device__ __forceinline__ void matvec_tile(const float* u, const Packed& t,
                                            int bc, int q0, float* sm,
                                            float out[3]) {
  const int n = t.n;
  float* uf = sm;                  // uf[c * (T + 2) + k]: position q0 - 1 + k
  float* fs = sm + 3 * (T + 2);    // fs[c * (T + 1) + k]: slot q0 - 1 + k
  __syncthreads();                 // the previous tile's readers are done
  for (int k = threadIdx.x; k < T + 2; k += T) {
    const int q = q0 - 1 + k;
    const bool in = q >= 0 && q < n;
    const float fr = (in && bc) ? t.freem[q] : 1.0f;
    for (int c = 0; c < 3; ++c) {
      const float v = in ? u[(long long)c * n + q] : 0.0f;
      uf[c * (T + 2) + k] = bc ? v * fr : v;
    }
  }
  __syncthreads();
  for (int k = threadIdx.x; k < T + 1; k += T) {
    const int q = q0 - 1 + k;
    float f[3] = {0.0f, 0.0f, 0.0f};
    if (q >= 0 && q < n) {
      float d[3];
      for (int c = 0; c < 3; ++c)
        d[c] = uf[c * (T + 2) + k] - uf[c * (T + 2) + k + 1];
      edge_force(d, t.cpack[q], t.ckbd[q], t.cact[q], f);
    }
    for (int c = 0; c < 3; ++c) fs[c * (T + 1) + k] = f[c];
  }
  __syncthreads();
  const int p = q0 + threadIdx.x;
  if (p >= n) {
    for (int c = 0; c < 3; ++c) out[c] = 0.0f;
    return;
  }
  const int k = threadIdx.x;
  float o[3];
  for (int c = 0; c < 3; ++c)
    o[c] = fs[c * (T + 1) + k + 1] - fs[c * (T + 1) + k];

  for (int e = t.jptr[p]; e < t.jptr[p + 1]; ++e) {
    const int ent = t.jent[e];
    const int j = ent >> 1;
    const int a = t.ja[j], b = t.jb[j];
    float dj[3];
    if (bc) {
      const float fa = t.freem[a], fb = t.freem[b];
      for (int c = 0; c < 3; ++c)
        dj[c] = u[(long long)c * n + a] * fa - u[(long long)c * n + b] * fb;
    } else {
      for (int c = 0; c < 3; ++c)
        dj[c] = u[(long long)c * n + a] - u[(long long)c * n + b];
    }
    float fj[3];
    edge_force(dj, t.jpack[j], t.jkbd[j], t.jact[j], fj);
    for (int c = 0; c < 3; ++c) o[c] = (ent & 1) ? o[c] - fj[c] : o[c] + fj[c];
  }

  if (bc) {
    const float fr = t.freem[p];
    for (int c = 0; c < 3; ++c) {
      const float uc = u[(long long)c * n + p];
      const float ufc = uf[c * (T + 2) + k + 1];
      out[c] = fr * (o[c] + t.reg * ufc) + (1.0f - fr) * uc;
    }
  } else {
    for (int c = 0; c < 3; ++c) out[c] = o[c];
  }
}

// ---- the per-position form (K5): 64-bit indices, separate tables ----

struct Tables {
  const float* freem;
  const float* cact;
  const float* jact;
  const float* cn;
  const float* ckax;
  const float* ckbd;
  const float* jn;
  const float* jkax;
  const float* jkbd;
  const long long* ja;
  const long long* jb;
  long long jp;
  const long long* jptr;
  const long long* jent;
  long long n;
  float reg;
};

__device__ __forceinline__ float uval(const float* u, const Tables& t,
                                      int bc, long long c, long long q) {
  float v = u[c * t.n + q];
  return bc ? v * t.freem[q] : v;
}

// chain force of slot q on position q (position q+1 receives -f)
__device__ __forceinline__ void slot_force(const float* u, const Tables& t,
                                           int bc, long long q, float f[3]) {
  const long long n = t.n;
  float d[3];
  for (int c = 0; c < 3; ++c) {
    float nxt = (q + 1 < n) ? uval(u, t, bc, c, q + 1) : 0.0f;
    d[c] = uval(u, t, bc, c, q) - nxt;
  }
  float n0 = t.cn[q], n1 = t.cn[n + q], n2 = t.cn[2 * n + q];
  float nd = n0 * d[0] + n1 * d[1] + n2 * d[2];
  float kax_nd = t.ckax[q] * nd;
  float kbd = t.ckbd[q];
  float act = t.cact[q];
  float nn[3] = {n0, n1, n2};
  for (int c = 0; c < 3; ++c)
    f[c] = (kax_nd * nn[c] + kbd * (d[c] - nd * nn[c])) * act;
}

// out = (A u)[p]: bc = 1 the boundary-conditioned operator
// free·(K(free·u) + reg·free·u) + (1 - free)·u, bc = 0 the raw K·u
__device__ __forceinline__ void matvec_node(const float* u, const Tables& t,
                                            int bc, long long p,
                                            float out[3]) {
  const long long n = t.n;
  float f[3], fm[3] = {0.0f, 0.0f, 0.0f};
  slot_force(u, t, bc, p, f);
  if (p > 0) slot_force(u, t, bc, p - 1, fm);
  float o[3];
  for (int c = 0; c < 3; ++c) o[c] = f[c] - fm[c];

  for (long long e = t.jptr[p]; e < t.jptr[p + 1]; ++e) {
    long long j = t.jent[e] >> 1;
    int side = (int)(t.jent[e] & 1);
    long long a = t.ja[j], b = t.jb[j];
    float dj[3];
    for (int c = 0; c < 3; ++c)
      dj[c] = uval(u, t, bc, c, a) - uval(u, t, bc, c, b);
    float m0 = t.jn[j], m1 = t.jn[t.jp + j], m2 = t.jn[2 * t.jp + j];
    float nn[3] = {m0, m1, m2};
    float ndj = m0 * dj[0] + m1 * dj[1] + m2 * dj[2];
    float kax_nd = t.jkax[j] * ndj;
    float kbd = t.jkbd[j];
    float act = t.jact[j];
    for (int c = 0; c < 3; ++c) {
      float fj = (kax_nd * nn[c] + kbd * (dj[c] - ndj * nn[c])) * act;
      o[c] = side ? o[c] - fj : o[c] + fj;
    }
  }

  if (bc) {
    float fr = t.freem[p];
    for (int c = 0; c < 3; ++c) {
      float uc = u[c * n + p];
      float ufc = uc * fr;
      out[c] = fr * (o[c] + t.reg * ufc) + (1.0f - fr) * uc;
    }
  } else {
    for (int c = 0; c < 3; ++c) out[c] = o[c];
  }
}

}  // namespace chain_op
