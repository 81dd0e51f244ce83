// The chain-ordered stiffness matvec as device functions shared by K1
// (chain_matvec.cu), K5 (chain_cg.cu) and K6 (tree_cg.cu), so all three
// compute the operator with the same instructions: matvec_tile, a block's
// tile of positions through shared memory; and the per-position 3x3
// diagonal block of the same stiffness (diag_block), which K5's
// block-Jacobi preconditioner and K6's forest diagonal add up in one order.
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

// u as three contiguous component planes
struct Planes {
  const float* u;
  int n;
  __device__ __forceinline__ float operator()(int c, int q) const {
    return u[(long long)c * n + q];
  }
};

// out = (A u)[q0 + threadIdx.x] for the T positions from q0 (bc = 1 the
// boundary-conditioned operator free·(K(free·u) + reg·free·u) + (1 − free)·u,
// bc = 0 the raw K·u). Every thread of a block of T threads calls it; sm
// holds Tile<T>::floats floats. free·u is loaded once for the tile and its
// two neighbours, each of the T + 1 slot forces is computed once into shared
// memory and differenced; the positions that have jumps (a few percent)
// add them from the CSR. A thread whose position is past the end gets 0.
// matvec_tile_u reads u through a loader, u(c, q): in K5 the direction
// p = z + beta·p_old formed as it is read; matvec_tile reads the planes.
template <int T, class U>
__device__ __forceinline__ void matvec_tile_u(const U& u, const Packed& t,
                                              int bc, int q0, float* sm,
                                              float out[3]) {
  const int n = t.n;
  float* uf = sm;                  // uf[c * (T + 2) + k]: position q0 - 1 + k
  float* fs = sm + 3 * (T + 2);    // fs[c * (T + 1) + k]: slot q0 - 1 + k
  // what the later stages read from device memory, loaded before the first
  // barrier so that every load of the tile is in flight at once: the
  // thread's first slot and its own position
  const int k = threadIdx.x;
  const int p = q0 + k;
  const int qs = q0 - 1 + k;
  const bool slot_in = qs >= 0 && qs < n;
  const float4 nk = slot_in ? t.cpack[qs] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float kbd = slot_in ? t.ckbd[qs] : 0.0f;
  const float act = slot_in ? t.cact[qs] : 0.0f;
  const bool own = p < n;
  const int e0 = own ? t.jptr[p] : 0, e1 = own ? t.jptr[p + 1] : 0;
  const float frp = (own && bc) ? t.freem[p] : 1.0f;
  float up[3];
  for (int c = 0; c < 3; ++c) up[c] = own ? u(c, p) : 0.0f;
  // the thread's first position of the tile and its two neighbours
  const float fh = (slot_in && bc) ? t.freem[qs] : 1.0f;
  float uh[3];
  for (int c = 0; c < 3; ++c) uh[c] = slot_in ? u(c, qs) : 0.0f;
  __syncthreads();                 // the previous tile's readers are done
  for (int c = 0; c < 3; ++c) uf[c * (T + 2) + k] = bc ? uh[c] * fh : uh[c];
  for (int w = k + T; w < T + 2; w += T) {
    const int q = q0 - 1 + w;
    const bool in = q >= 0 && q < n;
    const float fr = (in && bc) ? t.freem[q] : 1.0f;
    for (int c = 0; c < 3; ++c) {
      const float v = in ? u(c, q) : 0.0f;
      uf[c * (T + 2) + w] = bc ? v * fr : v;
    }
  }
  __syncthreads();
  for (int w = k; w < T + 1; w += T) {
    const int q = q0 - 1 + w;
    float f[3] = {0.0f, 0.0f, 0.0f};
    if (q >= 0 && q < n) {
      float d[3];
      for (int c = 0; c < 3; ++c)
        d[c] = uf[c * (T + 2) + w] - uf[c * (T + 2) + w + 1];
      if (w == k) {
        edge_force(d, nk, kbd, act, f);
      } else {
        edge_force(d, t.cpack[q], t.ckbd[q], t.cact[q], f);
      }
    }
    for (int c = 0; c < 3; ++c) fs[c * (T + 1) + w] = f[c];
  }
  __syncthreads();
  if (!own) {
    for (int c = 0; c < 3; ++c) out[c] = 0.0f;
    return;
  }
  float o[3];
  for (int c = 0; c < 3; ++c)
    o[c] = fs[c * (T + 1) + k + 1] - fs[c * (T + 1) + k];

  for (int e = e0; e < e1; ++e) {
    const int ent = t.jent[e];
    const int j = ent >> 1;
    const int a = t.ja[j], b = t.jb[j];
    float dj[3];
    if (bc) {
      const float fa = t.freem[a], fb = t.freem[b];
      for (int c = 0; c < 3; ++c) dj[c] = u(c, a) * fa - u(c, b) * fb;
    } else {
      for (int c = 0; c < 3; ++c) dj[c] = u(c, a) - u(c, b);
    }
    float fj[3];
    edge_force(dj, t.jpack[j], t.jkbd[j], t.jact[j], fj);
    for (int c = 0; c < 3; ++c) o[c] = (ent & 1) ? o[c] - fj[c] : o[c] + fj[c];
  }

  if (bc) {
    for (int c = 0; c < 3; ++c) {
      const float ufc = uf[c * (T + 2) + k + 1];
      out[c] = frp * (o[c] + t.reg * ufc) + (1.0f - frp) * up[c];
    }
  } else {
    for (int c = 0; c < 3; ++c) out[c] = o[c];
  }
}

template <int T>
__device__ __forceinline__ void matvec_tile(const float* u, const Packed& t,
                                            int bc, int q0, float* sm,
                                            float out[3]) {
  matvec_tile_u<T>(Planes{u, t.n}, t, bc, q0, sm, out);
}

// (kax - kbd)·m·n n^T + kbd·m·I of a chain slot or jump row (nk: n0, n1,
// n2, kax), the association of fea/tree_factor.py::chain_diag
__device__ __forceinline__ void edge_k3(float4 nk, float kbd, float m,
                                        float k[9]) {
  const float nn[3] = {nk.x, nk.y, nk.z};
  const float kd = (nk.w - kbd) * m;
  const float kb = kbd * m;
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const float v = nn[i] * nn[j] * kd;
      k[3 * i + j] = (i == j) ? v + kb : v;
    }
}

// The 3x3 diagonal block of position q: the stiffness of chain slots q and
// q - 1 and of the position's jumps, each through its mask (chain_m(slot),
// jump_m(jump): 1 or 0), the jumps added in the order of the per-node jump
// CSR (a sequential index_add_'s); then reg on the diagonal of a free
// position and the identity on a pinned one. Term by term as
// fea/tree_factor.py::chain_diag.
template <class ChainMask, class JumpMask>
__device__ __forceinline__ void diag_block(const Packed& t, int q, bool free,
                                           float reg, const ChainMask& chain_m,
                                           const JumpMask& jump_m,
                                           float d[9]) {
  float kc[9], km[9];
  float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  edge_k3(t.cpack[q], t.ckbd[q], chain_m(q), kc);
  if (q > 0) {
    edge_k3(t.cpack[q - 1], t.ckbd[q - 1], chain_m(q - 1), km);
  } else {
    for (int c = 0; c < 9; ++c) km[c] = 0.0f;
  }
  for (int e = t.jptr[q]; e < t.jptr[q + 1]; ++e) {
    const int j = t.jent[e] >> 1;
    float kj[9];
    edge_k3(t.jpack[j], t.jkbd[j], jump_m(j), kj);
    for (int c = 0; c < 9; ++c) acc[c] = acc[c] + kj[c];
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      const int c = 3 * i + j;
      float pv = kc[c] + km[c];
      pv = pv + acc[c];
      if (i == j) {
        pv = free ? pv + reg : 1.0f;
      } else {
        pv = free ? pv : 0.0f;
      }
      d[c] = pv;
    }
}

}  // namespace chain_op
