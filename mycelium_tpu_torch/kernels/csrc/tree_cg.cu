// K6: the whole spanning-forest-preconditioned CG solve in one launch.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_tree.py::_tree_cg_kernel
// (B4): the solve's set-up, every level's PCR factorization with the
// attachment and fill Schur corrections, B1's operator, the forest
// preconditioner's forward and backward sweeps, and CG with the stop on
// r·r <= rtol²·|free·b|²; no atol, no restarts, no dense tail, no coarse
// stage. B4 has no stall exit; K6 has the one of the reference's pcg
// (mycelium_tpu/fea/solve.py:254-300), which runs the solves above B4's
// memory gate that K6 takes: the loop also ends once |r| has not improved
// by 0.1% on its best for stall_window iterations, or for near_window
// iterations while |r| <= stall_accept·tol (float32 throughout, as pcg).
// It does not copy B4's layout: no (NB, 128) planes,
// no rolls, no level masks over all slots and no one-hot matrix products.
// Vectors are the port's (3, N) chain-ordered component planes (slot s of
// the forest IS chain position s), B4's one-hot gathers and scatters are
// index arrays, each level runs on its own slot range for its own number of
// rounds, and the per-slot arithmetic is K1's, K2's and K3's
// (chain_matvec.cuh, pcr.cuh).
//
// What bounds it on the card: the grid-wide barriers on small meshes, bytes
// on large ones; never operations. Between two barriers a phase moves at
// most ~250 bytes a slot: at 22k DOF (2,022 slots) that is microseconds of
// work behind a barrier of about the same cost, and every table stays in
// the 50 MB L2; at 3M DOF (874k slots) the phases stream from device
// memory. So the design keeps the host out of the solve (one launch, the
// set-up and the stop test on the device, the result written in node
// order), keeps the barriers few, and sizes the grid to the mesh (a
// barrier costs more the more blocks cross it).
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel, all
// blocks resident). Phases between barriers:
//   set-up: from the solve's own inputs in the model's layout (the active
//     mask by element, the free mask and the start vector by node, the two
//     grip displacements) one thread a position, jump, slot or attachment
//     computes the masks, the prescribed values and the start vector in
//     chain order, the forest diagonal d9 (the jump terms added through
//     the per-node jump CSR in its fixed order), the left-edge couplings
//     and the attachment couplings, term by term as the plain set-up
//     (fea/tree_factor.py::tree_factor_inputs) does;
//   r = b - A x with |free·b|² and r·r (tiles of chain_op::matvec_tile),
//     in the same phase as the first level's factorization;
//   factorization, per level. A level whose paths fit the window (WINDOW
//     slots, the build's TREE_CG_WINDOW) is cut on the host into windows of
//     whole paths: a block loads a window's state into shared memory (D =
//     diagonal + the Schur corrections of earlier levels' paths gathered
//     through a CSR by junction slot, L and R from the left-edge couplings
//     plus the fill couplings of earlier levels, the corner right-hand
//     sides), runs every round there with __syncthreads() between them,
//     and writes the coefficients, the block inverses and, one thread a
//     path, the attachment couplings, the Schur corrections dG and the fill
//     coupling: one phase and one barrier a level. PCR never couples two
//     paths, so the window's neighbours read as zero and the result is the
//     whole level's. A level with a longer path keeps global ping-pong
//     state and one barrier a round (rounds + 2 a level);
//   apply forward, per level: a windowed level runs its rounds on the same
//     windows in shared memory, with no halo; a level on global rounds
//     takes chunks of CHUNK slots plus a halo of 2^rounds - 1 on both
//     sides. A slot's right-hand side is r minus the attachment products
//     of earlier levels' paths, gathered through the same CSR in a fixed
//     order. The last level has no attachments, so its forward solution is
//     its z and it has no backward phase;
//   apply backward, per level from the last but one: the right-hand side of
//     a path's first and last slot is the transposed attachment coupling
//     times the junction's value (gathered), u = y - T^-1 z;
//   CG: operator and p·Ap; the x, r update with r·r, fused into the first
//     level's forward windows (a window's owner updates its slots as it
//     loads them; the other positions in the same phase); p = z + beta p.
// Barriers: 1 + levels to set up and factor, 2·levels - 1 a preconditioner
// apply, 2·levels + 1 an iteration (all levels windowed).
// Several paths attach to one junction slot; the CSR lets the slot's owner
// add their terms in a fixed order (level, side, path: the order in which a
// sequential index_add_ adds them), so no float atomics and two launches on
// the same inputs give the same bits. Dots are grid_reduce.cuh's (float64
// partial sums per block, the same total in every block). Scratch comes
// from the caller; the kernel allocates nothing. Built with -fmad=false.

#include <cooperative_groups.h>

#include "chain_matvec.cuh"
#include "grid_reduce.cuh"
#include "pcr.cuh"

namespace cg = cooperative_groups;

namespace {

using grid_reduce::THREADS;
using grid_reduce::WARPS;
using grid_reduce::grid_total;
using grid_reduce::prod;
using grid_reduce::put_partial;

#ifndef TREE_CG_CHUNK
#error "TREE_CG_CHUNK (central slots of a halo window) is set by the build"
#endif
#ifndef TREE_CG_WINDOW
#error "TREE_CG_WINDOW (slots of a path-aligned window) is set by the build"
#endif
constexpr int CHUNK = TREE_CG_CHUNK;
constexpr int WINDOW = TREE_CG_WINDOW;

// the order of the pointer and integer arguments of tree_cg_f32: the
// model's static tables and the launch's own scratch, bound once
enum Ptr {
  P_PERM, P_CHAIN_ELEM, P_JUMP_ELEM, P_CPACK, P_CKBD, P_JPACK, P_JKBD, P_JA,
  P_JB, P_JPTR, P_JENT,
  P_CHAIN_TREE, P_JUMP_TREE, P_TOP, P_BOT,
  P_LEFT_K3, P_LEFT_ELEM, P_ATT_ELEM, P_ATT_NA, P_ATT_NB, P_ATT_K3,
  P_LVL, P_WLV, P_WIN_START, P_WIN_LEN, P_LEFT_FILL, P_FIRST_PATH,
  P_LAST_PATH, P_FG, P_LG, P_HAS_FILL, P_ATT_TGT, P_ATT_FILL, P_ATT_FLIP,
  P_ATT_PTR, P_ATT_ENT,
  P_WORK, P_PART, N_PTRS
};
enum Int {
  I_N, I_JP, I_E, I_S, I_P, I_L, I_SMAX_GLOBAL, I_COEF, I_GRID, I_SMEM,
  I_STALL_WINDOW, I_NEAR_WINDOW, N_INTS
};

struct TreeArgs {
  chain_op::Packed t;
  // the solve's own inputs, in the model's layout
  const unsigned char* active;   // (E)
  const unsigned char* freen;    // (N) by node
  const float* x0n;              // (N, 3) by node
  float* xn;                     // (N, 3) by node: the result
  float* stats;                  // [iterations, |r|, tol, iterations
                                 //  without improvement, barriers]
  float dy_top, dy_bot, reg_pc, rtol, stall_accept;
  int max_iter, stall_window, near_window;
  // the set-up's static tables
  const int* perm;               // (N) position -> node
  const int* chain_elem;         // (N) element of chain slot p, E for none
  const int* jump_elem;          // (Jp)
  const unsigned char* chain_tree;   // (N) the slot's element is in the forest
  const unsigned char* jump_tree;    // (Jp)
  const unsigned char* top;      // (N) by node: grip masks
  const unsigned char* bot;
  const float* left_k3;          // (9, S) left-edge k3
  const int* left_elem;          // (S) left-edge element, -1
  const int* att_elem;           // (2P) attachment element, -1
  const int* att_na;             // (2P) its end nodes
  const int* att_nb;
  const float* att_k3;           // (2P, 9) its k3
  // the schedule
  const long long* lvl;          // (4, L + 1): slot offsets, path offsets,
                                 // rounds, coefficient offsets
  const long long* wlv;          // (2, L + 1): window offsets, windowed
  const int* win_start;          // first slot of a window
  const int* win_len;
  const int* left_fill;          // (S) 2·path + flip of the left fill edge, -1
  const int* first_path;         // (S) the path that starts at the slot, -1
  const int* last_path;          // (S) the path that ends at the slot, -1
  const int* fg;                 // (P) first slot
  const int* lg;                 // (P) last slot
  const int* has_fill;           // (P)
  const int* att_tgt;            // (2P) junction slot of entry 2·path + side, S
  const int* att_fill;           // (2P) producing path of a fill attachment, -1
  const int* att_flip;           // (2P)
  const int* att_ptr;            // (S + 1) CSR of entries by junction slot
  const int* att_ent;
  // scratch (the order of the work buffer)
  float* uk;                     // (3, N) each, chain order
  float* x;
  float* r;
  float* z;
  float* p;
  float* ap;
  float* freem;                  // (N)
  float* cact;                   // (N)
  float* jact;                   // (Jp)
  float* d9;                     // (9, S) forest diagonal
  float* bel;                    // (9, S) left-edge element couplings
  float* y;                      // (3, S) forward solutions
  float* dinv;                   // (9, S)
  float* katt;                   // (2P, 9) attachment element couplings
  float* ab;                     // (2P, 9) attachment couplings
  float* dg;                     // (2P, 9) Schur corrections by path and side
  float* fill;                   // (P, 9) fill couplings
  float* state;                  // 2 x 45 x smax: levels on global rounds
  float* al;                     // per level (rounds, 9, S_l)
  float* be;
  double* part;                  // 4 x gridDim.x
  long long S, P, smax;
  int n, jp, E, L;
};

struct Level {
  long long s0, len, p0, p1, coef;
  int steps, w0, w1;
  bool windowed;
};

__device__ __forceinline__ Level level_of(const TreeArgs& a, int li) {
  const long long* v = a.lvl;
  const int w = a.L + 1;
  Level l;
  l.s0 = v[li];
  l.len = v[li + 1] - v[li];
  l.p0 = v[w + li];
  l.p1 = v[w + li + 1];
  l.steps = (int)v[2 * w + li];
  l.coef = v[3 * w + li];
  l.w0 = (int)a.wlv[li];
  l.w1 = (int)a.wlv[li + 1];
  l.windowed = a.wlv[w + li] != 0;
  return l;
}

// ---------------------------------------------------------------------------
// the per-solve set-up
// ---------------------------------------------------------------------------

__device__ __forceinline__ bool elem_active(const TreeArgs& a, int e) {
  return e >= 0 && e < a.E && a.active[e] != 0;
}

// the masks of the forest diagonal: an active element of the forest
struct ForestChain {
  const TreeArgs& a;
  __device__ __forceinline__ float operator()(int q) const {
    return elem_active(a, a.chain_elem[q]) && a.chain_tree[q] != 0 ? 1.0f
                                                                  : 0.0f;
  }
};
struct ForestJump {
  const TreeArgs& a;
  __device__ __forceinline__ float operator()(int j) const {
    return elem_active(a, a.jump_elem[j]) && a.jump_tree[j] != 0 ? 1.0f
                                                                : 0.0f;
  }
};

// One thread a position, jump, slot and attachment entry; reads only the
// solve's inputs and the static tables, so it needs no barrier inside.
__device__ void setup_phase(const TreeArgs& a, long long tid, long long nthr) {
  const int n = a.n;
  const long long S = a.S;
  for (long long q = tid; q < n; q += nthr) {
    const int node = a.perm[q];
    const float f = a.freen[node] ? 1.0f : 0.0f;
    const float pin = 1.0f - f;
    a.freem[q] = f;
    a.cact[q] = elem_active(a, a.chain_elem[q]) ? 1.0f : 0.0f;
    const float uy = (a.top[node] ? 1.0f : 0.0f) * a.dy_top +
                     (a.bot[node] ? 1.0f : 0.0f) * a.dy_bot;
    const float uk[3] = {0.0f, uy, 0.0f};
    for (int c = 0; c < 3; ++c) {
      a.uk[(long long)c * n + q] = uk[c];
      a.x[(long long)c * n + q] = f * a.x0n[3LL * node + c] + pin * uk[c];
    }
  }
  for (long long j = tid; j < a.jp; j += nthr)
    a.jact[j] = elem_active(a, a.jump_elem[j]) ? 1.0f : 0.0f;

  for (long long s = tid; s < S; s += nthr) {
    const int q = (int)s;
    const bool fr = a.freen[a.perm[q]] != 0;
    const bool fprev = q > 0 && a.freen[a.perm[q - 1]] != 0;
    // the forest diagonal: both chain ends, then the jumps in CSR order
    float d[9];
    chain_op::diag_block(a.t, q, fr, a.reg_pc, ForestChain{a}, ForestJump{a},
                         d);
    for (int c = 0; c < 9; ++c) a.d9[c * S + s] = d[c];
    // the left-edge coupling: -k3 where the edge is active and both ends
    // are free
    const float m = (elem_active(a, a.left_elem[s]) && fr && fprev)
                        ? 1.0f : 0.0f;
    for (int c = 0; c < 9; ++c) a.bel[c * S + s] = -a.left_k3[c * S + s] * m;
  }

  for (long long ent = tid; ent < 2 * a.P; ent += nthr) {
    const bool ok = elem_active(a, a.att_elem[ent]) &&
                    a.freen[a.att_na[ent]] != 0 && a.freen[a.att_nb[ent]] != 0;
    const float m = ok ? 1.0f : 0.0f;
    for (int c = 0; c < 9; ++c)
      a.katt[9 * ent + c] = -a.att_k3[9 * ent + c] * m;
  }
}

// ---------------------------------------------------------------------------
// the factorization
// ---------------------------------------------------------------------------

// B[s] = K[slot s-1, slot s]: the element coupling plus the fill coupling
// an earlier level left (transposed when flipped)
__device__ __forceinline__ void left_coupling(const TreeArgs& a, long long s,
                                              float B[9]) {
  for (int c = 0; c < 9; ++c) B[c] = a.bel[c * a.S + s];
  const int code = a.left_fill[s];
  if (code >= 0) {
    const float* f = a.fill + 9 * (long long)(code >> 1);
    float ft[9];
    if (code & 1) {
      pcr::transpose9(f, ft);
    } else {
      for (int c = 0; c < 9; ++c) ft[c] = f[c];
    }
    for (int c = 0; c < 9; ++c) B[c] = B[c] + ft[c];
  }
}

// The state of the slots sb + i, i = i0, i0 + di, ... < cnt, of level l at
// index i of the 45 planes `cur` (stride st)
__device__ void factor_init(const TreeArgs& a, const Level& l, float* cur,
                            long long st, long long sb, long long cnt,
                            long long i0, long long di) {
  const long long lend = l.s0 + l.len;
  for (long long i = i0; i < cnt; i += di) {
    const long long s = sb + i;
    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = a.att_ptr[s]; e < a.att_ptr[s + 1]; ++e) {
      const float* g = a.dg + 9 * (long long)a.att_ent[e];
      for (int c = 0; c < 9; ++c) acc[c] = acc[c] + g[c];
    }
    float B[9], Bn[9], Bt[9];
    left_coupling(a, s, B);
    pcr::transpose9(B, Bt);
    if (s + 1 < lend) {
      left_coupling(a, s + 1, Bn);
    } else {
      for (int c = 0; c < 9; ++c) Bn[c] = 0.0f;
    }
    for (int c = 0; c < 9; ++c) {
      cur[c * st + i] = a.d9[c * a.S + s] + acc[c];
      cur[(9 + c) * st + i] = Bt[c];
      cur[(18 + c) * st + i] = Bn[c];
    }
    const bool isf = a.first_path[s] >= 0, isl = a.last_path[s] >= 0;
    for (int q = 0; q < 3; ++q)
      for (int j = 0; j < 6; ++j) {
        const bool one = j < 3 ? (isf && q == j) : (isl && q == j - 3);
        cur[(27 + 6 * q + j) * st + i] = one ? 1.0f : 0.0f;
      }
  }
}

// the attachment coupling of entry 2·path + side: the element coupling plus
// the fill coupling of the producing path, transposed when flipped
__device__ __forceinline__ void attachment(const TreeArgs& a, long long ent,
                                           float o[9]) {
  float m[9];
  const float* k = a.katt + 9 * ent;
  const int fp = a.att_fill[ent];
  for (int c = 0; c < 9; ++c) {
    const float f = fp >= 0 ? a.fill[9 * (long long)fp + c] : 0.0f;
    m[c] = k[c] + f;
  }
  if (a.att_flip[ent]) {
    pcr::transpose9(m, o);
  } else {
    for (int c = 0; c < 9; ++c) o[c] = m[c];
  }
}

// o = -(b · M · c^T)
__device__ __forceinline__ void schur(const float b[9], const float M[9],
                                      const float c[9], float o[9]) {
  float t[9], ct[9], u[9];
  pcr::mm9(b, M, t);
  pcr::transpose9(c, ct);
  pcr::mm9(t, ct, u);
  for (int k = 0; k < 9; ++k) o[k] = -u[k];
}

// Path p's attachment couplings, Schur corrections and fill coupling from
// the final state `cur` (stride st, len slots, the first of them slot sb)
__device__ void finish_path(const TreeArgs& a, long long p, const float* cur,
                            long long st, long long len, long long sb) {
  float d[9], xf[18], xl[18];
  pcr::final_slot(cur, st, len, a.fg[p] - sb, d, xf);
  pcr::final_slot(cur, st, len, a.lg[p] - sb, d, xl);
  float Mff[9], Mll[9], Mfl[9];
  for (int q = 0; q < 3; ++q)
    for (int j = 0; j < 3; ++j) {
      Mff[3 * q + j] = xf[6 * q + j];
      Mfl[3 * q + j] = xf[6 * q + 3 + j];
      Mll[3 * q + j] = xl[6 * q + 3 + j];
    }
  float bl[9], br[9], o[9];
  attachment(a, 2 * p, bl);
  attachment(a, 2 * p + 1, br);
  for (int c = 0; c < 9; ++c) {
    a.ab[9 * (2 * p) + c] = bl[c];
    a.ab[9 * (2 * p + 1) + c] = br[c];
  }
  schur(bl, Mff, bl, o);
  for (int c = 0; c < 9; ++c) a.dg[9 * (2 * p) + c] = o[c];
  schur(br, Mll, br, o);
  for (int c = 0; c < 9; ++c) a.dg[9 * (2 * p + 1) + c] = o[c];
  schur(bl, Mfl, br, o);
  const bool hf = a.has_fill[p] != 0;
  for (int c = 0; c < 9; ++c) a.fill[9 * p + c] = hf ? o[c] : 0.0f;
}

__device__ __forceinline__ void store_dinv(const TreeArgs& a, const float* cur,
                                           long long st, long long len,
                                           long long i, long long s) {
  float t[9], d[9];
  pcr::load9(cur, st, len, i, t);
  pcr::inv9(t, d);
  for (int c = 0; c < 9; ++c) a.dinv[c * a.S + s] = d[c];
}

// A windowed level: every window in one block's shared memory, all rounds
// there. One phase; the caller's barrier follows.
__device__ void factor_level_windowed(const TreeArgs& a, const Level& l,
                                      float* smem) {
  float* cur = smem;
  float* nxt = smem + pcr::kStatePlanes * WINDOW;
  for (int w = l.w0 + blockIdx.x; w < l.w1; w += gridDim.x) {
    const long long ws = a.win_start[w];
    const int wl = a.win_len[w];
    const long long i0 = ws - l.s0;
    __syncthreads();   // the previous window's (or phase's) readers are done
    factor_init(a, l, cur, WINDOW, ws, wl, threadIdx.x, blockDim.x);
    __syncthreads();
    const float* fin = pcr::factor_rounds_window(
        cur, nxt, WINDOW, wl, l.steps, a.al + l.coef + i0,
        a.be + l.coef + i0, l.len);
    for (int i = threadIdx.x; i < wl; i += blockDim.x) {
      store_dinv(a, fin, WINDOW, wl, i, ws + i);
      const int p = a.first_path[ws + i];
      if (p >= 0) finish_path(a, p, fin, WINDOW, wl, ws);
    }
  }
}

// ---------------------------------------------------------------------------
// the preconditioner's sweeps
// ---------------------------------------------------------------------------

// x += alpha p, r -= alpha Ap at position q; returns its part of r·r
__device__ __forceinline__ double update_pos(const TreeArgs& a, long long q,
                                             float alpha) {
  const long long n = a.n;
  double srr = 0.0;
  for (int c = 0; c < 3; ++c) {
    const long long e = c * n + q;
    a.x[e] = a.x[e] + alpha * a.p[e];
    const float rv = a.r[e] - alpha * a.ap[e];
    a.r[e] = rv;
    srr += prod(rv, rv);
  }
  return srr;
}

// The right-hand side of slot s: forward, r minus the attachment products
// of earlier levels' paths; backward, the transposed attachment couplings
// times the junctions' values at a path's first and last slot
__device__ __forceinline__ void sweep_rhs(const TreeArgs& a, long long s,
                                          bool backward, float v[3]) {
  const long long n = a.n, S = a.S;
  if (!backward) {
    for (int c = 0; c < 3; ++c) v[c] = a.r[c * n + s];
    for (int e = a.att_ptr[s]; e < a.att_ptr[s + 1]; ++e) {
      const long long ent = a.att_ent[e];
      const long long end = (ent & 1) ? a.lg[ent >> 1] : a.fg[ent >> 1];
      const float* m = a.ab + 9 * ent;
      const float y0 = a.y[end], y1 = a.y[S + end], y2 = a.y[2 * S + end];
      for (int q = 0; q < 3; ++q) {
        const float pr = m[3 * q] * y0 + m[3 * q + 1] * y1 +
                         m[3 * q + 2] * y2;
        v[q] = v[q] + (-pr);
      }
    }
  } else {
    for (int c = 0; c < 3; ++c) v[c] = 0.0f;
    const int ends[2] = {a.first_path[s], a.last_path[s]};
    for (int side = 0; side < 2; ++side) {
      if (ends[side] < 0) continue;
      const long long ent = 2 * (long long)ends[side] + side;
      const long long tgt = a.att_tgt[ent];
      float u[3] = {0.0f, 0.0f, 0.0f};
      if (tgt < S)
        for (int c = 0; c < 3; ++c) u[c] = a.z[c * n + tgt];
      const float* m = a.ab + 9 * ent;
      for (int k = 0; k < 3; ++k) {
        const float pr = m[k] * u[0] + m[3 + k] * u[1] + m[6 + k] * u[2];
        v[k] = v[k] + pr;
      }
    }
  }
}

// Slot s from its reduced right-hand side v and its block inverse d: forward
// y = d·v (the last level's y is its z: it has no attachments), backward
// z = y - d·v. Returns the slot's part of r·z where z was written. `first`:
// p = z too.
__device__ __forceinline__ double sweep_store(const TreeArgs& a, long long s,
                                              const float d[9], float v0,
                                              float v1, float v2,
                                              bool backward, bool last,
                                              bool first) {
  const long long n = a.n, S = a.S;
  double srz = 0.0;
  for (int q = 0; q < 3; ++q) {
    const float o = d[3 * q] * v0 + d[3 * q + 1] * v1 + d[3 * q + 2] * v2;
    if (!backward) a.y[q * S + s] = o;
    if (backward || last) {
      const float u = backward ? a.y[q * S + s] - o : o;
      a.z[q * n + s] = u;
      if (first) a.p[q * n + s] = u;
      srz += prod(a.r[q * n + s], u);
    }
  }
  return srz;
}

__device__ __forceinline__ void load_dinv(const TreeArgs& a, long long s,
                                          float d[9]) {
  for (int c = 0; c < 9; ++c) d[c] = a.dinv[c * a.S + s];
}

struct Sums {
  double rz, rr;
};

// One level's sweep on its path-aligned windows: the rounds run in shared
// memory on the window alone. `update`: the window's owner first applies
// the CG update to its slots (forward, first level).
__device__ void sweep_windowed(const TreeArgs& a, const Level& l, bool backward,
                               bool last, bool first, bool update,
                               float alpha, float* smem, Sums& sums) {
  float* buf0 = smem;
  float* buf1 = smem + 3 * WINDOW;
  for (int w = l.w0 + blockIdx.x; w < l.w1; w += gridDim.x) {
    const long long ws = a.win_start[w];
    const int wl = a.win_len[w];
    __syncthreads();
    for (int i = threadIdx.x; i < wl; i += blockDim.x) {
      if (update) sums.rr += update_pos(a, ws + i, alpha);
      float v[3];
      sweep_rhs(a, ws + i, backward, v);
      for (int c = 0; c < 3; ++c) buf0[c * wl + i] = v[c];
    }
    __syncthreads();
    const float* cur = pcr::apply_rounds(buf0, buf1, wl, ws - l.s0, l.len,
                                         l.steps, a.al + l.coef,
                                         a.be + l.coef, l.len);
    for (int i = threadIdx.x; i < wl; i += blockDim.x) {
      float d[9];
      load_dinv(a, ws + i, d);
      sums.rz += sweep_store(a, ws + i, d, cur[i], cur[wl + i],
                             cur[2 * wl + i], backward, last, first);
    }
  }
}

// The same on a level that keeps global rounds: chunks of CHUNK central
// slots plus a halo of 2^rounds - 1 slots on both sides
__device__ void sweep_halo(const TreeArgs& a, const Level& l, bool backward,
                           bool last, bool first, float* smem, Sums& sums) {
  const int halo = (1 << l.steps) - 1;
  const int W = CHUNK + 2 * halo;
  float* buf0 = smem;
  float* buf1 = smem + 3 * W;
  const long long nchunks = (l.len + CHUNK - 1) / CHUNK;
  for (long long ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const long long base = ch * CHUNK - halo;
    __syncthreads();
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long pos = base + w;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (pos >= 0 && pos < l.len) sweep_rhs(a, l.s0 + pos, backward, v);
      for (int c = 0; c < 3; ++c) buf0[c * W + w] = v[c];
    }
    __syncthreads();
    const float* cur = pcr::apply_rounds(buf0, buf1, W, base, l.len, l.steps,
                                         a.al + l.coef, a.be + l.coef, l.len);
    for (int w = halo + threadIdx.x; w < halo + CHUNK; w += blockDim.x) {
      const long long pos = base + w;
      if (pos >= l.len) break;
      float d[9];
      load_dinv(a, l.s0 + pos, d);
      sums.rz += sweep_store(a, l.s0 + pos, d, cur[w], cur[W + w],
                             cur[2 * W + w], backward, last, first);
    }
  }
}

// ---------------------------------------------------------------------------
// the solve
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS) tree_cg_kernel(TreeArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[WARPS + 1];
  extern __shared__ float smem[];
  const chain_op::Packed& t = a.t;
  const long long n = a.n;
  const int G = gridDim.x;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)G * THREADS;
  double* part_pap = a.part;
  double* part_rr = a.part + G;
  double* part_rz = a.part + 2 * G;
  double* part_bb = a.part + 3 * G;
  int barriers = 0;
  auto barrier = [&]() {
    grid.sync();
    ++barriers;
  };

  setup_phase(a, tid, nthr);
  barrier();

  // r = b - A x, with b = pin·uk - free·(K uk) (raw K: pinned columns kept);
  // it reads only the set-up, so it shares the first level's phase
  {
    double sbb = 0.0, srr = 0.0;
    for (long long q0 = (long long)blockIdx.x * THREADS; q0 < n;
         q0 += (long long)G * THREADS) {
      float ku[3], ax[3];
      chain_op::matvec_tile<THREADS>(a.uk, t, 0, (int)q0, smem, ku);
      chain_op::matvec_tile<THREADS>(a.x, t, 1, (int)q0, smem, ax);
      const long long q = q0 + threadIdx.x;
      if (q < n) {
        const float f = a.freem[q], pin = 1.0f - f;
        for (int c = 0; c < 3; ++c) {
          const float b = pin * a.uk[c * n + q] - f * ku[c];
          const float fb = f * b;
          sbb += prod(fb, fb);
          const float rv = b - ax[c];
          a.r[c * n + q] = rv;
          srr += prod(rv, rv);
        }
      }
    }
    put_partial(sbb, part_bb, sh);
    put_partial(srr, part_rr, sh);
  }

  // the factorization, level by level
  for (int li = 0; li < a.L; ++li) {
    const Level l = level_of(a, li);
    if (l.windowed) {
      factor_level_windowed(a, l, smem);
    } else {
      float* cur = a.state;
      float* nxt = a.state + pcr::kStatePlanes * a.smax;
      factor_init(a, l, cur, a.smax, l.s0, l.len, tid, nthr);
      barrier();
      for (int k = 0; k < l.steps; ++k) {
        float* alk = a.al + l.coef + (long long)k * 9 * l.len;
        float* bek = a.be + l.coef + (long long)k * 9 * l.len;
        for (long long i = tid; i < l.len; i += nthr)
          pcr::round_slot(cur, nxt, alk, bek, a.smax, l.len, l.len, i,
                          1LL << k);
        barrier();
        float* sw = cur;
        cur = nxt;
        nxt = sw;
      }
      for (long long i = tid; i < l.len; i += nthr)
        store_dinv(a, cur, a.smax, l.len, i, l.s0 + i);
      for (long long p = l.p0 + tid; p < l.p1; p += nthr)
        finish_path(a, p, cur, a.smax, l.len, l.s0);
    }
    barrier();
  }

  const Level l0 = level_of(a, 0);
  const bool fused = l0.windowed;   // the CG update rides the first sweep

  // z = M^-1 r: the forest solve on the slots, the identity on the positions
  // after them; leaves the per-block partial sums of r·z (and of r·r when
  // the update is fused) in their slots. Ends on a barrier.
  auto precondition = [&](bool first, bool update, float alpha) {
    Sums sums{0.0, 0.0};
    for (long long q = a.S + tid; q < n; q += nthr) {
      if (update) sums.rr += update_pos(a, q, alpha);
      for (int c = 0; c < 3; ++c) {
        const float rv = a.r[c * n + q];
        a.z[c * n + q] = rv;
        if (first) a.p[c * n + q] = rv;
        sums.rz += prod(rv, rv);
      }
    }
    if (update)   // the later levels' slots: their sweeps read the new r
      for (long long q = l0.len + tid; q < a.S; q += nthr)
        sums.rr += update_pos(a, q, alpha);
    for (int li = 0; li < a.L; ++li) {
      const Level l = level_of(a, li);
      const bool last = li == a.L - 1;
      if (l.windowed) {
        sweep_windowed(a, l, false, last, first, update && li == 0, alpha,
                       smem, sums);
      } else {
        sweep_halo(a, l, false, last, first, smem, sums);
      }
      if (update && li == 0) put_partial(sums.rr, part_rr, sh);
      if (last && li == 0) put_partial(sums.rz, part_rz, sh);
      barrier();
    }
    for (int li = a.L - 2; li >= 0; --li) {
      const Level l = level_of(a, li);
      if (l.windowed) {
        sweep_windowed(a, l, true, false, first, false, 0.0f, smem, sums);
      } else {
        sweep_halo(a, l, true, false, first, smem, sums);
      }
      if (li == 0) put_partial(sums.rz, part_rz, sh);
      barrier();
    }
  };

  precondition(true, false, 0.0f);

  const float tol2 = a.rtol * a.rtol * grid_total(part_bb, sh);
  const float tol = sqrtf(tol2);
  float rr = grid_total(part_rr, sh);
  float rz = grid_total(part_rz, sh);
  float rnorm = sqrtf(rr), best = rnorm;
  int k = 0, since = 0;
  while (k < a.max_iter && rr > tol2) {
    // the stall exit: every block holds the same rr, so all leave together
    const bool near = rnorm <= a.stall_accept * tol;
    if (since >= (near ? a.near_window : a.stall_window)) break;
    double spap = 0.0;
    for (long long q0 = (long long)blockIdx.x * THREADS; q0 < n;
         q0 += (long long)G * THREADS) {
      float o[3];
      chain_op::matvec_tile<THREADS>(a.p, t, 1, (int)q0, smem, o);
      const long long q = q0 + threadIdx.x;
      if (q < n)
        for (int c = 0; c < 3; ++c) {
          a.ap[c * n + q] = o[c];
          spap += prod(a.p[c * n + q], o[c]);
        }
    }
    put_partial(spap, part_pap, sh);
    barrier();

    const float pap = grid_total(part_pap, sh);
    const float alpha = pap > 0.0f ? rz / pap : 0.0f;
    if (!fused) {
      double srr = 0.0;
      for (long long q = tid; q < n; q += nthr) srr += update_pos(a, q, alpha);
      put_partial(srr, part_rr, sh);
      barrier();
    }
    precondition(false, fused, alpha);

    const float rz_new = grid_total(part_rz, sh);
    rr = grid_total(part_rr, sh);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
    for (long long e = tid; e < 3 * n; e += nthr)
      a.p[e] = a.z[e] + beta * a.p[e];
    rz = rz_new;
    ++k;
    rnorm = sqrtf(rr);
    since = rnorm < best * 0.999f ? 0 : since + 1;
    best = fminf(best, rnorm);
    barrier();
  }

  // the result in node order
  for (long long q = tid; q < n; q += nthr) {
    const long long node = a.perm[q];
    for (int c = 0; c < 3; ++c) a.xn[3 * node + c] = a.x[c * n + q];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.stats[0] = (float)k;
    a.stats[1] = rnorm;
    a.stats[2] = tol;
    a.stats[3] = (float)since;
    a.stats[4] = (float)barriers;
  }
}

// the set-up phase alone, for comparing its outputs with the plain set-up
__global__ void __launch_bounds__(THREADS) tree_cg_setup_kernel(TreeArgs a) {
  setup_phase(a, (long long)blockIdx.x * THREADS + threadIdx.x,
              (long long)gridDim.x * THREADS);
}

// `syncs` grid-wide barriers and nothing else: what one barrier costs on a
// grid of this size
__global__ void __launch_bounds__(THREADS) barrier_probe_kernel(int syncs,
                                                                int* out) {
  cg::grid_group grid = cg::this_grid();
  for (int i = 0; i < syncs; ++i) grid.sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = syncs;
}

// a window above the 48 KB a kernel gets without asking must be allowed;
// a smaller value is never set, because it would lower the limit for
// later, larger launches
cudaError_t allow_smem(long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tree_cg_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool fill_args(const void* const* ptrs, int n_ptrs, const long long* ints,
               int n_ints, TreeArgs& a) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS) return false;
  const long long n = ints[I_N], jp = ints[I_JP], S = ints[I_S],
                  P = ints[I_P];
  const long long smax = ints[I_SMAX_GLOBAL], coef = ints[I_COEF];
  if (n <= 0 || n >= (1LL << 31) || S < 0 || S > n || P < 0 ||
      ints[I_L] < 1 || ints[I_GRID] <= 0)
    return false;
  auto f = [&](int i) { return (const float*)ptrs[i]; };
  auto q = [&](int i) { return (const int*)ptrs[i]; };
  auto b = [&](int i) { return (const unsigned char*)ptrs[i]; };
  a.perm = q(P_PERM);
  a.chain_elem = q(P_CHAIN_ELEM);
  a.jump_elem = q(P_JUMP_ELEM);
  a.chain_tree = b(P_CHAIN_TREE);
  a.jump_tree = b(P_JUMP_TREE);
  a.top = b(P_TOP);
  a.bot = b(P_BOT);
  a.left_k3 = f(P_LEFT_K3);
  a.left_elem = q(P_LEFT_ELEM);
  a.att_elem = q(P_ATT_ELEM);
  a.att_na = q(P_ATT_NA);
  a.att_nb = q(P_ATT_NB);
  a.att_k3 = f(P_ATT_K3);
  a.lvl = (const long long*)ptrs[P_LVL];
  a.wlv = (const long long*)ptrs[P_WLV];
  a.win_start = q(P_WIN_START);
  a.win_len = q(P_WIN_LEN);
  a.left_fill = q(P_LEFT_FILL);
  a.first_path = q(P_FIRST_PATH);
  a.last_path = q(P_LAST_PATH);
  a.fg = q(P_FG);
  a.lg = q(P_LG);
  a.has_fill = q(P_HAS_FILL);
  a.att_tgt = q(P_ATT_TGT);
  a.att_fill = q(P_ATT_FILL);
  a.att_flip = q(P_ATT_FLIP);
  a.att_ptr = q(P_ATT_PTR);
  a.att_ent = q(P_ATT_ENT);
  // the order of kernels/tree_cg.py::work_layout
  float* w = (float*)ptrs[P_WORK];
  a.uk = w;
  a.x = w + 3 * n;
  a.r = w + 6 * n;
  a.z = w + 9 * n;
  a.p = w + 12 * n;
  a.ap = w + 15 * n;
  w += 18 * n;
  a.freem = w;
  a.cact = w + n;
  a.jact = w + 2 * n;
  w += 2 * n + jp;
  a.d9 = w;
  a.bel = w + 9 * S;
  a.y = w + 18 * S;
  a.dinv = w + 21 * S;
  w += 30 * S;
  a.katt = w;
  a.ab = w + 18 * P;
  a.dg = w + 36 * P;
  a.fill = w + 54 * P;
  w += 63 * P;
  a.state = w;
  w += 2 * pcr::kStatePlanes * smax;
  a.al = w;
  a.be = w + coef;
  a.part = (double*)ptrs[P_PART];
  a.t = chain_op::Packed{a.freem, a.cact, a.jact,
                         (const float4*)ptrs[P_CPACK], f(P_CKBD),
                         (const float4*)ptrs[P_JPACK], f(P_JKBD), q(P_JA),
                         q(P_JB), q(P_JPTR), q(P_JENT), (int)n, 0.0f};
  a.S = S;
  a.P = P;
  a.smax = smax;
  a.n = (int)n;
  a.jp = (int)jp;
  a.E = (int)ints[I_E];
  a.L = (int)ints[I_L];
  a.stall_window = (int)ints[I_STALL_WINDOW];
  a.near_window = (int)ints[I_NEAR_WINDOW];
  return true;
}

}  // namespace

// Blocks per SM of the cooperative kernel for `smem` bytes of dynamic
// shared memory a block (*per_sm) and the card's SMs (*sms): all of
// sms·per_sm blocks are co-resident, as grid-wide synchronisation needs.
// Fails on a card without cooperative launch or with less shared memory
// than asked.
extern "C" int tree_cg_grid_blocks(int smem, int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, tree_cg_kernel,
                                                    THREADS, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  return 0;
}

// One solve. ptrs and ints in the order of the enums above (the model's
// static tables, the work buffer in the layout of fill_args and 4·grid
// doubles of partial sums); the rest is the solve's own: the active mask
// by element (bytes), the free mask by node (bytes), the start vector and
// the result (N, 3) by node, stats (5 floats), the grips' displacements,
// the tolerance, the operator's and the preconditioner's regularisation,
// the stall exit's acceptance factor.
extern "C" int tree_cg_f32(const void* const* ptrs, int n_ptrs,
                           const long long* ints, int n_ints,
                           const void* active, const void* freen,
                           const float* x0, float* x, float* stats,
                           float dy_top, float dy_bot, float rtol, float reg,
                           float reg_pc, float stall_accept, int max_iter,
                           cudaStream_t stream) {
  TreeArgs a;
  if (!fill_args(ptrs, n_ptrs, ints, n_ints, a))
    return (int)cudaErrorInvalidValue;
  a.active = (const unsigned char*)active;
  a.freen = (const unsigned char*)freen;
  a.x0n = x0;
  a.xn = x;
  a.stats = stats;
  a.dy_top = dy_top;
  a.dy_bot = dy_bot;
  a.rtol = rtol;
  a.t.reg = reg;
  a.reg_pc = reg_pc;
  a.stall_accept = stall_accept;
  a.max_iter = max_iter;
  void* args[] = {&a};
  cudaError_t e = allow_smem(ints[I_SMEM]);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel(
      (const void*)tree_cg_kernel, dim3((unsigned)ints[I_GRID]),
      dim3(THREADS), args, (size_t)ints[I_SMEM], stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The set-up phase alone into the work buffer (uk, x, freem, cact, jact,
// d9, bel, katt): the same device function the solve runs first.
extern "C" int tree_cg_setup_f32(const void* const* ptrs, int n_ptrs,
                                 const long long* ints, int n_ints,
                                 const void* active, const void* freen,
                                 const float* x0, float dy_top, float dy_bot,
                                 float reg_pc, cudaStream_t stream) {
  TreeArgs a;
  if (!fill_args(ptrs, n_ptrs, ints, n_ints, a))
    return (int)cudaErrorInvalidValue;
  a.active = (const unsigned char*)active;
  a.freen = (const unsigned char*)freen;
  a.x0n = x0;
  a.xn = nullptr;
  a.stats = nullptr;
  a.dy_top = dy_top;
  a.dy_bot = dy_bot;
  a.rtol = 0.0f;
  a.reg_pc = reg_pc;
  a.stall_accept = 0.0f;
  a.max_iter = 0;
  const unsigned blocks = (unsigned)((a.n + THREADS - 1) / THREADS);
  tree_cg_setup_kernel<<<blocks, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// `syncs` grid-wide barriers on a cooperative grid of `grid` blocks of the
// solve's block size, no work between them; out: one int on the device.
extern "C" int tree_cg_barrier_probe(int grid, int syncs, int* out,
                                     cudaStream_t stream) {
  void* args[] = {&syncs, &out};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)barrier_probe_kernel, dim3((unsigned)grid), dim3(THREADS),
      args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
