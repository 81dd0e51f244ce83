// K5: the whole cg + coarse solve in one launch, its set-up included.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_cg.py::_cg_kernel (B5)
// and the set-up the reference runs around it in XLA (pallas_cg.py:607-697):
// B1's operator, the 3x3 block-Jacobi preconditioner plus an additive
// coarse correction over clusters of `width` consecutive chain positions
// (the dense inverse of the cluster Galerkin matrix, const or linear
// basis), b = pin·uk - free·(K uk), x0 = free·x0 + pin·uk, stop on
// r·r <= rtol²·|free·b|²; no atol, no stall exit, no restarts. It does not
// copy B5's (3·NB, 128) plane layout, its rolls or its one-hot MXU
// selections: vectors are the port's (3, N) chain-ordered component planes.
//
// What bounds it on the card: neither bytes nor operations but latency.
// One CG iteration moves ~2 MB at 22k DOF (the operator's tables, the
// vectors, the block inverses and the nc x nc coarse inverse), which the
// 50 MB L2 holds, and ~370 dependent iterations each need three global
// dots. So the floor is iterations x barriers x ~1.1 us, and the design
// keeps the barriers to the three dots and gives every phase between them
// a whole block:
//
//   set-up (one thread a position, a jump or a coarse-matrix entry): the
//     masks, the prescribed values and the start vector in chain order;
//     the per-position diagonal block (chain_op::diag_block, K6's code, with
//     every active element and reg) and its scale-stabilised adjugate
//     inverse (fea/model.py::invert_blocks); each entry of the coarse
//     Galerkin matrix summed in float64 from the model's contribution list
//     (fea/coarse.py::CoarsePlan: per pair of clusters, every chain edge,
//     jump edge and reg diagonal feeding it, in one fixed order) and
//     rounded once;
//   normalisation and r0: the matrix scaled to unit diagonal with the 1e-5
//     shift (fea/coarse.py::coarse_normalize); r0 = b - A x per cluster with
//     the cluster's restricted residual;
//   the dense inverse: Gauss-Jordan elimination without pivoting (the
//     normalised matrix is symmetric positive definite), two pivots a phase
//     (the first pivot's entries that the second reads recomputed where
//     they are needed), ping-pong buffers (fea/coarse.py::gauss_jordan);
//   CG, one block a cluster (a block loops over its clusters when there are
//     more clusters than resident blocks), three grid.sync() an iteration:
//     A. p = z + beta·p_old, formed as the operator reads it (a second p
//        buffer), ap = A p by K1's shared-memory tile body, p·ap;
//     B. x += alpha p, r -= alpha ap, r·r, and the cluster's restriction
//        sums of free·r (and ramp·free·r) over the block's 8 warps;
//     C. the cluster's 3 (const) or 6 (linear) rows of
//        s·ainv_n·(s·rc), spread over the block, then
//        z = c9·r + free·(zc + ramp·zc') and r·z.
// Dots are per-block float64 partials (grid_reduce.cuh) that every block
// sums in one order (warp_totals), so all blocks take the same decisions
// and reruns are bit-equal. Every sum adds exact float64 products and rounds once.
// No float atomics anywhere: two launches on the same inputs give the same
// bits, and the set-up equals its plain version on the CPU
// (kernels/chain_cg.py::chain_cg_setup_plain) bit for bit. Scratch comes
// from the caller; the kernel allocates nothing. Built with -fmad=false.

#include <cooperative_groups.h>

#include "chain_matvec.cuh"
#include "grid_reduce.cuh"

namespace cg = cooperative_groups;

namespace {

using grid_reduce::THREADS;
using grid_reduce::WARPS;
using grid_reduce::prod;
using grid_reduce::put_partial;

// the reference's float32 shift of the normalised coarse matrix
constexpr float COARSE_SHIFT = 1e-5f;
// a contribution's code: source·16 + kind; kinds 0-3 a chain edge, 4-7 a
// jump edge (bit 0: the row's end is b, bit 1: the column's end is b), 8 a
// reg diagonal (fea/coarse.py::build_coarse_plan)
constexpr int KIND_JUMP = 4;
constexpr int KIND_REG = 8;

// the order of the pointer and integer arguments of chain_cg_f32: the
// model's static tables and the launch's own scratch, bound once
enum Ptr {
  P_PERM, P_CHAIN_ELEM, P_JUMP_ELEM, P_CPACK, P_CKBD, P_JPACK, P_JKBD, P_JA,
  P_JB, P_JPTR, P_JENT, P_FREE_NODES, P_TOP, P_BOT,
  P_CB_PTR, P_CB_ENT, P_CB_MAP,
  P_WORK, P_PART, N_PTRS
};
enum Int { I_N, I_JP, I_E, I_NBC, I_WIDTH, I_NBAS, I_NBLK, I_GRID, N_INTS };

struct CgArgs {
  chain_op::Packed t;
  // the solve's own inputs, in the model's layout
  const unsigned char* active;     // (E)
  const unsigned char* anchored;   // (N) by node, or null: all anchored
  const float* x0n;                // (N, 3) by node
  float* xn;                       // (N, 3) by node: the result
  float* stats;                    // [iterations, |r|, tol, barriers]
  float dy_top, dy_bot, rtol, reg;
  int max_iter;
  bool setup_only;
  // static tables
  const int* perm;                 // (N) position -> node
  const int* chain_elem;           // (N) element of chain slot q, E for none
  const int* jump_elem;            // (Jp)
  const unsigned char* free_nodes; // (N) by node
  const unsigned char* top;        // (N) by node: grip masks
  const unsigned char* bot;
  const int* cb_ptr;               // (nblk + 1) contributions by block
  const int* cb_ent;               // their codes
  const int* cb_map;               // (nbc²) block of a cluster pair, -1
  // scratch (the order of kernels/chain_cg.py::work_layout)
  float* uk;                       // (3, N) each, chain order
  float* x;
  float* r;
  float* z;
  float* p0;                       // p in turns
  float* p1;
  float* ap;
  float* freem;                    // (N)
  float* cact;                     // (N)
  float* jact;                     // (Jp)
  float* c9;                       // (9, N) block-Jacobi inverse
  float* rc;                       // (nc) restricted residual
  float* ablk;                     // (nblk, e2) coarse entries by block
  float* a;                        // (nc, nc) coarse matrix
  float* s;                        // (nc) its scaling
  float* g0;                       // (nc, nc) Gauss-Jordan, in turns
  float* g1;
  double* part;                    // 4 x gridDim.x
  int n, jp, E, nbc, width, nbas, nblk, nc;
};

__device__ __forceinline__ bool elem_active(const CgArgs& a, int e) {
  return e >= 0 && e < a.E && a.active[e] != 0;
}

__device__ __forceinline__ bool node_free(const CgArgs& a, int node) {
  return a.free_nodes[node] != 0 &&
         (a.anchored == nullptr || a.anchored[node] != 0);
}

// the in-cluster ramp of position q, in [-1, 1] (fea/coarse.py::ramp_weight)
__device__ __forceinline__ float ramp_at(const CgArgs& a, int q) {
  return ((float)(q % a.width) - 0.5f * (float)(a.width - 1)) /
         (0.5f * (float)a.width);
}

// the weight of basis function f at position q: free, times the ramp for
// the linear one
__device__ __forceinline__ double basis_w(const CgArgs& a, int q, int f) {
  if (!node_free(a, a.perm[q])) return 0.0;
  return f ? (double)ramp_at(a, q) : 1.0;
}

struct AllChain {
  const CgArgs& a;
  __device__ __forceinline__ float operator()(int q) const {
    return elem_active(a, a.chain_elem[q]) ? 1.0f : 0.0f;
  }
};
struct AllJump {
  const CgArgs& a;
  __device__ __forceinline__ float operator()(int j) const {
    return elem_active(a, a.jump_elem[j]) ? 1.0f : 0.0f;
  }
};

// the scale-stabilised adjugate inverse of fea/model.py::invert_blocks
__device__ __forceinline__ void inv9_scaled(const float m[9], float o[9]) {
  float scale = 0.0f;
  for (int c = 0; c < 9; ++c) scale = fmaxf(scale, fabsf(m[c]));
  scale = fmaxf(scale, 1e-30f);
  float b[9];
  for (int c = 0; c < 9; ++c) b[c] = m[c] / scale;
  const float a00 = b[0], a01 = b[1], a02 = b[2];
  const float a10 = b[3], a11 = b[4], a12 = b[5];
  const float a20 = b[6], a21 = b[7], a22 = b[8];
  const float c[9] = {a11 * a22 - a12 * a21, a02 * a21 - a01 * a22,
                      a01 * a12 - a02 * a11, a12 * a20 - a10 * a22,
                      a00 * a22 - a02 * a20, a02 * a10 - a00 * a12,
                      a10 * a21 - a11 * a20, a01 * a20 - a00 * a21,
                      a00 * a11 - a01 * a10};
  const float det = a00 * c[0] + a01 * c[3] + a02 * c[6];
  const float den = det * scale;
  for (int k = 0; k < 9; ++k) o[k] = c[k] / den;
}

// One coarse entry: block `blk`, row (fa, kc), column (fb, kc2); its
// contributions in list order, each an exact float64 product chain
__device__ float coarse_entry(const CgArgs& a, int blk, int fa, int kc,
                              int fb, int kc2) {
  double acc = 0.0;
  const double reg = (double)a.reg;
  for (int e = a.cb_ptr[blk]; e < a.cb_ptr[blk + 1]; ++e) {
    const int code = a.cb_ent[e];
    const int src = code >> 4, kind = code & 15;
    int pr, pc;
    double v;
    if (kind == KIND_REG) {
      pr = pc = src;
      v = kc == kc2 ? reg : 0.0;
    } else {
      const bool jump = kind >= KIND_JUMP;
      int ea, eb;
      float4 nk;
      float kbd, m;
      if (jump) {
        ea = a.t.ja[src];
        eb = a.t.jb[src];
        nk = a.t.jpack[src];
        kbd = a.t.jkbd[src];
        m = elem_active(a, a.jump_elem[src]) ? 1.0f : 0.0f;
      } else {
        ea = src;
        eb = src + 1;
        nk = a.t.cpack[src];
        kbd = a.t.ckbd[src];
        m = elem_active(a, a.chain_elem[src]) ? 1.0f : 0.0f;
      }
      const bool rb = kind & 1, cbe = (kind >> 1) & 1;
      pr = rb ? eb : ea;
      pc = cbe ? eb : ea;
      const double nn[3] = {(double)nk.x, (double)nk.y, (double)nk.z};
      double k3 = nn[kc] * nn[kc2];
      k3 = k3 * ((double)nk.w - (double)kbd);
      if (kc == kc2) k3 = k3 + (double)kbd;
      k3 = k3 * (double)m;
      v = rb == cbe ? k3 : -k3;
    }
    double w = basis_w(a, pr, fa) * basis_w(a, pc, fb);
    acc = acc + w * v;
  }
  return (float)acc;
}

// coarse index i -> (basis, component, cluster)
__device__ __forceinline__ void coarse_split(const CgArgs& a, int i, int& f,
                                             int& k, int& cl) {
  f = i / (3 * a.nbc);
  k = (i / a.nbc) % 3;
  cl = i % a.nbc;
}

// the entry (i, j) of the coarse matrix from the block entries
__device__ __forceinline__ float coarse_at(const CgArgs& a, int i, int j) {
  int fa, kc, ra, fb, kc2, cb;
  coarse_split(a, i, fa, kc, ra);
  coarse_split(a, j, fb, kc2, cb);
  const int blk = a.cb_map[ra * a.nbc + cb];
  if (blk < 0) return 0.0f;
  const int d = 3 * a.nbas;
  return a.ablk[(long long)blk * d * d + (3 * fa + kc) * d + 3 * fb + kc2];
}

// ---------------------------------------------------------------------------
// the set-up
// ---------------------------------------------------------------------------

__device__ void setup_phase(const CgArgs& a, long long tid, long long nthr) {
  const int n = a.n;
  for (long long qq = tid; qq < n; qq += nthr) {
    const int q = (int)qq;
    const int node = a.perm[q];
    const bool fr = node_free(a, node);
    const float f = fr ? 1.0f : 0.0f;
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
    float d[9], inv[9];
    chain_op::diag_block(a.t, q, fr, a.reg, AllChain{a}, AllJump{a}, d);
    inv9_scaled(d, inv);
    for (int c = 0; c < 9; ++c) a.c9[(long long)c * n + q] = inv[c];
  }
  for (long long j = tid; j < a.jp; j += nthr)
    a.jact[j] = elem_active(a, a.jump_elem[j]) ? 1.0f : 0.0f;
  const int d = 3 * a.nbas;
  const long long entries = (long long)a.nblk * d * d;
  for (long long e = tid; e < entries; e += nthr) {
    const int blk = (int)(e / (d * d)), inner = (int)(e % (d * d));
    const int row = inner / d, col = inner % d;
    a.ablk[e] = coarse_entry(a, blk, row / 3, row % 3, col / 3, col % 3);
  }
}

// The coarse matrix, its scaling s = 1/sqrt(diag) (1 where the diagonal is
// not positive) and the normalised matrix s·a·s + 1e-5·I (+ 1 on a row
// with no stiffness) into the first Gauss-Jordan buffer
__device__ void normalize_phase(const CgArgs& a, long long tid,
                                long long nthr) {
  const long long nc = a.nc;
  for (long long e = tid; e < nc * nc; e += nthr) {
    const int i = (int)(e / nc), j = (int)(e % nc);
    const float v = coarse_at(a, i, j);
    a.a[e] = v;
    const float di = coarse_at(a, i, i), dj = coarse_at(a, j, j);
    const float si = di > 0.0f ? 1.0f / sqrtf(fmaxf(di, 1e-30f)) : 1.0f;
    const float sj = dj > 0.0f ? 1.0f / sqrtf(fmaxf(dj, 1e-30f)) : 1.0f;
    if (i == j) a.s[i] = si;
    float an = si * v;
    an = an * sj;
    an = an + (i == j ? COARSE_SHIFT : 0.0f);
    an = an + ((i == j && !(di > 0.0f)) ? 1.0f : 0.0f);
    a.g0[e] = an;
  }
}

// One Gauss-Jordan pivot k's value of entry (i, j) from the entries before
// it: mij, mik (column k), mkj (row k) and p = 1/m_kk; ik: i == k, jk:
// j == k. Row k is scaled by p, every other row loses m_ik·(m_kj·p), and
// column k becomes -m_ik·p (fea/coarse.py::gauss_jordan).
__device__ __forceinline__ float gj_entry(float mij, float mik, float mkj,
                                          float p, bool ik, bool jk) {
  if (ik) return jk ? p : mkj * p;
  return jk ? -(mik * p) : mij - mik * (mkj * p);
}

// Pivots k and k + 1 (k alone when `two` is false) of the Gauss-Jordan
// inversion, from `cur` into `nxt`: the entries after pivot k that pivot
// k + 1 reads are recomputed from `cur` where they are needed, with the
// same operations, so the result is the two pivots' one after the other,
// bit for bit, with one barrier for both. A work item is a column and a
// group of rows; a chunk of rows is loaded before any of it is stored (the
// buffers are not restrict-qualified, so a store would otherwise hold back
// the next row's loads).
constexpr int GJ_ROWS = 4;
__device__ void gauss_jordan_step(const CgArgs& a, const float* cur,
                                  float* nxt, int k, bool two, long long tid,
                                  long long nthr) {
  const long long nc = a.nc;
  const int k2 = two ? k + 1 : k;
  const long long groups = nthr > nc ? nthr / nc : 1;
  const float p1 = 1.0f / cur[(long long)k * nc + k];
  const float mk_k2 = cur[(long long)k * nc + k2];
  const float p2 = 1.0f / gj_entry(cur[(long long)k2 * nc + k2],
                                   cur[(long long)k2 * nc + k], mk_k2, p1,
                                   false, false);
  for (long long w = tid; w < groups * nc; w += nthr) {
    const long long j = w % nc, g = w / nc;
    const float mkj = cur[(long long)k * nc + j];
    const float a_k2j = gj_entry(cur[(long long)k2 * nc + j],
                                 cur[(long long)k2 * nc + k], mkj, p1, false,
                                 j == k);
    for (long long i0 = g; i0 < nc; i0 += GJ_ROWS * groups) {
      float mij[GJ_ROWS], mik[GJ_ROWS], mik2[GJ_ROWS];
#pragma unroll
      for (int u = 0; u < GJ_ROWS; ++u) {
        const long long i = i0 + u * groups;
        const bool in = i < nc;
        mij[u] = in ? cur[i * nc + j] : 0.0f;
        mik[u] = in ? cur[i * nc + k] : 0.0f;
        mik2[u] = in && two ? cur[i * nc + k2] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < GJ_ROWS; ++u) {
        const long long i = i0 + u * groups;
        if (i >= nc) break;
        float v = gj_entry(mij[u], mik[u], mkj, p1, i == k, j == k);
        if (two) {
          const float a_ik2 = gj_entry(mik2[u], mik[u], mk_k2, p1, i == k,
                                       false);
          v = gj_entry(v, a_ik2, a_k2j, p2, i == k2, j == k2);
        }
        nxt[i * nc + j] = v;
      }
    }
  }
}

// The totals of K slot arrays (slots + k·gridDim.x) for every thread of
// the block: warp 0 adds the slots, lane by lane in a fixed stride and then
// down its shuffle tree, and shares them through one block barrier. Every
// block adds in the same order, so all hold the same bits.
template <int K>
__device__ __forceinline__ void warp_totals(const double* slots, double* sh,
                                            float out[K]) {
  if (threadIdx.x < 32) {
    for (int k = 0; k < K; ++k) {
      double v = 0.0;
      for (int i = threadIdx.x; i < (int)gridDim.x; i += 32)
        v += slots[k * gridDim.x + i];
      v = grid_reduce::warp_sum0(v);
      if (threadIdx.x == 0) sh[k] = v;
    }
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) out[k] = (float)sh[k];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// the solve's phases, one block a cluster
// ---------------------------------------------------------------------------

// the direction p = z + beta·p_old as the operator reads it (z itself on
// the first iteration)
struct Direction {
  const float* z;
  const float* pold;
  float beta;
  bool first;
  int n;
  __device__ __forceinline__ float operator()(int c, int q) const {
    const long long e = (long long)c * n + q;
    return first ? z[e] : z[e] + beta * pold[e];
  }
};

// values a cluster's restriction pass reduces over the block at once: two
// dot products, the sums of free·r (3) and, with the linear basis, of
// ramp·free·r (3)
constexpr int RESTRICT_SUMS = 8;

// a position's terms of the restriction sums (free·r and ramp·free·r),
// each an exact float64
__device__ __forceinline__ void restrict_terms(const CgArgs& a, int q,
                                               float f, const float r[3],
                                               double v[RESTRICT_SUMS]) {
  const float ramp = ramp_at(a, q);
  for (int c = 0; c < 3; ++c) {
    const float rf = r[c] * f;
    v[2 + c] += (double)rf;
    v[5 + c] += (double)(rf * ramp);
  }
}

// The block's totals of the thread's two dot terms (v[0], v[1]) and its
// restriction terms, each added in one order (only the basis's); the
// cluster's sums into rc
__device__ void restrict_cluster(const CgArgs& a, int cl,
                                 double v[RESTRICT_SUMS], double* sh) {
  if (a.nbas == 2) {
    grid_reduce::block_sums<8>(v, sh);
  } else {
    grid_reduce::block_sums<5>(v, sh);
  }
  if (threadIdx.x == 0)
    for (int c = 0; c < 3 * a.nbas; ++c)
      a.rc[(c / 3) * 3 * a.nbc + (c % 3) * a.nbc + cl] = (float)v[2 + c];
}

// r0 = b - A x with b = pin·uk - free·(K uk) (raw K: pinned columns kept)
// on cluster cl, and its restriction; adds the cluster's |free·b|² and r·r
// to bb and rr (the block's totals)
__device__ void residual_cluster(const CgArgs& a, int cl, float* sm,
                                 double* sh, double& bb, double& rr) {
  const int n = a.n;
  const int base = cl * a.width, end = min(base + a.width, n);
  double v[RESTRICT_SUMS] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int q0 = base; q0 < end; q0 += THREADS) {
    float ku[3], ax[3];
    chain_op::matvec_tile<THREADS>(a.uk, a.t, 0, q0, sm, ku);
    chain_op::matvec_tile<THREADS>(a.x, a.t, 1, q0, sm, ax);
    const int q = q0 + threadIdx.x;
    if (q < end) {
      const float f = a.freem[q], pin = 1.0f - f;
      float r[3];
      for (int c = 0; c < 3; ++c) {
        const float b = pin * a.uk[(long long)c * n + q] - f * ku[c];
        const float fb = f * b;
        v[0] += prod(fb, fb);
        r[c] = b - ax[c];
        a.r[(long long)c * n + q] = r[c];
        v[1] += prod(r[c], r[c]);
      }
      restrict_terms(a, q, f, r, v);
    }
  }
  restrict_cluster(a, cl, v, sh);
  bb += v[0];
  rr += v[1];
}

// phase A on cluster cl: p_new = z + beta·p_old, ap = A p_new; adds the
// thread's p·ap terms to spap
__device__ void operator_cluster(const CgArgs& a, int cl, const Direction& u,
                                 float* pnew, float* sm, double& spap) {
  const int n = a.n;
  const int base = cl * a.width, end = min(base + a.width, n);
  for (int q0 = base; q0 < end; q0 += THREADS) {
    float o[3];
    chain_op::matvec_tile_u<THREADS>(u, a.t, 1, q0, sm, o);
    const int q = q0 + threadIdx.x;
    if (q < end) {
      float pv[3];
      for (int c = 0; c < 3; ++c) pv[c] = u(c, q);
      for (int c = 0; c < 3; ++c) {
        const long long e = (long long)c * n + q;
        pnew[e] = pv[c];
        a.ap[e] = o[c];
        spap += prod(pv[c], o[c]);
      }
    }
  }
}

// phase B on cluster cl: x += alpha p, r -= alpha ap, and the restriction
// of the new r; adds the cluster's r·r to rr (the block's total)
__device__ void update_cluster(const CgArgs& a, int cl, const float* p,
                               float alpha, double* sh, double& rr) {
  const int n = a.n;
  const int base = cl * a.width, end = min(base + a.width, n);
  double v[RESTRICT_SUMS] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int q = base + threadIdx.x; q < end; q += THREADS) {
    float xv[3], pv[3], rv[3], av[3];
    const float f = a.freem[q];
    for (int c = 0; c < 3; ++c) {
      const long long e = (long long)c * n + q;
      xv[c] = a.x[e];
      pv[c] = p[e];
      rv[c] = a.r[e];
      av[c] = a.ap[e];
    }
    for (int c = 0; c < 3; ++c) {
      const long long e = (long long)c * n + q;
      a.x[e] = xv[c] + alpha * pv[c];
      rv[c] = rv[c] - alpha * av[c];
      a.r[e] = rv[c];
      v[0] += prod(rv[c], rv[c]);
    }
    restrict_terms(a, q, f, rv, v);
  }
  restrict_cluster(a, cl, v, sh);
  rr += v[0];
}

// z = c9·r + free·(zc + ramp·zc') at position q, from its loaded r, c9
// and free; returns its r·z terms
__device__ __forceinline__ double precond_pos(const CgArgs& a, int q,
                                              const float rv[3],
                                              const float m[9], float f,
                                              const float zc[6]) {
  const int n = a.n;
  const float ramp = ramp_at(a, q);
  double srz = 0.0;
  for (int c = 0; c < 3; ++c) {
    const float zb = m[3 * c] * rv[0] + m[3 * c + 1] * rv[1] +
                     m[3 * c + 2] * rv[2];
    float cc = zc[c];
    if (a.nbas == 2) cc = cc + zc[3 + c] * ramp;
    cc = cc * f;
    const float zv = zb + cc;
    a.z[(long long)c * n + q] = zv;
    srz += prod(rv[c], zv);
  }
  return srz;
}

__device__ __forceinline__ void load_pos(const CgArgs& a, int q, float rv[3],
                                         float m[9], float& f) {
  const int n = a.n;
  for (int c = 0; c < 3; ++c) rv[c] = a.r[(long long)c * n + q];
  for (int c = 0; c < 9; ++c) m[c] = a.c9[(long long)c * n + q];
  f = a.freem[q];
}

// phase C on cluster cl: the cluster's rows of zc = s·ainv_n·(s·rc) over
// the block, then z = c9·r + free·(zc + ramp·zc'); adds the thread's r·z
// terms to srz. The thread's first position is loaded with the rows.
__device__ void precond_cluster(const CgArgs& a, int cl, const float* ainv,
                                double* sh, double& srz) {
  const int n = a.n, nc = a.nc, nbc = a.nbc;
  const int rows = 3 * a.nbas;
  const int base = cl * a.width, end = min(base + a.width, n);
  const int q1 = base + threadIdx.x;
  float rv[3], m[9], f = 0.0f;
  if (q1 < end) load_pos(a, q1, rv, m, f);
  double acc[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
  for (int j = threadIdx.x; j < nc; j += THREADS) {
    const float t = a.s[j] * a.rc[j];
    for (int r = 0; r < rows; ++r) {
      const int i = (r / 3) * 3 * nbc + (r % 3) * nbc + cl;
      acc[r] += prod(ainv[(long long)i * nc + j], t);
    }
  }
  if (rows == 6) {
    grid_reduce::block_sums<6>(acc, sh);
  } else {
    grid_reduce::block_sums<3>(acc, sh);
  }
  float zc[6];
  for (int r = 0; r < rows; ++r) {
    const int i = (r / 3) * 3 * nbc + (r % 3) * nbc + cl;
    zc[r] = a.s[i] * (float)acc[r];
  }
  if (q1 < end) srz += precond_pos(a, q1, rv, m, f, zc);
  for (int q = q1 + THREADS; q < end; q += THREADS) {
    load_pos(a, q, rv, m, f);
    srz += precond_pos(a, q, rv, m, f, zc);
  }
}

__global__ void __launch_bounds__(THREADS) chain_cg_kernel(CgArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[RESTRICT_SUMS * (WARPS + 1)];
  __shared__ float sm[chain_op::Tile<THREADS>::floats];
  const int n = a.n;
  const int G = gridDim.x;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)G * THREADS;
  // per-block partial sums; rz, rr and bb adjacent for warp_totals
  double* part_pap = a.part;
  double* part_rz = a.part + G;
  double* part_rr = a.part + 2 * G;
  double* part_bb = a.part + 3 * G;
  int barriers = 0;
  auto barrier = [&]() {
    grid.sync();
    ++barriers;
  };
  auto put_block = [&](double v, double* slots) {
    if (threadIdx.x == 0) slots[blockIdx.x] = v;
  };

  setup_phase(a, tid, nthr);
  barrier();

  // the normalised coarse matrix; r0 and its restriction per cluster
  normalize_phase(a, tid, nthr);
  {
    double bb = 0.0, rr = 0.0;
    for (int cl = blockIdx.x; cl < a.nbc; cl += G)
      residual_cluster(a, cl, sm, sh, bb, rr);
    put_block(bb, part_bb);
    put_block(rr, part_rr);
  }
  barrier();

  // the coarse inverse, two pivots a phase
  int phases = 0;
  for (int k = 0; k < a.nc; k += 2, ++phases) {
    gauss_jordan_step(a, (phases & 1) ? a.g1 : a.g0,
                      (phases & 1) ? a.g0 : a.g1, k, k + 1 < a.nc, tid, nthr);
    barrier();
  }
  const float* ainv = (phases & 1) ? a.g1 : a.g0;
  if (a.setup_only) {
    if (blockIdx.x == 0 && threadIdx.x == 0) a.stats[3] = (float)barriers;
    return;
  }

  {
    double srz = 0.0;
    for (int cl = blockIdx.x; cl < a.nbc; cl += G)
      precond_cluster(a, cl, ainv, sh, srz);
    put_partial(srz, part_rz, sh);
  }
  barrier();

  float tot[3];
  warp_totals<3>(part_rz, sh, tot);   // rz, rr, bb
  float rz = tot[0], rr = tot[1];
  const float tol2 = a.rtol * a.rtol * tot[2];
  float beta = 0.0f;
  float* pold = a.p0;
  float* pnew = a.p1;
  int k = 0;
  while (k < a.max_iter && rr > tol2) {
    // A: the direction and the operator
    const Direction u{a.z, pold, beta, k == 0, n};
    double spap = 0.0;
    for (int cl = blockIdx.x; cl < a.nbc; cl += G)
      operator_cluster(a, cl, u, pnew, sm, spap);
    put_partial(spap, part_pap, sh);
    barrier();

    // B: the update and the restriction
    float pap;
    warp_totals<1>(part_pap, sh, &pap);
    const float alpha = pap > 0.0f ? rz / pap : 0.0f;
    double brr = 0.0;
    for (int cl = blockIdx.x; cl < a.nbc; cl += G)
      update_cluster(a, cl, pnew, alpha, sh, brr);
    put_block(brr, part_rr);
    barrier();

    // C: the preconditioner
    double srz = 0.0;
    for (int cl = blockIdx.x; cl < a.nbc; cl += G)
      precond_cluster(a, cl, ainv, sh, srz);
    put_partial(srz, part_rz, sh);
    barrier();

    float t2[2];
    warp_totals<2>(part_rz, sh, t2);   // rz, rr
    rr = t2[1];
    beta = rz > 0.0f ? t2[0] / rz : 0.0f;
    rz = t2[0];
    float* sw = pold;
    pold = pnew;
    pnew = sw;
    ++k;
  }

  // the result in node order
  for (long long q = tid; q < n; q += nthr) {
    const long long node = a.perm[q];
    for (int c = 0; c < 3; ++c) a.xn[3 * node + c] = a.x[(long long)c * n + q];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.stats[0] = (float)k;
    a.stats[1] = sqrtf(rr);
    a.stats[2] = sqrtf(tol2);
    a.stats[3] = (float)barriers;
  }
}

bool fill_args(const void* const* ptrs, int n_ptrs, const long long* ints,
               int n_ints, CgArgs& a) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS) return false;
  const long long n = ints[I_N], jp = ints[I_JP], nbc = ints[I_NBC],
                  width = ints[I_WIDTH], nbas = ints[I_NBAS],
                  nblk = ints[I_NBLK];
  const long long nc = 3 * nbas * nbc;
  if (n <= 0 || n >= (1LL << 31) || nbc <= 0 || width <= 0 ||
      nbc * width < n || (nbas != 1 && nbas != 2) || nblk <= 0 ||
      nc * nc >= (1LL << 31) || ints[I_GRID] <= 0)
    return false;
  auto f = [&](int i) { return (const float*)ptrs[i]; };
  auto q = [&](int i) { return (const int*)ptrs[i]; };
  auto b = [&](int i) { return (const unsigned char*)ptrs[i]; };
  a.perm = q(P_PERM);
  a.chain_elem = q(P_CHAIN_ELEM);
  a.jump_elem = q(P_JUMP_ELEM);
  a.free_nodes = b(P_FREE_NODES);
  a.top = b(P_TOP);
  a.bot = b(P_BOT);
  a.cb_ptr = q(P_CB_PTR);
  a.cb_ent = q(P_CB_ENT);
  a.cb_map = q(P_CB_MAP);
  // the order of kernels/chain_cg.py::work_layout
  float* w = (float*)ptrs[P_WORK];
  a.uk = w;
  a.x = w + 3 * n;
  a.r = w + 6 * n;
  a.z = w + 9 * n;
  a.p0 = w + 12 * n;
  a.p1 = w + 15 * n;
  a.ap = w + 18 * n;
  w += 21 * n;
  a.freem = w;
  a.cact = w + n;
  a.jact = w + 2 * n;
  w += 2 * n + jp;
  a.c9 = w;
  w += 9 * n;
  a.rc = w;
  w += nc;
  a.ablk = w;
  w += nblk * 9 * nbas * nbas;
  a.a = w;
  w += nc * nc;
  a.s = w;
  w += nc;
  a.g0 = w;
  a.g1 = w + nc * nc;
  a.part = (double*)ptrs[P_PART];
  a.t = chain_op::Packed{a.freem, a.cact, a.jact,
                         (const float4*)ptrs[P_CPACK], f(P_CKBD),
                         (const float4*)ptrs[P_JPACK], f(P_JKBD), q(P_JA),
                         q(P_JB), q(P_JPTR), q(P_JENT), (int)n, 0.0f};
  a.n = (int)n;
  a.jp = (int)jp;
  a.E = (int)ints[I_E];
  a.nbc = (int)nbc;
  a.width = (int)width;
  a.nbas = (int)nbas;
  a.nblk = (int)nblk;
  a.nc = (int)nc;
  return true;
}

}  // namespace

// Blocks of the cooperative grid that fit the card at once (*per_sm a
// multiprocessor, *sms of them): the launch never asks for more. Fails on a
// card without cooperative launch.
extern "C" int chain_cg_grid_blocks(int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, chain_cg_kernel,
                                                    THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  return 0;
}

// One solve, or with setup_only the set-up alone (the work buffer then
// holds it; stats[3] the barriers). ptrs and ints in the order of the enums
// above (the model's static tables, the coarse plan, the work buffer in
// the layout of fill_args and 4·grid doubles of partial sums); the rest is
// the solve's own: the active mask by element (bytes), the anchored mask by
// node (bytes, or null), the start vector and the result (N, 3) by node,
// stats (4 floats), the grips' displacements, the tolerance, the
// operator's regularisation.
extern "C" int chain_cg_f32(const void* const* ptrs, int n_ptrs,
                            const long long* ints, int n_ints,
                            const void* active, const void* anchored,
                            const float* x0, float* x, float* stats,
                            float dy_top, float dy_bot, float rtol, float reg,
                            int max_iter, int setup_only,
                            cudaStream_t stream) {
  CgArgs a;
  if (!fill_args(ptrs, n_ptrs, ints, n_ints, a))
    return (int)cudaErrorInvalidValue;
  a.active = (const unsigned char*)active;
  a.anchored = (const unsigned char*)anchored;
  a.x0n = x0;
  a.xn = x;
  a.stats = stats;
  a.dy_top = dy_top;
  a.dy_bot = dy_bot;
  a.rtol = rtol;
  a.reg = reg;
  a.t.reg = reg;
  a.max_iter = max_iter;
  a.setup_only = setup_only != 0;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)chain_cg_kernel, dim3((unsigned)ints[I_GRID]),
      dim3(THREADS), args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
