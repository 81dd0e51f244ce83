// K6: the whole spanning-forest-preconditioned CG solve in one launch.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_tree.py::_tree_cg_kernel
// (B4): every level's PCR factorization with the attachment and fill Schur
// corrections, B1's operator, the forest preconditioner's forward and
// backward sweeps, and CG with the stop on r·r <= rtol²·|free·b|²; no atol,
// no stall exit, no restarts, no dense tail, no coarse stage. It does not
// copy B4's layout: no (NB, 128) planes, no rolls, no level masks over all
// slots and no one-hot matrix products. Vectors are the port's (3, N)
// chain-ordered component planes (slot s of the forest IS chain position
// s), B4's one-hot gathers and scatters are index arrays, each level runs
// on its own slot range for its own number of rounds, and the per-slot
// arithmetic is K1's, K2's and K3's (chain_matvec.cuh, pcr.cuh).
//
// What bounds it on the card: the grid-wide barriers on small meshes, bytes
// on large ones; never operations. The factorization takes sum over levels
// of (rounds + 2) barriers once, a CG iteration 2·levels + 3. Between two
// barriers a phase moves at most ~250 bytes a slot: at 22k DOF (2,022
// slots) that is microseconds of work behind a barrier of about the same
// cost, and every table stays in the 50 MB L2; at 3M DOF (874k slots, 1 GB
// touched) the phases stream from device memory. The design keeps the host
// out of the solve (one launch, the stop test on the device) and keeps the
// barriers few: gathers replace scatters so that a level's Schur
// corrections, its attachment products and its right-hand sides are
// computed where they are consumed, with no phase of their own.
//
// Design: a persistent cooperative kernel (cudaLaunchCooperativeKernel,
// grid = SMs x the occupancy the calculator reports for the dynamic shared
// memory asked, all blocks resident), K5's skeleton. Phases between
// barriers:
//   factorization, per level: init (D = diagonal + the Schur corrections of
//     earlier levels' paths gathered through a CSR by junction slot, L and R
//     from the left-edge couplings plus the fill couplings of earlier
//     levels, transposed when flipped; the corner right-hand sides), then
//     one phase per round on global ping-pong state (pcr::round_slot), then
//     one phase that writes the block inverses and, one thread a path, the
//     attachment couplings, the corner blocks and from them the Schur
//     corrections dG (kept per path and side) and the fill coupling;
//   apply forward, per level: each block takes chunks of CHUNK slots plus
//     a halo of 2^rounds - 1 on both sides in shared memory (K3's window,
//     sized by the level's own rounds); a slot's right-hand side is r minus
//     the attachment products of earlier levels' paths, gathered through
//     the same CSR in a fixed order; all rounds run in shared memory;
//   apply backward, per level from the last: the right-hand side of a
//     path's first and last slot is the transposed attachment coupling
//     times the junction's value (gathered), u = y - T^-1 z;
//   CG: operator and p·Ap; x, r update and r·r; p = z + beta p.
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
#error "TREE_CG_CHUNK (central slots of an apply window) is set by the build"
#endif
constexpr int CHUNK = TREE_CG_CHUNK;

// the order of the pointer and integer arguments of tree_cg_f32
enum Ptr {
  P_UK, P_X0, P_FREEM, P_CACT, P_JACT, P_CN, P_CKAX, P_CKBD, P_JN, P_JKAX,
  P_JKBD, P_JA, P_JB, P_JPTR, P_JENT,
  P_D9, P_BEL, P_KATT,
  P_LVL, P_LEFT_FILL, P_FIRST_PATH, P_LAST_PATH, P_FG, P_LG, P_HAS_FILL,
  P_ATT_TGT, P_ATT_FILL, P_ATT_FLIP, P_ATT_PTR, P_ATT_ENT,
  P_X, P_STATS, P_WORK, P_PART, N_PTRS
};
enum Int {
  I_N, I_JP, I_S, I_P, I_L, I_SMAX, I_COEF, I_MAX_ITER, I_GRID, I_SMEM,
  N_INTS
};

struct TreeArgs {
  chain_op::Tables t;
  const float* uk;
  const float* x0;
  const float* d9;          // (9, S) forest diagonal
  const float* bel;         // (9, S) left-edge element couplings
  const float* katt;        // (2P, 9) attachment element couplings
  const long long* lvl;     // (4, L + 1): slot offsets, path offsets,
                            // rounds, coefficient offsets
  const int* left_fill;     // (S) 2·path + flip of the left fill edge, -1
  const int* first_path;    // (S) the path that starts at the slot, -1
  const int* last_path;     // (S) the path that ends at the slot, -1
  const int* fg;            // (P) first slot
  const int* lg;            // (P) last slot
  const int* has_fill;      // (P)
  const int* att_tgt;       // (2P) junction slot of entry 2·path + side, S
  const int* att_fill;      // (2P) producing path of a fill attachment, -1
  const int* att_flip;      // (2P)
  const int* att_ptr;       // (S + 1) CSR of entries by junction slot
  const int* att_ent;
  float* x;
  float* stats;             // [iterations, |r|, tol]
  float* r;                 // (3, N) each
  float* z;
  float* p;
  float* ap;
  float* y;                 // (3, S) forward solutions
  float* dinv;              // (9, S)
  float* ab;                // (2P, 9) attachment couplings
  float* dg;                // (2P, 9) Schur corrections by path and side
  float* fill;              // (P, 9) fill couplings
  float* state;             // 2 x 45 x smax ping-pong factorization state
  float* al;                // per level (rounds, 9, S_l)
  float* be;
  double* part;             // 4 x gridDim.x
  long long S, P, smax;
  int L, max_iter;
  float rtol;
};

struct Level {
  long long s0, len, p0, p1, coef;
  int steps;
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
  return l;
}

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

__device__ void factor_init(const TreeArgs& a, const Level& l, float* cur,
                            long long tid, long long nthr) {
  const long long st = a.smax;
  for (long long i = tid; i < l.len; i += nthr) {
    const long long s = l.s0 + i;
    float acc[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int e = a.att_ptr[s]; e < a.att_ptr[s + 1]; ++e) {
      const float* g = a.dg + 9 * (long long)a.att_ent[e];
      for (int c = 0; c < 9; ++c) acc[c] = acc[c] + g[c];
    }
    float B[9], Bn[9], Bt[9];
    left_coupling(a, s, B);
    pcr::transpose9(B, Bt);
    if (i + 1 < l.len) {
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

// the block inverses of the level, and per path its attachment couplings,
// Schur corrections and fill coupling
__device__ void factor_finish(const TreeArgs& a, const Level& l,
                              const float* cur, long long tid,
                              long long nthr) {
  const long long st = a.smax;
  for (long long i = tid; i < l.len; i += nthr) {
    float t[9], d[9];
    pcr::load9(cur, st, l.len, i, t);
    pcr::inv9(t, d);
    for (int c = 0; c < 9; ++c) a.dinv[c * a.S + l.s0 + i] = d[c];
  }
  for (long long p = l.p0 + tid; p < l.p1; p += nthr) {
    float d[9], xf[18], xl[18];
    pcr::final_slot(cur, st, l.len, a.fg[p] - l.s0, d, xf);
    pcr::final_slot(cur, st, l.len, a.lg[p] - l.s0, d, xl);
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
}

// One level of the preconditioner's forward (y = T^-1 (r - attachment
// products of earlier levels)) or backward (z = y - T^-1 (attachment
// couplings^T · junction values)) sweep. Returns the thread's part of r·z
// (backward only). `first`: p = z too.
__device__ double level_apply(const TreeArgs& a, const Level& l,
                              bool backward, bool first, float* smem) {
  const long long n = a.t.n, S = a.S;
  const int halo = (1 << l.steps) - 1;
  const int W = CHUNK + 2 * halo;
  float* buf0 = smem;
  float* buf1 = smem + 3 * W;
  const float* al = a.al + l.coef;
  const float* be = a.be + l.coef;
  const long long nchunks = (l.len + CHUNK - 1) / CHUNK;
  double srz = 0.0;
  for (long long ch = blockIdx.x; ch < nchunks; ch += gridDim.x) {
    const long long base = ch * CHUNK - halo;
    for (int w = threadIdx.x; w < W; w += blockDim.x) {
      const long long pos = base + w;
      float v[3] = {0.0f, 0.0f, 0.0f};
      if (pos >= 0 && pos < l.len) {
        const long long s = l.s0 + pos;
        if (!backward) {
          for (int c = 0; c < 3; ++c) v[c] = a.r[c * n + s];
          for (int e = a.att_ptr[s]; e < a.att_ptr[s + 1]; ++e) {
            const long long ent = a.att_ent[e];
            const long long end = (ent & 1) ? a.lg[ent >> 1] : a.fg[ent >> 1];
            const float* m = a.ab + 9 * ent;
            const float y0 = a.y[end], y1 = a.y[S + end],
                        y2 = a.y[2 * S + end];
            for (int q = 0; q < 3; ++q) {
              const float pr = m[3 * q] * y0 + m[3 * q + 1] * y1 +
                               m[3 * q + 2] * y2;
              v[q] = v[q] + (-pr);
            }
          }
        } else {
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
              const float pr = m[k] * u[0] + m[3 + k] * u[1] +
                               m[6 + k] * u[2];
              v[k] = v[k] + pr;
            }
          }
        }
      }
      for (int c = 0; c < 3; ++c) buf0[c * W + w] = v[c];
    }
    __syncthreads();
    const float* cur = pcr::apply_rounds(buf0, buf1, W, base, l.len, l.steps,
                                         al, be, l.len);
    for (int w = halo + threadIdx.x; w < halo + CHUNK; w += blockDim.x) {
      const long long pos = base + w;
      if (pos >= l.len) break;
      const long long s = l.s0 + pos;
      const float v0 = cur[w], v1 = cur[W + w], v2 = cur[2 * W + w];
      for (int q = 0; q < 3; ++q) {
        const float o = a.dinv[(3 * q) * S + s] * v0 +
                        a.dinv[(3 * q + 1) * S + s] * v1 +
                        a.dinv[(3 * q + 2) * S + s] * v2;
        if (!backward) {
          a.y[q * S + s] = o;
        } else {
          const float u = a.y[q * S + s] - o;
          a.z[q * n + s] = u;
          if (first) a.p[q * n + s] = u;
          srz += prod(a.r[q * n + s], u);
        }
      }
    }
    __syncthreads();
  }
  return srz;
}

// z = M^-1 r: the forest solve on the slots, the identity on the positions
// after them; leaves the per-block partial sums of r·z in `slots`. Ends on
// a grid-wide barrier.
__device__ void precondition(const TreeArgs& a, cg::grid_group& grid,
                             bool first, double* slots, double* sh,
                             float* smem, long long tid, long long nthr) {
  const long long n = a.t.n;
  double srz = 0.0;
  for (long long q = a.S + tid; q < n; q += nthr)
    for (int c = 0; c < 3; ++c) {
      const float rv = a.r[c * n + q];
      a.z[c * n + q] = rv;
      if (first) a.p[c * n + q] = rv;
      srz += prod(rv, rv);
    }
  for (int li = 0; li < a.L; ++li) {
    level_apply(a, level_of(a, li), false, first, smem);
    grid.sync();
  }
  for (int li = a.L - 1; li >= 0; --li) {
    srz += level_apply(a, level_of(a, li), true, first, smem);
    if (li == 0) put_partial(srz, slots, sh);
    grid.sync();
  }
  if (a.L == 0) {
    put_partial(srz, slots, sh);
    grid.sync();
  }
}

__global__ void __launch_bounds__(THREADS) tree_cg_kernel(TreeArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ double sh[WARPS + 1];
  extern __shared__ float smem[];
  const chain_op::Tables& t = a.t;
  const long long n = t.n;
  const int G = gridDim.x;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long nthr = (long long)G * THREADS;
  double* part_pap = a.part;
  double* part_rr = a.part + G;
  double* part_rz = a.part + 2 * G;
  double* part_bb = a.part + 3 * G;

  // the factorization, level by level
  for (int li = 0; li < a.L; ++li) {
    const Level l = level_of(a, li);
    float* cur = a.state;
    float* nxt = a.state + pcr::kStatePlanes * a.smax;
    factor_init(a, l, cur, tid, nthr);
    grid.sync();
    for (int k = 0; k < l.steps; ++k) {
      float* alk = a.al + l.coef + (long long)k * 9 * l.len;
      float* bek = a.be + l.coef + (long long)k * 9 * l.len;
      for (long long i = tid; i < l.len; i += nthr)
        pcr::round_slot(cur, nxt, alk, bek, a.smax, l.len, l.len, i,
                        1LL << k);
      grid.sync();
      float* sw = cur;
      cur = nxt;
      nxt = sw;
    }
    factor_finish(a, l, cur, tid, nthr);
    grid.sync();
  }

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
  precondition(a, grid, true, part_rz, sh, smem, tid, nthr);

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
    srr = 0.0;
    for (long long e = tid; e < 3 * n; e += nthr) {
      a.x[e] = a.x[e] + alpha * a.p[e];
      const float rv = a.r[e] - alpha * a.ap[e];
      a.r[e] = rv;
      srr += prod(rv, rv);
    }
    put_partial(srr, part_rr, sh);
    grid.sync();

    precondition(a, grid, false, part_rz, sh, smem, tid, nthr);

    const float rz_new = grid_total(part_rz, sh);
    rr = grid_total(part_rr, sh);
    const float beta = rz > 0.0f ? rz_new / rz : 0.0f;
    for (long long e = tid; e < 3 * n; e += nthr)
      a.p[e] = a.z[e] + beta * a.p[e];
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

// a window above the 48 KB a kernel gets without asking must be allowed
cudaError_t allow_smem(long long smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(tree_cg_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

// Blocks of the cooperative grid for `smem` bytes of dynamic shared memory
// a block: SMs x blocks per SM, all co-resident. Fails on a card without
// cooperative launch or with less shared memory than asked.
extern "C" int tree_cg_grid_blocks(int smem, int* out) {
  int dev = 0, coop = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = allow_smem(smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, tree_cg_kernel,
                                                    THREADS, (size_t)smem);
  if (e != cudaSuccess) return (int)e;
  if (per < 1) return (int)cudaErrorLaunchOutOfResources;
  *out = sms * per;
  return 0;
}

// ptrs and ints in the order of the enums above. work: r, z, p, ap (3N
// each), y (3S), dinv (9S), ab and dg (18P each), fill (9P), the ping-pong
// state (90·smax) and the coefficients (2·coef) floats; part: 4·grid
// doubles.
extern "C" int tree_cg_f32(const void* const* ptrs, int n_ptrs,
                           const long long* ints, int n_ints, float rtol,
                           float reg, cudaStream_t stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS) return (int)cudaErrorInvalidValue;
  const long long n = ints[I_N], S = ints[I_S], P = ints[I_P];
  const long long smax = ints[I_SMAX], coef = ints[I_COEF];
  if (n <= 0 || S < 0 || S > n || P < 0 || ints[I_L] < 0 ||
      ints[I_GRID] <= 0)
    return (int)cudaErrorInvalidValue;
  auto f = [&](int i) { return (const float*)ptrs[i]; };
  auto q = [&](int i) { return (const int*)ptrs[i]; };
  TreeArgs a;
  a.t = chain_op::Tables{f(P_FREEM), f(P_CACT), f(P_JACT), f(P_CN),
                         f(P_CKAX), f(P_CKBD), f(P_JN), f(P_JKAX),
                         f(P_JKBD), (const long long*)ptrs[P_JA],
                         (const long long*)ptrs[P_JB], ints[I_JP],
                         (const long long*)ptrs[P_JPTR],
                         (const long long*)ptrs[P_JENT], n, reg};
  a.uk = f(P_UK);
  a.x0 = f(P_X0);
  a.d9 = f(P_D9);
  a.bel = f(P_BEL);
  a.katt = f(P_KATT);
  a.lvl = (const long long*)ptrs[P_LVL];
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
  a.x = (float*)ptrs[P_X];
  a.stats = (float*)ptrs[P_STATS];
  float* w = (float*)ptrs[P_WORK];
  a.r = w;
  a.z = w + 3 * n;
  a.p = w + 6 * n;
  a.ap = w + 9 * n;
  w += 12 * n;
  a.y = w;
  a.dinv = w + 3 * S;
  w += 12 * S;
  a.ab = w;
  a.dg = w + 18 * P;
  a.fill = w + 36 * P;
  w += 45 * P;
  a.state = w;
  w += 2 * pcr::kStatePlanes * smax;
  a.al = w;
  a.be = w + coef;
  a.part = (double*)ptrs[P_PART];
  a.S = S;
  a.P = P;
  a.smax = smax;
  a.L = (int)ints[I_L];
  a.max_iter = (int)ints[I_MAX_ITER];
  a.rtol = rtol;
  void* args[] = {&a};
  cudaError_t e = allow_smem(ints[I_SMEM]);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchCooperativeKernel(
      (const void*)tree_cg_kernel, dim3((unsigned)ints[I_GRID]),
      dim3(THREADS), args, (size_t)ints[I_SMEM], stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
