// K1: boundary-conditioned stiffness matvec on the chain-ordered layout.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_tree_big.py::_matvec_kernel
// (both of its uses in pallas_tree_big_solve: the BC'd CG operator and the
// raw K·u of the right-hand side).
//
// Layout: u and out are three contiguous (N,) component planes, position p
// being chain position p (nodes permuted along the tree-slot/path order).
// Chain edge p joins positions p and p+1, with unit direction cn[:, p] and
// stiffnesses ckax[p], ckbd[p]; jump edge j joins ja[j] and jb[j].
//
// What bounds it on the card: bytes. Per position it reads u (3 planes,
// at p-1, p, p+1 — neighbouring threads share them through L1/L2), the
// chain tables (5 floats at p and p-1) and the masks, and writes 3 floats:
// about 60 bytes a position, 0.02 flop/byte. At 103k nodes that is ~6 MB
// per call, well inside the 50 MB L2, so the call is launch- and
// latency-bound rather than HBM-bound.
//
// Design: one thread per position, a coalesced 3-point stencil. The
// stencil recomputes the force of slot p-1 instead of exchanging it, which
// costs arithmetic the card has to spare and needs no shared memory or
// second pass. Jumps are summed deterministically: each node walks its own
// rows of a per-node jump CSR built once on the host (jptr/jent, entry
// 2j + side) and gathers u[ja[j]], u[jb[j]] itself. No atomics, so the CG
// trajectory is the same from run to run.
//
// Arithmetic order follows the plain PyTorch version term by term; the
// library is built with -fmad=false so products are not contracted into
// fused multiply-adds and the kernel rounds as the plain version does.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float uval(const float* __restrict__ u,
                                      const float* __restrict__ freem,
                                      int bc, long long c, long long q,
                                      long long n) {
  float v = u[c * n + q];
  return bc ? v * freem[q] : v;
}

// chain force of slot q on position q (position q+1 receives -f)
__device__ __forceinline__ void slot_force(
    const float* __restrict__ u, const float* __restrict__ freem, int bc,
    const float* __restrict__ cact, const float* __restrict__ cn,
    const float* __restrict__ ckax, const float* __restrict__ ckbd,
    long long q, long long n, float f[3]) {
  float d[3];
  for (int c = 0; c < 3; ++c) {
    float nxt = (q + 1 < n) ? uval(u, freem, bc, c, q + 1, n) : 0.0f;
    d[c] = uval(u, freem, bc, c, q, n) - nxt;
  }
  float n0 = cn[q], n1 = cn[n + q], n2 = cn[2 * n + q];
  float nd = n0 * d[0] + n1 * d[1] + n2 * d[2];
  float kax_nd = ckax[q] * nd;
  float kbd = ckbd[q];
  float act = cact[q];
  float nn[3] = {n0, n1, n2};
  for (int c = 0; c < 3; ++c)
    f[c] = (kax_nd * nn[c] + kbd * (d[c] - nd * nn[c])) * act;
}

__global__ void chain_matvec_kernel(
    const float* __restrict__ u, const float* __restrict__ freem,
    const float* __restrict__ cact, const float* __restrict__ jact,
    const float* __restrict__ cn, const float* __restrict__ ckax,
    const float* __restrict__ ckbd, const float* __restrict__ jn,
    const float* __restrict__ jkax, const float* __restrict__ jkbd,
    const long long* __restrict__ ja, const long long* __restrict__ jb,
    long long jp, const long long* __restrict__ jptr,
    const long long* __restrict__ jent, float* __restrict__ out,
    long long n, float reg, int bc) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  float f[3], fm[3] = {0.0f, 0.0f, 0.0f};
  slot_force(u, freem, bc, cact, cn, ckax, ckbd, p, n, f);
  if (p > 0) slot_force(u, freem, bc, cact, cn, ckax, ckbd, p - 1, n, fm);
  float o[3];
  for (int c = 0; c < 3; ++c) o[c] = f[c] - fm[c];

  for (long long e = jptr[p]; e < jptr[p + 1]; ++e) {
    long long j = jent[e] >> 1;
    int side = (int)(jent[e] & 1);
    long long a = ja[j], b = jb[j];
    float dj[3];
    for (int c = 0; c < 3; ++c)
      dj[c] = uval(u, freem, bc, c, a, n) - uval(u, freem, bc, c, b, n);
    float m0 = jn[j], m1 = jn[jp + j], m2 = jn[2 * jp + j];
    float nn[3] = {m0, m1, m2};
    float ndj = m0 * dj[0] + m1 * dj[1] + m2 * dj[2];
    float kax_nd = jkax[j] * ndj;
    float kbd = jkbd[j];
    float act = jact[j];
    for (int c = 0; c < 3; ++c) {
      float fj = (kax_nd * nn[c] + kbd * (dj[c] - ndj * nn[c])) * act;
      o[c] = side ? o[c] - fj : o[c] + fj;
    }
  }

  if (bc) {
    float fr = freem[p];
    for (int c = 0; c < 3; ++c) {
      float uc = u[c * n + p];
      float ufc = uc * fr;
      out[c * n + p] = fr * (o[c] + reg * ufc) + (1.0f - fr) * uc;
    }
  } else {
    for (int c = 0; c < 3; ++c) out[c * n + p] = o[c];
  }
}

}  // namespace

extern "C" int chain_matvec_f32(
    const float* u, const float* freem, const float* cact, const float* jact,
    const float* cn, const float* ckax, const float* ckbd, const float* jn,
    const float* jkax, const float* jkbd, const long long* ja,
    const long long* jb, long long jp, const long long* jptr,
    const long long* jent, float* out, long long n, float reg, int bc,
    cudaStream_t stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  chain_matvec_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      u, freem, cact, jact, cn, ckax, ckbd, jn, jkax, jkbd, ja, jb, jp, jptr,
      jent, out, n, reg, bc);
  return (int)cudaGetLastError();
}
