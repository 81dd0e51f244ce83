// K1: boundary-conditioned stiffness matvec on the chain-ordered layout.
//
// Replaces the TPU kernel mycelium_tpu/fea/pallas_tree_big.py::_matvec_kernel
// (both of its uses in pallas_tree_big_solve: the BC'd CG operator and the
// raw K·u of the right-hand side). The body is chain_op::matvec_tile
// (chain_matvec.cuh), which K6 shares.
//
// What bounds it on the card: at the sizes the port solves, the launch. Per
// position it reads u (3 planes), a 16-byte packed direction and axial
// stiffness, the bending stiffness and two masks, and writes 3 floats:
// about 50 bytes a position, 0.02 flop/byte. At 103k nodes that is ~5 MB a
// call, well inside the 50 MB L2 and ~1.5 us of device memory time, below
// the few microseconds any launch costs.
//
// Design: a block takes a tile of TILE consecutive positions. It loads
// free·u for the tile and its two neighbours into shared memory once,
// computes each of the TILE + 1 slot forces once into shared memory and
// differences them (the per-position form computed every slot force twice
// and loaded the free mask three times over). TILE = 64 so that the 22k-DOF
// mesh (7,375 positions, 116 blocks) covers most of the card's 132 SMs.
// Indices are 32-bit; a slot's direction and axial stiffness come in one
// 16-byte load. Jumps are summed deterministically: each node walks its own
// rows of a per-node jump CSR built once on the host and gathers u[ja[j]],
// u[jb[j]] itself. No atomics, so the CG trajectory is the same from run
// to run.
//
// The static pointers come as one array that the wrapper builds once per
// operator (enum Ptr below); a call passes u, out and the stream.

#include "chain_matvec.cuh"

namespace {

constexpr int TILE = 64;

// the order of the pointer argument of chain_matvec_f32
enum Ptr {
  P_FREEM, P_CACT, P_JACT, P_CPACK, P_CKBD, P_JPACK, P_JKBD, P_JA, P_JB,
  P_JPTR, P_JENT, N_PTRS
};

__global__ void __launch_bounds__(TILE)
chain_matvec_kernel(const float* u, chain_op::Packed t, float* out, int bc) {
  __shared__ float sm[chain_op::Tile<TILE>::floats];
  const int q0 = blockIdx.x * TILE;
  float o[3];
  chain_op::matvec_tile<TILE>(u, t, bc, q0, sm, o);
  const int p = q0 + threadIdx.x;
  if (p < t.n)
    for (int c = 0; c < 3; ++c) out[(long long)c * t.n + p] = o[c];
}

}  // namespace

extern "C" int chain_matvec_f32(const void* const* ptrs, int n_ptrs,
                                long long n, float reg, const float* u,
                                float* out, int bc, cudaStream_t stream) {
  if (n_ptrs != N_PTRS || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  auto f = [&](int i) { return (const float*)ptrs[i]; };
  auto q = [&](int i) { return (const int*)ptrs[i]; };
  chain_op::Packed t{f(P_FREEM), f(P_CACT), f(P_JACT),
                     (const float4*)ptrs[P_CPACK], f(P_CKBD),
                     (const float4*)ptrs[P_JPACK], f(P_JKBD), q(P_JA),
                     q(P_JB), q(P_JPTR), q(P_JENT), (int)n, reg};
  const unsigned blocks = (unsigned)((n + TILE - 1) / TILE);
  chain_matvec_kernel<<<blocks, TILE, 0, stream>>>(u, t, out, bc);
  return (int)cudaGetLastError();
}
