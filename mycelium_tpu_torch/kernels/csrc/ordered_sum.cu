// Segment sums in one fixed order, for the sums of the port's PyTorch
// routes whose terms collide on a target (the chain diagonal's jump terms,
// the coarse Galerkin entries, the hybrid's Schur corrections, the dense
// tail's matrix and its right-hand side).
//
// It takes the place of a scatter-add (index_add_), which on the card adds
// colliding terms with float atomics in an order that changes from run to
// run; the JAX package's counterparts are XLA scatter-adds. It is not one
// of the six TPU kernels.
//
//   out[k, s] = init[k, s] + vals[k, ent[j] >> shift] + ... for j from
//               ptr[s] to ptr[s + 1] - 1, added one after another
//
// (init 0 when absent, ent[j] = j when absent), which is the order in which
// the CPU's sequential index_add_ adds the same terms when the CSR lists
// them in its index order: the two give the same bits.
//
// What bounds it on this card: the longest chain of dependent adds, not
// bytes (0.0008 ms at 3.35 TB/s on the 22k coarse blocks). The order is
// fixed, so a segment's adds cannot be reassociated; what can move is the
// loads. The coarse blocks are skewed: 452 segments of median 1 term, and
// the 58 diagonal blocks' ~640. A thread that owns a sum and loads its own
// terms waits on memory through the whole chain: 0.029 ms, however its
// loads are batched (16 in flight a thread, measured on the card: 0.024).
//
// Design, by the segments' length, which the caller states (the wrapper's
// long_segments):
//   short segments (a node's jumps, a junction's attachments, the dense
//     tail's entries): a thread a (k, s), its terms added as it loads them;
//   long segments (the coarse blocks): a block a segment. Its other warps
//     stage the segment's terms, chunk by chunk, into shared memory with
//     coalesced loads (a term's K values sit side by side), one chunk ahead
//     of the first warp(s), whose lane k adds column k from shared memory in
//     CSR order. The adds then wait on shared memory, not on device memory.
// No atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// elements of one shared-memory chunk buffer (two buffers: 36 KB in
// float64)
constexpr int kChunkElems = 2304;

template <typename T>
__global__ void ordered_sum_kernel(const T* vals, long long vs_k,
                                   long long vs_e, const int* ptr,
                                   const int* ent, int shift, const T* init,
                                   long long is_k, long long is_s, T* out,
                                   long long n, int K) {
  long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n * K) return;
  long long s, k;
  if (vs_k == 1) {          // terms are rows: neighbouring threads over k
    s = t / K;
    k = t - s * K;
  } else {                  // terms are planes: neighbouring threads over s
    k = t / n;
    s = t - k * n;
  }
  T acc = init ? init[k * is_k + s * is_s] : T(0);
  const int j1 = ptr[s + 1];
  for (int j = ptr[s]; j < j1; ++j) {
    const long long e = ent ? (long long)(ent[j] >> shift) : (long long)j;
    acc = acc + vals[k * vs_k + e * vs_e];
  }
  out[k * n + s] = acc;
}

// One block a segment: the adders are the first ceil(K/32) warps (lane k
// adds column k), the other warps stage chunk c + 1 while chunk c is added.
// Element i of a chunk of C terms is column i % K of its term i / K (terms
// as rows, vs_k == 1: a term's K values side by side) or term i % C of
// column i / C (planes).
template <typename T>
__global__ void __launch_bounds__(kThreads) ordered_sum_segment_kernel(
    const T* vals, long long vs_k, long long vs_e, const int* ptr,
    const int* ent, int shift, const T* init, long long is_k, long long is_s,
    T* out, long long n, int K) {
  __shared__ T buf[2][kChunkElems];
  const long long s = blockIdx.x;
  const int j0 = ptr[s], j1 = ptr[s + 1];
  const int C = kChunkElems / K;
  const int n_chunks = (j1 - j0 + C - 1) / C;
  const int adders = 32 * ((K + 31) / 32);
  const bool rows = vs_k == 1;

  auto stage = [&](int c) {
    const int jc = j0 + c * C;
    const int len = min(C, j1 - jc);
    for (int i = threadIdx.x - adders; i < len * K;
         i += blockDim.x - adders) {
      const int b = rows ? i / K : i % len;
      const int k = rows ? i - b * K : i / len;
      const int j = jc + b;
      const long long e = ent ? (long long)(ent[j] >> shift) : (long long)j;
      buf[c & 1][rows ? i : k * C + b] = vals[k * vs_k + e * vs_e];
    }
  };

  T acc = T(0);
  const int k = threadIdx.x;
  if (k < K) acc = init ? init[k * is_k + s * is_s] : T(0);
  if (threadIdx.x >= adders && n_chunks > 0) stage(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    if (threadIdx.x >= adders) {
      if (c + 1 < n_chunks) stage(c + 1);
    } else if (k < K) {
      const T* b = buf[c & 1];
      const int len = min(C, j1 - (j0 + c * C));
      if (rows)
        for (int i = 0; i < len; ++i) acc = acc + b[i * K + k];
      else
        for (int i = 0; i < len; ++i) acc = acc + b[k * C + i];
    }
    __syncthreads();
  }
  if (k < K) out[k * n + s] = acc;
}

template <typename T>
int launch(const T* vals, long long vs_k, long long vs_e, const int* ptr,
           const int* ent, int shift, const T* init, long long is_k,
           long long is_s, T* out, long long n, int K, int long_segments,
           cudaStream_t stream) {
  if (n <= 0 || K <= 0) return 0;
  if (long_segments && K <= 64) {
    ordered_sum_segment_kernel<T><<<(unsigned)n, kThreads, 0, stream>>>(
        vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s, out, n, K);
    return (int)cudaGetLastError();
  }
  long long blocks = (n * K + kThreads - 1) / kThreads;
  ordered_sum_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(
      vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s, out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// out (K, n) contiguous; vals and init by their strides (element units);
// long_segments: a block a segment (segments of tens of terms or more)
extern "C" int ordered_sum_f32(const float* vals, long long vs_k,
                               long long vs_e, const int* ptr, const int* ent,
                               int shift, const float* init, long long is_k,
                               long long is_s, float* out, long long n, int K,
                               int long_segments, cudaStream_t stream) {
  return launch<float>(vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s,
                       out, n, K, long_segments, stream);
}

extern "C" int ordered_sum_f64(const double* vals, long long vs_k,
                               long long vs_e, const int* ptr, const int* ent,
                               int shift, const double* init, long long is_k,
                               long long is_s, double* out, long long n,
                               int K, int long_segments,
                               cudaStream_t stream) {
  return launch<double>(vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s,
                        out, n, K, long_segments, stream);
}
