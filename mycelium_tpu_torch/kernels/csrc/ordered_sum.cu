// Segment sums in one fixed order, for the sums of the port's PyTorch
// routes whose terms collide on a target (the chain diagonal's jump terms,
// the coarse Galerkin entries, the hybrid's Schur corrections and its
// forward right-hand sides).
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
// What bounds it on this card: bytes and latency. Each thread owns one
// (k, s) and reads its terms in sequence, a chain of dependent adds; the
// segments are short (a node's jumps, a junction's attachments) except the
// coarse blocks (hundreds of terms), whose dd entries sit side by side, so
// a warp's loads of one term are adjacent. No atomics, no shared memory.

#include <cuda_runtime.h>

namespace {

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

template <typename T>
int launch(const T* vals, long long vs_k, long long vs_e, const int* ptr,
           const int* ent, int shift, const T* init, long long is_k,
           long long is_s, T* out, long long n, int K, cudaStream_t stream) {
  if (n <= 0 || K <= 0) return 0;
  const int threads = 256;
  long long blocks = (n * K + threads - 1) / threads;
  ordered_sum_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s, out, n, K);
  return (int)cudaGetLastError();
}

}  // namespace

// out (K, n) contiguous; vals and init by their strides (element units)
extern "C" int ordered_sum_f32(const float* vals, long long vs_k,
                               long long vs_e, const int* ptr, const int* ent,
                               int shift, const float* init, long long is_k,
                               long long is_s, float* out, long long n, int K,
                               cudaStream_t stream) {
  return launch<float>(vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s,
                       out, n, K, stream);
}

extern "C" int ordered_sum_f64(const double* vals, long long vs_k,
                               long long vs_e, const int* ptr, const int* ent,
                               int shift, const double* init, long long is_k,
                               long long is_s, double* out, long long n,
                               int K, cudaStream_t stream) {
  return launch<double>(vals, vs_k, vs_e, ptr, ent, shift, init, is_k, is_s,
                        out, n, K, stream);
}
