// K8: a ramp step's post-solve and its record rows in one launch. For the
// solved displacement u (N, 3) and the step's active mask (the mask the
// solve ran with), each element's
//   strain     = n·(u[n2] − u[n1]) / max(L, 1e-12)    (fea/elements.py::
//                element_strain, its dot product ((x0 + x1) + x2): dot3)
//   stress     = active ? e_mod·strain : 0
//   active_new = active && |strain| <= max_strain
//   f          = (k_ax·nd)·n + k_bd·(d − nd·n), d = u[n1] − u[n2],
//                nd = n·d, times active              (element_forces)
// and of the whole step
//   force      = Σ over element ends on the top grip of ±f_y (+ at n1, − at
//                n2, as apply_stiffness signs them): the top grip's
//                y-reaction, the sum where(top, K·u, 0)[:, 1].sum() forms;
//   the count of active elements after the step and of those that
//   fractured in it (active && !active_new);
// written into the caller's record rows: stress (E,), active_new (E,), a
// copy of u into the disp row (3N,), the status row in float64
// [converged, active after, iterations, force] (the columns CONVERGED,
// ACTIVE, ITERS, FORCE of kernels/post_solve.py; converged and iterations
// are the host's values after the solve's stats read, passed in) and the
// changed flag (fractured > 0), which the host reads once a step.
//
// It replaces no TPU kernel: the JAX package computes the same in plain jnp
// (mycelium_tpu/fea/ramp.py::post_solve) and the port did the same in
// PyTorch operations (fea/ramp.py::post_solve on CPU tensors, which it still
// is there): the whole ELL operator to sum one grip's reactions, the strain,
// the stress, the fracture test, then the record keeper's three row writes
// and four status fills: 43 launches a step at 309k DOF, 0.129 ms of device
// time and 0.69 ms of host time on the H100 (each lasted a few us while the
// host took ~10-15 us to issue it; the card idled through that stretch).
//
// What bounds it on the card: launch latency. At 309k DOF (~103k elements)
// it must move 7.3 MB (connectivity, geometry, the masks, u, the rows, each
// once), 2.2 us at 3.35 TB/s; it runs in ~6 us. So the design spends
// one launch and no host read: a thread an element, 256 a block, and the
// step's three sums taken without float atomics in one fixed order, so the
// same inputs give the same bits on every run and every card:
//   1. each block sums its threads' values (grid_reduce.cuh's block_sums: a
//      warp's lanes by shuffle-down halving, then its 8 warps in order) and
//      stores its partials; the block that counts in last (an integer
//      atomic on `done`, after a fence) adds every block's partials, thread
//      t those of blocks t, t + 256, ... in order, then block_sums again, and
//      writes the status row and the flag and sets `done` back to 0;
//   2. the grid is ceil(E / 256) blocks whatever the card, so the order
//      depends on E alone and kernels/post_solve.py::fixed_order_sum
//      reproduces it on the CPU.
// The force's terms are the model dtype's f_y (exact in float64) added in
// float64; the counts are exact. -fmad=false keeps every product rounded as
// the plain PyTorch operations round it, so the rows equal theirs bit for
// bit. A launch's scratch (`partial`, `done`) is its model's: two launches
// on one model must be ordered on one stream.

#include <cuda_runtime.h>

#include "grid_reduce.cuh"

namespace {

constexpr int THREADS = grid_reduce::THREADS;
constexpr int SUMS = 3;   // force, active after, fractured

template <typename T>
struct PostArgs {
  const T* u;                   // (N, 3)
  const long long* conn;        // (E, 2)
  const T* dir;                 // (E, 3) unit directions
  const T* length;              // (E,)
  const T* k_ax;                // (E,)
  const T* k_bd;                // (E,)
  const unsigned char* top;     // (N,) bool
  const unsigned char* active;  // (E,) bool
  T* stress;                    // (E,)
  unsigned char* active_new;    // (E,) bool
  T* disp;                      // (3N,)
  double* status;               // (4,)
  unsigned char* changed;       // () bool
  double* partial;              // (SUMS, grid)
  unsigned int* done;           // () 0 between launches
  T e_mod;
  T max_strain;
  double converged;
  double iters;
  long long n_nodes;
  long long n_elems;
};

template <typename T>
__device__ __forceinline__ T abs_of(T x) {
  return x < T(0) ? -x : x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    post_solve_kernel(PostArgs<T> a) {
  __shared__ double sh[SUMS * (grid_reduce::WARPS + 1)];
  __shared__ bool last;
  const long long e = (long long)blockIdx.x * THREADS + threadIdx.x;
  double v[SUMS] = {0.0, 0.0, 0.0};
  if (e < a.n_elems) {
    const T* u1 = a.u + 3 * a.conn[2 * e];
    const T* u2 = a.u + 3 * a.conn[2 * e + 1];
    const T* nv = a.dir + 3 * e;
    const T n0 = nv[0], n1 = nv[1], n2 = nv[2];
    const T x0 = u1[0], x1 = u1[1], x2 = u1[2];
    const T y0 = u2[0], y1 = u2[1], y2 = u2[2];
    // element_strain: du = u[n2] - u[n1]
    const T s = (n0 * (y0 - x0) + n1 * (y1 - x1)) + n2 * (y2 - x2);
    const T lo = static_cast<T>(1e-12);
    const T len = a.length[e];
    const T strain = s / (len < lo ? lo : len);
    const bool act = a.active[e] != 0;
    const bool keep = act && abs_of(strain) <= a.max_strain;
    a.stress[e] = act ? a.e_mod * strain : T(0);
    a.active_new[e] = keep;
    // element_forces' y-component: d = u[n1] - u[n2]
    const T d0 = x0 - y0, d1 = x1 - y1, d2 = x2 - y2;
    const T nd = (n0 * d0 + n1 * d1) + n2 * d2;
    T fy = (a.k_ax[e] * nd) * n1 + a.k_bd[e] * (d1 - nd * n1);
    fy = fy * (act ? T(1) : T(0));
    double c = 0.0;
    if (a.top[a.conn[2 * e]]) c = c + (double)fy;
    if (a.top[a.conn[2 * e + 1]]) c = c - (double)fy;
    v[0] = c;
    v[1] = keep ? 1.0 : 0.0;
    v[2] = (act && !keep) ? 1.0 : 0.0;
  }
  const long long n_disp = 3 * a.n_nodes;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
       i < n_disp; i += (long long)gridDim.x * THREADS)
    a.disp[i] = a.u[i];

  grid_reduce::block_sums<SUMS>(v, sh);
  if (threadIdx.x == 0) {
    for (int k = 0; k < SUMS; ++k)
      a.partial[k * gridDim.x + blockIdx.x] = v[k];
    __threadfence();
    last = atomicAdd(a.done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double w[SUMS] = {0.0, 0.0, 0.0};
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS)
    for (int k = 0; k < SUMS; ++k)
      w[k] = w[k] + __ldcg(a.partial + k * gridDim.x + i);
  grid_reduce::block_sums<SUMS>(w, sh);
  if (threadIdx.x == 0) {
    // kernels/post_solve.py's CONVERGED, ACTIVE, ITERS, FORCE
    a.status[0] = a.converged;
    a.status[1] = w[1];
    a.status[2] = a.iters;
    a.status[3] = w[0];
    *a.changed = w[2] > 0.0;
    *a.done = 0u;
  }
}

template <typename T>
int launch(const void* u, const void* conn, const void* dir,
           const void* length, const void* k_ax, const void* k_bd,
           const void* top, const void* active, void* stress,
           void* active_new, void* disp, void* status, void* changed,
           void* partial, void* done, double e_mod, double max_strain,
           double converged, double iters, long long n_nodes,
           long long n_elems, int grid, cudaStream_t stream) {
  if (n_nodes < 1 || n_elems < 0 || grid < 1 ||
      (long long)grid * THREADS < n_elems)
    return (int)cudaErrorInvalidValue;
  PostArgs<T> a;
  a.u = (const T*)u;
  a.conn = (const long long*)conn;
  a.dir = (const T*)dir;
  a.length = (const T*)length;
  a.k_ax = (const T*)k_ax;
  a.k_bd = (const T*)k_bd;
  a.top = (const unsigned char*)top;
  a.active = (const unsigned char*)active;
  a.stress = (T*)stress;
  a.active_new = (unsigned char*)active_new;
  a.disp = (T*)disp;
  a.status = (double*)status;
  a.changed = (unsigned char*)changed;
  a.partial = (double*)partial;
  a.done = (unsigned int*)done;
  a.e_mod = static_cast<T>(e_mod);
  a.max_strain = static_cast<T>(max_strain);
  a.converged = converged;
  a.iters = iters;
  a.n_nodes = n_nodes;
  a.n_elems = n_elems;
  post_solve_kernel<T><<<(unsigned)grid, THREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One step: u (N, 3), conn (E, 2) int64, dir (E, 3), length, k_ax, k_bd
// (E,), top (N,) bool, active (E,) bool; the rows stress (E,), active_new
// (E,) bool, disp (3N,), status (4,) float64, changed () bool; the scratch
// partial (3·grid,) float64 and done () uint32 (0 before the first launch);
// `grid` = ceil(E / 256) blocks (at least 1). All contiguous on one card.
extern "C" int post_solve_f32(const void* u, const void* conn,
                              const void* dir, const void* length,
                              const void* k_ax, const void* k_bd,
                              const void* top, const void* active,
                              void* stress, void* active_new, void* disp,
                              void* status, void* changed, void* partial,
                              void* done, double e_mod, double max_strain,
                              double converged, double iters,
                              long long n_nodes, long long n_elems, int grid,
                              cudaStream_t stream) {
  return launch<float>(u, conn, dir, length, k_ax, k_bd, top, active, stress,
                       active_new, disp, status, changed, partial, done,
                       e_mod, max_strain, converged, iters, n_nodes, n_elems,
                       grid, stream);
}

extern "C" int post_solve_f64(const void* u, const void* conn,
                              const void* dir, const void* length,
                              const void* k_ax, const void* k_bd,
                              const void* top, const void* active,
                              void* stress, void* active_new, void* disp,
                              void* status, void* changed, void* partial,
                              void* done, double e_mod, double max_strain,
                              double converged, double iters,
                              long long n_nodes, long long n_elems, int grid,
                              cudaStream_t stream) {
  return launch<double>(u, conn, dir, length, k_ax, k_bd, top, active,
                        stress, active_new, disp, status, changed, partial,
                        done, e_mod, max_strain, converged, iters, n_nodes,
                        n_elems, grid, stream);
}
