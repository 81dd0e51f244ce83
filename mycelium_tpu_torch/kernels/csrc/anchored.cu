// K7: grip reachability in one launch. out[i] is true where node i is
// joined to a grip node through active elements: the mask the solve pins
// the fracture islands by, refreshed after every step that fractures.
//
// It replaces no TPU kernel: the JAX package computes the mask in plain
// jnp (mycelium_tpu/fea/tree_jax.py::tree_anchored), and the port did the
// same in PyTorch operations (fea/tree_factor.py::tree_anchored, a fixpoint
// of ~11 trips on the 309k-DOF network, each a few dozen small launches and
// one host read of a `changed` flag). Measured on the H100 that refresh was
// the pull test's bottleneck: ~19.5 refreshes a 0.06 mm pull test at ~70 ms
// of host time each, against ~0.8 ms of device time a trip, the card idle
// 92% of the time. A fixpoint of hops from the grips needs as many trips as
// the network's paths are long (the benchmark's networks are trees of ~64-
// node chains); connected components by union-find do not depend on the
// diameter or on the forest, so one launch covers every model.
//
// What bounds it on the card: latency. At 309k DOF a refresh moves ~2.5 MB
// (conn, the active mask, the scratch and the result), ~0.8 us at 3.35
// TB/s, against four grid-wide barriers (~1.3 us each) and the dependent
// loads of the root searches. So the design spends one launch and no host
// read a refresh: a persistent cooperative grid (cudaLaunchCooperativeKernel,
// all blocks resident, one thread a node by tree_cg.py::grid_rule), five
// phases between four grid.sync():
//   1. parent[i] = i, flag[i] = 0;
//   2. for each active element e, a lock-free union of conn[e, 0] and
//      conn[e, 1] (ECL-CC's hooking): find both roots with path halving,
//      link the larger root under the smaller by atomicCAS on the larger's
//      parent, and on failure go on from what the CAS found. Every parent
//      pointer only ever decreases (parent[i] <= i), so the sets stay trees
//      and every search ends;
//   3. parent[i] = find(i): compression. A search of another thread may
//      still store a grandparent over a root written here, so the
//      pointers are short, not all on their root;
//   4. flag[root(g)] = 1 for every grip node g;
//   5. out[i] = flag[root(i)].
// Phases 4 and 5 store no pointer, so their root searches (a hop or two
// after phase 3) see fixed trees and find each set's one root.
// Grip nodes are anchored by construction, as in anchored_mask_host.
// Inactive elements are never read past their flag. Which node ends as a
// set's root depends on the order the hooks land in (it is always the
// set's smallest id), so the scratch may differ between runs but the mask
// is exact and the same in every run: booleans, nothing rounds.
// Loads of `parent` go through L2 (__ldcg), where the CAS resolve, so no
// block reads another SM's stale L1 line while the sets are being joined.

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

struct AnchoredArgs {
  const long long* conn;         // (E, 2) node ids of each element
  const unsigned char* active;   // (E,) bool
  const unsigned char* grip;     // (N,) bool: top | bot
  int* parent;                   // (N,) scratch
  unsigned char* flag;           // (N,) scratch
  unsigned char* out;            // (N,) bool
  long long n;
  long long n_elems;
};

// The root of x's set, each node passed on the way pointed at its
// grandparent (path halving). A node that is no root stays no root, so the
// plain store never races a successful CAS.
__device__ int find_root(int* parent, int x) {
  while (true) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    const int g = __ldcg(parent + p);
    if (g == p) return p;
    parent[x] = g;
    x = g;
  }
}

// The root of x's set where no thread stores a pointer any more.
__device__ int fixed_root(const int* parent, int x) {
  int p;
  while ((p = __ldcg(parent + x)) != x) x = p;
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  a = find_root(parent, a);
  b = find_root(parent, b);
  while (a != b) {
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int seen = atomicCAS(parent + b, b, a);
    if (seen == b) return;
    b = find_root(parent, seen);
  }
}

__global__ void __launch_bounds__(THREADS)
    anchored_kernel(AnchoredArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * THREADS;
  const long long t0 = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (long long i = t0; i < a.n; i += stride) {
    a.parent[i] = (int)i;
    a.flag[i] = 0;
  }
  grid.sync();
  for (long long e = t0; e < a.n_elems; e += stride)
    if (a.active[e])
      unite(a.parent, (int)a.conn[2 * e], (int)a.conn[2 * e + 1]);
  grid.sync();
  for (long long i = t0; i < a.n; i += stride)
    a.parent[i] = find_root(a.parent, (int)i);
  grid.sync();
  for (long long i = t0; i < a.n; i += stride)
    if (a.grip[i]) a.flag[fixed_root(a.parent, (int)i)] = 1;
  grid.sync();
  for (long long i = t0; i < a.n; i += stride)
    a.out[i] = __ldcg(a.flag + fixed_root(a.parent, (int)i));
}

}  // namespace

// Blocks of the kernel that fit one SM at once, and the card's SMs: the
// cooperative grid may not exceed their product.
extern "C" int anchored_grid_blocks(int* per_sm, int* sms) {
  int dev = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, anchored_kernel,
                                                    THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (*per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  return 0;
}

// One refresh: conn (E, 2) int64, active (E,) bool, grip (N,) bool,
// the scratch parent (N,) int32 and flag (N,) uint8, out (N,) bool; `grid`
// blocks of THREADS, at most anchored_grid_blocks' product.
extern "C" int anchored_mask(const void* conn, const void* active,
                             const void* grip, void* parent, void* flag,
                             void* out, long long n, long long n_elems,
                             int grid, cudaStream_t stream) {
  if (n < 1 || n > 0x7fffffffLL || n_elems < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  AnchoredArgs a;
  a.conn = (const long long*)conn;
  a.active = (const unsigned char*)active;
  a.grip = (const unsigned char*)grip;
  a.parent = (int*)parent;
  a.flag = (unsigned char*)flag;
  a.out = (unsigned char*)out;
  a.n = n;
  a.n_elems = n_elems;
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)anchored_kernel, dim3((unsigned)grid), dim3(THREADS),
      args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
