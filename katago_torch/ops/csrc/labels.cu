// K2: connected-component labels of Go boards, one thread block per board.
//
// Replaces katago_tpu/ops/labels_pallas.py::connected_labels_batch (body
// _labels_kernel). For each point: the smallest flat index reachable through
// 4-connected points holding the same value (stone chains and empty regions
// alike).
//
// Bound on an H100: a [128, 361] int32 call reads 185 KB and writes 185 KB,
// about 0.1 us of HBM time, so the kernel is bound by latency: the launch,
// one global read and one global write per point, and whatever chain of
// dependent shared-memory steps the labelling needs in between. A
// label-propagation loop (the first design) needs block-wide rounds that grow
// with the longest path inside a component, which a spiral or a serpentine
// makes hundreds of points long.
//
// This design is block-based union-find in shared memory (Playne & Hawick
// 2018; Allegretti et al. 2019), with a fixed three block barriers whatever
// the board's shape:
//   1. every point reads its value;
//   2. every point points at the start of its horizontal run of equal
//      values (a walk of at most size - 1 shared loads), so each run is a
//      one-level tree rooted at its smallest index before any union;
//   3. every point whose lower neighbour holds the same value unites the
//      two trees (skipped where the left neighbours already join the same
//      two runs): find both roots, atomicMin the larger root's parent
//      towards the smaller root, retried from the returned parent until it
//      holds;
//   4. every point writes its root.
// Linking always to the smaller root makes each root its component's
// smallest flat index, the label asked for. Finds halve their path as they
// walk (each visited node is pointed at its grandparent), which keeps the
// trees shallow while they grow.
//
// Why the concurrent steps are safe: a node's parent is always a smaller
// index of the same component, so every walk ends at a root. A halving store
// only ever points a non-root at one of its ancestors, which keeps it in its
// tree, and a non-root never becomes a root again. An atomicMin that lands on
// a node another thread linked first returns that node's parent (not the
// node); the union then retries from that parent, so a's old tree and b's
// still merge and no link is lost (Playne & Hawick's argument).

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int find_root(volatile int* parent, int p) {
  while (true) {
    const int q = parent[p];
    if (q == p) return p;
    const int r = parent[q];
    if (r == q) return q;
    parent[p] = r;  // path halving
    p = r;
  }
}

__device__ __forceinline__ void unite(int* parent, int a, int b) {
  volatile int* vp = parent;
  while (true) {
    a = find_root(vp, a);
    b = find_root(vp, b);
    if (a == b) return;
    if (a < b) {
      const int t = a;
      a = b;
      b = t;
    }
    // a is the larger root: link it under b. If another thread linked a
    // first, a now points at min(its new parent, b); retry the union from
    // that parent, so a's old component and b's still merge.
    const int old = atomicMin(&parent[a], b);
    if (old == a) return;
    a = old;
  }
}

__global__ void labels_kernel(const int* __restrict__ values,
                              int* __restrict__ labels, int size) {
  extern __shared__ int sh[];
  const int nn = size * size;
  int* val = sh;
  int* parent = sh + nn;
  const int p = threadIdx.x;
  const bool on = p < nn;
  const long base = (long)blockIdx.x * nn;
  int v = 0;
  if (on) {
    v = values[base + p];
    val[p] = v;
  }
  __syncthreads();
  const int x = on ? p % size : 0;
  if (on) {
    int s = p;
    for (int k = x; k > 0 && val[s - 1] == v; --k) --s;
    parent[p] = s;
  }
  __syncthreads();
  if (on && p + size < nn && val[p + size] == v &&
      !(x > 0 && val[p - 1] == v && val[p + size - 1] == v))
    unite(parent, p, p + size);
  __syncthreads();
  if (on) {
    volatile int* vp = parent;
    const int r = find_root(vp, p);
    vp[p] = r;
    labels[base + p] = r;
  }
}

}  // namespace

extern "C" int connected_labels_launch(const void* values, void* labels,
                                       int g, int size, void* stream) {
  const int nn = size * size;
  const int threads = ((nn + 31) / 32) * 32;
  const size_t shmem = 2 * (size_t)nn * sizeof(int);
  labels_kernel<<<g, threads, shmem, (cudaStream_t)stream>>>(
      (const int*)values, (int*)labels, size);
  return (int)cudaGetLastError();
}
