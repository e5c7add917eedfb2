// K2: connected-component labels of Go boards, one thread block per board.
//
// Replaces katago_tpu/ops/labels_pallas.py::connected_labels_batch (body
// _labels_kernel). For each point: the smallest flat index reachable through
// 4-connected points holding the same value (stone chains and empty regions
// alike).
//
// Bound on an H100: a [128, 361] int32 call reads 185 KB and writes 185 KB,
// about 0.1 us of HBM time, so the kernel is bound by launch latency and by
// the rounds of its dependent loop, not by bytes or operations. The design
// keeps the whole board in shared memory for the entire solve (one global
// read and one global write per point) and runs min-propagation plus a
// pointer jump (lab = lab[lab]) until a round changes nothing
// (__syncthreads_or), which makes the result exact by construction where the
// TPU kernel ran a fixed, heuristic 2*ceil(log2 NN)+4 rounds.
//
// Updates are in place and monotone: every label is always the index of a
// point of the same component and never increases, so a read that races a
// neighbour's write sees either value, both valid; a round in which no
// thread wrote anything saw only final values, hence is a fixpoint, and a
// fixpoint of min-propagation + jump is the component minimum.

#include <cuda_runtime.h>

__global__ void labels_kernel(const int* __restrict__ values,
                              int* __restrict__ labels, int size) {
  extern __shared__ int sh[];
  const int nn = size * size;
  int* val = sh;
  volatile int* lab = sh + nn;
  const int p = threadIdx.x;
  const bool on = p < nn;
  const long base = (long)blockIdx.x * nn;
  int v = 0;
  if (on) {
    v = values[base + p];
    val[p] = v;
    lab[p] = p;
  }
  __syncthreads();
  const int x = on ? p % size : 0;
  const int y = on ? p / size : 0;
  const bool n_down = on && y + 1 < size && val[p + size] == v;
  const bool n_up = on && y > 0 && val[p - size] == v;
  const bool n_right = on && x + 1 < size && val[p + 1] == v;
  const bool n_left = on && x > 0 && val[p - 1] == v;
  while (true) {
    int changed = 0;
    if (on) {
      int cur = lab[p];
      int m = cur;
      if (n_down) m = min(m, lab[p + size]);
      if (n_up) m = min(m, lab[p - size]);
      if (n_right) m = min(m, lab[p + 1]);
      if (n_left) m = min(m, lab[p - 1]);
      if (m < cur) {
        lab[p] = m;
        changed = 1;
      }
    }
    __syncthreads();
    if (on) {
      int l = lab[p];
      int j = lab[l];
      if (j < l) {
        lab[p] = j;
        changed = 1;
      }
    }
    if (!__syncthreads_or(changed)) break;
  }
  if (on) labels[base + p] = lab[p];
}

extern "C" int connected_labels_launch(const void* values, void* labels,
                                       int g, int size, void* stream) {
  const int nn = size * size;
  const int threads = ((nn + 31) / 32) * 32;
  const size_t shmem = 2 * (size_t)nn * sizeof(int);
  labels_kernel<<<g, threads, shmem, (cudaStream_t)stream>>>(
      (const int*)values, (int*)labels, size);
  return (int)cudaGetLastError();
}
