// K2: k-means nearest-centre assignment,
// labels[n] = argmin_m (-2 x[n] . c[m] + |c[m]|^2), int32, float32 inputs.
// The |x[n]|^2 term is constant under the argmin and dropped; ties go to
// the lowest index, as jnp.argmin does.
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign (kernel
// body _kmeans_kernel).
//
// Bound: at the trainer's shapes (N = 8 clients, D = 6272, M <= 6
// centres) the function moves about 0.4 MB, a fraction of a microsecond
// of device-memory time, so one launch costs far more than the work: the
// kernel is launch-bound and the Lloyd loop around it pays one launch per
// iteration.
//
// Design: one block per row of x. Every thread strides over D, keeping
// the partial dot products x . c[m] and squared norms |c[m]|^2 of a chunk
// of kMChunk centres in registers; a warp-shuffle reduction, then one
// across warps through shared memory, gives the block's totals, and
// thread 0 keeps the running argmin with a strict '<'. Centres are read
// straight from device memory: each block reads each centre element
// once, and the N blocks share them through L2, so staging them in
// shared memory would buy nothing at these shapes. Duplicated centres
// reduce in the same order and produce bit-identical scores, so exact
// ties resolve to the lower index.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMChunk = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ labels, int M, int D) {
  __shared__ float red[2 * kMChunk][kWarps];
  const float* xr = x + static_cast<long long>(blockIdx.x) * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float best = 0.f;
  int best_m = 0;

  for (int m0 = 0; m0 < M; m0 += kMChunk) {
    float dot[kMChunk], cc[kMChunk];
#pragma unroll
    for (int j = 0; j < kMChunk; ++j) dot[j] = cc[j] = 0.f;
    for (int d = threadIdx.x; d < D; d += kThreads) {
      const float xv = __ldg(xr + d);
#pragma unroll
      for (int j = 0; j < kMChunk; ++j) {
        if (m0 + j < M) {
          const float cv = __ldg(c + static_cast<long long>(m0 + j) * D + d);
          dot[j] = fmaf(xv, cv, dot[j]);
          cc[j] = fmaf(cv, cv, cc[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMChunk; ++j) {
      const float ds = warp_sum(dot[j]), cs = warp_sum(cc[j]);
      if (lane == 0) {
        red[j][warp] = ds;
        red[kMChunk + j][warp] = cs;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int j = 0; j < kMChunk && m0 + j < M; ++j) {
        float ds = 0.f, cs = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          ds += red[j][w];
          cs += red[kMChunk + j][w];
        }
        const float score = -2.f * ds + cs;
        if (m0 + j == 0 || score < best) {
          best = score;
          best_m = m0 + j;
        }
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) labels[blockIdx.x] = best_m;
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int* labels,
                                 int N, int M, int D, void* stream) {
  kmeans_assign_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, c, labels, M, D);
  return static_cast<int>(cudaGetLastError());
}
