// K1: clustered federated aggregation, out[S, D] = W[S, K] @ theta[K, D],
// all float32.
//
// Replaces: src/repro/kernels/weighted_agg.py, clustered_agg_flat (kernel
// body _clustered_agg_kernel; weighted_agg_flat is its S = 1 case).
//
// Bound: device-memory bytes. Each column of D costs 2 * S * K flops
// against (K + S) * 4 bytes moved: under 3 flops per byte at K = 8,
// S = 16, far below the ~20 flops per byte at which float32 FMA
// throughput would bind an H100. At the main path's clustered round the
// S * D writes outweigh the K * D reads.
//
// Design: a 1-D grid over column tiles of D. The whole weight matrix is
// staged in shared memory once per block (S * K floats). Each thread owns
// VEC consecutive columns (a float4 when D is a multiple of 4, so
// neighbouring threads read and write neighbouring 16-byte words), walks
// the K rows of theta once per chunk of kRowChunk output rows, and keeps
// that chunk's sums in registers (FP32 FMAs). The ragged tail of D is
// masked in the kernel; nothing is padded on the host. For S above
// kRowChunk the block's theta tile is read again from L1/L2, not device
// memory.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 16;

template <int VEC>
__global__ void __launch_bounds__(kThreads)
clustered_agg_kernel(const float* __restrict__ w,
                     const float* __restrict__ theta,
                     float* __restrict__ out, int S, int K, long long D) {
  extern __shared__ float w_sh[];  // [S * K], row-major like W
  for (int i = threadIdx.x; i < S * K; i += blockDim.x) w_sh[i] = w[i];
  __syncthreads();

  const long long col =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (col >= D) return;

  for (int s0 = 0; s0 < S; s0 += kRowChunk) {
    float acc[kRowChunk][VEC];
#pragma unroll
    for (int j = 0; j < kRowChunk; ++j)
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[j][v] = 0.f;

    for (int k = 0; k < K; ++k) {
      float t[VEC];
      const float* src = theta + static_cast<long long>(k) * D + col;
      if constexpr (VEC == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src));
        t[0] = q.x; t[1] = q.y; t[2] = q.z; t[3] = q.w;
      } else {
        t[0] = __ldg(src);
      }
#pragma unroll
      for (int j = 0; j < kRowChunk; ++j) {
        const float wk = (s0 + j < S) ? w_sh[(s0 + j) * K + k] : 0.f;
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[j][v] = fmaf(wk, t[v], acc[j][v]);
      }
    }

#pragma unroll
    for (int j = 0; j < kRowChunk; ++j) {
      if (s0 + j >= S) break;
      float* dst = out + static_cast<long long>(s0 + j) * D + col;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
      } else {
        *dst = acc[j][0];
      }
    }
  }
}

template <int VEC>
int launch(const float* w, const float* theta, float* out, int S, int K,
           long long D, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * K * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        clustered_agg_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const long long per_block = static_cast<long long>(kThreads) * VEC;
  const unsigned blocks = static_cast<unsigned>((D + per_block - 1) / per_block);
  clustered_agg_kernel<VEC><<<blocks, kThreads, smem, stream>>>(
      w, theta, out, S, K, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). vec4 != 0
// requires D % 4 == 0 and 16-byte aligned theta/out rows.
extern "C" int clustered_agg_f32(const float* w, const float* theta,
                                 float* out, int S, int K, long long D,
                                 int vec4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec4 ? launch<4>(w, theta, out, S, K, D, s)
              : launch<1>(w, theta, out, S, K, D, s);
}
