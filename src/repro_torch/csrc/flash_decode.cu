// K4: flash decode, one query token against a KV cache, float32.
// out[b, h] = softmax_j(q[b, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the cache positions j < min(cache_len, S), G = H / KV.
//
// Replaces: src/repro/kernels/flash_decode.py, flash_decode (kernel body
// _flash_decode_kernel).
//
// Bound: every valid cache row is read once and used for G query heads,
// about 1 flop per byte, so the kernel is bound by device-memory bytes:
// the granite-3-2b decode shape (B = 8, KV = 8, hd = 64, 32768 cached
// positions) streams 1.07 GB of K and V.
//
// Design: one block of 256 threads per (kv head, batch row) covers the
// kv head's G query heads, so each cache row is read from device memory
// once. The block walks the cache in tiles (256 rows for hd <= 64, fewer
// for wider heads), staged in shared memory with coalesced loads; each
// thread scores whole (head, row) pairs, one warp per head folds the
// tile into the running max and denominator, and each thread keeps up to
// 8 of the G x hd output accumulators in registers. The length is read on
// the device (or passed by value), so a decode loop needs no host sync
// per token; rows at or past it are never read. The masked-score fill is
// -1e30 and the denominator is clamped at 1e-30, as in the TPU kernel.
// One block per (kv head, batch row) leaves most SMs idle at small
// B * KV: splitting the cache across blocks with a combine pass is the
// next step for this kernel. hd is a template parameter (8 .. 256).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxOut = 8;             // G * hd <= kThreads * kMaxOut
constexpr float kNegInf = -1e30f;

// cache rows per tile: 256 for hd <= 64, fewer for wider heads
template <int HD>
struct Tile {
  static constexpr int kRows = HD <= 64 ? 256 : (HD == 128 ? 128 : 64);
};

template <int HD>
int smem_bytes(int G) {
  constexpr int BS = Tile<HD>::kRows;
  return static_cast<int>(sizeof(float)) *
         (BS * (HD + 1) + BS * HD + G * BS + G * HD + 3 * G);
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ len_ptr,
                    int len_val, float* __restrict__ out, int S, int H,
                    int KV) {
  constexpr int BS = Tile<HD>::kRows;
  const int G = H / KV;
  extern __shared__ float smem[];
  float* ks = smem;                    // [BS][HD + 1]
  float* vs = ks + BS * (HD + 1);      // [BS][HD]
  float* ps = vs + BS * HD;            // [G][BS] scores, then p
  float* qs = ps + G * BS;             // [G][HD]
  float* mrun = qs + G * HD;           // [G] running max
  float* lrun = mrun + G;              // [G] running denominator
  float* crr = lrun + G;               // [G] this tile's correction

  const int kvh = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  int len = len_ptr != nullptr ? *len_ptr : len_val;
  len = len < 0 ? 0 : (len > S ? S : len);

  // query heads kvh * G .. kvh * G + G - 1 are contiguous in q[b]
  const float* qb = q + (static_cast<long long>(b) * H +
                         static_cast<long long>(kvh) * G) * HD;
  for (int i = tid; i < G * HD; i += kThreads) qs[i] = qb[i];
  for (int g = tid; g < G; g += kThreads) {
    mrun[g] = kNegInf;
    lrun[g] = 0.f;
  }
  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.f;

  const long long row = static_cast<long long>(KV) * HD;
  const float* kb = k + static_cast<long long>(b) * S * row +
                    static_cast<long long>(kvh) * HD;
  const float* vb = v + static_cast<long long>(b) * S * row +
                    static_cast<long long>(kvh) * HD;

  for (int s0 = 0; s0 < len; s0 += BS) {
    __syncthreads();     // the previous tile is consumed; q is staged
    for (int i = tid; i < BS * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int pos = s0 + c;
      const bool ok = pos < len;
      ks[c * (HD + 1) + d] = ok ? kb[pos * row + d] : 0.f;
      vs[c * HD + d] = ok ? vb[pos * row + d] : 0.f;
    }
    __syncthreads();

    for (int i = tid; i < G * BS; i += kThreads) {
      const int g = i / BS, c = i % BS;
      const float* qg = qs + g * HD;
      const float* kc = ks + c * (HD + 1);
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) dot = fmaf(qg[d], kc[d], dot);
      ps[g * BS + c] = s0 + c < len ? dot / sqrt_hd : kNegInf;
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* pg = ps + g * BS;
      float mx = kNegInf;
      for (int c = lane; c < BS; c += 32) mx = fmaxf(mx, pg[c]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = mrun[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < BS; c += 32) {
        const float p = s0 + c < len ? expf(pg[c] - m_new) : 0.f;
        pg[c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        crr[g] = corr;
        lrun[g] = lrun[g] * corr + sum;
        mrun[g] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * kThreads;
      if (o < G * HD) {
        const int g = o / HD, d = o % HD;
        const float* pg = ps + g * BS;
        float a = acc[j] * crr[g];
#pragma unroll 8
        for (int c = 0; c < BS; ++c) a = fmaf(pg[c], vs[c * HD + d], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

  float* ob = out + (static_cast<long long>(b) * H +
                     static_cast<long long>(kvh) * G) * HD;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * kThreads;
    if (o < G * HD) ob[o] = acc[j] / fmaxf(lrun[o / HD], 1e-30f);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* len_ptr,
           int len_val, float* out, int B, int S, int H, int KV,
           cudaStream_t stream) {
  const int bytes = smem_bytes<HD>(H / KV);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  flash_decode_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, len_ptr, len_val, out, S, H, KV);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, H, hd], k/v [B, S, KV, hd], out [B, H, hd], all contiguous on the
// device; H a multiple of KV and (H / KV) * hd <= 2048. The cache length is
// *len_ptr (a device int32) when len_ptr is not null, else len_val; it is
// clamped to [0, S]. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                const int* len_ptr, int len_val, float* out,
                                int B, int S, int H, int KV, int hd,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    case 16: return launch<16>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    case 32: return launch<32>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    case 64: return launch<64>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    case 128:
      return launch<128>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    case 256:
      return launch<256>(q, k, v, len_ptr, len_val, out, B, S, H, KV, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
