// K3: memory-efficient (flash-style) prefill attention, float32.
// out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the keys j < lens[b] (and j <= i when causal), G = H / KV.
//
// Replaces: src/repro/kernels/mem_attention.py, mem_attention (kernel body
// _mem_attention_kernel).
//
// Bound: at the shapes served (S in the thousands) the work is
// 4 * hd * (valid query-key pairs) * H flops against reading q, k, v and
// writing out once, so the kernel is bound by float32 operations: the
// granite-3-2b attention shape (S = 4096, H = 32, hd = 64, causal) is
// about 69 GFLOP against 84 MB.
//
// Design: one block of 256 threads per (64-row query tile, head, batch
// row). The query tile stays in shared memory; the block walks the key
// axis in 64-row tiles, staging K and V in shared memory, and keeps the
// online-softmax state (running max, denominator, output accumulator) in
// registers: each thread owns 4 query rows x 4 key columns of the score
// tile and 4 query rows x hd/16 output columns, and the 16 threads of a
// half-warp that share a row reduce its max and sum with shuffles. The
// [S, S] scores never exist. Key tiles that lie wholly past the row's
// length, or wholly above the causal diagonal, are skipped: they would
// add p = 0 with a correction of 1, so skipping is exact. Keys at or past
// the length are never read (their rows stage as zeros), so nothing in
// the masked part of the cache can reach a valid row. The masked-score
// fill is -1e30, not -inf, and the denominator is clamped at 1e-30, as
// in the TPU kernel: a row with no valid key gives zeros, not NaN.
// hd is a template parameter (8 .. 256). Shared memory exceeds 48 KB for
// hd >= 32 and is requested through the dynamic shared-memory attribute.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // key rows per tile
constexpr float kNegInf = -1e30f;

template <int HD>
constexpr int smem_bytes() {
  return static_cast<int>(sizeof(float)) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
mem_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ out, int S, int H, int KV,
                     int causal) {
  constexpr int DC = (HD + 15) / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);     // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);     // [kBK][HD]
  float* ps = vs + kBK * HD;           // [kBQ][kBK + 1]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const float sqrt_hd = sqrtf(static_cast<float>(HD));
  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const float* qb = q + static_cast<long long>(b) * S * q_row +
                    static_cast<long long>(h) * HD;
  const float* kb = k + static_cast<long long>(b) * S * kv_row +
                    static_cast<long long>(kvh) * HD;
  const float* vb = v + static_cast<long long>(b) * S * kv_row +
                    static_cast<long long>(kvh) * HD;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int qpos = q0 + r;
    qs[r * (HD + 1) + d] = qpos < S ? qb[qpos * q_row + d] : 0.f;
  }

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // keys past the length, or past the tile's last row when causal, are
  // masked for every row of this block
  const int k_end = causal ? min(len, q0 + kBQ) : len;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();     // the previous tile is consumed; q is staged
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int c = i / HD, d = i % HD;
      const int kpos = k0 + c;
      const bool ok = kpos < len;
      ks[c * (HD + 1) + d] = ok ? kb[kpos * kv_row + d] : 0.f;
      vs[c * HD + d] = ok ? vb[kpos * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (HD + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < len && (!causal || kpos <= qpos);
        s[i][j] = ok[j] ? s[i][j] / sqrt_hd : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * (kBK + 1) + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) {
        const int d = tx + 16 * j;
        if (d < HD) {
          const float vv = vs[c * HD + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

  float* ob = out + static_cast<long long>(b) * S * q_row +
              static_cast<long long>(h) * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DC; ++j) {
      const int d = tx + 16 * j;
      if (d < HD) ob[qpos * q_row + d] = acc[i][j] / denom;
    }
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* lens,
           float* out, int B, int S, int H, int KV, int causal,
           cudaStream_t stream) {
  constexpr int bytes = smem_bytes<HD>();
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mem_attention_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  mem_attention_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      q, k, v, lens, out, S, H, KV, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, hd], k/v [B, S, KV, hd], lens [B] int32, out [B, S, H, hd],
// all contiguous on the device; H a multiple of KV. Returns the CUDA error
// code of the launch (0 on success).
extern "C" int mem_attention_f32(const float* q, const float* k,
                                 const float* v, const int* lens, float* out,
                                 int B, int S, int H, int KV, int hd,
                                 int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8: return launch<8>(q, k, v, lens, out, B, S, H, KV, causal, st);
    case 16: return launch<16>(q, k, v, lens, out, B, S, H, KV, causal, st);
    case 32: return launch<32>(q, k, v, lens, out, B, S, H, KV, causal, st);
    case 64: return launch<64>(q, k, v, lens, out, B, S, H, KV, causal, st);
    case 128: return launch<128>(q, k, v, lens, out, B, S, H, KV, causal, st);
    case 256: return launch<256>(q, k, v, lens, out, B, S, H, KV, causal, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
