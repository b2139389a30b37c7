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
// positions) streams 1.07 GB of K and V, 0.32 ms at 3.35 TB/s.
//
// Design (flash-decoding): the grid is (n_splits x head chunks, KV, B).
// Block (i, kvh, b) reads the length on the device and takes split i of
// [0, len): rows [i * ceil(len / n), min((i + 1) * ceil(len / n), len)),
// so the split is balanced for any length, including one the host never
// reads. The wrapper picks n_splits from S, B * KV and the SM count
// (decode_splits), so even B * KV = 8 fills the card.
// Inside a block each of the 4 warps streams its own rows through a
// private 4-stage cp.async ring in shared memory: a row of hd floats is
// read by hd / 4 neighbouring lanes as 16-byte copies (two per lane at
// hd = 256), several rows per warp, and each lane reads back only the
// bytes it copied itself, so cp.async.wait_group alone orders the ring
// and the loop has no barrier. Three stages are in flight while one is
// scored: 48 KB per block, ~144 KB per SM. The lane keeps its columns of
// the block's query heads (the group size G rounded up to 1, 2, 4 or 8,
// at most 4 at hd = 256; larger groups take several head chunks in the
// grid) and their output accumulators in registers, scores a row with
// register FMAs and a shuffle reduction over the row's lanes, and folds
// U rows at a time into the running max and denominator (in the log2
// domain, exp2f). The lanes of different rows and the 4 warps merge once,
// at the end of the split.
// Combine: with one split the block writes the output. Otherwise each
// split writes (m, l, acc[heads, hd]) to a float32 workspace; the block
// that draws the last ticket of its (b, kvh) counter (atomicAdd after a
// __threadfence) combines the splits in the same launch,
// out = sum_i acc_i 2^(m_i - M) / max(sum_i l_i 2^(m_i - M), 1e-30), and
// resets the counter to 0, so no memset is launched per call. Calls
// queued on one stream run one after another and may share the counters;
// calls on two streams at once need two sets (the wrapper keeps one per
// stream). An empty split writes m = -1e30, l = 0, so cache_len = 0 gives
// zeros, as in the TPU kernel. Rows at or past the length are never read:
// their copies are zero-filled with a source size of 0.
// hd is a template parameter (8 .. 256).
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 4;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int LPR = HD / 4 < 32 ? HD / 4 : 32;  // lanes per row
  static constexpr int C = HD / LPR;      // floats per lane and row: 4 or 8
  static constexpr int RPW = 32 / LPR;    // rows per warp step
  static constexpr int U = 16 / C;        // warp steps per stage
  static constexpr int ROWS = RPW * U;    // rows per warp and stage
  static constexpr int NV = U * C / 4;    // float4 of K (and of V) per lane
  static constexpr int GMAX = 32 / C;     // most query heads per block
  static constexpr int SLOT = 2 * NV * 32;  // float4 per warp and stage
};

constexpr int ring_bytes() {
  return kWarps * kStages * 2 * 4 * 32 * 16;  // NV = 4 for every hd
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int HD, int GH>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const int* __restrict__ len_ptr,
                    int len_val, float* __restrict__ out,
                    float* __restrict__ ws, int* __restrict__ counters, int S,
                    int H, int KV, int n_splits) {
  using Cf = Cfg<HD>;
  constexpr int LPR = Cf::LPR, C = Cf::C, RPW = Cf::RPW, U = Cf::U;
  constexpr int NV = Cf::NV;
  extern __shared__ float4 ring[];
  __shared__ int last_ticket;

  const int split = blockIdx.x % n_splits, hc = blockIdx.x / n_splits;
  const int n_hc = gridDim.x / n_splits;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV, g0 = hc * GH;
  const int ng = min(GH, G - g0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = lane / LPR, sub = lane % LPR;

  int len = len_ptr != nullptr ? *len_ptr : len_val;
  len = len < 0 ? 0 : (len > S ? S : len);
  const int per = (len + n_splits - 1) / n_splits;
  const int r0 = min(split * per, len), r1 = min(r0 + per, len);

  // this lane's columns of the block's query heads, scaled so that the
  // scores come out in the log2 domain
  const float scale = kLog2e / sqrtf(static_cast<float>(HD));
  const float* qb = q + (static_cast<long long>(b) * H + kvh * G + g0) * HD +
                    sub * C;
  float qr[GH][C], acc[GH][C], m[GH], l[GH];
#pragma unroll
  for (int g = 0; g < GH; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      qr[g][c] = g < ng ? qb[g * HD + c] * scale : 0.f;
      acc[g][c] = 0.f;
    }
  }

  const long long row = static_cast<long long>(KV) * HD;
  const float* kb = k + static_cast<long long>(b) * S * row + kvh * HD +
                    sub * C;
  const float* vb = v + static_cast<long long>(b) * S * row + kvh * HD +
                    sub * C;
  float4* wring = ring + warp * kStages * Cf::SLOT;
  const int n_iter = (r1 - r0 + kWarps * Cf::ROWS - 1) / (kWarps * Cf::ROWS);

  // stage `it`: this warp's rows r0 + (it * kWarps + warp) * ROWS + ...
  auto issue = [&](int it) {
    float4* slot = wring + (it % kStages) * Cf::SLOT;
    const int base = r0 + (it * kWarps + warp) * Cf::ROWS + grp;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = base + u * RPW;
      const bool ok = r < r1;
      const long long off = ok ? r * row : 0;
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const int j = (u * (C / 4) + c4) * 32 + lane;
        cp16(slot + j, kb + off + 4 * c4, ok);
        cp16(slot + NV * 32 + j, vb + off + 4 * c4, ok);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < n_iter; ++it) {
    issue(it + kStages - 1);
    cp_wait<kStages - 1>();
    const float4* slot = wring + (it % kStages) * Cf::SLOT;
    const int base = r0 + (it * kWarps + warp) * Cf::ROWS + grp;

    float s[U][GH];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kk[C];
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 x = slot[(u * (C / 4) + c4) * 32 + lane];
        kk[4 * c4] = x.x;
        kk[4 * c4 + 1] = x.y;
        kk[4 * c4 + 2] = x.z;
        kk[4 * c4 + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) d = fmaf(qr[g][c], kk[c], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int g = 0; g < GH; ++g)
          if (g < ng) s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);

    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) ok[u] = base + u * RPW < r1;
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      if (g >= ng) continue;
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = ok[u] ? fmaxf(mx, s[u][g]) : mx;
      const float corr = exp2f(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[g][c] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) s[u][g] = ok[u] ? exp2f(s[u][g] - mx) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vv[C];
#pragma unroll
      for (int c4 = 0; c4 < C / 4; ++c4) {
        const float4 x = slot[NV * 32 + (u * (C / 4) + c4) * 32 + lane];
        vv[4 * c4] = x.x;
        vv[4 * c4 + 1] = x.y;
        vv[4 * c4 + 2] = x.z;
        vv[4 * c4 + 3] = x.w;
      }
#pragma unroll
      for (int g = 0; g < GH; ++g) {
        l[g] += s[u][g];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[g][c] = fmaf(s[u][g], vv[c], acc[g][c]);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // merge the row groups of the warp, then the warps of the block
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      if (g >= ng) continue;
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float ca = exp2f(m[g] - mm), cb = exp2f(mo - mm);
      m[g] = mm;
      l[g] = l[g] * ca + lo * cb;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][c], off);
        acc[g][c] = acc[g][c] * ca + ao * cb;
      }
    }
  }
  __syncthreads();     // every warp is done with the ring
  float* red_m = reinterpret_cast<float*>(ring);     // [kWarps][GH]
  float* red_l = red_m + kWarps * GH;                // [kWarps][GH]
  float* red_acc = red_l + kWarps * GH;              // [kWarps][GH][HD]
  if (grp == 0) {
#pragma unroll
    for (int g = 0; g < GH; ++g) {
      if (g >= ng) continue;
      if (sub == 0) {
        red_m[warp * GH + g] = m[g];
        red_l[warp * GH + g] = l[g];
      }
#pragma unroll
      for (int c = 0; c < C; ++c)
        red_acc[(warp * GH + g) * HD + sub * C + c] = acc[g][c];
    }
  }
  __syncthreads();

  const int bk = b * KV + kvh;
  const long long part = static_cast<long long>(bk) * n_splits + split;
  const long long n_part = static_cast<long long>(gridDim.z) * KV * n_splits;
  float* ws_m = ws;                       // [B * KV][n_splits][G]
  float* ws_l = ws + n_part * G;          // [B * KV][n_splits][G]
  float* ws_acc = ws + 2 * n_part * G;    // [B * KV][n_splits][G][HD]
  for (int o = tid; o < ng * HD; o += kThreads) {
    const int g = o / HD, d = o % HD;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_m[w * GH + g]);
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = exp2f(red_m[w * GH + g] - mm);
      ls = fmaf(red_l[w * GH + g], c, ls);
      a = fmaf(red_acc[(w * GH + g) * HD + d], c, a);
    }
    if (n_splits == 1) {
      out[(static_cast<long long>(b) * H + kvh * G + g0 + g) * HD + d] =
          a / fmaxf(ls, 1e-30f);
    } else {
      ws_acc[(part * G + g0 + g) * HD + d] = a;
      if (d == 0) {
        ws_m[part * G + g0 + g] = mm;
        ws_l[part * G + g0 + g] = ls;
      }
    }
  }
  if (n_splits == 1) return;

  // the last block of this (b, kvh) to finish combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_ticket = atomicAdd(&counters[bk], 1) == n_splits * n_hc - 1;
  __syncthreads();
  if (!last_ticket) return;
  __threadfence();
  const long long p0 = static_cast<long long>(bk) * n_splits;
  for (int o = tid; o < G * HD; o += kThreads) {
    const int g = o / HD, d = o % HD;
    float mm = kNegInf;
    for (int i = 0; i < n_splits; ++i)
      mm = fmaxf(mm, __ldcg(ws_m + (p0 + i) * G + g));
    float ls = 0.f, a = 0.f;
    for (int i = 0; i < n_splits; ++i) {
      const float c = exp2f(__ldcg(ws_m + (p0 + i) * G + g) - mm);
      ls = fmaf(__ldcg(ws_l + (p0 + i) * G + g), c, ls);
      a = fmaf(__ldcg(ws_acc + ((p0 + i) * G + g) * HD + d), c, a);
    }
    out[(static_cast<long long>(b) * H + kvh * G + g) * HD + d] =
        a / fmaxf(ls, 1e-30f);
  }
  if (tid == 0) counters[bk] = 0;
}

template <int HD, int GH>
int launch_g(const float* q, const float* k, const float* v,
             const int* len_ptr, int len_val, float* out, float* ws,
             int* counters, int B, int S, int H, int KV, int n_splits,
             cudaStream_t stream) {
  constexpr int bytes = ring_bytes();
  // the shared-memory attribute is set once per device (it is per device)
  static thread_local int attr_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != attr_dev) {
    err = cudaFuncSetAttribute(flash_decode_kernel<HD, GH>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_dev = dev;
  }
  const int n_hc = (H / KV + GH - 1) / GH;
  const dim3 grid(n_splits * n_hc, KV, B);
  flash_decode_kernel<HD, GH><<<grid, kThreads, bytes, stream>>>(
      q, k, v, len_ptr, len_val, out, ws, counters, S, H, KV, n_splits);
  return static_cast<int>(cudaGetLastError());
}

// the block's head count: the group size G rounded up to a power of two,
// at most GMAX (larger groups take several head chunks)
template <int HD>
int launch(const float* q, const float* k, const float* v, const int* len_ptr,
           int len_val, float* out, float* ws, int* counters, int B, int S,
           int H, int KV, int n_splits, cudaStream_t stream) {
  const int G = H / KV;
#define FD_LAUNCH(GH)                                                   \
  return launch_g<HD, GH>(q, k, v, len_ptr, len_val, out, ws, counters, \
                          B, S, H, KV, n_splits, stream)
  if (G <= 1) FD_LAUNCH(1);
  if (G <= 2) FD_LAUNCH(2);
  if constexpr (Cfg<HD>::GMAX == 8) {
    if (G > 4) FD_LAUNCH(8);
  }
  FD_LAUNCH(4);
#undef FD_LAUNCH
}

}  // namespace

// q [B, H, hd], k/v [B, S, KV, hd], out [B, H, hd], all contiguous on the
// device; H a multiple of KV. The cache length is *len_ptr (a device int32)
// when len_ptr is not null, else len_val; it is clamped to [0, S]. With
// n_splits > 1, ws holds (2 + hd) * B * KV * n_splits * H / KV floats and
// counters B * KV ints that are 0 on entry (and are 0 again on exit).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_decode_f32(const float* q, const float* k, const float* v,
                                const int* len_ptr, int len_val, float* out,
                                float* ws, int* counters, int B, int S, int H,
                                int KV, int hd, int n_splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_splits < 1) return static_cast<int>(cudaErrorInvalidValue);
#define FD_CASE(D)                                                       \
  case D:                                                                \
    return launch<D>(q, k, v, len_ptr, len_val, out, ws, counters, B, S, \
                     H, KV, n_splits, st);
  switch (hd) {
    FD_CASE(8)
    FD_CASE(16)
    FD_CASE(32)
    FD_CASE(64)
    FD_CASE(128)
    FD_CASE(256)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FD_CASE
}
