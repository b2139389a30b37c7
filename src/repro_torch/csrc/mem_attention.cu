// K3: memory-efficient (flash-style) prefill attention, float32.
// out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h / G] / sqrt(hd)) v[b, j, h / G]
// over the keys j < lens[b] (and j <= i when causal), G = H / KV.
//
// Replaces: src/repro/kernels/mem_attention.py, mem_attention (kernel body
// _mem_attention_kernel).
//
// Bound: at the shapes served (S in the thousands) the work is
// 4 * hd * (valid query-key pairs) * H flops against reading q, k, v and
// writing out once, so the kernel is bound by operations: the
// granite-3-2b attention shape (S = 4096, H = 32, hd = 64, causal) is
// about 69 GFLOP against 84 MB, 1.03 ms at the 67 TFLOP/s of float32 FMA.
//
// Design: both products, S = Q K^T and O += P V, run on the tensor cores
// as 3xTF32: each operand x is split once into big = tf32(x) and
// small = tf32(x - big) (cvt.rna), and every k-step issues three
// mma.sync.m16n8k8 TF32 products, small.big + big.small + big.big, into
// float32 accumulators. That keeps about float32 accuracy (the dropped
// small.small term is ~2^-22 relative) at the TF32 rate: 3 x 69 GFLOP at
// 495 TFLOP/s is 0.42 ms.
// One block per (head, 64-row query tile, batch row); each of 4 warps owns
// 16 query rows. Q is split once per block, into registers up to hd 64
// and into shared memory above. K and V tiles of BK rows (64 at
// hd <= 64, 8 above) stream through a 2-stage cp.async
// ring (16-byte copies; keys at or past lens[b] are zero-filled, never
// read); when a tile lands, the block splits it once: big in place, small
// beside it. Rows are padded (Q and K to hd + 8, V to hd + 4 floats),
// which keeps 16-byte alignment and makes every fragment load free of
// bank conflicts. P V of each tile sums in a fresh accumulator and is
// added to O with rounded float32 FMAs. The
// online softmax runs on the score fragments: row max and sum over the 4
// lanes of a quad with shuffles, in the log2 domain (exp2f), with the
// -1e30 fill and the 1e-30 clamp of the TPU kernel (a row with no valid
// key gives zeros). P goes from the accumulator fragment to the A operand
// of the next product without shared memory: the lane holding keys 2t and
// 2t + 1 feeds them as k-indices t and t + 4, and V's fragment rows are
// read in the same order, so the sum over keys is unchanged. Key tiles
// wholly past the length or above the causal diagonal are skipped (exact:
// they would add p = 0 with a correction of 1), and causal calls issue the
// heaviest query tiles (the bottom of the diagonal) first.
// hd is a template parameter (8 .. 256).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int THREADS = 128;                     // 4 warps
  static constexpr int BQ = 64;                           // query rows
  static constexpr int BK = HD <= 64 ? 64 : 8;  // keys
  // Q's split fragments stay in registers (HD of them) up to hd 64, in
  // shared memory above
  static constexpr bool QREG = HD <= 64;
  // Q and K rows: a lane reads dims 2t and 2t + 1 of row g as one 8-byte
  // load, free of bank conflicts for a stride of 8 or 24 mod 32 floats
  static constexpr int STR = HD % 32 == 8 ? HD + 16 : HD + 8;
  // V rows: a lane reads keys 2t and 2t + 1 at dim g, free of conflicts
  // for a stride of 4 mod 8 floats
  static constexpr int STRV = HD + 4;
  // output column tiles that share one fresh per-tile accumulator
  static constexpr int NCH = HD / 8 < 8 ? HD / 8 : 8;
  static constexpr int SMEM_BYTES =
      static_cast<int>(sizeof(float)) *
      ((QREG ? 0 : 2 * BQ * STR) + 3 * BK * (STR + STRV));
};

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small + O(2^-22 x), both parts TF32 values in float32 words
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = tf32(x);
  small = tf32(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32: small.big + big.small + big.big
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0,
                                     uint32_t bs1) {
  mma(d, as, bb0, bb1);
  mma(d, ab, bs0, bs1);
  mma(d, ab, bb0, bb1);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t bits(const float* p) {
  return __float_as_uint(*p);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

// big in place of x, small into *small_out
__device__ __forceinline__ void split4(float* x, float* small_out) {
  float4 a = *reinterpret_cast<float4*>(x);
  uint32_t b0, b1, b2, b3, s0, s1, s2, s3;
  split(a.x, b0, s0);
  split(a.y, b1, s1);
  split(a.z, b2, s2);
  split(a.w, b3, s3);
  *reinterpret_cast<float4*>(x) = make_float4(
      __uint_as_float(b0), __uint_as_float(b1), __uint_as_float(b2),
      __uint_as_float(b3));
  *reinterpret_cast<float4*>(small_out) = make_float4(
      __uint_as_float(s0), __uint_as_float(s1), __uint_as_float(s2),
      __uint_as_float(s3));
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::THREADS)
mem_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const int* __restrict__ lens,
                     float* __restrict__ out, int S, int H, int KV,
                     int causal) {
  using Cf = Cfg<HD>;
  constexpr int BQ = Cf::BQ, BK = Cf::BK, STR = Cf::STR, STRV = Cf::STRV;
  constexpr int NT = Cf::THREADS, NCH = Cf::NCH;
  constexpr int NT_S = BK / 8, NT_O = HD / 8;
  extern __shared__ float4 smem4[];
  constexpr int QS = Cf::QREG ? 0 : BQ * STR;
  float* qbig = reinterpret_cast<float*>(smem4);    // [BQ][STR] or none
  float* qsml = qbig + QS;                          // [BQ][STR] or none
  float* kbuf = qsml + QS;                          // [2][BK][STR]
  float* ksml = kbuf + 2 * BK * STR;                // [BK][STR]
  float* vbuf = ksml + BK * STR;                    // [2][BK][STRV]
  float* vsml = vbuf + 2 * BK * STRV;               // [BK][STRV]

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane >> 2, tig = lane & 3;
  int len = lens[b];
  len = len < 0 ? 0 : (len > S ? S : len);

  const long long q_row = static_cast<long long>(H) * HD;
  const long long kv_row = static_cast<long long>(KV) * HD;
  const float* qb = q + static_cast<long long>(b) * S * q_row + h * HD;
  const float* kb = k + static_cast<long long>(b) * S * kv_row + kvh * HD;
  const float* vb = v + static_cast<long long>(b) * S * kv_row + kvh * HD;

  auto load_kv = [&](int tile, int stage) {
    float* kd = kbuf + stage * BK * STR;
    float* vd = vbuf + stage * BK * STRV;
    for (int i = tid; i < BK * HD / 4; i += NT) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      const int kpos = tile * BK + r;
      const bool ok = kpos < len;
      const long long off = ok ? kpos * kv_row : 0;
      cp16(kd + r * STR + c, kb + off + c, ok);
      cp16(vd + r * STRV + c, vb + off + c, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // keys past the length, or past the tile's last row when causal, are
  // masked for every row of this block
  const int k_end = causal ? min(len, q0 + BQ) : len;
  const int n_kt = (k_end + BK - 1) / BK;
  if (n_kt > 0) load_kv(0, 0);

  const float scale = kLog2e / sqrtf(static_cast<float>(HD));
  const int wr = warp * 16 + gid;          // this lane's first row in the tile
  const int qpos0 = q0 + wr, qpos1 = qpos0 + 8;
  // A fragments of Q: the lane's dims 2 tig and 2 tig + 1 of each 8-dim
  // step are k-indices tig and tig + 4 (K's fragments use the same order,
  // so the sum over dims is unchanged)
  uint32_t qrb[Cf::QREG ? HD / 8 : 1][4], qrs[Cf::QREG ? HD / 8 : 1][4];
  if constexpr (Cf::QREG) {
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const int c = ks * 8 + 2 * tig;
      const float2 z = make_float2(0.f, 0.f);
      const float2 x0 = qpos0 < S ? ld2(qb + qpos0 * q_row + c) : z;
      const float2 x1 = qpos1 < S ? ld2(qb + qpos1 * q_row + c) : z;
      split(x0.x, qrb[ks][0], qrs[ks][0]);
      split(x1.x, qrb[ks][1], qrs[ks][1]);
      split(x0.y, qrb[ks][2], qrs[ks][2]);
      split(x1.y, qrb[ks][3], qrs[ks][3]);
    }
  } else {
    for (int i = tid; i < BQ * HD / 4; i += NT) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      const int qpos = q0 + r;
      *reinterpret_cast<float4*>(qbig + r * STR + c) =
          qpos < S ? *reinterpret_cast<const float4*>(qb + qpos * q_row + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      split4(qbig + r * STR + c, qsml + r * STR + c);
    }
  }
  float o[NT_O][4];
#pragma unroll
  for (int j = 0; j < NT_O; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m_r[2] = {kNegInf, kNegInf}, l_r[2] = {0.f, 0.f};

  for (int t = 0; t < n_kt; ++t) {
    const int stage = t & 1;
    if (t + 1 < n_kt) {
      load_kv(t + 1, stage ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();     // tile t has landed for every thread
    float* kd = kbuf + stage * BK * STR;
    float* vd = vbuf + stage * BK * STRV;
    for (int i = tid; i < BK * HD / 4; i += NT) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      split4(kd + r * STR + c, ksml + r * STR + c);
      split4(vd + r * STRV + c, vsml + r * STRV + c);
    }
    __syncthreads();

    // a causal tile wholly above this warp's rows adds nothing to them
    const int k0 = t * BK;
    if (causal && k0 > q0 + warp * 16 + 15) {
      __syncthreads();
      continue;
    }

    // S = Q K^T for this warp's 16 rows and the tile's BK keys; with fewer
    // than 8 column tiles the three products go to three accumulators, so
    // that MMAs do not wait on each other
    float sc[NT_S][4], sx[NT_S][4], sy[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = sx[j][e] = sy[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 8; ++ks) {
      const int c = ks * 8 + 2 * tig;
      uint32_t ab[4], as[4];
      if constexpr (Cf::QREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ab[e] = qrb[ks][e];
          as[e] = qrs[ks][e];
        }
      } else {
        const float2 b0 = ld2(qbig + wr * STR + c);
        const float2 b1 = ld2(qbig + (wr + 8) * STR + c);
        const float2 s0 = ld2(qsml + wr * STR + c);
        const float2 s1 = ld2(qsml + (wr + 8) * STR + c);
        ab[0] = __float_as_uint(b0.x);
        ab[1] = __float_as_uint(b1.x);
        ab[2] = __float_as_uint(b0.y);
        ab[3] = __float_as_uint(b1.y);
        as[0] = __float_as_uint(s0.x);
        as[1] = __float_as_uint(s1.x);
        as[2] = __float_as_uint(s0.y);
        as[3] = __float_as_uint(s1.y);
      }
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int kr = (j * 8 + gid) * STR + c;
        const float2 kbig = ld2(kd + kr), ksmall = ld2(ksml + kr);
        const uint32_t kb0 = __float_as_uint(kbig.x);
        const uint32_t kb1 = __float_as_uint(kbig.y);
        const uint32_t ks0 = __float_as_uint(ksmall.x);
        const uint32_t ks1 = __float_as_uint(ksmall.y);
        if constexpr (NT_S >= 8) {     // enough independent accumulators
          mma3(sc[j], ab, as, kb0, kb1, ks0, ks1);
        } else {
          mma(sx[j], as, kb0, kb1);
          mma(sy[j], ab, ks0, ks1);
          mma(sc[j], ab, kb0, kb1);
        }
      }
    }
    if constexpr (NT_S < 8) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] += sx[j][e] + sy[j][e];
    }

    // online softmax on the fragments: sc[j][e] is row gid (+8 for e >= 2),
    // key t * BK + j * 8 + 2 * tig + (e & 1)
    float mx[2] = {m_r[0], m_r[1]}, corr[2];
    if (k0 + BK <= len && (!causal || k0 + BK <= q0 + warp * 16 + 1)) {
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[j][e] *= scale;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    } else {     // the tile crosses the length or the diagonal
#pragma unroll
      for (int j = 0; j < NT_S; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + j * 8 + 2 * tig + (e & 1);
          const bool ok =
              kpos < len && (!causal || kpos <= (e < 2 ? qpos0 : qpos1));
          sc[j][e] = ok ? sc[j][e] * scale : kNegInf;
          mx[e >> 1] = fmaxf(mx[e >> 1], sc[j][e]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < NT_S; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = sc[j][e] > 0.5f * kNegInf ? exp2f(sc[j][e] - mx[e >> 1])
                                                  : 0.f;
        sc[j][e] = p;
        l_r[e >> 1] += p;
      }

    // O = O * corr + P V: the lane's keys 2 tig and 2 tig + 1 of the
    // 8-key step j are k-indices tig and tig + 4 of the A operand. P V
    // sums into a fresh accumulator per tile (the tensor cores' own float32
    // accumulation is not rounded to nearest, so long chains through it
    // drift), which is added to O with rounded float32 FMAs
    uint32_t pb[NT_S][4], ps[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
      split(sc[j][0], pb[j][0], ps[j][0]);
      split(sc[j][2], pb[j][1], ps[j][1]);
      split(sc[j][1], pb[j][2], ps[j][2]);
      split(sc[j][3], pb[j][3], ps[j][3]);
    }
#pragma unroll
    for (int n0 = 0; n0 < NT_O; n0 += NCH) {
      float ot[NCH][4];
#pragma unroll
      for (int n = 0; n < NCH; ++n) ot[n][0] = ot[n][1] = ot[n][2] = ot[n][3] = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const int kr = (j * 8 + 2 * tig) * STRV;
#pragma unroll
        for (int n = 0; n < NCH; ++n) {
          const int d = (n0 + n) * 8 + gid;
          mma3(ot[n], pb[j], ps[j], bits(vd + kr + d),
               bits(vd + kr + STRV + d), bits(vsml + kr + d),
               bits(vsml + kr + STRV + d));
        }
      }
#pragma unroll
      for (int n = 0; n < NCH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[n0 + n][e] = fmaf(o[n0 + n][e], corr[e >> 1], ot[n][e]);
    }
    __syncthreads();     // the tile is consumed before the ring moves on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
    l_r[r] = 1.f / fmaxf(l_r[r], 1e-30f);
  }
  float* ob = out + static_cast<long long>(b) * S * q_row + h * HD;
#pragma unroll
  for (int j = 0; j < NT_O; ++j) {
    const int d = j * 8 + 2 * tig;
    if (qpos0 < S)
      *reinterpret_cast<float2*>(ob + qpos0 * q_row + d) =
          make_float2(o[j][0] * l_r[0], o[j][1] * l_r[0]);
    if (qpos1 < S)
      *reinterpret_cast<float2*>(ob + qpos1 * q_row + d) =
          make_float2(o[j][2] * l_r[1], o[j][3] * l_r[1]);
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const int* lens,
           float* out, int B, int S, int H, int KV, int causal,
           cudaStream_t stream) {
  using Cf = Cfg<HD>;
  // the shared-memory attribute is set once per device (it is per device)
  static thread_local int attr_dev = -1;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev != attr_dev) {
    err = cudaFuncSetAttribute(mem_attention_kernel<HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cf::SMEM_BYTES);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_dev = dev;
  }
  const dim3 grid(H, (S + Cf::BQ - 1) / Cf::BQ, B);
  mem_attention_kernel<HD><<<grid, Cf::THREADS, Cf::SMEM_BYTES, stream>>>(
      q, k, v, lens, out, S, H, KV, causal);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, S, H, hd], k/v [B, S, KV, hd], lens [B] int32, out [B, S, H, hd],
// all contiguous and 16-byte aligned on the device; H a multiple of KV.
// Returns the CUDA error code of the launch (0 on success).
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
