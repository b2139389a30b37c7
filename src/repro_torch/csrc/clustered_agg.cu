// K1: clustered federated aggregation, out[S, D] = W[S, K] @ theta[K, D],
// all float32. theta may be row-strided (row stride ld >= D); out is
// written with row stride ldo, a multiple of 4.
//
// Replaces: src/repro/kernels/weighted_agg.py, clustered_agg_flat (kernel
// body _clustered_agg_kernel; weighted_agg_flat is its S = 1 case).
//
// Bound: device-memory bytes. Each column of D costs 2 * S * K flops
// against (K + S) * 4 bytes moved, 2 * S / 4 flops per byte of theta:
// 12 at S = 24, under the ~20 flops per byte at which float32 FMA
// throughput would bind an H100. But not far under: at the population's
// chunk tile (S = 24, K = 64) the FMAs need 44 % of the byte bound's
// time, and in a dense round (K >> S) 59 %, so they must run while the
// copies stream, not between them.
//
// Design: one walk of theta from device memory, whatever S and K are.
//  - A 2-D grid: x over column tiles of 4 * ct columns (ct = 128 threads
//    per row group, fewer past two groups), y over blocks of rows of W
//    (one block of rows whenever S <= 8 * 16).
//  - theta streams through shared memory in K-tiles of kKTile rows x the
//    tile's columns (32 KB at ct = 128), in a ring of kStages stages
//    filled with cp.async: 16-byte copies (.cg, past L1) when theta's
//    rows start on 16-byte boundaries (the federation plan pads its row
//    stride to 32 floats), 4-byte copies otherwise. The matching
//    W[:, k0:k0 + kKTile] slice is staged with each K-tile, stored
//    k-major, so one ld.shared.v4 (a broadcast) gives four rows' weights;
//    K has no bound.
//  - Each thread keeps ROWS rows x 4 columns of sums in registers. S = 1
//    runs alone, S <= 8 in one group of 8 rows; larger S in row groups of
//    8, 12 or 16 rows (two groups up to S = 24), each group its own warps
//    over the same staged tile. A thread's sums then take at most 64
//    registers, and 16 warps fit on an SM beside the ring, enough to
//    keep the FMA pipes busy while the copies stream (one group of 24
//    rows took 204 registers, 8 warps per SM, and ran the FMAs and the
//    copies nearly one after the other).
//  - Ragged edges are masked in the kernel: copies past D or K fill
//    zeros (cp.async's source size), rows of W past S are zero, and
//    columns past D are not stored. Nothing is padded on the host.
#include <cuda_runtime.h>

namespace {

constexpr int kKTile = 16;         // theta rows per stage
constexpr int kStages = 3;         // ring depth
constexpr int kMaxThreads = 256;
constexpr int kMaxGroups = 8;      // row groups per block
constexpr int kMaxCt = 1 << 7;     // threads per row group, at most

struct Params {
  const float* w;
  const float* theta;
  float* out;
  int S, K;
  long long D, ld, ldo;
  int ct_log2;   // log2(threads per row group)
  int groups;    // row groups per block
  int n_stages;  // stages allocated in shared memory
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(float* dst, const float* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::
                   "r"(smem_u32(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// W rows kept per row group in shared memory: a multiple of 4 floats, so
// every group's weights of one k start on a 16-byte boundary.
template <int ROWS>
__host__ __device__ constexpr int rows_pad() { return ROWS < 4 ? 4 : ROWS; }

// Stage K-tile kt of theta and the matching slice of W into ring slot
// kt % kStages.
template <int ROWS, bool ALIGNED>
__device__ __forceinline__ void stage_tile(const Params& p, float* th_sh,
                                           float* w_sh, int kt,
                                           long long col0, int row0) {
  const int ct = 1 << p.ct_log2;
  const int tc = 4 * ct;
  const int sb = p.groups * rows_pad<ROWS>();
  const int slot = kt % kStages;
  const int k0 = kt * kKTile;
  float* th = th_sh + slot * kKTile * tc;
  if constexpr (ALIGNED) {
    for (int q = threadIdx.x; q < kKTile * ct; q += blockDim.x) {
      const int r = q >> p.ct_log2;
      const int c4 = q & (ct - 1);
      const long long col = col0 + 4 * c4;
      const int k = k0 + r;
      const float* src = p.theta;
      int bytes = 0;
      if (k < p.K && col < p.D) {
        src = p.theta + static_cast<long long>(k) * p.ld + col;
        bytes = 4 * static_cast<int>(p.D - col < 4 ? p.D - col : 4);
      }
      cp_async_16(th + r * tc + 4 * c4, src, bytes);
    }
  } else {
    for (int q = threadIdx.x; q < kKTile * tc; q += blockDim.x) {
      const int r = q >> (p.ct_log2 + 2);
      const int c = q & (tc - 1);
      const long long col = col0 + c;
      const int k = k0 + r;
      const bool ok = k < p.K && col < p.D;
      cp_async_4(th + r * tc + c,
                 ok ? p.theta + static_cast<long long>(k) * p.ld + col
                    : p.theta,
                 ok ? 4 : 0);
    }
  }
  float* ws = w_sh + slot * kKTile * sb;
  for (int q = threadIdx.x; q < kKTile * sb; q += blockDim.x) {
    const int r = q / sb;
    const int s = q - r * sb;
    const int grp = s / rows_pad<ROWS>();
    const int sr = s - grp * rows_pad<ROWS>();
    const int row = row0 + grp * ROWS + sr;
    const int k = k0 + r;
    const bool ok = sr < ROWS && row < p.S && k < p.K;
    cp_async_4(ws + q,
               ok ? p.w + static_cast<long long>(row) * p.K + k : p.w,
               ok ? 4 : 0);
  }
}

template <int ROWS, bool ALIGNED>
__global__ void __launch_bounds__(kMaxThreads)
clustered_agg_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  const int ct = 1 << p.ct_log2;
  const int tc = 4 * ct;
  const int sb = p.groups * rows_pad<ROWS>();
  float* th_sh = smem;                                  // [stages][kKTile][tc]
  float* w_sh = smem + p.n_stages * kKTile * tc;        // [stages][kKTile][sb]
  const int g = threadIdx.x >> p.ct_log2;               // row group
  const int lane = threadIdx.x & (ct - 1);
  const long long col0 = static_cast<long long>(blockIdx.x) * tc;
  const int row0 = blockIdx.y * p.groups * ROWS;
  const int n_kt = (p.K + kKTile - 1) / kKTile;

  float acc[ROWS][4];
#pragma unroll
  for (int j = 0; j < ROWS; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;

  // prologue: kStages - 1 groups in flight (empty groups past the last
  // tile keep the wait count below uniform)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_kt) stage_tile<ROWS, ALIGNED>(p, th_sh, w_sh, st, col0, row0);
    cp_async_commit();
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    cp_async_wait<kStages - 2>();   // this thread's copies of tile kt landed
    __syncthreads();                // everyone's did, and slot kt - 1 is free
    if (kt + kStages - 1 < n_kt)
      stage_tile<ROWS, ALIGNED>(p, th_sh, w_sh, kt + kStages - 1, col0, row0);
    cp_async_commit();

    const int slot = kt % kStages;
    const float* th = th_sh + slot * kKTile * tc + 4 * lane;
    const float* ws = w_sh + slot * kKTile * sb + g * rows_pad<ROWS>();
#pragma unroll
    for (int r = 0; r < kKTile; ++r) {
      const float4 t = *reinterpret_cast<const float4*>(th + r * tc);
      if constexpr (ROWS == 1) {
        const float wv = ws[r * sb];
        acc[0][0] = fmaf(wv, t.x, acc[0][0]);
        acc[0][1] = fmaf(wv, t.y, acc[0][1]);
        acc[0][2] = fmaf(wv, t.z, acc[0][2]);
        acc[0][3] = fmaf(wv, t.w, acc[0][3]);
      } else {
#pragma unroll
        for (int s4 = 0; s4 < ROWS / 4; ++s4) {
          const float4 wv =
              *reinterpret_cast<const float4*>(ws + r * sb + 4 * s4);
          const float wr[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            float* a = acc[4 * s4 + u];
            a[0] = fmaf(wr[u], t.x, a[0]);
            a[1] = fmaf(wr[u], t.y, a[1]);
            a[2] = fmaf(wr[u], t.z, a[2]);
            a[3] = fmaf(wr[u], t.w, a[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  const long long col = col0 + 4 * lane;
  if (col >= p.D) return;
  // out's rows start on 16-byte boundaries and col + 4 <= ldo: the pad
  // columns past D take the zero-filled tail's sums
#pragma unroll
  for (int j = 0; j < ROWS; ++j) {
    const int row = row0 + g * ROWS + j;
    if (row < p.S)
      *reinterpret_cast<float4*>(p.out + static_cast<long long>(row) * p.ldo +
                                 col) =
          make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  }
}

size_t smem_bytes(int rows, int groups, int ct, int n_stages) {
  const int sb = groups * (rows < 4 ? 4 : rows);
  return static_cast<size_t>(n_stages) * kKTile * (4 * ct + sb) *
         sizeof(float);
}

template <int ROWS, bool ALIGNED>
int launch(Params p, cudaStream_t stream) {
  auto kernel = clustered_agg_kernel<ROWS, ALIGNED>;
  static bool configured = false;
  if (!configured) {
    // groups * ct <= kMaxThreads: at most 4 * kMaxCt columns and
    // kMaxGroups row groups
    const size_t most = smem_bytes(ROWS, kMaxGroups, kMaxCt, kStages);
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  const int n_kt = (p.K + kKTile - 1) / kKTile;
  p.n_stages = n_kt < kStages ? n_kt : kStages;
  const int rows_per_block = p.groups * ROWS;
  // kMaxCt threads (4 * kMaxCt columns) per row group for up to two
  // groups, fewer past that: at most kMaxThreads threads a block
  p.ct_log2 = p.groups <= 2 ? 7 : (p.groups <= 4 ? 6 : 5);
  const int ct = 1 << p.ct_log2;
  const dim3 grid(static_cast<unsigned>((p.D + 4 * ct - 1) / (4 * ct)),
                  static_cast<unsigned>((p.S + rows_per_block - 1) /
                                        rows_per_block));
  kernel<<<grid, p.groups * ct,
           smem_bytes(ROWS, p.groups, ct, p.n_stages), stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Rows per thread and row groups per block for S rows: S = 1 alone; up to
// 8 rows in one group; past that, groups of 8, 12 or 16 rows, so that a
// thread's sums take at most 64 registers and 16 warps fit on an SM.
template <bool ALIGNED>
int dispatch(Params p, cudaStream_t stream) {
  p.groups = 1;
  if (p.S <= 1) return launch<1, ALIGNED>(p, stream);
  if (p.S <= 8) return launch<8, ALIGNED>(p, stream);
  p.groups = 2;
  if (p.S <= 16) return launch<8, ALIGNED>(p, stream);
  if (p.S <= 24) return launch<12, ALIGNED>(p, stream);
  const int g = (p.S + 15) / 16;
  p.groups = g < kMaxGroups ? g : kMaxGroups;
  return launch<16, ALIGNED>(p, stream);
}

}  // namespace

// Returns the CUDA error code of the launch (0 on success). theta's rows
// are ld floats apart (ld >= D), out's ldo (ldo % 4 == 0, ldo >= D, out
// 16-byte aligned); aligned != 0 requires ld % 4 == 0 and a 16-byte
// aligned theta.
extern "C" int clustered_agg_f32(const float* w, const float* theta,
                                 float* out, int S, int K, long long D,
                                 long long ld, long long ldo, int aligned,
                                 void* stream) {
  Params p{w, theta, out, S, K, D, ld, ldo, 0, 1, 1};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return aligned ? dispatch<true>(p, s) : dispatch<false>(p, s);
}
