// K2: k-means nearest-centre assignment,
// labels[n] = argmin_m (-2 x[n] . c[m] + |c[m]|^2), int32, float32 inputs.
// The |x[n]|^2 term is constant under the argmin and dropped. Centres are
// visited in index order: exact ties go to the lowest index, and the first
// NaN score wins, as jnp.argmin does.
//
// Replaces: src/repro/kernels/kmeans_assign.py, kmeans_assign (kernel
// body _kmeans_kernel).
//
// Bound: the function reads x [N, D] and the centres [M, D] once and
// writes N labels, and does about 2 M flops per element of x: at most
// 4 flop/B for M <= 8, far below the float32 FMA ridge of the H100
// (67 TFLOP/s / 3.35 TB/s = 20 flop/B). So bytes bound it (N = 4096,
// M = 6, D = 6272: 103 MB of x, 0.0307 ms), and the dot products stay on
// the CUDA cores in float32 FMA: tensor cores, even as 3xTF32, would
// speed up work that takes no time here.
//
// Design: a block takes a tile of kRows = 16 rows of x and one split of D
// (columns [i * split_len, (i + 1) * split_len), the last split to D).
// - The centres are staged in shared memory, kMChunk = 8 centres by
//   kChunk = 512 columns at a time, through a double buffer of cp.async
//   copies (16-byte copies; 4-byte copies and 128 columns when D % 4 != 0,
//   since rows of x and of the centres then do not start on 16-byte
//   boundaries). So a block reads each centre element once for its 16
//   rows, not once per row as a block per row did through L2.
// - Each warp owns kRW = 4 rows and streams them in 16-byte loads, all 16
//   of a lane's loads for a chunk (4 rows x 4 steps) in flight together,
//   and keeps a register tile of 4 rows x 8 centres of partial dot
//   products: each centre value read from shared memory serves four rows,
//   so shared memory moves 1.5 bytes per byte of x at M = 6, not 6.
// - |c|^2 is accumulated once per block: warp w squares the centres
//   m % kWarps == w as it reads them.
// - Every centre is summed in the same order (the same lane partition,
//   FMA chain and shuffle tree, lane 0's total broadcast, the same split
//   order), so exact duplicate centres give bit-identical scores.
// - M > 8 loops over passes of 8 centres; each pass streams the block's
//   rows again.
// Split D (the trainer's N = 8 is one row tile for 132 SMs): the wrapper
// picks the split count (assign_splits) so the grid fills about one wave.
// With one split the block picks the labels itself. Otherwise each block
// writes its partial dot products and |c|^2 to a float32 workspace; the
// block that draws the last ticket of its row tile's counter (atomicAdd
// after a __threadfence) copies the tile's partials to shared memory
// (cp.async.cg, which reads L2), sums them in split-index order (never in
// arrival order, never with float atomics, so duplicates still tie), picks
// the labels and resets the counter to 0 (no memset per call). Calls
// queued on one stream may share the counters; calls on two streams at
// once need two sets (the wrapper keeps one per stream).
// At the trainer's shape the launch is a chain of dependent memory round
// trips (chunk loads, fence, ticket, partials), not a stream of bytes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRW = 4;                  // rows per warp
constexpr int kRows = kWarps * kRW;     // rows per block
constexpr int kMChunk = 8;              // centres per pass
constexpr int kSteps = 4;               // warp steps per staged chunk
constexpr int kMaxSplits = 32;
constexpr int kSlots = kRows + 1;       // workspace rows per split and pass
static_assert(kThreads == kRows * kMChunk, "the combine maps one thread "
              "to each (row, centre) of a pass");
static_assert(kRW * kMChunk == 32, "the partials are written one per lane");

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = ok ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// lane 0's xor-butterfly total, broadcast to the warp
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return __shfl_sync(0xffffffffu, v, 0);
}

// whether score s, visited after the running best, replaces it
__device__ __forceinline__ bool takes(float s, float best) {
  return (isnan(s) && !isnan(best)) || s < best;
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
kmeans_assign_kernel(const float* __restrict__ x, const float* __restrict__ c,
                     int* __restrict__ labels, float* __restrict__ ws,
                     int* __restrict__ counters, int N, int M, int D,
                     int n_splits, int split_len) {
  constexpr int kStep = 32 * VEC;          // columns a warp covers per step
  constexpr int kChunk = kSteps * kStep;   // columns per staged chunk
  constexpr int kUnits = kChunk / VEC;     // copies per centre and chunk
  // the double buffer of centre chunks; the combine stages the splits'
  // partials in the same memory
  constexpr int kStaged = kMaxSplits * kSlots * kMChunk;
  constexpr int kBuf = 2 * kMChunk * kChunk;
  __shared__ __align__(16) float smem[kBuf > kStaged ? kBuf : kStaged];
  float(*cs)[kMChunk][kChunk] =
      reinterpret_cast<float(*)[kMChunk][kChunk]>(smem);
  __shared__ float cc_s[kMChunk];
  __shared__ float score_s[kRows][kMChunk];
  __shared__ int last_ticket;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int split = blockIdx.x % n_splits, tile = blockIdx.x / n_splits;
  const int d0 = split * split_len;
  const int len = (split == n_splits - 1 ? D : d0 + split_len) - d0;
  const int n_chunks = (len + kChunk - 1) / kChunk;
  const int row0 = tile * kRows + warp * kRW;

  const float* xr[kRW];
  bool row_ok[kRW];
  float best[kRW];
  int best_m[kRW];
#pragma unroll
  for (int r = 0; r < kRW; ++r) {
    row_ok[r] = row0 + r < N;
    xr[r] = x + static_cast<long long>(row_ok[r] ? row0 + r : 0) * D + d0;
    best[r] = INFINITY;
    best_m[r] = 0;
  }
  // workspace: [tile][pass][split][slot][kMChunk] floats, slot 0 holding
  // the pass's |c|^2 and slot 1 + j the dots of the tile's row j
  const int n_pass = (M + kMChunk - 1) / kMChunk;

  for (int m0 = 0; m0 < M; m0 += kMChunk) {
    const int mc = min(kMChunk, M - m0);
    const float* cb = c + static_cast<long long>(m0) * D + d0;
    auto issue = [&](int k) {
      for (int u = tid; u < kMChunk * kUnits; u += kThreads) {
        const int m = u / kUnits, col = (u % kUnits) * VEC;
        const int off = k * kChunk + col;
        const bool ok = m < mc && off < len;
        cp_async<4 * VEC>(&cs[k & 1][m][col],
                          ok ? cb + static_cast<long long>(m) * D + off : c,
                          ok);
      }
      cp_commit();
    };

    float acc[kRW][kMChunk], cc[kMChunk];
#pragma unroll
    for (int m = 0; m < kMChunk; ++m) {
      cc[m] = 0.f;
#pragma unroll
      for (int r = 0; r < kRW; ++r) acc[r][m] = 0.f;
    }
    if (n_chunks > 0) issue(0);
    for (int k = 0; k < n_chunks; ++k) {
      if (k + 1 < n_chunks)
        issue(k + 1);
      else
        cp_commit();  // an empty group keeps wait_group 1 exact
      // this chunk's columns of the warp's rows, all loads in flight
      float xv[kSteps][kRW][VEC];
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        const int off = k * kChunk + s * kStep + lane * VEC;
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const bool ok = row_ok[r] && off < len;
          if constexpr (VEC == 4) {
            const float4 v =
                ok ? __ldg(reinterpret_cast<const float4*>(xr[r] + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
            xv[s][r][0] = v.x;
            xv[s][r][1] = v.y;
            xv[s][r][2] = v.z;
            xv[s][r][3] = v.w;
          } else {
            xv[s][r][0] = ok ? __ldg(xr[r] + off) : 0.f;
          }
        }
      }
      cp_wait<1>();
      __syncthreads();
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        if (k * kChunk + s * kStep >= len) break;
#pragma unroll
        for (int m = 0; m < kMChunk; ++m) {
          if (m >= mc) break;
          float cv[VEC];
          if constexpr (VEC == 4) {
            const float4 v = *reinterpret_cast<const float4*>(
                &cs[k & 1][m][s * kStep + lane * 4]);
            cv[0] = v.x;
            cv[1] = v.y;
            cv[2] = v.z;
            cv[3] = v.w;
          } else {
            cv[0] = cs[k & 1][m][s * kStep + lane];
          }
          if (m % kWarps == warp) {
#pragma unroll
            for (int v = 0; v < VEC; ++v) cc[m] = fmaf(cv[v], cv[v], cc[m]);
          }
#pragma unroll
          for (int r = 0; r < kRW; ++r) {
#pragma unroll
            for (int v = 0; v < VEC; ++v)
              acc[r][m] = fmaf(xv[s][r][v], cv[v], acc[r][m]);
          }
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int m = 0; m < kMChunk; ++m) {
      if (m >= mc) break;
#pragma unroll
      for (int r = 0; r < kRW; ++r) acc[r][m] = warp_sum(acc[r][m]);
      if (m % kWarps == warp) {
        const float t = warp_sum(cc[m]);
        if (lane == 0) cc_s[m] = t;
      }
    }
    __syncthreads();
    if (n_splits == 1) {
#pragma unroll
      for (int m = 0; m < kMChunk; ++m) {
        if (m >= mc) break;
#pragma unroll
        for (int r = 0; r < kRW; ++r) {
          const float s = -2.f * acc[r][m] + cc_s[m];
          if (takes(s, best[r])) {
            best[r] = s;
            best_m[r] = m0 + m;
          }
        }
      }
    } else {
      float* wp = ws + ((static_cast<long long>(tile) * n_pass +
                         m0 / kMChunk) * n_splits + split) * kSlots * kMChunk;
#pragma unroll
      for (int r = 0; r < kRW; ++r) {
#pragma unroll
        for (int m = 0; m < kMChunk; ++m)
          if (lane == r * kMChunk + m)
            wp[(1 + warp * kRW + r) * kMChunk + m] = acc[r][m];
      }
      if (tid < kMChunk) wp[tid] = tid < mc ? cc_s[tid] : 0.f;
    }
  }

  if (n_splits == 1) {
#pragma unroll
    for (int r = 0; r < kRW; ++r)
      if (lane == r && row_ok[r]) labels[row0 + r] = best_m[r];
    return;
  }

  // the last block of this row tile to finish combines the splits
  __threadfence();
  __syncthreads();
  if (tid == 0) last_ticket = atomicAdd(&counters[tile], 1) == n_splits - 1;
  __syncthreads();
  if (!last_ticket) return;
  __threadfence();
  // each pass's partials of this tile are copied to shared memory; thread
  // (r, m) sums those of row r and centre m0 + m in split order, and
  // thread (r, 0) then visits the pass's scores in centre order
  const int r = tid / kMChunk, m = tid % kMChunk;
  const int row = tile * kRows + r;
  constexpr int kPart = kSlots * kMChunk;     // floats per split and pass
  float bst = INFINITY;
  int bm = 0;
  for (int p = 0; p < n_pass; ++p) {
    const int m0 = p * kMChunk;
    const float* src =
        ws + (static_cast<long long>(tile) * n_pass + p) * n_splits * kPart;
    for (int u = tid; u < n_splits * kPart / 4; u += kThreads)
      cp_async<16>(smem + 4 * u, src + 4 * u, true);
    cp_commit();
    cp_wait<0>();
    __syncthreads();
    if (m0 + m < M && row < N) {
      float dot = 0.f, cc = 0.f;
      for (int i = 0; i < n_splits; ++i) {
        cc += smem[i * kPart + m];
        dot += smem[i * kPart + (1 + r) * kMChunk + m];
      }
      score_s[r][m] = -2.f * dot + cc;
    }
    __syncthreads();
    if (m == 0 && row < N) {
      for (int j = 0; j < kMChunk && m0 + j < M; ++j) {
        const float s = score_s[r][j];
        if (takes(s, bst)) {
          bst = s;
          bm = m0 + j;
        }
      }
    }
    __syncthreads();
  }
  if (m == 0 && row < N) labels[row] = bm;
  if (tid == 0) counters[tile] = 0;
}

}  // namespace

// x [N, D], c [M, D] float32 and labels [N] int32, contiguous on the
// device. The block grid is ceil(N / 16) row tiles by n_splits (1 ..
// 32) splits of D: split i covers [i * split_len, (i + 1) * split_len),
// the last one up to D. With n_splits > 1, split_len is a multiple of 4,
// ws holds ceil(N / 16) * ceil(M / 8) * n_splits * 17 * 8 floats (16-byte
// aligned) and counters
// ceil(N / 16) ints that are 0 on entry (and are 0 again on exit).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int kmeans_assign_f32(const float* x, const float* c, int* labels,
                                 float* ws, int* counters, int N, int M,
                                 int D, int n_splits, int split_len,
                                 void* stream) {
  if (N < 1 || M < 1 || D < 1 || n_splits < 1 || n_splits > kMaxSplits ||
      (n_splits > 1 && (ws == nullptr || counters == nullptr ||
                        split_len % 4 != 0 ||
                        static_cast<long long>(split_len) * (n_splits - 1) >=
                            D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_tiles = (static_cast<long long>(N) + kRows - 1) / kRows;
  const dim3 grid(static_cast<unsigned>(n_tiles * n_splits));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = D % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(c) % 16 == 0;
  if (vec)
    kmeans_assign_kernel<4><<<grid, kThreads, 0, st>>>(
        x, c, labels, ws, counters, N, M, D, n_splits, split_len);
  else
    kmeans_assign_kernel<1><<<grid, kThreads, 0, st>>>(
        x, c, labels, ws, counters, N, M, D, n_splits, split_len);
  return static_cast<int>(cudaGetLastError());
}
