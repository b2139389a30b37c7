// Shared all-reduce: the sum of a contiguous float32 vector over the n
// ranks of a process group whose processes share one card, in place.
//
// Replaces: no Pallas kernel. It stands in for the psum that XLA places
// inside the scan of the reference's fused epoch under fed_mesh
// (src/repro/core/huscf.py, make_epoch_fn, jitted with the mesh's
// shardings): a client-sharded step sums its server BatchNorm statistics
// (forward and backward), its server gradients and its losses over the
// ranks, 57 all-reduces per GAN step. Between processes that share one
// card gloo stages every call through the host, which a CUDA graph cannot
// capture, and NCCL refuses two ranks on one device; this kernel needs no
// host and replays from a graph.
//
// Buffers: every rank allocates one buffer with cudaMalloc (outside
// torch's caching allocator, so that its IPC handle covers exactly it)
// and maps every peer's through CUDA IPC. A buffer holds
//   flags[2][blocks]  u32, written by the owner only, read by the peers
//   slot[2][cap]      f32 (past the flags, 256-byte aligned), the
//                     owner's partials, read by the peers
// and each rank keeps its own sequence counters seq[blocks] beside it.
// The grid is fixed (blocks), so block b of every call of every rank
// handles the same chunk of the vector and owns counter seq[b]; the
// counters advance on the device, so a captured launch replays (no
// argument carries a call number).
//
// Protocol of call s = seq[b] + 1 in block b, slot and flag parity s & 1:
//  1. copy this rank's chunk of x into its slot; barrier; one thread
//     fences and writes flags[s & 1][b] = s with a release store at
//     system scope (the peers are other processes' contexts);
//  2. one thread per peer spins on the peer's flags[s & 1][b] with an
//     acquire load at system scope until it reads s, each wait bounded
//     by %globaltimer; barrier;
//  3. every thread adds the n ranks' chunks in rank order 0..n-1 in
//     float32 (loads .cg, past L1) and writes the sum into x.
// Every rank adds the same values in the same order, so all ranks get the
// same bits, which equal a plain rank-order sum. A slot is written again
// two calls later; by then every peer has passed call s + 1, whose flag
// it writes only after it finished reading call s's slot, so no slot is
// overwritten before every peer has read it.
//
// A wait that outlasts timeout_ns writes (1, rank, peer, call site,
// sequence) to err[0..4] (the first failure wins) and ends the block; the
// host reads the word at the epoch's readback and raises. Once the word
// is set, every later block and call of this rank returns at once (and
// a block already waiting stops): the readback raises anyway, and an
// epoch of captured steps would otherwise spend a timeout on each call.
//
// Bound: device-memory bytes: each rank reads n partials and writes its
// sum. Ranks that share a card run one at a time (the card time-slices
// their contexts), so a rank whose peers have not arrived spins until its
// time slice ends: the call takes time slices, not bytes.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRanks = 8;
constexpr int kThreads = 512;

struct Args {
  float* slots[kMaxRanks];      // rank q's slot[0]; slot[1] = + cap
  unsigned* flags[kMaxRanks];   // rank q's flags[2][blocks]
  float* x;
  unsigned* seq;                // this rank's counters [blocks]
  int* err;                     // [5]
  long long n, cap;
  unsigned long long timeout_ns;
  int ranks, rank, site;
};

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void store_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned load_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// VEC: x starts on a 16-byte boundary (slots always do), so the chunk's
// whole float4s move 16 bytes at a time; the tail past them 4 at a time
template <bool VEC>
__global__ void __launch_bounds__(kThreads) shared_all_reduce(Args a) {
  __shared__ unsigned s_seq;
  __shared__ int s_fail;
  const int b = blockIdx.x;
  const int nb = gridDim.x;
  if (threadIdx.x == 0) {
    s_seq = a.seq[b] + 1u;
    s_fail = load_volatile(a.err) != 0;   // an earlier wait timed out
  }
  __syncthreads();
  if (s_fail) return;
  const unsigned s = s_seq;
  const long long par = s & 1u;
  // chunks of whole float4s, so that every chunk but the last starts and
  // ends on a 16-byte boundary
  const long long chunk = ((a.n + nb - 1) / nb + 3) / 4 * 4;
  const long long lo = min(a.n, (long long)b * chunk);
  const long long hi = min(a.n, lo + chunk);
  const long long n4 = VEC ? (hi - lo) / 4 : 0;
  float* mine = a.slots[a.rank] + par * a.cap;

  // 1. this rank's partial into its slot, then the flag
  for (long long i = threadIdx.x; i < n4; i += kThreads)
    reinterpret_cast<float4*>(mine + lo)[i] =
        reinterpret_cast<const float4*>(a.x + lo)[i];
  for (long long i = lo + 4 * n4 + threadIdx.x; i < hi; i += kThreads)
    mine[i] = a.x[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence_system();
    store_release_sys(a.flags[a.rank] + par * nb + b, s);
  }

  // 2. every peer's chunk
  const int q = threadIdx.x;
  if (q < a.ranks && q != a.rank) {
    const unsigned* f = a.flags[q] + par * nb + b;
    const unsigned long long t0 = global_ns();
    while ((int)(load_acquire_sys(f) - s) < 0) {
      if (load_volatile(a.err) != 0) {      // another block timed out
        s_fail = 1;
        break;
      }
      if (global_ns() - t0 > a.timeout_ns) {
        if (atomicCAS(a.err, 0, 1) == 0) {
          a.err[1] = a.rank;
          a.err[2] = q;
          a.err[3] = a.site;
          a.err[4] = (int)s;
          __threadfence_system();
        }
        s_fail = 1;
        break;
      }
      __nanosleep(256);
    }
    __threadfence_system();
  }
  __syncthreads();
  if (s_fail) return;

  // 3. the sum in rank order
  for (long long i = threadIdx.x; i < n4; i += kThreads) {
    float4 acc = __ldcg(reinterpret_cast<const float4*>(
                            a.slots[0] + par * a.cap + lo) + i);
    for (int r = 1; r < a.ranks; ++r)
      acc = add4(acc, __ldcg(reinterpret_cast<const float4*>(
                                 a.slots[r] + par * a.cap + lo) + i));
    reinterpret_cast<float4*>(a.x + lo)[i] = acc;
  }
  for (long long i = lo + 4 * n4 + threadIdx.x; i < hi; i += kThreads) {
    float acc = __ldcg(a.slots[0] + par * a.cap + i);
    for (int r = 1; r < a.ranks; ++r)
      acc = __fadd_rn(acc, __ldcg(a.slots[r] + par * a.cap + i));
    a.x[i] = acc;
  }
  if (threadIdx.x == 0) a.seq[b] = s;
}

}  // namespace

// cudaMalloc'd buffer of `bytes`, zeroed, on `device`
extern "C" int sar_alloc(int device, long long bytes, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaMalloc(ptr, (size_t)bytes);
  if (e == cudaSuccess) e = cudaMemset(*ptr, 0, (size_t)bytes);
  if (e == cudaSuccess) e = cudaDeviceSynchronize();
  return (int)e;
}

extern "C" int sar_free(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaFree(ptr);
  return (int)e;
}

// the buffer's IPC handle, 64 bytes (cudaIpcMemHandle_t)
extern "C" int sar_ipc_handle(void* ptr, void* handle) {
  static_assert(sizeof(cudaIpcMemHandle_t) == 64, "IPC handle size");
  return (int)cudaIpcGetMemHandle(
      reinterpret_cast<cudaIpcMemHandle_t*>(handle), ptr);
}

// a peer's buffer mapped into this process
extern "C" int sar_ipc_open(int device, const void* handle, void** ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess)
    e = cudaIpcOpenMemHandle(
        ptr, *reinterpret_cast<const cudaIpcMemHandle_t*>(handle),
        cudaIpcMemLazyEnablePeerAccess);
  return (int)e;
}

extern "C" int sar_ipc_close(int device, void* ptr) {
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess) e = cudaIpcCloseMemHandle(ptr);
  return (int)e;
}

// one all-reduce of x[0:n] on `stream`: slots[q] and flags[q] are rank
// q's (this rank's own at q = rank), seq and err this rank's
extern "C" int sar_all_reduce_f32(float* x, long long n, void* const* slots,
                                  void* const* flags, unsigned* seq, int* err,
                                  int ranks, int rank, int blocks,
                                  long long cap, int site,
                                  unsigned long long timeout_ns, int vec,
                                  void* stream) {
  if (ranks < 1 || ranks > kMaxRanks || rank < 0 || rank >= ranks ||
      blocks < 1 || n < 1 || n > cap)
    return (int)cudaErrorInvalidValue;
  Args a{};
  for (int q = 0; q < ranks; ++q) {
    a.slots[q] = static_cast<float*>(slots[q]);
    a.flags[q] = static_cast<unsigned*>(flags[q]);
  }
  a.x = x;
  a.seq = seq;
  a.err = err;
  a.n = n;
  a.cap = cap;
  a.timeout_ns = timeout_ns;
  a.ranks = ranks;
  a.rank = rank;
  a.site = site;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    shared_all_reduce<true><<<blocks, kThreads, 0, s>>>(a);
  else
    shared_all_reduce<false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}
