// Edge <-> node segment kernels of the tick, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of chandy_lamport_tpu/kernels/segment.py:
//   sum_segments (:39) and sum_by_perm (:55)  -> clsim_segment_sum_*
//   spread (:72)                              -> clsim_spread_*
//
// segment_sum: out[r, n] = sum_{j in [lo[n], hi[n])} x[r, perm ? perm[j] : j]
//   for x [R, E] int32 or bool (read as uint8 0/1), out [R, N] int32.
//   The Pallas form takes an exclusive cumsum along E and differences it
//   at the bounds. Integer addition wraps mod 2^32 in any order, so a
//   direct per-segment sum is bit-identical to that form (the sum is
//   accumulated as unsigned to keep the wrap defined); no scan is needed.
//
//   What bounds it: bytes. At the bench's config 4 (sf-1024, B=2048, S=8)
//   the marker-arrival call reads x [16384, 3063] bool (50.2 MB) and writes
//   out [16384, 1024] int32 (67.1 MB): 35 us at 3.35 TB/s; one add per
//   element of x is far below the integer rate. Segments hold ~3 edges
//   (sf-1024: mean 2.99, max 17; er-256: mean 3, max 7), so a warp per
//   (row, node) would idle most of its lanes, reload the tables for every
//   row and gather single bytes of x uncoalesced; the design below reads
//   the tables once per block and x once, and writes out coalesced.
//
//   Design, staged path (segment_staged_kernel). The index tables are the
//   same for every row and a row is small (3,063 B bool at config 4, 3,072
//   B int32 at er-256), so:
//   - a persistent grid, as many blocks as fit on the card at once; each
//     block copies perm, lo and hi into shared memory once, in the same
//     batch of cp.async copies as its first group of rows, so a block
//     starts after one round trip to memory;
//   - the rows are cut into groups of k rows (kernels/segment.segment_plan:
//     ~16 KB of x, at least 4 rows). The k rows of a group are one
//     contiguous span of x, which the block copies into shared memory with
//     16-byte cp.async. A span starts wherever r*E*size falls, so the
//     buffer holds the 16-byte-aligned window around it (the tables
//     likewise), whole chunks at both ends (stage_span says why that is
//     safe); a byte-by-byte copy of the partial chunks would serialise
//     their threads on one round trip per byte. Two
//     buffers: the next group's copy is in flight while the block sums the
//     current one;
//   - one thread per (chunk of 4 rows, node): it walks its segment once,
//     reads each perm entry once for the 4 rows, gathers the 4 values from
//     shared memory, and writes 4 sums; the walk is unrolled by 4 (loads
//     of 4 edges in flight; an explicit batch of predicated reads ran
//     slower, with spills). Consecutive threads take
//     consecutive nodes, so each warp store is 128 contiguous bytes;
//   - perm == null (sum_segments) is the same kernel with contiguous
//     segments.
//   Device memory sees x read once and out written once; each block reads
//   the tables from L2 once. What is left is on chip: the lanes of a warp
//   wait for the longest segment among their 32 nodes (sf-1024: 10 edges
//   on average against a mean of 3), and the byte gathers from shared
//   memory meet bank conflicts.
//
//   Tiled path (segment_tiled_kernel), for shapes whose tables and two
//   one-row buffers do not fit a block's 232,448 B (int32 rows of tens of
//   thousands of edges): a block per (tile of 256 nodes, row residue);
//   each block stages its tile's slice of perm (contiguous when the bounds
//   are a CSR, as by_dst's are; read from device memory when the slice is
//   longer than the shared memory given, one hub) and gathers x through
//   L2, one thread per node, 4 rows at a time.
//
//   The plan (path, rows per group, shared-memory bytes) comes from
//   kernels/segment.segment_plan; the entry point recomputes the staged
//   layout and refuses a launch whose share is short of it.
//
// spread: out[r, e] = x[r, idx[e]] for x [R, N] (bool or int32).
//   What bounds it: bytes. At config 4 [B*S, N] bool in (16.8 MB) + [B*S,
//   E] bool out (50.2 MB): about 20 us. The first design (one thread per
//   output, its row and column by a 64-bit divide, idx re-read from
//   memory for every output, one byte stored per thread) ran 1.3-1.9x
//   behind index_select.
//
//   Design (spread_staged_kernel), the segment sums' staging turned
//   around: a persistent grid; each block stages idx in shared memory
//   once, then for each group of k rows (kernels/segment.spread_plan:
//   ~4,096 outputs a group, so the small shapes still fill the card) the
//   rows' contiguous span of x by 16-byte cp.async, double-buffered, and
//   writes the group's outputs, one contiguous span, as words of 4 (a
//   32-bit word for bool, an int4 for int32) between scalar ends; a
//   thread divides once (32-bit) for its word's first output and steps
//   through the rest. Rows too wide for the plan's share
//   (spread_direct_kernel) read idx and x through L1/L2 in the same
//   words.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError() (or cudaErrorInvalidValue for a plan it refuses); the
// Python wrapper raises on non-zero.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <mutex>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowChunk = 4;          // rows one thread sums at once
constexpr long long kSmemLimit = 232448;
constexpr int kStaged = 0, kTiled = 1;   // kernels/segment.PATHS

__host__ __device__ constexpr long long align16(long long v) {
  return (v + 15) / 16 * 16;
}

// Byte offsets of the staged path's shared memory: the windows of perm
// (when given), lo and hi, then buffers 0 and 1. Each window holds the
// 16-byte-aligned span around its array (stage_span), so it takes 15 bytes
// of slack; kernels/segment.staged_smem_bytes gives the same total.
struct Staged {
  long long lo, hi, buf, buf_bytes, bytes;
};

__host__ __device__ inline Staged staged_layout(int e, int n, int k,
                                                int size, bool perm) {
  Staged s;
  s.lo = perm ? align16(4LL * e + 15) : 0;
  s.hi = s.lo + align16(4LL * n + 15);
  s.buf = s.hi + align16(4LL * n + 15);
  s.buf_bytes = align16((long long)k * e * size + 15);
  s.bytes = s.buf + 2 * s.buf_bytes;
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s =
      static_cast<unsigned int>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copies the bytes [first, last) of device memory into buf, by cp.async
// of every 16-byte-aligned chunk that holds one of them: byte p lands at
// buf + (p - (first & ~15)). The chunks at the two ends may carry bytes
// outside [first, last), which nothing reads; an aligned chunk that holds
// a byte of a tensor lies inside the same allocation (device allocations
// are page-aligned, and PyTorch's caching allocator hands out blocks of
// whole 512-byte units), so no copy reads outside the tensor's memory.
__device__ inline void stage_span(unsigned char* buf,
                                  const unsigned char* first,
                                  const unsigned char* last) {
  const uintptr_t base = reinterpret_cast<uintptr_t>(first) & ~uintptr_t(15);
  const long long chunks =
      (long long)((reinterpret_cast<uintptr_t>(last) - base + 15) >> 4);
  if (last == first) return;
  for (long long c = threadIdx.x; c < chunks; c += kThreads)
    cp_async16(buf + 16 * c, reinterpret_cast<const void*>(base + 16 * c));
}

// Starts the copy of the int32 array t[0, len) into its window; returns
// where t[0] will be.
__device__ inline const int32_t* stage_table(unsigned char* window,
                                             const int32_t* t, long long len) {
  const unsigned char* first = reinterpret_cast<const unsigned char*>(t);
  stage_span(window, first, first + 4 * len);
  return reinterpret_cast<const int32_t*>(
      window + (reinterpret_cast<uintptr_t>(first) & 15));
}

// The sums of one staged group: v holds its krows rows (row q at v + q*e),
// out its first output row.
template <typename T, bool kPerm>
__device__ inline void sum_group(const T* v, const int32_t* s_perm,
                                 const int32_t* s_lo, const int32_t* s_hi,
                                 int32_t* out, int krows, int e, int n) {
  const int items = (krows + kRowChunk - 1) / kRowChunk * n;
  for (int w = threadIdx.x; w < items; w += kThreads) {
    const int c = w / n;
    const int node = w - c * n;
    const int rb = c * kRowChunk;
    const int live = min(kRowChunk, krows - rb);
    const T* vr = v + rb * e;
    const int j0 = s_lo[node], j1 = s_hi[node];
    unsigned int acc[kRowChunk];
#pragma unroll
    for (int q = 0; q < kRowChunk; ++q) acc[q] = 0u;
    if (live == kRowChunk) {
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const int col = kPerm ? s_perm[j] : j;
#pragma unroll
        for (int q = 0; q < kRowChunk; ++q)
          acc[q] += (unsigned int)vr[q * e + col];
      }
    } else {
#pragma unroll 4
      for (int j = j0; j < j1; ++j) {
        const int col = kPerm ? s_perm[j] : j;
#pragma unroll
        for (int q = 0; q < kRowChunk; ++q)
          if (q < live) acc[q] += (unsigned int)vr[q * e + col];
      }
    }
    int32_t* o = out + (long long)rb * n + node;
#pragma unroll
    for (int q = 0; q < kRowChunk; ++q)
      if (q < live) o[(long long)q * n] = (int32_t)acc[q];
  }
}

template <typename T, bool kPerm>
__global__ void __launch_bounds__(kThreads)
    segment_staged_kernel(const T* __restrict__ x,
                          const int32_t* __restrict__ perm,
                          const int32_t* __restrict__ lo,
                          const int32_t* __restrict__ hi,
                          int32_t* __restrict__ out, long long rows, int e,
                          int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Staged lay = staged_layout(e, n, k, (int)sizeof(T), kPerm);
  unsigned char* const buf0 = smem + lay.buf;   // buffer b at b*buf_bytes
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long row_bytes = (long long)e * (long long)sizeof(T);
  const long long groups = (rows + k - 1) / k;

  // the tables and the first group in one batch of copies: one round trip
  const int32_t* s_perm = kPerm ? stage_table(smem, perm, e) : nullptr;
  const int32_t* s_lo = stage_table(smem + lay.lo, lo, n);
  const int32_t* s_hi = stage_table(smem + lay.hi, hi, n);
  long long g = blockIdx.x;
  if (g < groups)
    stage_span(buf0, xb + g * k * row_bytes,
               xb + min(rows, (g + 1) * k) * row_bytes);
  cp_async_commit();
  int cur = 0;
  for (; g < groups; g += gridDim.x) {
    const long long next = g + gridDim.x;
    if (next < groups)
      stage_span(buf0 + (cur ^ 1) * lay.buf_bytes,
                 xb + next * k * row_bytes,
                 xb + min(rows, (next + 1) * k) * row_bytes);
    cp_async_commit();
    cp_async_wait_one();   // this group's copy (all but the newest)
    __syncthreads();
    const long long r0 = g * k;
    const uintptr_t skew =
        reinterpret_cast<uintptr_t>(xb + r0 * row_bytes) & 15;
    sum_group<T, kPerm>(
        reinterpret_cast<const T*>(buf0 + cur * lay.buf_bytes + skew),
        s_perm, s_lo, s_hi, out + r0 * n,
        (int)min((long long)k, rows - r0), e, n);
    __syncthreads();       // before the buffer is refilled
    cur ^= 1;
  }
}

template <typename T, bool kPerm>
__global__ void __launch_bounds__(kThreads)
    segment_tiled_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ perm,
                         const int32_t* __restrict__ lo,
                         const int32_t* __restrict__ hi,
                         int32_t* __restrict__ out, long long rows, int e,
                         int n, int perm_cap) {
  extern __shared__ __align__(16) int32_t s_slice[];
  __shared__ int s_first, s_end;
  const int tiles = (n + kThreads - 1) / kThreads;
  const int tile = (int)(blockIdx.x % tiles);
  const long long stride = gridDim.x / tiles;   // the grid is tiles*stride
  const int node = tile * kThreads + threadIdx.x;
  const bool live = node < n;
  const int j0 = live ? lo[node] : 0;
  const int j1 = live ? max(hi[node], j0) : 0;
  bool staged = false;
  int first = 0;
  if (kPerm) {
    if (threadIdx.x == 0) {
      s_first = INT_MAX;
      s_end = INT_MIN;
    }
    __syncthreads();
    if (j1 > j0) {
      atomicMin(&s_first, j0);
      atomicMax(&s_end, j1);
    }
    __syncthreads();
    first = s_first;
    const long long span = (long long)s_end - s_first;
    staged = span > 0 && span <= perm_cap;   // the same on every thread
    if (staged) {
      for (int i = threadIdx.x; i < span; i += kThreads)
        s_slice[i] = perm[first + i];
      __syncthreads();
    }
  }
  for (long long r = blockIdx.x / tiles; r < rows; r += stride * kRowChunk) {
    unsigned int acc[kRowChunk];
#pragma unroll
    for (int q = 0; q < kRowChunk; ++q) acc[q] = 0u;
#pragma unroll 4
    for (int j = j0; j < j1; ++j) {
      const int col =
          kPerm ? (staged ? s_slice[j - first] : __ldg(perm + j)) : j;
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        const long long rq = r + q * stride;
        if (rq < rows) acc[q] += (unsigned int)__ldg(x + rq * e + col);
      }
    }
    if (live) {
#pragma unroll
      for (int q = 0; q < kRowChunk; ++q) {
        const long long rq = r + q * stride;
        if (rq < rows) out[rq * n + node] = (int32_t)acc[q];
      }
    }
  }
}

// Blocks of one kernel that fit on the card at once at `smem` bytes each,
// cached per kernel and device for the last kSlots shares (the wrapper's
// host time counts on the small calls, and a path calls one kernel at a
// few shapes in turn). The kernel's dynamic shared-memory limit is raised
// to `smem` first: the default 48 KB counts the kernel's static shared
// memory too, so a 48 KB dynamic share is already over it.
constexpr int kSlots = 4;
struct Occupancy {
  int device = -1, sms = 0, limit = 0, next = 0;
  int smem[kSlots] = {-1, -1, -1, -1}, per_sm[kSlots] = {};
};

std::mutex g_occupancy_lock;

template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, Occupancy& c, int smem,
                            long long* total) {
  std::lock_guard<std::mutex> hold(g_occupancy_lock);
  int device = 0;
  cudaError_t st = cudaGetDevice(&device);
  if (st != cudaSuccess) return st;
  if (device != c.device) {
    c = Occupancy();
    st = cudaDeviceGetAttribute(&c.sms, cudaDevAttrMultiProcessorCount,
                                device);
    if (st != cudaSuccess) return st;
    c.device = device;
  }
  int slot = 0;
  while (slot < kSlots && c.smem[slot] != smem) ++slot;
  if (slot == kSlots) {
    if (smem > c.limit) {
      st = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (st != cudaSuccess) return st;
      c.limit = smem;
    }
    slot = c.next;
    c.next = (c.next + 1) % kSlots;
    c.smem[slot] = -1;
    st = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&c.per_sm[slot],
                                                       kernel, kThreads, smem);
    if (st != cudaSuccess) return st;
    c.smem[slot] = smem;
  }
  *total = (long long)c.per_sm[slot] * c.sms;
  return cudaSuccess;
}

template <typename T, bool kPerm>
int launch_segment_sum(const T* x, const int32_t* perm, const int32_t* lo,
                       const int32_t* hi, int32_t* out, long long rows,
                       int e, int n, int path, int k, int smem,
                       cudaStream_t stream) {
  static Occupancy staged_occ, tiled_occ;
  if (rows < 0 || e < 0 || n < 0 || smem < 0 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  if (path == kStaged) {
    if (k < 1 || staged_layout(e, n, k, (int)sizeof(T), kPerm).bytes > smem)
      return (int)cudaErrorInvalidValue;
  } else if (path != kTiled) {
    return (int)cudaErrorInvalidValue;
  }
  if (rows == 0 || n == 0) return (int)cudaGetLastError();
  long long resident = 0;
  cudaError_t st;
  if (path == kStaged) {
    st = resident_blocks(segment_staged_kernel<T, kPerm>, staged_occ, smem,
                         &resident);
    if (st != cudaSuccess) return (int)st;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    const long long grid = std::min((rows + k - 1) / k, resident);
    segment_staged_kernel<T, kPerm>
        <<<(unsigned int)grid, kThreads, (size_t)smem, stream>>>(
            x, perm, lo, hi, out, rows, e, n, k);
  } else {
    st = resident_blocks(segment_tiled_kernel<T, kPerm>, tiled_occ, smem,
                         &resident);
    if (st != cudaSuccess) return (int)st;
    if (resident < 1) return (int)cudaErrorInvalidConfiguration;
    const long long tiles = (n + kThreads - 1) / kThreads;
    const long long stride =
        std::max(1LL, std::min(rows, (resident + tiles - 1) / tiles));
    if (tiles * stride > INT_MAX) return (int)cudaErrorInvalidConfiguration;
    segment_tiled_kernel<T, kPerm>
        <<<(unsigned int)(tiles * stride), kThreads, (size_t)smem,
           stream>>>(x, perm, lo, hi, out, rows, e, n, smem / 4);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int segment_sum(const T* x, const int32_t* perm, const int32_t* lo,
                const int32_t* hi, int32_t* out, long long rows, int e,
                int n, int path, int k, int smem, void* stream) {
  return perm ? launch_segment_sum<T, true>(x, perm, lo, hi, out, rows, e,
                                            n, path, k, smem,
                                            (cudaStream_t)stream)
              : launch_segment_sum<T, false>(x, perm, lo, hi, out, rows, e,
                                             n, path, k, smem,
                                             (cudaStream_t)stream);
}

// Byte offsets of spread's staged shared memory: the window of idx, then
// buffers 0 and 1 of k rows of x each (stage_span's windows, 15 bytes of
// slack each); kernels/segment.spread_smem_bytes gives the same total.
struct Spread {
  long long buf, buf_bytes, bytes;
};

__host__ __device__ inline Spread spread_layout(int e, int n, int k,
                                                int size) {
  Spread s;
  s.buf = align16(4LL * e + 15);
  s.buf_bytes = align16((long long)k * n * size + 15);
  s.bytes = s.buf + 2 * s.buf_bytes;
  return s;
}

// The 4-output word one thread stores: 4 bytes for bool, an int4 for
// int32
template <typename T> struct Word4;
template <> struct Word4<uint8_t> {
  using type = uint32_t;
  __device__ static uint32_t pack(const uint8_t* v) {
    return (uint32_t)v[0] | (uint32_t)v[1] << 8 | (uint32_t)v[2] << 16 |
           (uint32_t)v[3] << 24;
  }
};
template <> struct Word4<int32_t> {
  using type = int4;
  __device__ static int4 pack(const int32_t* v) {
    return make_int4(v[0], v[1], v[2], v[3]);
  }
};

// The outputs of krows rows, out[0, krows * e) (row q at out + q * e):
// out[q, j] = v[q * n + idx[j]]. The rows are one contiguous span, so it
// is cut at the first 4-output boundary of the word size: scalars before
// it and after the last whole word, one word of 4 outputs per thread in
// between. A thread finds its first output's row with one 32-bit
// division and steps through the next three.
template <typename T>
__device__ inline void spread_rows(const T* v, const int32_t* idx, T* out,
                                   int krows, int n, int e) {
  using W = typename Word4<T>::type;
  const int total = krows * e;
  const int mis = (int)((reinterpret_cast<uintptr_t>(out) % sizeof(W)) /
                        sizeof(T));
  const int head = min(total, mis ? 4 - mis : 0);
  const int words = (total - head) / 4;
  const int tail = head + 4 * words;
  for (int i = threadIdx.x; i < head + (total - tail); i += kThreads) {
    const int o = i < head ? i : tail + (i - head);
    const int q = o / e;
    out[o] = v[q * n + idx[o - q * e]];
  }
  W* wout = reinterpret_cast<W*>(out + head);
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int o = head + 4 * w;
    int q = o / e, j = o - q * e;
    T vals[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      vals[i] = v[q * n + idx[j]];
      if (++j == e) {
        j = 0;
        ++q;
      }
    }
    wout[w] = Word4<T>::pack(vals);
  }
}

// spread, staged: a persistent grid; each block stages idx once, then
// for each group of k rows it owns, x's k rows (one contiguous span,
// 16-byte cp.async, the next group's copy in flight while the block
// writes the current one) and writes the group's k * e outputs in words.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spread_staged_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ idx,
                         T* __restrict__ out, long long rows, int n, int e,
                         int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Spread lay = spread_layout(e, n, k, (int)sizeof(T));
  unsigned char* const buf0 = smem + lay.buf;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);
  const long long row_bytes = (long long)n * (long long)sizeof(T);
  const long long groups = (rows + k - 1) / k;
  const int32_t* s_idx = stage_table(smem, idx, e);
  long long g = blockIdx.x;
  if (g < groups)
    stage_span(buf0, xb + g * k * row_bytes,
               xb + min(rows, (g + 1) * k) * row_bytes);
  cp_async_commit();
  int cur = 0;
  for (; g < groups; g += gridDim.x) {
    const long long next = g + gridDim.x;
    if (next < groups)
      stage_span(buf0 + (cur ^ 1) * lay.buf_bytes,
                 xb + next * k * row_bytes,
                 xb + min(rows, (next + 1) * k) * row_bytes);
    cp_async_commit();
    cp_async_wait_one();   // this group's copy (all but the newest)
    __syncthreads();
    const long long r0 = g * k;
    const uintptr_t skew =
        reinterpret_cast<uintptr_t>(xb + r0 * row_bytes) & 15;
    spread_rows<T>(
        reinterpret_cast<const T*>(buf0 + cur * lay.buf_bytes + skew), s_idx,
        out + r0 * e, (int)min((long long)k, rows - r0), n, e);
    __syncthreads();       // before the buffer is refilled
    cur ^= 1;
  }
}

// spread, direct: rows whose tables and two row buffers do not fit the
// plan's share read idx and x through L1 and L2; one row per block step,
// the same words.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    spread_direct_kernel(const T* __restrict__ x,
                         const int32_t* __restrict__ idx,
                         T* __restrict__ out, long long rows, int n, int e) {
  for (long long r = blockIdx.x; r < rows; r += gridDim.x)
    spread_rows<T>(x + r * n, idx, out + r * e, 1, n, e);
}

template <typename T>
int launch_spread(const T* x, const int32_t* idx, T* out, long long rows,
                  int n, int e, int k, int smem, cudaStream_t stream) {
  static Occupancy staged_occ, direct_occ;
  if (rows < 0 || n < 0 || e < 0 || k < 0 || smem < 0 || smem > kSmemLimit)
    return (int)cudaErrorInvalidValue;
  // the row span of a group and a block's outputs are 32-bit offsets
  if ((long long)max(k, 1) * max(n, e) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  if (k > 0 && spread_layout(e, n, k, (int)sizeof(T)).bytes > smem)
    return (int)cudaErrorInvalidValue;
  if (rows == 0 || e == 0) return (int)cudaGetLastError();
  long long resident = 0;
  const cudaError_t st =
      k > 0 ? resident_blocks(spread_staged_kernel<T>, staged_occ, smem,
                              &resident)
            : resident_blocks(spread_direct_kernel<T>, direct_occ, 0,
                              &resident);
  if (st != cudaSuccess) return (int)st;
  if (resident < 1) return (int)cudaErrorInvalidConfiguration;
  if (k > 0) {
    const long long grid = std::min((rows + k - 1) / k, resident);
    spread_staged_kernel<T><<<(unsigned int)grid, kThreads, (size_t)smem,
                              stream>>>(x, idx, out, rows, n, e, k);
  } else {
    spread_direct_kernel<T><<<(unsigned int)std::min(rows, resident),
                              kThreads, 0, stream>>>(x, idx, out, rows, n,
                                                     e);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// perm may be null (sum_segments: edges already in segment order); path,
// k (rows per group) and smem (bytes) are kernels/segment.segment_plan's
int clsim_segment_sum_i32(const int32_t* x, const int32_t* perm,
                          const int32_t* lo, const int32_t* hi, int32_t* out,
                          long long rows, int e, int n, int path, int k,
                          int smem, void* stream) {
  return segment_sum<int32_t>(x, perm, lo, hi, out, rows, e, n, path, k,
                              smem, stream);
}

int clsim_segment_sum_u8(const uint8_t* x, const int32_t* perm,
                         const int32_t* lo, const int32_t* hi, int32_t* out,
                         long long rows, int e, int n, int path, int k,
                         int smem, void* stream) {
  return segment_sum<uint8_t>(x, perm, lo, hi, out, rows, e, n, path, k,
                              smem, stream);
}

// k (rows per staged group, 0: direct) and smem (bytes) are
// kernels/segment.spread_plan's
int clsim_spread_i32(const int32_t* x, const int32_t* idx, int32_t* out,
                     long long rows, int n, int e, int k, int smem,
                     void* stream) {
  return launch_spread<int32_t>(x, idx, out, rows, n, e, k, smem,
                                (cudaStream_t)stream);
}

int clsim_spread_u8(const uint8_t* x, const int32_t* idx, uint8_t* out,
                    long long rows, int n, int e, int k, int smem,
                    void* stream) {
  return launch_spread<uint8_t>(x, idx, out, rows, n, e, k, smem,
                                (cudaStream_t)stream);
}

}  // extern "C"
