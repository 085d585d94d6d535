// Ring-queue kernels of the sync and exact storms, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of chandy_lamport_tpu/kernels/queue.py:
//   head_fields (:63)  -> clsim_head_fields
//   queue_step (:92)   -> clsim_queue_step
//   select_pop (:119)  -> clsim_select_pop
//   append_rows (:157) -> clsim_append_rows
//
// The rings are packed planes q_meta/q_data [B, E, C] int32, a slot word
// q_meta = rtime << 1 | is_marker (core/state.pack_meta). The Pallas
// kernels address the planes with one-hot [E, C] masks because a TPU has
// no in-kernel scatter or gather; here a thread addresses its one slot.
//
// head_fields: one thread per (b, e) reads q_head, loads that slot of
//   both planes and writes rtime = meta >> 1, is_marker = meta & 1 and
//   data. Bound at config 4 (B=2048, E=3063): the gather moves q_head
//   (4 B), one meta and one data word (8 B) in and 9 B out per row, about
//   130 MB -> about 39 us at 3.35 TB/s; each gathered word drags its
//   32-byte sector, which the design accepts (rows are 64 B apart).
//
// queue_step: the exact tick's delivery selection (_queue_step_kernel,
//   queue.py:76-89): head gather, eligibility len > 0 && rtime <= time[b],
//   the first eligible edge of each source in dest order, and its pop.
//   One thread per (b, source node) walks the source's outbound edges
//   [src_lo, src_hi) in edge (= dest) order. The Pallas form selects an
//   edge when its exclusive prefix count of eligible edges equals the
//   count at its source's first edge (_select :47-52), i.e. when no
//   earlier edge of the same contiguous segment is eligible: that is
//   exactly "the first eligible edge of the segment", which the walk
//   finds directly, with no scan. Every edge writes head_data (the word
//   at its head slot, stale for an empty ring, as the gather reads it)
//   and its head/len (popped only where selected). time[b] is per lane,
//   as vmap gives each lane its own scalar. Bound at the exact-at-scale
//   cell (er-256, B=4096, E=768): per (lane, edge) 8 B of head/len and 8 B
//   of gathered slot words in, 1+1+4+4+4 B out = 30 B, about 94 MB ->
//   about 28 us at 3.35 TB/s; adjacent threads walk adjacent edge ranges,
//   so loads are only partly coalesced, which the simple design accepts.
//
// select_pop: the selection + pop of the faulted exact tick
//   (_select_pop_kernel, queue.py:111-116), where the fault gates (jitter
//   stalls, crashed destinations) edit the eligibility mask between the
//   head read (head_fields) and the selection. The same walk as
//   queue_step: one thread per (b, source node) over [src_lo, src_hi),
//   selecting the first eligible edge of the segment, and writing sel,
//   new_head = (head + sel) % c and new_len = len - sel on every edge of
//   the segment. Bound at the faulted exact cell (er-256, B=4096, E=768):
//   per (lane, edge) 4 + 4 + 1 B in and 1 + 4 + 4 B out = 18 B, about
//   57 MB -> about 17 us at 3.35 TB/s; the loads are partly coalesced, as
//   in queue_step.
//
// append_rows: one thread per (b, e) on a 1-D grid of ceil(E / 256)
//   blocks per lane (block -> lane = blockIdx.x / blocks-per-lane), so a
//   block, and every warp in it, lies in one lane and the lane count is
//   bounded only by the 2^31 - 1 grid limit. An active edge writes its one
//   slot at (head + len) % C IN PLACE in both planes; the Pallas form
//   rewrites the whole [E, C] plane, which at config 4 would move
//   2 x 401 MB per phase. The error word of a lane (ERR_VALUE_OVERFLOW on
//   tok_pushed >= key_limit or rt >= RTIME_PACK_LIMIT, ERR_QUEUE_OVERFLOW
//   on len >= C) is a warp OR (__reduce_or_sync) plus one atomicOr per
//   warp into err[b], which the wrapper zeroes. q_len/tok_pushed advance
//   in the caller. Bound at config 4: 25 B per row read + 8 B per active
//   row written, about 180 MB -> about 54 us.
//
// Modulus: CUDA's % truncates toward zero where PyTorch's floors; every
// modulus here has non-negative operands (head in [0, C), len >= 0), so
// the two agree.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises on non-zero.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kErrQueueOverflow = 1;       // core/state.ERR_QUEUE_OVERFLOW
constexpr int kErrValueOverflow = 32;      // core/state.ERR_VALUE_OVERFLOW
constexpr int kRtimePackLimit = 1 << 30;   // core/state.RTIME_PACK_LIMIT

__global__ void head_fields_kernel(const int32_t* __restrict__ q_meta,
                                   const int32_t* __restrict__ q_data,
                                   const int32_t* __restrict__ q_head,
                                   int32_t* __restrict__ rtime,
                                   uint8_t* __restrict__ is_marker,
                                   int32_t* __restrict__ data,
                                   long long rows, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long slot = i * c + q_head[i];
  const int32_t meta = q_meta[slot];
  rtime[i] = meta >> 1;               // arithmetic, as jnp's >> on int32
  is_marker[i] = (uint8_t)(meta & 1);
  data[i] = q_data[slot];
}

__global__ void queue_step_kernel(const int32_t* __restrict__ q_meta,
                                  const int32_t* __restrict__ q_data,
                                  const int32_t* __restrict__ q_head,
                                  const int32_t* __restrict__ q_len,
                                  const int32_t* __restrict__ time,
                                  const int32_t* __restrict__ src_lo,
                                  const int32_t* __restrict__ src_hi,
                                  uint8_t* __restrict__ tok,
                                  uint8_t* __restrict__ mk,
                                  int32_t* __restrict__ head_data,
                                  int32_t* __restrict__ new_head,
                                  int32_t* __restrict__ new_len,
                                  long long rows, int n, int e, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long b = i / n;
  const int node = (int)(i - b * n);
  const int32_t t = time[b];
  bool found = false;
  for (int k = src_lo[node]; k < src_hi[node]; ++k) {
    const long long r = b * e + k;
    const int32_t head = q_head[r];
    const int32_t len = q_len[r];
    const long long slot = r * c + head;
    const int32_t meta = q_meta[slot];
    head_data[r] = q_data[slot];
    // arithmetic >>, as jnp's on int32; the first eligible edge wins
    const bool sel = !found && len > 0 && (meta >> 1) <= t;
    found = found || sel;
    tok[r] = (uint8_t)(sel && !(meta & 1));
    mk[r] = (uint8_t)(sel && (meta & 1));
    new_head[r] = sel ? (head + 1) % c : head;
    new_len[r] = len - (int32_t)sel;
  }
}

__global__ void select_pop_kernel(const int32_t* __restrict__ q_head,
                                  const int32_t* __restrict__ q_len,
                                  const uint8_t* __restrict__ elig,
                                  const int32_t* __restrict__ src_lo,
                                  const int32_t* __restrict__ src_hi,
                                  uint8_t* __restrict__ sel,
                                  int32_t* __restrict__ new_head,
                                  int32_t* __restrict__ new_len,
                                  long long rows, int n, int e, int c) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= rows) return;
  const long long b = i / n;
  const int node = (int)(i - b * n);
  bool found = false;
  for (int k = src_lo[node]; k < src_hi[node]; ++k) {
    const long long r = b * e + k;
    const int32_t head = q_head[r];
    // the first eligible edge of the segment wins
    const bool s = !found && elig[r];
    found = found || s;
    sel[r] = (uint8_t)s;
    new_head[r] = s ? (head + 1) % c : head;
    new_len[r] = q_len[r] - (int32_t)s;
  }
}

__global__ void append_rows_kernel(int32_t* __restrict__ q_meta,
                                   int32_t* __restrict__ q_data,
                                   const int32_t* __restrict__ q_head,
                                   const int32_t* __restrict__ q_len,
                                   const int32_t* __restrict__ tok_pushed,
                                   const uint8_t* __restrict__ active,
                                   const int32_t* __restrict__ meta,
                                   const int32_t* __restrict__ rt,
                                   const int32_t* __restrict__ data,
                                   int32_t* __restrict__ err,
                                   int e, int c, int key_limit,
                                   int flag_queue_overflow,
                                   unsigned int blocks_per_lane) {
  const long long b = blockIdx.x / blocks_per_lane;
  const int edge = (int)(blockIdx.x % blocks_per_lane) * blockDim.x
                   + threadIdx.x;
  unsigned int bits = 0;
  if (edge < e) {
    const long long i = b * e + edge;
    if (active[i]) {
      const int32_t len = q_len[i];
      if (tok_pushed[i] >= key_limit || rt[i] >= kRtimePackLimit)
        bits |= kErrValueOverflow;
      if (flag_queue_overflow && len >= c) bits |= kErrQueueOverflow;
      const long long slot = i * c + (q_head[i] + len) % c;
      q_meta[slot] = meta[i];
      q_data[slot] = data[i];
    }
  }
  // no thread returned early: the whole warp takes part in the reduce
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits) atomicOr(err + b, (int)bits);
}

}  // namespace

extern "C" {

int clsim_head_fields(const int32_t* q_meta, const int32_t* q_data,
                      const int32_t* q_head, int32_t* rtime,
                      uint8_t* is_marker, int32_t* data, long long rows,
                      int c, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    head_fields_kernel<<<(unsigned int)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
        q_meta, q_data, q_head, rtime, is_marker, data, rows, c);
  }
  return (int)cudaGetLastError();
}

int clsim_queue_step(const int32_t* q_meta, const int32_t* q_data,
                     const int32_t* q_head, const int32_t* q_len,
                     const int32_t* time, const int32_t* src_lo,
                     const int32_t* src_hi, uint8_t* tok, uint8_t* mk,
                     int32_t* head_data, int32_t* new_head, int32_t* new_len,
                     long long rows, int n, int e, int c, void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    queue_step_kernel<<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        q_meta, q_data, q_head, q_len, time, src_lo, src_hi, tok, mk,
        head_data, new_head, new_len, rows, n, e, c);
  }
  return (int)cudaGetLastError();
}

int clsim_select_pop(const int32_t* q_head, const int32_t* q_len,
                     const uint8_t* elig, const int32_t* src_lo,
                     const int32_t* src_hi, uint8_t* sel, int32_t* new_head,
                     int32_t* new_len, long long rows, int n, int e, int c,
                     void* stream) {
  if (rows > 0) {
    const long long blocks = (rows + kThreads - 1) / kThreads;
    select_pop_kernel<<<(unsigned int)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
        q_head, q_len, elig, src_lo, src_hi, sel, new_head, new_len, rows,
        n, e, c);
  }
  return (int)cudaGetLastError();
}

int clsim_append_rows(int32_t* q_meta, int32_t* q_data,
                      const int32_t* q_head, const int32_t* q_len,
                      const int32_t* tok_pushed, const uint8_t* active,
                      const int32_t* meta, const int32_t* rt,
                      const int32_t* data, int32_t* err, long long b, int e,
                      int c, int key_limit, int flag_queue_overflow,
                      void* stream) {
  if (b > 0 && e > 0) {
    const long long per_lane = (e + kThreads - 1) / kThreads;
    if (b * per_lane > 0x7fffffffLL)
      return (int)cudaErrorInvalidConfiguration;
    append_rows_kernel<<<(unsigned int)(b * per_lane), kThreads, 0,
                         (cudaStream_t)stream>>>(
        q_meta, q_data, q_head, q_len, tok_pushed, active, meta, rt, data,
        err, e, c, key_limit, flag_queue_overflow,
        (unsigned int)per_lane);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
