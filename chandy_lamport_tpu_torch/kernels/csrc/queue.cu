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
// append_rows: the whole routed append of a tick in one launch, one thread
//   per (lane, row): a lane's rows take G threads, G the least power of
//   two >= 32 and >= W (the row width), at most 256, so a block holds
//   256 / G whole lanes (narrow rows) or a lane spans ceil(W / 256)
//   blocks (wide ones), and the grid is bounded only by 2^31 - 1 blocks.
//   Each active row packs its slot word (rt << 1 | marker,
//   core/state.pack_meta) and writes it and the payload at (head + len) %
//   C IN PLACE in both planes, then advances its own q_len and tok_pushed
//   in place; the lane's overflow bits (ERR_VALUE_OVERFLOW on tok_pushed
//   >= key_limit or rt >= RTIME_PACK_LIMIT, ERR_QUEUE_OVERFLOW on len >=
//   C) reduce by a warp OR (a warp lies in one lane) and one atomicOr per
//   warp into the lane's error word, in place. So the caller's pack, adds
//   and error OR and the wrapper's zeroed error buffer are gone: one
//   launch per append. The per-row inputs (active, rt, marker, data) are
//   read through (lane, edge) element strides, so an expanded [E] or [B]
//   operand needs no copy.
// append_marker_rows: SendToNeighbors for one node per lane, routed in the
//   same launch, W = D (the widest out-edge row): thread k of lane b takes
//   node[b]'s out-edge src_lo + k, k below its out-degree (edges are
//   sorted by (src, dst), so that is dest order), and the k-th receive
//   time rt[b, k] of the
//   [B, D] block the sampler drew, the marker bit and the lane's payload
//   data[b]; a lane outside ``mask`` appends nothing. It replaces the
//   caller's two dense [B, E + 1] scatter_s and their copies.
// Bound (chip_smoke.py counts it from the run's inputs): each input read
//   once (the [B, E] active mask; per active row head, len, tok_pushed, rt
//   and data, 4 B each) and each output written once, every scattered slot
//   write as the 32-byte sector it dirties (2 x 32 B a row), q_len and
//   tok_pushed 4 B each, the error word read and written once a lane. At
//   the exact token send (1,048,576 of 3,145,728 rows) about 100 MB, 0.030
//   ms; the broadcast moves under 1 MB. The kernel is bound by its launch.
// Ownership: the caller owns the planes and the three counter leaves it
//   passes (ops/tick.py's module docstring lists the call sites).

// Modulus: CUDA's % truncates toward zero where PyTorch's floors; every
// modulus here has non-negative operands (head in [0, C), len >= 0), so
// the two agree.
//
// Each entry point launches on the given stream and returns
// cudaGetLastError(); the Python wrapper raises on non-zero.

#include <cstdint>
#include <cuda_runtime.h>

// ops/tick.TickKernel._append_rows's operands, mirrored by
// kernels/queue._AppendArgs: the state's planes and counters, the per-row
// inputs by (lane, edge) element strides (mk == nullptr: every row's
// marker bit is mk_all), and for the routed form the lanes' nodes, masks
// and payloads by their lane strides, the out-edge ranges and the [B, D]
// receive times by (lane, ordinal) strides.
// At global scope: the C entry point takes it, so it has external linkage
struct AppendArgs {
  int32_t* q_meta;        // [B, E, C]
  int32_t* q_data;
  const int32_t* q_head;  // [B, E]
  int32_t* q_len;
  int32_t* tok_pushed;
  int32_t* error;         // [B]
  const uint8_t* active;  // row form: [B, E] by strides; routed: [B]
  const int32_t* rt;
  const uint8_t* mk;
  const int32_t* data;    // row form: [B, E] by strides; routed: [B]
  const int32_t* node;    // routed: [B]
  const int32_t* src_lo;  // routed: [N]
  const int32_t* src_hi;
  long long act_sb, act_se, rt_sb, rt_se, mk_sb, mk_se, data_sb, data_se;
  long long node_sb;       // routed: node [B] by its stride
  long long b;
  int e, c, key_limit, flag_queue_overflow, mk_all;
  int width;              // W: E (row form) or D (routed)
};

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

// one message on edge ``i`` (a flat (lane, edge) row) at its ring's tail,
// in place; returns its overflow bits
__device__ __forceinline__ unsigned append_one(const AppendArgs& a,
                                               long long i, int32_t rt,
                                               bool marker, int32_t data) {
  const int32_t len = a.q_len[i];
  const int32_t pushed = a.tok_pushed[i];
  unsigned bits = 0;
  if (pushed >= a.key_limit || rt >= kRtimePackLimit)
    bits |= kErrValueOverflow;
  if (a.flag_queue_overflow && len >= a.c) bits |= kErrQueueOverflow;
  const long long slot = i * a.c + (a.q_head[i] + len) % a.c;
  a.q_meta[slot] = (int32_t)((uint32_t)rt * 2u + (marker ? 1u : 0u));
  a.q_data[slot] = data;
  a.q_len[i] = len + 1;
  a.tok_pushed[i] = pushed + 1;
  return bits;
}

// The lane and the row of this thread (``group``, ``blocks_per_lane``:
// the grid's layout, clsim_append_rows)
struct RowAt {
  long long lane;
  int row;
};

__device__ __forceinline__ RowAt row_at(int group, int blocks_per_lane) {
  const long long chunk = blockIdx.x / blocks_per_lane;
  return {chunk * (kThreads / group) + threadIdx.x / group,
          (int)(blockIdx.x % blocks_per_lane) * group +
              (int)(threadIdx.x % group)};
}

// The lane's overflow bits into its error word, in place: a warp OR (a
// warp lies in one lane), then one atomicOr a warp. Every thread of the
// warp calls it.
__device__ __forceinline__ void or_into_error(const AppendArgs& a,
                                              unsigned bits, long long lane) {
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0 && bits && lane < a.b)
    atomicOr(a.error + lane, (int32_t)bits);
}

__global__ void __launch_bounds__(kThreads)
append_rows_kernel(const AppendArgs a, int group, int blocks_per_lane) {
  const RowAt at = row_at(group, blocks_per_lane);
  const long long lane = at.lane;
  const int f = at.row;
  unsigned bits = 0;
  if (lane < a.b && f < a.e && a.active[lane * a.act_sb + f * a.act_se]) {
    const bool marker =
        a.mk ? a.mk[lane * a.mk_sb + f * a.mk_se] != 0 : a.mk_all != 0;
    bits = append_one(a, lane * a.e + f, a.rt[lane * a.rt_sb + f * a.rt_se],
                      marker, a.data[lane * a.data_sb + f * a.data_se]);
  }
  // no thread returned early: the whole warp takes part in the reduce
  or_into_error(a, bits, lane);
}

__global__ void __launch_bounds__(kThreads)
append_marker_rows_kernel(const AppendArgs a, int group,
                          int blocks_per_lane) {
  const RowAt at = row_at(group, blocks_per_lane);
  const long long lane = at.lane;
  const int k = at.row;
  unsigned bits = 0;
  if (lane < a.b && a.active[lane * a.act_sb]) {
    const int v = a.node[lane * a.node_sb];
    const int lo = a.src_lo[v];
    if (k < a.src_hi[v] - lo)
      bits = append_one(a, lane * a.e + lo + k,
                        a.rt[lane * a.rt_sb + k * a.rt_se], true,
                        a.data[lane * a.data_sb]);
  }
  or_into_error(a, bits, lane);
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

// routed = 0: append_rows over [B, E]; 1: append_marker_rows over the
// lanes' out-edge rows of width D
int clsim_append_rows(const AppendArgs* a, int routed, void* stream) {
  if (a->b > 0 && a->width > 0) {
    int group = 32;
    while (group < a->width && group < kThreads) group *= 2;
    const int per_lane = (a->width + group - 1) / group;
    const long long per_block = kThreads / group;
    const long long blocks = (a->b + per_block - 1) / per_block * per_lane;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    if (routed)
      append_marker_rows_kernel<<<(unsigned int)blocks, kThreads, 0,
                                  (cudaStream_t)stream>>>(*a, group,
                                                          per_lane);
    else
      append_rows_kernel<<<(unsigned int)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(*a, group, per_lane);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
