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
// select_pop: the same selection and pop in the faulted exact tick
//   (_select_pop_kernel, queue.py:111-116), over the eligibility mask the
//   fault gates (jitter stalls, crashed destinations) edited between the
//   head read (head_fields) and the selection.
// The selection as a max-scan. The Pallas _select (queue.py:47-52) keeps
//   an eligible edge e when the exclusive prefix count of eligible edges
//   at e equals the count at src_first[e], its source's first edge: when
//   no edge of [src_first[e], e) is eligible. With last(e) the largest
//   eligible k < e (-1 if none), that is
//       sel[e] = elig[e] && last(e) < src_first[e],
//   and max is associative, so last(e) carries across lanes, warps and
//   tiles with no per-segment logic: within a warp it is the highest set
//   bit of the eligibility ballot below the thread's lane; across the
//   block's chunks of 32 edges, an exclusive max-scan of one word a chunk
//   by warp 0; across the block's tiles, the running maximum. So one
//   thread takes one edge of each of kItems chunks of the tile (striped:
//   base + j * 256 + tid), a warp's loads and byte stores fall on 32
//   consecutive edges, and every load of a thread (head, len, then both
//   slot words) is issued before the scan.
// Ownership: a lane's edges are cut into tiles of T = 256 * kItems
//   (kItems = ceil(E / 256), at most 4); block k of the lane owns the
//   edges whose segment starts in [k T, (k + 1) T), read off src_first
//   alone. It scans from k T, tile by tile, while the next tile's first
//   edge is still its own, so a segment of any length is walked whole by
//   the block it starts in, and no carry leaves a block. The edges before
//   the block's first segment start belong to an earlier block: they are
//   not loaded and count as not eligible, which changes no selection,
//   since every such edge lies before the owned edges' src_first.
// Bounds (chip_smoke.py counts them from the run's inputs): queue_step per
//   (lane, edge) its head and len (8 B), its two gathered slot words as
//   the 32-byte sectors they come in (64 B) and 1 + 1 + 4 + 4 + 4 B out =
//   86 B, 0.0808 ms at the exact cell's [4096,768,24] and 0.323 ms at
//   config 5's [512,24572,24] at 3.35 TB/s; select_pop 4 + 4 + 1 B in and
//   1 + 4 + 4 B out = 18 B, 0.0169 ms at [4096,768].
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

// The operands of queue_step (kGather) and select_pop: select_pop reads
// elig and writes sel through ``tok``.
struct SelectArgs {
  const int32_t* q_meta;     // [B, E, C] (kGather)
  const int32_t* q_data;
  const int32_t* q_head;     // [B, E]
  const int32_t* q_len;
  const int32_t* time;       // [B] (kGather)
  const uint8_t* elig;       // [B, E] (select_pop)
  const int32_t* src_first;  // [E]
  uint8_t* tok;              // [B, E]: tok, or select_pop's sel
  uint8_t* mk;               // (kGather)
  int32_t* head_data;        // (kGather)
  int32_t* new_head;
  int32_t* new_len;
  int e, c, blocks_per_lane;
};

template <bool kGather, int kItems>
__global__ void __launch_bounds__(kThreads)
select_kernel(const SelectArgs a) {
  constexpr int kTile = kThreads * kItems;
  constexpr int kWarps = kThreads / 32;
  constexpr int kChunks = kItems * kWarps;   // chunks of 32 edges a tile
  static_assert(kChunks <= 32, "warp 0 scans one chunk a lane");
  __shared__ int chunk_last[kChunks];    // the chunk's last eligible edge
  __shared__ int chunk_before[kChunks];  // the last one before the chunk
  const unsigned lane = blockIdx.x / a.blocks_per_lane;
  const int lo = (int)(blockIdx.x - lane * a.blocks_per_lane) * kTile;
  const int warp = threadIdx.x >> 5;
  const int ln = threadIdx.x & 31;
  const long long row0 = (long long)lane * a.e;
  const int32_t t = kGather ? a.time[lane] : 0;
  // an edge is this block's when its segment starts in [lo, lo + kTile)
  auto owned = [&](int edge, int32_t first) {
    return edge < a.e && (uint32_t)first - (uint32_t)lo < (uint32_t)kTile;
  };
  int carry = -1;   // warp 0: the last eligible edge before this tile
  for (int base = lo;; base += kTile) {
    int32_t first[kItems], head[kItems], len[kItems], word[kItems],
        data[kItems];
    bool own[kItems], el[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int edge = base + j * kThreads + threadIdx.x;
      first[j] = edge < a.e ? a.src_first[edge] : -1;
    }
    const int next = base + kTile;
    const bool more = next < a.e && owned(next, a.src_first[next]);
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      const int edge = base + j * kThreads + threadIdx.x;
      own[j] = owned(edge, first[j]);
      if (own[j]) {
        head[j] = a.q_head[row0 + edge];
        len[j] = a.q_len[row0 + edge];
        if (!kGather) word[j] = a.elig[row0 + edge];
      }
    }
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (kGather && own[j]) {
        const long long slot =
            (row0 + base + j * kThreads + threadIdx.x) * a.c + head[j];
        word[j] = a.q_meta[slot];
        data[j] = a.q_data[slot];
      }
    }
    unsigned ballot[kItems];
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      // arithmetic >>, as jnp's on int32
      el[j] = own[j] && (kGather ? len[j] > 0 && (word[j] >> 1) <= t
                                 : word[j] != 0);
      ballot[j] = __ballot_sync(0xffffffffu, el[j]);
      if (ln == 0)
        chunk_last[j * kWarps + warp] =
            ballot[j] ? base + j * kThreads + warp * 32 + 31 -
                            __clz((int)ballot[j])
                      : -1;
    }
    __syncthreads();
    if (warp == 0) {
      int v = ln < kChunks ? chunk_last[ln] : -1;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, v, d);
        if (ln >= d) v = max(v, u);
      }
      int before = __shfl_up_sync(0xffffffffu, v, 1);
      if (ln == 0) before = -1;
      if (ln < kChunks) chunk_before[ln] = max(before, carry);
      carry = max(carry, __shfl_sync(0xffffffffu, v, 31));
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
      if (!own[j]) continue;
      const int edge = base + j * kThreads + threadIdx.x;
      const unsigned below = ballot[j] & ((1u << ln) - 1u);
      const int last = below ? base + j * kThreads + warp * 32 + 31 -
                                   __clz((int)below)
                             : chunk_before[j * kWarps + warp];
      const bool sel = el[j] && last < first[j];
      const long long r = row0 + edge;
      if (kGather) {
        a.tok[r] = (uint8_t)(sel && !(word[j] & 1));
        a.mk[r] = (uint8_t)(sel && (word[j] & 1));
        a.head_data[r] = data[j];   // stale for an empty ring
      } else {
        a.tok[r] = (uint8_t)sel;
      }
      a.new_head[r] = sel ? (head[j] + 1) % a.c : head[j];
      a.new_len[r] = len[j] - (int32_t)sel;
    }
    if (!more) break;
  }
}

// One launch of the selection over ``lanes`` lanes, kItems from E
template <bool kGather>
int launch_select(SelectArgs a, long long lanes, void* stream) {
  if (lanes > 0 && a.e > 0) {
    const int items = a.e > 3 * kThreads ? 4 : (a.e + kThreads - 1) / kThreads;
    a.blocks_per_lane = (a.e + kThreads * items - 1) / (kThreads * items);
    const long long blocks = lanes * a.blocks_per_lane;
    if (blocks > 0x7fffffffLL || a.e > 0x7fffffff - 2 * 4 * kThreads)
      return (int)cudaErrorInvalidConfiguration;
    const dim3 grid((unsigned int)blocks);
    cudaStream_t st = (cudaStream_t)stream;
    switch (items) {
      case 1: select_kernel<kGather, 1><<<grid, kThreads, 0, st>>>(a);
        break;
      case 2: select_kernel<kGather, 2><<<grid, kThreads, 0, st>>>(a);
        break;
      case 3: select_kernel<kGather, 3><<<grid, kThreads, 0, st>>>(a);
        break;
      default: select_kernel<kGather, 4><<<grid, kThreads, 0, st>>>(a);
    }
  }
  return (int)cudaGetLastError();
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
                     const int32_t* time, const int32_t* src_first,
                     uint8_t* tok, uint8_t* mk, int32_t* head_data,
                     int32_t* new_head, int32_t* new_len, long long lanes,
                     int e, int c, void* stream) {
  const SelectArgs a{q_meta,    q_data, q_head,    q_len,    time,
                     nullptr,   src_first, tok,    mk,       head_data,
                     new_head,  new_len, e,        c,        0};
  return launch_select<true>(a, lanes, stream);
}

int clsim_select_pop(const int32_t* q_head, const int32_t* q_len,
                     const uint8_t* elig, const int32_t* src_first,
                     uint8_t* sel, int32_t* new_head, int32_t* new_len,
                     long long lanes, int e, int c, void* stream) {
  const SelectArgs a{nullptr,  nullptr, q_head,  q_len,   nullptr,
                     elig,     src_first, sel,   nullptr, nullptr,
                     new_head, new_len, e,       c,       0};
  return launch_select<false>(a, lanes, stream);
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
