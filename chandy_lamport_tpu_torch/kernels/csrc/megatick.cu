// The fused megatick for Hopper (sm_90a): K exact ticks of every lane in one
// launch.
//
// Replaces the Pallas kernel of chandy_lamport_tpu/kernels/megatick.py:
//   fused_scan (:432, pallas_call :641, with RingStream.commit_and_heads
//   :380) -> clsim_fused_ticks
// for its fault-free, unsupervised, untraced body: each step is a quiet
// bump, the identity, or one cascade tick (ops/tick._cascade_tick with
// faults=None and no supervisor), as kernels/megatick.py's module
// docstring sets out for the modes "ticks", "drain" and "flush".
//
// Design. One block per lane; the K steps loop inside the block, as the
// Pallas kernel's lax.scan runs inside one grid step. A lane's state does
// not fit in a block's shared memory (ER-256: 0.347 MB against 227 KB),
// so the TPU's resident carry does not carry over. The block keeps the
// tick's small working planes in shared memory (carve: the [E]
// vectors, tokens, the [S, N] planes, recording, the [S] vectors; 48,480
// B at ER-256) and reads and writes the [E, C] rings, the [L, E] log and
// the [S, E] windows in device memory in place. The JAX tiled layout
// defers each tick's ring appends into buffers and replays them in one
// block pass (RingStream) because a TPU kernel addresses VMEM by whole
// blocks; a CUDA thread writes its one slot directly, in program order, so
// no deferred pass is needed and an overflowing append clobbers exactly as
// the eager path does.
//
// Per tick:
//   1. selection + pop, one thread per source node walking its edges in
//      dest order (queue_step's walk): the first edge with len > 0 and
//      rtime <= time is popped, its payload kept in head_data;
//   2. the marker fold, sequential, in warp 0: popped markers in ascending
//      edge order; before each, the tokens of the sources ranked below it
//      are credited (warp-parallel, atomicAdd in shared memory) and marked
//      for the log when their channel records at that moment; credits run
//      source range by source range, so a tick credits each edge once,
//      O(E) in all. Then HandleMarker: the first receipt creates the local
//      snapshot (windows open at the counter the channel WILL have after
//      this tick's deferred log appends) and broadcasts one marker per
//      out-edge in dest order, one delay draw each (thread 0 holds the
//      sampler); a repeat closes the channel's window. Then the
//      finalization check;
//   3. the remaining credits (all threads), the log append with the
//      record-dtype limit and the overflow bits, and the completion stamp.
// The small planes are loaded into shared memory at launch and written
// back once at exit: one round trip per launch, not per tick.
//
// Bound: the bytes this design must move over 3.35 TB/s. Per lane that
// ticks, the shared-memory planes once in and once out (42 KB at ER-256);
// per tick, the head rtime of every non-empty edge, the payload of every
// popped slot, every appended slot, and the log and window entries the
// tick writes; the delay words once in and out. chip_smoke.py counts these
// from the run's own data (one ER-256 B=4096 drain megatick, K=8); they
// come to a few hundred MB, well under the 1.42 GB of the whole state,
// since the rings, log and windows are touched only at their heads and
// appends. The kernel runs far above that bound: the fold is a sequential
// chain of dependent shared-memory operations in one warp per lane, bound
// by latency, not bytes; 48 KB of shared memory per block leaves room for
// four lanes per SM.
//
// Modulus: CUDA's % truncates toward zero; every modulus here has
// non-negative operands (head in [0, C), len >= 0, counters >= 0, the
// unsigned hash), so it agrees with PyTorch's floor. uint32 words arrive
// as int64 in [0, 2^32) and uint64 words as int64 bit patterns; the
// kernel converts at the boundary and computes natively.

#include <cstdint>
#include <cuda_runtime.h>

// kernels/megatick._Args, field for field (at global scope: the C entry
// point takes it, so it must have external linkage)
struct ClsimMegatickArgs {
  int32_t* time;          // [B]
  int32_t* tokens;        // [B, N]
  int32_t* q_meta;        // [B, E, C]  rtime << 1 | is_marker
  int32_t* q_data;        // [B, E, C]
  int32_t* q_head;        // [B, E]
  int32_t* q_len;
  int32_t* tok_pushed;
  const uint8_t* started; // [B, S]
  uint8_t* has_local;     // [B, S, N]
  int32_t* frozen;
  int32_t* rem;
  uint8_t* done_local;
  uint8_t* recording;     // [B, S, E]
  int32_t* rec_cnt;       // [B, E]
  int32_t* min_prot;
  void* log_amt;          // [B, L, E] int16 or int32
  int32_t* rec_start;     // [B, S, E]
  int32_t* rec_end;
  int32_t* completed;     // [B, S]
  const uint8_t* snap_failed;
  int32_t* snap_done_time;
  int32_t* error;         // [B]
  void* dw0;              // hash: key; Go: vec [B, 607] (uint64 bits)
  void* dw1;              // hash: counter; Go: tap (int32)
  void* dw2;              // hash: epoch; Go: feed (int32)
  const uint8_t* live;    // [B], mode "ticks"
  const int32_t* limit;   // [B], mode "drain"
  const int32_t* edge_src;   // [E], edges sorted by (src, dst)
  const int32_t* edge_dst;
  const int32_t* in_degree;  // [N]
  const int32_t* src_lo;     // [N] out-edge range of each node
  const int32_t* src_hi;
  const int32_t* dst_lo;     // [N] in-edge range in by_dst order
  const int32_t* dst_hi;
  const int32_t* by_dst;     // [E]
  int b, n, e, c, s, l;
  int log16, rec_limit, key_limit;
  int sampler, max_delay, fixed_delay;
  int mode, length, quarantine;
  int smem_bytes;  // kernels/megatick.fused_smem_bytes: the block's share
};

namespace {

using Args = ClsimMegatickArgs;

constexpr int kThreads = 256;
constexpr int kErrQueueOverflow = 1;     // core/state.ERR_QUEUE_OVERFLOW
constexpr int kErrRecordOverflow = 4;    // core/state.ERR_RECORD_OVERFLOW
constexpr int kErrValueOverflow = 32;    // core/state.ERR_VALUE_OVERFLOW
constexpr int kRtimePackLimit = 1 << 30; // core/state.RTIME_PACK_LIMIT
constexpr int kGoLen = 607;              // ops/gorand.LEN
enum { kTicks = 0, kDrain = 1, kFlush = 2 };
enum { kFixed = 0, kHash = 1, kGoExact = 2 };

// one lane's planes in shared memory, and the bytes they take
struct Lane {
  int32_t *q_head, *q_len, *tok_pushed, *rec_cnt, *min_prot, *head_data;
  int32_t *tokens, *frozen, *rem, *completed, *done_time, *err, *ctl;
  uint8_t *tok, *mk, *app, *recording, *has_local, *done_local, *started,
      *failed;
  long long bytes;
};

// The next ``count`` elements of type T at ``p``, advancing ``p``: integer
// arithmetic, so the host may lay out from base 0 without a real buffer.
template <class T>
__host__ __device__ __forceinline__ T* take(uintptr_t& p, long long count) {
  T* out = reinterpret_cast<T*>(p);
  p += sizeof(T) * count;
  return out;
}

// Lays the planes out from ``base``; the host calls it at base 0 only to
// read ``bytes`` and check the caller's reckoning against it.
__host__ __device__ Lane carve(uintptr_t base, int n, int e, int s) {
  Lane w;
  uintptr_t p = base;
  const long long sn = (long long)s * n, se = (long long)s * e;
  w.q_head = take<int32_t>(p, e);
  w.q_len = take<int32_t>(p, e);
  w.tok_pushed = take<int32_t>(p, e);
  w.rec_cnt = take<int32_t>(p, e);
  w.min_prot = take<int32_t>(p, e);
  w.head_data = take<int32_t>(p, e);
  w.tokens = take<int32_t>(p, n);
  w.frozen = take<int32_t>(p, sn);
  w.rem = take<int32_t>(p, sn);
  w.completed = take<int32_t>(p, s);
  w.done_time = take<int32_t>(p, s);
  w.err = take<int32_t>(p, 1);
  w.ctl = take<int32_t>(p, 3);
  w.tok = take<uint8_t>(p, e);
  w.mk = take<uint8_t>(p, e);
  w.app = take<uint8_t>(p, e);
  w.recording = take<uint8_t>(p, se);
  w.has_local = take<uint8_t>(p, sn);
  w.done_local = take<uint8_t>(p, sn);
  w.started = take<uint8_t>(p, s);
  w.failed = take<uint8_t>(p, s);
  w.bytes = (long long)(p - base);
  return w;
}

__device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// The lane's delay stream, held by thread 0 (ops/delay.py): FixedDelay,
// HashDelay (a counter hash; the epoch advances when the counter wraps,
// as draw() does one draw at a time) and GoExactDelay (Go's additive
// lagged Fibonacci source and Intn, one draw at a time).
struct Sampler {
  int kind, max_delay, fixed;
  uint32_t key, ctr, epoch;
  uint64_t* vec;
  int tap, feed;

  __device__ int32_t int31() {
    tap = tap == 0 ? kGoLen - 1 : tap - 1;
    feed = feed == 0 ? kGoLen - 1 : feed - 1;
    const uint64_t x = vec[feed] + vec[tap];
    vec[feed] = x;
    return (int32_t)((x & 0x7FFFFFFFFFFFFFFFull) >> 32);
  }

  // the receive time of one message sent at ``time``
  __device__ int32_t draw(int32_t time) {
    if (kind == kFixed) return time + fixed;
    uint32_t d;
    if (kind == kHash) {
      d = lowbias32(lowbias32(ctr) ^ key ^ lowbias32(epoch)) %
          (uint32_t)max_delay;
      ctr += 1u;
      if (ctr == 0u) epoch += 1u;
    } else {
      const uint32_t n = (uint32_t)max_delay;
      if ((n & (n - 1u)) == 0u) {
        d = (uint32_t)int31() & (n - 1u);
      } else {
        const int32_t vmax = (int32_t)(0x7FFFFFFFu - (0x80000000u % n));
        int32_t v = int31();
        while (v > vmax) v = int31();
        d = (uint32_t)v % n;
      }
    }
    return time + 1 + (int32_t)d;
  }
};

__device__ __forceinline__ bool recorded(const Lane& w, int s, int e, int f) {
  bool any = false;
  for (int k = 0; k < s; ++k) any = any || w.recording[k * e + f];
  return any;
}

// HandleToken's credit (node.go:175) for edge f when it delivered a token,
// and its mark for the log when its channel records now
__device__ __forceinline__ void credit(const Args& a, const Lane& w, int f) {
  if (!w.tok[f]) return;
  atomicAdd(&w.tokens[a.edge_dst[f]], w.head_data[f]);
  w.app[f] = recorded(w, a.s, a.e, f);
}

__global__ void __launch_bounds__(kThreads)
fused_ticks_kernel(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = a.n, e = a.e, S = a.s, C = a.c, L = a.l;
  const long long be = b * e, bn = b * n, bs = b * S;
  int32_t time = a.time[b];

  // A lane that takes no step of this launch is left exactly as it was,
  // and returns before it loads anything: not live at launch ("ticks"),
  // errored under quarantine (sticky), or not draining at the first step
  // (a condition-false drain step is the identity, so it stays false).
  if (a.mode == kTicks) {
    if (!a.live[b]) return;
  } else if (a.quarantine && a.error[b] != 0) {
    return;
  } else if (a.mode == kDrain) {
    bool pending = false;
    for (int k = 0; k < S; ++k)
      pending = pending || (a.started[bs + k] && !a.snap_failed[bs + k] &&
                            a.completed[bs + k] < n);
    if (!pending || time >= a.limit[b]) return;
  }

  const Lane w = carve(reinterpret_cast<uintptr_t>(smem), n, e, S);
  for (int f = tid; f < e; f += nt) {
    w.q_head[f] = a.q_head[be + f];
    w.q_len[f] = a.q_len[be + f];
    w.tok_pushed[f] = a.tok_pushed[be + f];
    w.rec_cnt[f] = a.rec_cnt[be + f];
    w.min_prot[f] = a.min_prot[be + f];
  }
  for (int v = tid; v < n; v += nt) w.tokens[v] = a.tokens[bn + v];
  for (int i = tid; i < S * n; i += nt) {
    const long long g = bs * n + i;
    w.frozen[i] = a.frozen[g];
    w.rem[i] = a.rem[g];
    w.has_local[i] = a.has_local[g];
    w.done_local[i] = a.done_local[g];
  }
  for (int i = tid; i < S * e; i += nt) w.recording[i] = a.recording[bs * e + i];
  for (int k = tid; k < S; k += nt) {
    w.completed[k] = a.completed[bs + k];
    w.done_time[k] = a.snap_done_time[bs + k];
    w.started[k] = a.started[bs + k];
    w.failed[k] = a.snap_failed[bs + k];
  }
  Sampler smp{a.sampler, a.max_delay, a.fixed_delay, 0u, 0u, 0u, nullptr,
              0, 0};
  if (tid == 0) {
    *w.err = a.error[b];
    if (a.sampler == kHash) {
      smp.key = (uint32_t)static_cast<const int64_t*>(a.dw0)[b];
      smp.ctr = (uint32_t)static_cast<const int64_t*>(a.dw1)[b];
      smp.epoch = (uint32_t)static_cast<const int64_t*>(a.dw2)[b];
    } else if (a.sampler == kGoExact) {
      smp.vec = static_cast<uint64_t*>(a.dw0) + b * kGoLen;
      smp.tap = static_cast<const int32_t*>(a.dw1)[b];
      smp.feed = static_cast<const int32_t*>(a.dw2)[b];
    }
  }
  __syncthreads();

  // every thread tracks the lane's clock and quiet flag identically
  bool quiet = false;
  for (int step = 0; step < a.length; ++step) {
    if (a.mode == kTicks) {
      int busy = 0;
      for (int f = tid; f < e; f += nt) busy |= w.q_len[f] > 0;
      busy = __syncthreads_or(busy);         // also the step's barrier
      const bool poisoned = a.quarantine && *w.err != 0;
      quiet = quiet || !busy || poisoned;
      if (quiet) {                            // bump: a pure time increment
        if (!poisoned) time += 1;
        continue;
      }
    } else {
      __syncthreads();
      if (a.quarantine && *w.err != 0) continue;
      if (a.mode == kDrain) {
        bool pending = false;
        for (int k = 0; k < S; ++k)
          pending = pending ||
                    (w.started[k] && !w.failed[k] && w.completed[k] < n);
        if (!pending || time >= a.limit[b]) continue;
      }
    }
    const int32_t t = ++time;

    // 1. selection + pop: each source's first eligible head in dest order
    for (int v = tid; v < n; v += nt) {
      bool found = false;
      for (int f = a.src_lo[v]; f < a.src_hi[v]; ++f) {
        const int32_t len = w.q_len[f];
        int32_t meta = 0;
        bool sel = false;
        if (!found && len > 0) {
          const int32_t h = w.q_head[f];
          const long long slot = (be + f) * C + h;
          meta = a.q_meta[slot];
          sel = (meta >> 1) <= t;             // arithmetic, as jnp's
          if (sel) {
            found = true;
            w.head_data[f] = a.q_data[slot];
            w.q_head[f] = (h + 1) % C;
            w.q_len[f] = len - 1;
          }
        }
        w.tok[f] = sel && !(meta & 1);
        w.mk[f] = sel && (meta & 1);
        w.app[f] = 0;
      }
    }
    __syncthreads();

    // 2. the marker fold, in warp 0
    if (tid < 32) {
      const int ln = tid;
      int done = 0;                           // edges [0, done) credited
      int from = 0;
      for (;;) {
        int m = -1;
        for (int base = from; base < e; base += 32) {
          const int f = base + ln;
          const unsigned hit = __ballot_sync(0xffffffffu, f < e && w.mk[f]);
          if (hit) {
            m = base + __ffs(hit) - 1;
            break;
          }
        }
        if (m < 0) break;
        // credit the tokens of the sources ranked below m's source
        const int upto = a.src_lo[a.edge_src[m]];
        for (int f = done + ln; f < upto; f += 32) credit(a, w, f);
        if (upto > done) done = upto;
        __syncwarp();

        // HandleMarker (node.go:149-171) for the marker on edge m
        const int d = a.edge_dst[m];
        int sid = w.head_data[m];
        sid = sid < 0 ? 0 : (sid >= S ? S - 1 : sid);
        const int cell = sid * n + d;
        const bool first = !w.has_local[cell];
        __syncwarp();
        if (first) {
          // CreateLocalSnapshot (node.go:58-84): record every in-link but
          // m from the counter it will have after this tick's appends
          for (int j = a.dst_lo[d] + ln; j < a.dst_hi[d]; j += 32) {
            const int f = a.by_dst[j];
            if (f == m) continue;
            const int32_t cnt = w.rec_cnt[f] + (int32_t)w.app[f];
            w.recording[sid * e + f] = 1;
            a.rec_start[(bs + sid) * e + f] = cnt;
            if (cnt < w.min_prot[f]) w.min_prot[f] = cnt;
          }
          if (ln == 0) {
            w.has_local[cell] = 1;
            w.frozen[cell] = w.tokens[d];
            w.rem[cell] = a.in_degree[d] - 1;
            // SendToNeighbors (node.go:97-109): one marker per out-link
            // in dest order, one delay draw each, appended in place
            for (int g = a.src_lo[d]; g < a.src_hi[d]; ++g) {
              const int32_t rt = smp.draw(t);
              const int32_t len = w.q_len[g];
              int bits = 0;
              if (len >= C) bits |= kErrQueueOverflow;
              if (w.tok_pushed[g] >= a.key_limit || rt >= kRtimePackLimit)
                bits |= kErrValueOverflow;
              if (bits) atomicOr(w.err, bits);
              const long long slot = (be + g) * C + (w.q_head[g] + len) % C;
              a.q_meta[slot] = (int32_t)((uint32_t)rt * 2u + 1u);
              a.q_data[slot] = sid;
              w.q_len[g] = len + 1;
              w.tok_pushed[g] += 1;
            }
          }
        } else if (ln == 0) {
          // a repeat closes the window where the channel still records
          const int rc = sid * e + m;
          if (w.recording[rc]) {
            w.recording[rc] = 0;
            w.rem[cell] -= 1;
            a.rec_end[(bs + sid) * e + m] = w.rec_cnt[m];
          }
        }
        if (ln == 0 && w.has_local[cell] && w.rem[cell] == 0 &&
            !w.done_local[cell]) {           // finalizeSnapshot
          w.done_local[cell] = 1;
          w.completed[sid] += 1;
        }
        __syncwarp();
        from = m + 1;
      }
      if (ln == 0) w.ctl[0] = done;
    }
    __syncthreads();

    // 3. the remaining credits, then the log append and the stamp
    for (int f = w.ctl[0] + tid; f < e; f += nt) credit(a, w, f);
    __syncthreads();
    for (int f = tid; f < e; f += nt) {
      if (!w.app[f]) continue;
      const int32_t cnt = w.rec_cnt[f];
      const int32_t amt = w.head_data[f];
      int bits = 0;
      if (cnt + 1 - w.min_prot[f] > L) bits |= kErrRecordOverflow;
      if (amt > a.rec_limit) bits |= kErrValueOverflow;
      if (bits) atomicOr(w.err, bits);
      const long long at = (b * L + cnt % L) * e + f;
      if (a.log16)
        static_cast<int16_t*>(a.log_amt)[at] = (int16_t)amt;
      else
        static_cast<int32_t*>(a.log_amt)[at] = amt;
      w.rec_cnt[f] = cnt + 1;
    }
    for (int k = tid; k < S; k += nt)
      if (w.started[k] && w.completed[k] >= n && w.done_time[k] < 0)
        w.done_time[k] = t;
  }
  __syncthreads();

  for (int f = tid; f < e; f += nt) {
    a.q_head[be + f] = w.q_head[f];
    a.q_len[be + f] = w.q_len[f];
    a.tok_pushed[be + f] = w.tok_pushed[f];
    a.rec_cnt[be + f] = w.rec_cnt[f];
    a.min_prot[be + f] = w.min_prot[f];
  }
  for (int v = tid; v < n; v += nt) a.tokens[bn + v] = w.tokens[v];
  for (int i = tid; i < S * n; i += nt) {
    const long long g = bs * n + i;
    a.frozen[g] = w.frozen[i];
    a.rem[g] = w.rem[i];
    a.has_local[g] = w.has_local[i];
    a.done_local[g] = w.done_local[i];
  }
  for (int i = tid; i < S * e; i += nt) a.recording[bs * e + i] = w.recording[i];
  for (int k = tid; k < S; k += nt) {
    a.completed[bs + k] = w.completed[k];
    a.snap_done_time[bs + k] = w.done_time[k];
  }
  if (tid == 0) {
    a.time[b] = time;
    a.error[b] = *w.err;
    if (a.sampler == kHash) {
      static_cast<int64_t*>(a.dw1)[b] = (int64_t)smp.ctr;
      static_cast<int64_t*>(a.dw2)[b] = (int64_t)smp.epoch;
    } else if (a.sampler == kGoExact) {
      static_cast<int32_t*>(a.dw1)[b] = smp.tap;
      static_cast<int32_t*>(a.dw2)[b] = smp.feed;
    }
  }
}

}  // namespace

extern "C" {

int clsim_fused_ticks(const Args* a, void* stream) {
  const long long smem = a->smem_bytes;
  if (carve(0, a->n, a->e, a->s).bytes > smem || smem > 232448)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t st = cudaFuncSetAttribute(
        fused_ticks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (st != cudaSuccess) return (int)st;
  }
  if (a->b > 0 && a->length > 0)
    fused_ticks_kernel<<<(unsigned int)a->b, kThreads, (size_t)smem,
                         (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

}  // extern "C"
