// The fused megatick for Hopper (sm_90a): K exact ticks of every lane in one
// launch, with the fault adversary and the snapshot supervisor inside the
// step.
//
// Replaces the Pallas kernel of chandy_lamport_tpu/kernels/megatick.py:
//   fused_scan (:432, pallas_call :641, with RingStream.commit_and_heads
//   :380) -> clsim_fused_ticks
// with its recorder arm: each step is a quiet bump, the identity, or one
// cascade or wave tick (ops/tick._cascade_tick / _wave_tick, with the fault
// hooks and the supervisor when armed, and the flight recorder's sites
// when traced), as kernels/megatick.py's module docstring sets out for the
// modes "ticks", "drain" and "flush".
//
// Design. One block per lane; the K steps loop inside the block, as the
// Pallas kernel's lax.scan runs inside one grid step. A lane's state does
// not fit in a block's shared memory (ER-256: 0.347 MB against 227 KB),
// so the TPU's resident carry does not carry over. The block keeps the
// tick's small working planes in shared memory (carve: the [E]
// vectors, tokens, the [S, N] planes, recording, the [S] vectors, the
// tick-start schedule; 52,416 B at ER-256, 54,384 B with the fault arm)
// and reads and writes the
// [E, C] rings, the [L, E] log and the [S, E] windows in device memory in
// place. The JAX tiled layout defers each tick's ring appends into
// buffers and replays them in one block pass (RingStream) because a TPU
// kernel addresses VMEM by whole blocks; a CUDA thread writes its one slot
// directly, in program order, so no deferred pass is needed and an
// overflowing append clobbers exactly as the eager path does.
//
// The tiled layout (JAX fused_tile, ROADMAP B2). The TPU tiles because the
// rings overflow VMEM; here the rings already live in device memory, and
// what overflows is the working set carve lays out (1,671,200 B for the
// SF-8k lane at S=8, against 232,448 B of shared memory a block). The kTiled instantiations carve the same planes from the lane's
// stride of a device-memory workspace (smem_bytes each, allocated by the
// wrapper) and run the same bodies: loaded at launch, written back at
// exit, nothing read that the launch did not write. Their bytes pass
// through L1 and L2 instead of shared memory: correct first, and slower.
//
// The fault arm. The JAX kernel takes the adversary's next K ticks as
// planes ([K, 8, E] and [K, 2, N] per lane, TickKernel._fault_planes);
// at ER-256 B=4096 and K=8 the edge plane alone would be 805 MB. The
// fault hash is stateless in (key, time, index) (models/faults.py), so
// this kernel hashes each step's masks at the step's own clock instead,
// which is what the planes hold: the megatick's gates are monotone, so a
// step that ticks is always at time t0 + 1 + j. Each armed class is one
// lowbias32 per edge on top of one shared per (edge, step); rate 0
// hashes nothing, rate >= 1 fires on every armed lane, a key of 0 disarms
// its lane (Faults._rate_mask). clsim_fault_planes fills the JAX planes
// from these same device functions for the chip check.
//
// Per tick (ops/tick._cascade_tick's order):
//   0. with the adversary: the step's edge flags (drop, dup, jitter and
//      their marker twins) and each node's down flag into shared memory,
//      all threads; a node whose crash window ended at t restarts
//      (counted; "lossy" restores it from the newest completed slot's
//      frozen balance, or zeroes it with ERR_FAULT_UNRECOVERED), every
//      balance change into fault_skew;
//   1. with the supervisor, in warp 0: the daemon's injection, the
//      timeout scan (abort: rows cleared, epoch bumped; retry with
//      backoff timeout << min(retries, 4), or fail with
//      ERR_SNAPSHOT_TIMEOUT), then each retried slot's re-initiation,
//      lowest first; markers carry epoch * S + sid;
//   2. selection + pop, one thread per source node walking its edges in
//      dest order: the first edge with len > 0 and
//      rtime <= time (and, under faults, not stalled by jitter or the
//      marker jitter, whose stalls are counted, and not bound for a down
//      node) is popped, its payload kept in head_data; then the drop /
//      dup split of the popped token or marker and, under the
//      supervisor, the stale-epoch rejection;
//   3. the markers. The cascade's fold handles the popped markers in
//      ascending edge order: before each, the tokens of the sources ranked
//      below it are credited (marked for the log when their channel
//      records at that moment); then HandleMarker: the first receipt
//      creates the local snapshot (windows open at the counter the channel
//      WILL have after this tick's deferred log appends) and broadcasts
//      one marker per out-edge in dest order, one delay draw each; a
//      repeat closes the channel's window. Then the finalization check.
//      Markers bound for different destinations touch disjoint cells and
//      commute but for their draws' stream positions, which are known at
//      tick start (ops/tick._wave_tick), so every instantiation, cascade
//      and wave, traced or not, runs one destination-owned step
//      (owner_step): a tick-start schedule (first receipts, their draw
//      bases by a block scan), then one thread per node serving all of its
//      markers in edge order with no barrier between them;
//   4. the remaining credits (all threads), the log append with the
//      record-dtype limit and the overflow bits, the duplicated tokens and
//      markers re-appended at their ring's tail (after the step's
//      broadcasts; receive time t + 1 + word % max_delay from the fault
//      stream), and the completion stamp.
// The small planes are loaded into shared memory at launch and written
// back once at exit: one round trip per launch, not per tick.
//
// The recorder arm (kTrace; utils/tracing.py). The JAX kernel traces the
// stock tick, recorder sites included, so its ring is part of the carry.
// Here the ring [B, K] stays in device memory and each event is written
// once, where it happens; the lane's count is a control word of the
// carve. Every step appends its events in the order of the port's plain
// tick (the JAX order): the crash restarts, the supervisor's
// startSnapshot, markers sent, aborts, retries and failures, the jitter
// stalls and the drop / dup splits, one class after another; in the
// cascade, before each marker the receipts of the sources ranked below it
// (edge order), its marker-recv, its broadcast's marker-sends (dest
// order) and its endSnapshot; in the wave, each wave's receipts, then its
// marker-recvs, marker-sends and endSnapshots ([S, N], slot major); then
// the tokens left. A multi-event append ranks its events in flattened row
// order by a block scan; event r of m goes to slot (count + r) % K, and
// only the last K of one append are written, so no two threads write one
// slot (the plain version's rule too). Steps 3 and 4's events are one
// ranked append after the owner step (record_step): their orders are
// orders of keys fixed at tick start, so each event's slot comes from its
// key's rank. A lane with tr_on == 0, and a quiet bump, append nothing.
// The untraced instantiations carry none of it: their carve, share and
// registers are those of the kernel without the recorder.
//
// Bound: the bytes this design must move over 3.35 TB/s, or the hash's
// integer operations over the scalar rate, whichever is larger. Per lane
// that ticks, the shared-memory planes once in and once out (42 KB at
// ER-256); per tick, the head rtime of every non-empty edge (every one
// under faults, whose jitter stalls are counted on all of them), the
// payload of every popped slot, every appended slot, and the log and
// window entries the tick writes; the delay words once in and out.
// chip_smoke.py counts these from the run's own data (one ER-256 B=4096
// drain megatick, K=8, fault-free and faulted). The kernel runs far above
// that bound: each step is a chain of dependent shared-memory and table
// reads per node or per edge, bound by latency, not bytes.
//
// The threefry sampler (kThreefry; ops/delay.UniformDelay, the JAX
// UniformJaxDelay): each draw splits the lane's key and draws
// randint(second half, 0, max_delay), five Threefry-2x32 blocks, so its
// stream is order-dependent like the Go-exact one: the owner step reads its
// draws from the buffer thread 0 fills in stream order (gdraw), as for
// Go-exact. Its state is the key's two words a lane. The draw is compiled
// only into the instantiations launched for it (kTf): compiled into every
// one, its call raised the others' registers (PERF.md §6).
//
// The uint16 window arm (SimConfig.window_dtype="uint16"): rec_start and
// rec_end are [B, S, E] planes of 2-byte words (rec_start16 / rec_end16,
// the int32 pair left null), written natively with the counter's low 16
// bits, which is the JAX astype(uint16). The windows lie in device memory
// in both layouts, so the working set (fused_smem_bytes) is the same; the
// window writes move half the bytes. The untraced instantiations fix the
// width at compile time (kWin): a branch on it at each write cost the
// int32 drain megaticks 0.7-2.7 % (PERF.md §6).
//
// Modulus: CUDA's % truncates toward zero; every modulus here has
// non-negative operands (head in [0, C), len >= 0, counters >= 0, the
// unsigned hash), so it agrees with PyTorch's floor. The clock's floor
// division and modulus (crash windows, marker payloads) go through
// floor_div / floor_mod, which divide non-negative operands only. Signed
// sums that may wrap (time + 1, deadlines, fault_skew) are taken in
// uint32, as int32 tensors wrap. uint32 words arrive as int64 in [0,
// 2^32) and uint64 words as int64 bit patterns; the kernel converts at
// the boundary and computes natively.

#include <cstdint>
#include <cuda_runtime.h>

// kernels/megatick._Program: the rate classes of Faults.kernel_program in
// core/state.FC_* order
struct ClsimFaultRates {
  uint32_t thresh[7];
  int arm[7];  // 0: never (nothing hashed); 1: word < thresh; 2: always
};

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
  uint8_t* started;       // [B, S]
  uint8_t* has_local;     // [B, S, N]
  int32_t* frozen;
  int32_t* rem;
  uint8_t* done_local;
  uint8_t* recording;     // [B, S, E]
  int32_t* rec_cnt;       // [B, E]
  int32_t* min_prot;
  void* log_amt;          // [B, L, E] int16 or int32
  int32_t* rec_start;     // [B, S, E], null under the uint16 arm
  int32_t* rec_end;
  int32_t* completed;     // [B, S]
  uint8_t* snap_failed;
  int32_t* snap_done_time;
  int32_t* error;         // [B]
  const int64_t* fault_key;  // [B] uint32 words
  int32_t* fault_skew;       // [B]
  int32_t* fault_counts;     // [B, 7]
  int32_t* snap_epoch;       // [B, S]
  int32_t* snap_deadline;
  int32_t* snap_retries;
  int32_t* snap_initiator;
  int32_t* next_sid;         // [B]
  int32_t* stale_markers;    // [B]
  void* dw0;              // hash: key; Go: vec [B, 607] (uint64 bits);
                          // threefry: the key [B, 2]
  void* dw1;              // hash: counter; Go: tap (int32)
  void* dw2;              // hash: epoch; Go: feed (int32)
  const uint8_t* live;    // [B] lane gate: required in mode "ticks",
                          // optional (null = every lane) otherwise
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
                   // (resident), the lane's workspace stride (tiled)
  int faulted;     // the adversary is armed
  int ext;         // the fault arm is compiled in: kernels/megatick.fault_arm
  int wave;        // the wave step body: kernels/megatick.wave_arm
  int crash_kind, crash_lossy, crash_len, crash_period, crash_start;
  int dup_mod;     // max(cfg.max_delay, 1): duplicates' delay range
  int snapshot_timeout, snapshot_retries, snapshot_every;
  ClsimFaultRates rates;
  // the tiled layout (kernels/megatick.resolve_fused): the lanes'
  // planes in ``workspace``, [B] strides of smem_bytes. Last, so that the
  // resident instantiations, which never read them, see every other field
  // where they did before (ptxas gave the faulted wave arm 2 registers
  // more with them in the middle)
  char* workspace;
  long long workspace_bytes;
  int tiled;
  // the flight recorder (TickKernel._trace_on), last for the same
  // reason: the ring [B, K], each lane's count and arm flag [B]
  int32_t* tr_meta;
  int32_t* tr_data;
  int32_t* tr_tick;
  int32_t* tr_count;
  const int32_t* tr_on;
  int tr_k;
  int traced;
  // the uint16 window arm (window_dtype="uint16"): the window planes as
  // 2-byte words, rec_start / rec_end then null; last, as above
  uint16_t* rec_start16;  // [B, S, E]
  uint16_t* rec_end16;
};

namespace {

using Args = ClsimMegatickArgs;

constexpr int kThreads = 256;
constexpr int kErrQueueOverflow = 1;       // core/state.ERR_QUEUE_OVERFLOW
constexpr int kErrRecordOverflow = 4;      // core/state.ERR_RECORD_OVERFLOW
constexpr int kErrValueOverflow = 32;      // core/state.ERR_VALUE_OVERFLOW
constexpr int kErrFaultUnrecovered = 128;  // ERR_FAULT_UNRECOVERED
constexpr int kErrSnapshotTimeout = 256;   // ERR_SNAPSHOT_TIMEOUT
constexpr int kRtimePackLimit = 1 << 30;   // core/state.RTIME_PACK_LIMIT
constexpr int kGoLen = 607;                // ops/gorand.LEN
constexpr int kClasses = 7;                // core/state.NUM_FAULT_CLASSES
constexpr int kWarps = kThreads / 32;
// the tick-start schedule's control words: the warps' draw sums and
// depths, then the sampler's tick-start key, counter and epoch
constexpr int kWaveCtl = 24;
enum { kCtlSums = 0, kCtlDepths = kWarps, kCtlKey = 2 * kWarps, kCtlCtr,
       kCtlEpoch };
static_assert(kCtlEpoch < kWaveCtl, "the wave's control words");
enum { kTicks = 0, kDrain = 1, kFlush = 2 };
enum { kFixed = 0, kHash = 1, kGoExact = 2, kThreefry = 3 };
// fault_counts columns (core/state.FC_*)
enum { kFcDrop = 0, kFcDup, kFcJitter, kFcCrash, kFcMDrop, kFcMDup,
       kFcMJitter };
// hash domains (models/faults._CLS_*)
enum { kClsDrop = 1, kClsDup, kClsJitter, kClsCrash, kClsDupDelay,
       kClsMDrop, kClsMDup, kClsMJitter, kClsMDupDelay };
// the step's per-edge fault flags
enum : uint8_t { kFDrop = 1, kFDup = 2, kFJit = 4, kFMDrop = 8, kFMDup = 16,
                 kFMJit = 32 };
// the duplicate kind of a popped message
enum : uint8_t { kDupNone = 0, kDupToken = 1, kDupMarker = 2 };
// utils/tracing.EV_* kinds
enum { kEvRecv = 1, kEvMSend = 2, kEvMRecv = 3, kEvSnapStart = 4,
       kEvSnapEnd = 5, kEvSupAbort = 6, kEvSupRetry = 7, kEvSupFail = 8,
       kEvFault = 9 };
// the recorder's control words: the lane's count, then the block scan's
// warp sums
constexpr int kTraceCtl = 1 + kWarps;
// the ranked append's count table ([group][warp] words) reuses the draw
// bases' plane once the owner step has read them; traced, that plane holds
// at least this many words, so a window takes at least 32 key groups
constexpr int kRankMin = kWarps * 32;

// one lane's planes (in shared memory, or in the workspace when tiled),
// and the bytes they take
struct Lane {
  int32_t *q_head, *q_len, *tok_pushed, *rec_cnt, *min_prot, *head_data;
  int32_t *tokens, *frozen, *rem, *completed, *done_time, *err, *ctl;
  // the fault arm (faulted or supervised lanes only)
  int32_t *epoch, *deadline, *retries, *initiator, *counts, *next_sid,
      *skew, *stale;
  // the tick-start schedule: each edge's draw base (traced, then the
  // ranked append's count table), the control words, the Go-exact draws,
  // each in-edge's wave number (traced wave: the markers of its node below
  // it) and first-receipt flag (traced, bit 1: the marker's cell fired)
  int32_t *base, *wctl, *gdraw;
  // the recorder arm: its control words and one word per edge (the step's
  // fault events as bits)
  int32_t *tctl, *tev;
  int16_t* wnum;
  uint8_t *tok, *mk, *app, *recording, *has_local, *done_local, *started,
      *failed;
  uint8_t *eflags, *dupk, *down, *retry, *first;
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

// Lays the planes out from ``base`` (``ext``: the fault arm's planes
// too; ``trace``: the recorder's, and the draw bases' plane at least
// kRankMin words; ``wave`` with ``trace``: the wave numbers; ``go``: with
// the Go-exact sampler, the buffer of a tick's draws), each plane taking
// no byte where it is not needed; the host calls it at base 0 only to
// read ``bytes`` and check the caller's reckoning against it.
__host__ __device__ Lane carve(uintptr_t base, int n, int e, int s,
                               bool ext, bool wave, bool trace, bool go) {
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
  const long long ext_s = ext ? s : 0;
  w.epoch = take<int32_t>(p, ext_s);
  w.deadline = take<int32_t>(p, ext_s);
  w.retries = take<int32_t>(p, ext_s);
  w.initiator = take<int32_t>(p, ext_s);
  w.counts = take<int32_t>(p, ext ? kClasses : 0);
  w.next_sid = take<int32_t>(p, ext ? 1 : 0);
  w.skew = take<int32_t>(p, ext ? 1 : 0);
  w.stale = take<int32_t>(p, ext ? 1 : 0);
  // the tick-start schedule of every step body
  w.base = take<int32_t>(p, trace && e < kRankMin ? kRankMin : e);
  w.wctl = take<int32_t>(p, kWaveCtl);
  // the Go-exact stream's draws of one tick, in stream order
  w.gdraw = take<int32_t>(p, go ? (long long)s * e : 0);
  w.tctl = take<int32_t>(p, trace ? kTraceCtl : 0);
  w.tev = take<int32_t>(p, trace ? e : 0);
  w.wnum = take<int16_t>(p, trace && wave ? e : 0);
  w.tok = take<uint8_t>(p, e);
  w.mk = take<uint8_t>(p, e);
  w.app = take<uint8_t>(p, e);
  w.recording = take<uint8_t>(p, se);
  w.has_local = take<uint8_t>(p, sn);
  w.done_local = take<uint8_t>(p, sn);
  w.started = take<uint8_t>(p, s);
  w.failed = take<uint8_t>(p, s);
  w.eflags = take<uint8_t>(p, ext ? e : 0);
  w.dupk = take<uint8_t>(p, ext ? e : 0);
  w.down = take<uint8_t>(p, ext ? n : 0);
  w.retry = take<uint8_t>(p, ext_s);
  w.first = take<uint8_t>(p, e);
  w.bytes = (long long)(p - base);
  return w;
}

__host__ __device__ __forceinline__ uint32_t lowbias32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  return x ^ (x >> 16);
}

// floor division and modulus of the clock by a positive ``d``, as
// PyTorch's and jnp's // and %, dividing non-negative operands only
__device__ __forceinline__ int32_t floor_div(int32_t x, int32_t d) {
  return x >= 0 ? x / d : -1 - (-(x + 1)) / d;
}

__device__ __forceinline__ int32_t floor_mod(int32_t x, int32_t d) {
  return (int32_t)((long long)x - (long long)floor_div(x, d) * d);
}

// int32 + int32 with the two's-complement wrap of an int32 tensor
__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return (int32_t)((uint32_t)x + (uint32_t)y);
}

// ---- the fault hash (models/faults.py) -----------------------------------

// the lane's adversary: its key and the program's constants
struct Fault {
  uint32_t key;
  ClsimFaultRates rates;
  int crash_kind, crash_len, crash_period, crash_start;
};

// the time half of _word: lowbias32(uint32(time) * 2654435769)
__device__ __forceinline__ uint32_t time_mix(int32_t time) {
  return lowbias32((uint32_t)time * 2654435769u);
}

// the index half of _word, shared by every class at one (time, index)
__device__ __forceinline__ uint32_t index_mix(uint32_t tmix, uint32_t idx) {
  return lowbias32(idx ^ tmix);
}

__device__ __forceinline__ uint32_t class_word(uint32_t key, int cls,
                                               uint32_t imix) {
  return lowbias32(imix ^ key ^ ((uint32_t)cls * 0x9E3779B9u));
}

// Faults._rate_mask at one (time, index): ``imix`` is index_mix of them
__device__ __forceinline__ bool fires(const Fault& f, int fc, int cls,
                                      uint32_t imix) {
  const int arm = f.rates.arm[fc];
  if (arm == 0 || f.key == 0u) return false;
  if (arm == 2) return true;
  return class_word(f.key, cls, imix) < f.rates.thresh[fc];
}

// Faults.down_nodes: node ``v`` down at ``time``
__device__ __forceinline__ bool down_at(const Fault& f, int32_t time,
                                        int v) {
  if (f.crash_kind == 0) return false;
  if (f.crash_kind == 2) {   // the one crash_start window, gate at time 0
    if (time < f.crash_start ||
        (long long)time >= (long long)f.crash_start + f.crash_len)
      return false;
    return fires(f, kFcCrash, kClsCrash, index_mix(time_mix(0), v));
  }
  if (floor_mod(time, f.crash_period) >= f.crash_len) return false;
  const int32_t window = floor_div(time, f.crash_period);
  return fires(f, kFcCrash, kClsCrash, index_mix(time_mix(window), v));
}

// Faults.restarted: down at time - 1, up at time, time >= 1
__device__ __forceinline__ bool restarted_at(const Fault& f, int32_t time,
                                             int v, bool now) {
  return time >= 1 && !now && down_at(f, wrap_add(time, -1), v);
}

// the step's fault flags of edge ``idx`` (kF* bits)
__device__ __forceinline__ uint8_t edge_flags(const Fault& f, uint32_t tmix,
                                              uint32_t idx) {
  const uint32_t imix = index_mix(tmix, idx);
  uint8_t fl = 0;
  if (fires(f, kFcDrop, kClsDrop, imix)) fl |= kFDrop;
  if (fires(f, kFcDup, kClsDup, imix)) fl |= kFDup;
  if (fires(f, kFcJitter, kClsJitter, imix)) fl |= kFJit;
  if (fires(f, kFcMDrop, kClsMDrop, imix)) fl |= kFMDrop;
  if (fires(f, kFcMDup, kClsMDup, imix)) fl |= kFMDup;
  if (fires(f, kFcMJitter, kClsMJitter, imix)) fl |= kFMJit;
  return fl;
}

// a duplicate's receive time: t + 1 + word % dup_mod (TickKernel._dup_times)
__device__ __forceinline__ int32_t dup_time(const Fault& f, int32_t t,
                                            bool marker, uint32_t tmix,
                                            uint32_t idx, int dup_mod) {
  const uint32_t w = class_word(f.key, marker ? kClsMDupDelay : kClsDupDelay,
                                index_mix(tmix, idx));
  return (int32_t)((uint32_t)t + 1u + w % (uint32_t)dup_mod);
}

// ---- the delay sampler ---------------------------------------------------

// Threefry-2x32, 20 rounds, of key (k0, k1) on the counter pair (x0, x1)
// (ops/delay.threefry2x32, jax/_src/prng.py _threefry2x32_lowering)
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = ((x1 << rot[i & 1][j]) | (x1 >> (32 - rot[i & 1][j]))) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// The sampler's draws come from a stream whose order matters (Go-exact,
// threefry): the owner step reads them from the buffer of a tick's draws
__host__ __device__ __forceinline__ bool ordered(int kind) {
  return kind == kGoExact || kind == kThreefry;
}

// the key's block of counter (0, i): jax.random.split's key i
__device__ __forceinline__ void key_split(uint32_t k0, uint32_t k1,
                                          uint32_t i, uint32_t& o0,
                                          uint32_t& o1) {
  o0 = 0u;
  o1 = i;
  threefry(k0, k1, o0, o1);
}

// One threefry draw (UniformDelay.draw) from the key (k0, k1): split it,
// and draw jax.random.randint(second half, (), 0, n) for int32: two 32-bit
// words, one per half of the second key, folded into the span with uint32
// wrap-around. Returns (the first half: the next key, the draw). A call,
// not inlined: only thread 0 draws, and inlined its five blocks raised
// the kernel's registers (ptxas: the fault-free resident kernel from 80
// to 120), and with them the lanes an SM keeps in flight.
__device__ __noinline__ uint3 threefry_draw(uint32_t k0, uint32_t k1,
                                            uint32_t n) {
  uint32_t n0, n1, s0, s1, a0, a1, b0, b1;
  key_split(k0, k1, 0u, n0, n1);
  key_split(k0, k1, 1u, s0, s1);
  key_split(s0, s1, 0u, a0, a1);
  key_split(s0, s1, 1u, b0, b1);
  uint32_t h0 = 0u, h1 = 0u, l0 = 0u, l1 = 0u;
  threefry(a0, a1, h0, h1);
  threefry(b0, b1, l0, l1);
  const uint32_t hi = h0 ^ h1, lo = l0 ^ l1;
  uint32_t mult = 65536u % n;
  mult = (mult * mult) % n;
  return make_uint3(n0, n1, ((hi % n) * mult + lo % n) % n);
}

// The lane's delay stream, held by thread 0 (ops/delay.py): FixedDelay,
// HashDelay (a counter hash; the epoch advances when the counter wraps,
// as draw() does one draw at a time), GoExactDelay (Go's additive
// lagged Fibonacci source and Intn, one draw at a time) and UniformDelay
// (threefry: ``threefry_draw`` on the key's two words ``tk0``, ``tk1``;
// compiled in only with kTf).
template <bool kTf>
struct Sampler {
  int kind, max_delay, fixed;
  uint32_t key, ctr, epoch;
  uint64_t* vec;
  int tap, feed;
  uint32_t tk0, tk1;

  __device__ int32_t int31() {
    tap = tap == 0 ? kGoLen - 1 : tap - 1;
    feed = feed == 0 ? kGoLen - 1 : feed - 1;
    const uint64_t x = vec[feed] + vec[tap];
    vec[feed] = x;
    return (int32_t)((x & 0x7FFFFFFFFFFFFFFFull) >> 32);
  }

  // the receive time of one message sent at ``time``
  __device__ int32_t draw(int32_t time) {
    if (kind == kFixed) return wrap_add(time, fixed);
    uint32_t d;
    if constexpr (kTf) {
      const uint3 r = threefry_draw(tk0, tk1, (uint32_t)max_delay);
      tk0 = r.x;
      tk1 = r.y;
      d = r.z;
    } else if (kind == kHash) {
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
    return wrap_add(time, 1 + (int32_t)d);
  }

  // the stream after ``count`` more draws (HashDelay.advance_draws)
  __device__ void advance(uint32_t count) {
    if (kind != kHash) return;
    const uint32_t next = ctr + count;
    if (next < ctr) epoch += 1u;
    ctr = next;
  }
};

// The receive time of the draw at stream position ``off`` past the
// tick-start state (key, ctr0, epoch0) of a position-addressable sampler
// (FixedDelay, or HashDelay.block_receive_times: a position past the
// counter's wrap takes the next epoch, as the sequential draw does)
__device__ __forceinline__ int32_t draw_at(const Args& a, uint32_t key,
                                           uint32_t ctr0, uint32_t epoch0,
                                           uint32_t off, int32_t time) {
  if (a.sampler == kFixed) return wrap_add(time, a.fixed_delay);
  const uint32_t pos = ctr0 + off;
  const uint32_t ep = epoch0 + (pos < ctr0 ? 1u : 0u);
  const uint32_t d = lowbias32(lowbias32(pos) ^ key ^ lowbias32(ep)) %
                     (uint32_t)a.max_delay;
  return wrap_add(time, 1 + (int32_t)d);
}

// ---- the flight recorder (kTrace) ----------------------------------------

// one lane's ring in device memory, [K] each, and whether it records
struct Ring {
  int32_t *meta, *data, *tick;
  int k;
  bool on;
};

// utils/tracing.pack_event: actor << 5 | kind, as int32 arithmetic wraps
__device__ __forceinline__ int32_t pack_event(int actor, int kind) {
  return (int32_t)((uint32_t)actor * 32u + (uint32_t)kind);
}

__device__ __forceinline__ void put_event(const Ring& r, int32_t count,
                                          int32_t meta, int32_t data,
                                          int32_t t) {
  const int slot = (int)floor_mod(count, r.k);
  r.meta[slot] = meta;
  r.data[slot] = data;
  r.tick[slot] = t;
}

// one event, by one thread (utils/tracing.trace_append_one)
__device__ __forceinline__ void record(const Ring& r, const Lane& w,
                                       int actor, int kind, int32_t data,
                                       int32_t t) {
  if (!r.on) return;
  const int32_t c = w.tctl[0];
  put_event(r, c, pack_event(actor, kind), data, t);
  w.tctl[0] = wrap_add(c, 1);
}

// The ranked append of every i in [0, count) with pred(i), in order, by
// the whole block (utils/tracing.trace_append_many): each thread takes a
// contiguous chunk, a block scan of the chunks' counts gives each event
// its rank, and only the last K events are written. ``ev(i, actor,
// payload)`` fills in event i. Every thread of the block calls it.
template <class Pred, class Ev>
__device__ __forceinline__ void block_record(const Ring& r, const Lane& w,
                                             int count, int32_t t, int kind,
                                             Pred pred, Ev ev) {
  if (!r.on) return;                    // the lane's: uniform in the block
  const int tid = threadIdx.x, nt = blockDim.x;
  const int chunk = (count + nt - 1) / nt;
  const int lo = tid * chunk < count ? tid * chunk : count;
  const int hi = lo + chunk < count ? lo + chunk : count;
  int mine = 0;
  for (int i = lo; i < hi; ++i) mine += pred(i) ? 1 : 0;
  const int lane = tid & 31, warp = tid >> 5;
  int incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  if (lane == 31) w.tctl[1 + warp] = incl;
  __syncthreads();
  int off = incl - mine, total = 0;
  for (int k = 0; k < nt / 32; ++k) {
    const int x = w.tctl[1 + k];
    if (k < warp) off += x;
    total += x;
  }
  const int32_t c = w.tctl[0];
  __syncthreads();                      // every thread has read the words
  if (total == 0) return;               // uniform
  for (int i = lo; i < hi; ++i) {
    if (!pred(i)) continue;
    if (off >= total - r.k) {
      int actor;
      int32_t data;
      ev(i, actor, data);
      put_event(r, wrap_add(c, off), pack_event(actor, kind), data, t);
    }
    ++off;
  }
  if (tid == 0) w.tctl[0] = wrap_add(c, total);
  __syncthreads();
}

// ---- the tick's pieces ----------------------------------------------------

__device__ __forceinline__ bool recorded(const Lane& w, int s, int e, int f) {
  bool any = false;
  for (int k = 0; k < s; ++k) any = any || w.recording[k * e + f];
  return any;
}

// HandleToken's credit (node.go:175) for edge f when it delivered a token
// not yet credited, and its mark for the log when its channel records now
// (traced, a token its owner credited holds 2: its receipt is recorded
// later, and it is not credited again)
template <bool kTrace>
__device__ __forceinline__ void credit(const Args& a, const Lane& w, int f) {
  if (kTrace ? w.tok[f] != 1 : !w.tok[f]) return;
  atomicAdd(&w.tokens[a.edge_dst[f]], w.head_data[f]);
  w.app[f] = recorded(w, a.s, a.e, f);
}

// a started, unfailed snapshot has not reached every node (_pending)
__device__ __forceinline__ bool pending(const Lane& w, int s, int n) {
  bool any = false;
  for (int k = 0; k < s; ++k)
    any = any || (w.started[k] && !w.failed[k] && w.completed[k] < n);
  return any;
}

// one message at the tail of edge g's ring, in place (append_rows for
// one row): the overflow bits, the slot, the counters
__device__ __forceinline__ void append(const Args& a, const Lane& w,
                                       long long be, int g, int32_t rt,
                                       bool marker, int32_t data) {
  const int32_t len = w.q_len[g];
  int bits = 0;
  if (len >= a.c) bits |= kErrQueueOverflow;
  if (w.tok_pushed[g] >= a.key_limit || rt >= kRtimePackLimit)
    bits |= kErrValueOverflow;
  if (bits) atomicOr(w.err, bits);
  const long long slot = (be + g) * a.c + (w.q_head[g] + len) % a.c;
  a.q_meta[slot] = (int32_t)((uint32_t)rt * 2u + (marker ? 1u : 0u));
  a.q_data[slot] = data;
  w.q_len[g] = len + 1;
  w.tok_pushed[g] += 1;
}

// The window planes' width, fixed at compile time (kWin32, kWin16) in the
// untraced hash instantiations, which thus compile the parent's int32
// writes alone; read from the launch (kWinAny: ``p16`` set or not) in the
// others
enum { kWinAny = 0, kWin32 = 1, kWin16 = 2 };

// one window-plane entry ``i`` of a [B, S, E] plane: the counter, or under
// the uint16 arm its low 16 bits
template <int kWin>
__device__ __forceinline__ void put_window(int32_t* p32, uint16_t* p16,
                                           long long i, int32_t v) {
  if (kWin == kWin16 || (kWin == kWinAny && p16 != nullptr))
    p16[i] = (uint16_t)v;
  else
    p32[i] = v;
}

// a marker's ring payload: epoch * S + sid under the supervisor
// (TickKernel._marker_payload), the bare sid otherwise
__device__ __forceinline__ int32_t payload(const Lane& w, int sid, int s,
                                           bool sup) {
  return sup ? (int32_t)((uint32_t)w.epoch[sid] * (uint32_t)s + sid) : sid;
}

// CreateLocalSnapshot (node.go:58-84) of an initiator: slot ``sid`` at
// ``node``, by the 32 lanes of warp 0, recording every in-link from the
// counter it has now and freezing the balance (the supervisor's
// injections; the owner step's first receipts write theirs in place)
template <int kWin>
__device__ __forceinline__ void initiate(const Args& a, const Lane& w,
                                         long long bs, int sid, int node,
                                         int ln) {
  for (int j = a.dst_lo[node] + ln; j < a.dst_hi[node]; j += 32) {
    const int f = a.by_dst[j];
    const int32_t cnt = w.rec_cnt[f];
    w.recording[sid * a.e + f] = 1;
    put_window<kWin>(a.rec_start, a.rec_start16, (bs + sid) * a.e + f, cnt);
    if (cnt < w.min_prot[f]) w.min_prot[f] = cnt;
  }
  if (ln == 0) {
    const int cell = sid * a.n + node;
    w.has_local[cell] = 1;
    w.frozen[cell] = w.tokens[node];
    w.rem[cell] = a.in_degree[node];
  }
}

// SendToNeighbors (node.go:97-109), thread 0: one marker per out-link of
// ``node`` in dest order, one delay draw each, appended in place (traced:
// a marker-send each, with the raw ``sid``)
template <bool kTrace, class Smp>
__device__ __forceinline__ void broadcast(const Args& a, const Lane& w,
                                          const Ring& ring, Smp& smp,
                                          long long be, int node, int sid,
                                          int32_t data, int32_t t) {
  for (int g = a.src_lo[node]; g < a.src_hi[node]; ++g) {
    append(a, w, be, g, smp.draw(t), true, data);
    if constexpr (kTrace) record(ring, w, g, kEvMSend, sid, t);
  }
}

// The supervisor's step at tick start, in warp 0 (TickKernel._supervise):
// the daemon, then the timeout scan and the re-initiations. Draws stay in
// thread 0 (lane 0), in the plain form's order, and so do the recorder's
// events.
template <bool kTrace, int kWin, class Smp>
__device__ __forceinline__ void supervise(const Args& a, const Lane& w,
                                          const Ring& ring, Smp& smp,
                                          long long be, long long bs,
                                          int32_t t, int ln) {
  const int S = a.s, n = a.n, e = a.e;
  const int every = a.snapshot_every, timeout = a.snapshot_timeout;
  if (every > 0 && t > 0 && t % every == 0) {    // t > 0: % on positives
    const int sid = *w.next_sid;
    __syncwarp();
    if (sid < S) {                  // _sup_daemon -> _inject_snapshot
      const int node = (t / every) % n;
      if (ln == 0) {
        *w.next_sid = sid + 1;
        w.started[sid] = 1;
        w.initiator[sid] = node;
        if (timeout > 0) w.deadline[sid] = wrap_add(t, timeout);
        if constexpr (kTrace) record(ring, w, node, kEvSnapStart, sid, t);
      }
      initiate<kWin>(a, w, bs, sid, node, ln);
      __syncwarp();
      if (ln == 0)
        broadcast<kTrace>(a, w, ring, smp, be, node, sid,
                          payload(w, sid, S, true), t);
      __syncwarp();
    }
  }
  if (timeout <= 0) return;
  if (ln == 0) {                    // _sup_scan's [S] vectors
    bool failed_any = false;
    const int32_t unit = timeout > 1 ? timeout : 1;
    for (int k = 0; k < S; ++k) {
      w.retry[k] = 0;
      if (!(w.started[k] && !w.failed[k] && w.completed[k] < n &&
            w.deadline[k] > 0 && t >= w.deadline[k]))
        continue;
      const bool can = w.retries[k] < a.snapshot_retries;
      const int32_t tries = w.retries[k] + (can ? 1 : 0);
      w.retries[k] = tries;
      w.epoch[k] += 1;
      w.completed[k] = 0;
      if (can) {
        const int32_t backoff =
            (int32_t)((uint32_t)unit << (tries < 4 ? tries : 4));
        w.deadline[k] = wrap_add(t, backoff);
        w.retry[k] = 1;
      } else {
        w.failed[k] = 1;
        w.deadline[k] = 0;
        w.retry[k] = 2;
        failed_any = true;
      }
    }
    if (failed_any) atomicOr(w.err, kErrSnapshotTimeout);
    if constexpr (kTrace) {   // aborts, then retries, then failures
      for (int kind = kEvSupAbort; kind <= kEvSupFail; ++kind)
        for (int k = 0; k < S; ++k) {
          const int code = w.retry[k];
          if (code == 0 || (kind == kEvSupRetry && code != 1) ||
              (kind == kEvSupFail && code != 2))
            continue;
          const int v = w.initiator[k];
          record(ring, w, v < 0 ? 0 : (v >= n ? n - 1 : v), kind, k, t);
        }
    }
  }
  __syncwarp();
  for (int k = 0; k < S; ++k) {     // aborted slots: cut state cleared
    if (!w.retry[k]) continue;
    for (int v = ln; v < n; v += 32) {
      const int cell = k * n + v;
      w.has_local[cell] = 0;
      w.done_local[cell] = 0;
      w.frozen[cell] = 0;
      w.rem[cell] = 0;
    }
    for (int f = ln; f < e; f += 32) {
      w.recording[k * e + f] = 0;
      put_window<kWin>(a.rec_start, a.rec_start16, (bs + k) * e + f, 0);
      put_window<kWin>(a.rec_end, a.rec_end16, (bs + k) * e + f, 0);
    }
  }
  __syncwarp();
  for (int k = 0; k < S; ++k) {     // _sup_reinitiate_ring, lowest first
    if (w.retry[k] != 1) continue;
    int node = w.initiator[k];
    node = node < 0 ? 0 : (node >= n ? n - 1 : node);
    initiate<kWin>(a, w, bs, k, node, ln);
    __syncwarp();
    if (ln == 0)
      broadcast<kTrace>(a, w, ring, smp, be, node, k,
                        payload(w, k, S, true), t);
    __syncwarp();
  }
}

// a popped marker's slot id: the payload decoded under the supervisor,
// the bare sid clamped into [0, S) otherwise (the cascade fold's rule)
__device__ __forceinline__ int marker_sid(int32_t data, int s, bool sup) {
  if (sup) return floor_mod(data, s);
  return data < 0 ? 0 : (data >= s ? s - 1 : data);
}

// The tick-start schedule of step 3 (ops/tick._wave_tick's, all threads):
// one thread per node marks each popped marker's first receipt (no local
// snapshot for (sid, node), and no earlier marker of this tick for them:
// bit 1 of has_local marks the cells seen and is cleared again) and, with
// ``kWnum`` (the traced wave), each in-edge's wave: the number of the
// node's markers below it in edge order (a marker's rank among them, the
// wave a token is credited in); a block scan of the first receipts' draws
// (the node's out-degree) in edge order gives each its draw base.
// Returns the tick's draw count and the deepest wave (``depth``), and
// leaves the sampler's tick-start key, counter and epoch and the warps'
// depths in the control words.
template <bool kWnum, class Smp>
__device__ __forceinline__ uint32_t schedule(const Args& a, const Lane& w,
                                             const Smp& smp, int tid,
                                             int nt, bool sup, int& depth) {
  const int n = a.n, e = a.e, S = a.s;
  depth = 0;
  for (int v = tid; v < n; v += nt) {
    int rank = 0;
    for (int j = a.dst_lo[v]; j < a.dst_hi[v]; ++j) {
      const int f = a.by_dst[j];
      if constexpr (kWnum) w.wnum[f] = (int16_t)rank;
      if (!w.mk[f]) continue;
      const int cell = marker_sid(w.head_data[f], S, sup) * n + v;
      w.first[f] = w.has_local[cell] == 0;
      w.has_local[cell] |= 2;
      ++rank;
    }
    for (int j = a.dst_lo[v]; rank > 0 && j < a.dst_hi[v]; ++j) {
      const int f = a.by_dst[j];
      if (w.mk[f])
        w.has_local[marker_sid(w.head_data[f], S, sup) * n + v] &= 1;
    }
    depth = rank > depth ? rank : depth;
  }
  __syncthreads();
  // the draw bases: each thread scans a contiguous chunk of edges
  const int chunk = (e + nt - 1) / nt;
  const int lo = tid * chunk < e ? tid * chunk : e;
  const int hi = lo + chunk < e ? lo + chunk : e;
  uint32_t mine = 0;
  for (int f = lo; f < hi; ++f)
    if (w.mk[f] && w.first[f])
      mine += a.src_hi[a.edge_dst[f]] - a.src_lo[a.edge_dst[f]];
  const int lane = tid & 31, warp = tid >> 5;
  uint32_t incl = mine;
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t x = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += x;
  }
  depth = __reduce_max_sync(0xffffffffu, depth);
  if (lane == 31) {
    w.wctl[kCtlSums + warp] = (int32_t)incl;
    w.wctl[kCtlDepths + warp] = depth;
  }
  if (tid == 0) {
    w.wctl[kCtlKey] = (int32_t)smp.key;
    w.wctl[kCtlCtr] = (int32_t)smp.ctr;
    w.wctl[kCtlEpoch] = (int32_t)smp.epoch;
  }
  __syncthreads();
  uint32_t off = incl - mine, total = 0;
  for (int k = 0; k < nt / 32; ++k) {
    const uint32_t x = (uint32_t)w.wctl[kCtlSums + k];
    if (k < warp) off += x;
    total += x;
    depth = w.wctl[kCtlDepths + k] > depth ? w.wctl[kCtlDepths + k] : depth;
  }
  for (int f = lo; f < hi; ++f) {
    w.base[f] = (int32_t)off;
    if (w.mk[f] && w.first[f])
      off += a.src_hi[a.edge_dst[f]] - a.src_lo[a.edge_dst[f]];
  }
  __syncthreads();                  // every base is written
  return total;
}

// HandleMarker (node.go:149-171) for the marker on edge ``f`` into ``d``
// by the thread that serves d (its owner), its tokens of lower edge rank
// already credited: a first receipt creates the local snapshot (every
// in-link but f, from the counter it will have after this tick's log
// appends) and broadcasts one marker per out-edge in dest order, the k-th
// at draw ``base + k`` (the Go-exact stream: ``gdraw``, the tick's draws
// in stream order); a repeat closes the channel's window; then the
// finalization check, which (traced) sets bit 1 of ``first[f]`` where the
// cell fires. Only ``completed`` and the error word are shared with other
// threads.
template <bool kTrace, int kWin>
__device__ __forceinline__ void handle_marker(const Args& a, const Lane& w,
                                              long long be, long long bs,
                                              int f, int d, int32_t t,
                                              uint32_t key, uint32_t ctr0,
                                              uint32_t epoch0, bool sup) {
  const int n = a.n, e = a.e, S = a.s;
  const int sid = marker_sid(w.head_data[f], S, sup);
  const int cell = sid * n + d;
  if (w.first[f]) {
    for (int j = a.dst_lo[d]; j < a.dst_hi[d]; ++j) {
      const int g = a.by_dst[j];
      if (g == f) continue;
      const int32_t cnt = w.rec_cnt[g] + (int32_t)w.app[g];
      w.recording[sid * e + g] = 1;
      put_window<kWin>(a.rec_start, a.rec_start16, (bs + sid) * e + g, cnt);
      if (cnt < w.min_prot[g]) w.min_prot[g] = cnt;
    }
    w.has_local[cell] = 1;
    w.frozen[cell] = w.tokens[d];
    w.rem[cell] = a.in_degree[d] - 1;
    const int32_t data = payload(w, sid, S, sup);
    const int g0 = a.src_lo[d];
    const uint32_t base = (uint32_t)w.base[f];
    for (int g = g0; g < a.src_hi[d]; ++g) {
      const uint32_t at = base + (uint32_t)(g - g0);
      const int32_t rt = ordered(a.sampler)
                             ? w.gdraw[at]
                             : draw_at(a, key, ctr0, epoch0, at, t);
      append(a, w, be, g, rt, true, data);
    }
  } else {
    const int rc = sid * e + f;
    if (w.recording[rc]) {
      w.recording[rc] = 0;
      w.rem[cell] -= 1;
      put_window<kWin>(a.rec_end, a.rec_end16, (bs + sid) * e + f,
                       w.rec_cnt[f]);
    }
  }
  if (w.has_local[cell] && w.rem[cell] == 0 && !w.done_local[cell]) {
    w.done_local[cell] = 1;
    atomicAdd(&w.completed[sid], 1);
    if constexpr (kTrace) w.first[f] |= 2;
  }
}

// Step 3 of every instantiation, the cascade's and the wave's alike
// (ops/tick._wave_tick's docstring: bit-identical to _cascade_tick): the
// tick-start schedule, then one thread per node, which serves all of
// that node's markers in edge order back to back: before each, the
// node's tokens of lower edge rank are credited (marked for the log where
// the channel records), then HandleMarker. Nodes touch disjoint in-edges,
// out-edges and (sid, node) cells, so no barrier separates one node's
// markers from another's. The draws are addressed by stream position; the
// Go-exact stream, which draws one at a time, is drawn by thread 0 for the
// whole tick in stream order first (at most one first receipt per (sid,
// node) a tick, so at most S * E draws), which are exactly the cascade's
// draws in its order. The tokens left are credited in step 4 (``ctl[0]``
// = 0). Traced (kTrace), a token its owner credits is left at 2 and each
// marker's block is left in ``first`` (first receipt, cell fired) for the
// ranked append (record_step); kWave (traced only) numbers every in-edge's
// wave for the wave's key, and the owner leaves each in-edge's record at
// its by_dst position j in ``tev`` (free once step 2's fault events are
// recorded): 0 for no marker, else 1 | first receipt << 1 | fired << 2 |
// wave << 3, so the wave's sends and endSnapshots are found in node order
// with no gather.
template <bool kTrace, bool kWave, int kWin, class Smp>
__device__ __forceinline__ void owner_step(const Args& a, const Lane& w,
                                           Smp& smp, long long be,
                                           long long bs, int32_t t, int tid,
                                           int nt, bool sup) {
  int depth;
  const uint32_t total = schedule<kWave>(a, w, smp, tid, nt, sup, depth);
  const uint32_t key = (uint32_t)w.wctl[kCtlKey];
  const uint32_t ctr0 = (uint32_t)w.wctl[kCtlCtr];
  const uint32_t epoch0 = (uint32_t)w.wctl[kCtlEpoch];
  if (tid == 0) {
    if (ordered(a.sampler))
      for (uint32_t i = 0; i < total; ++i) w.gdraw[i] = smp.draw(t);
    else
      smp.advance(total);
    w.ctl[0] = 0;                      // step 4 credits every token left
  }
  if (ordered(a.sampler)) __syncthreads();
  for (int d = tid; d < a.n; d += nt) {
    int next = a.dst_lo[d];            // in-edges [dst_lo, next) credited
    int wave = 0;                      // the node's markers so far
    for (int j = a.dst_lo[d]; j < a.dst_hi[d]; ++j) {
      const int f = a.by_dst[j];
      if (!w.mk[f]) {
        if constexpr (kWave) w.tev[j] = 0;
        continue;
      }
      // the node's tokens of lower edge rank (by_dst keeps edge order
      // within a node)
      for (; next < j; ++next) {
        const int g = a.by_dst[next];
        if (!w.tok[g]) continue;
        w.tokens[d] += w.head_data[g];
        w.app[g] = recorded(w, a.s, a.e, g);
        w.tok[g] = kTrace ? 2 : 0;
      }
      handle_marker<kTrace, kWin>(a, w, be, bs, f, d, t, key, ctr0, epoch0,
                                  sup);
      if constexpr (kWave) w.tev[j] = 1 | w.first[f] << 1 | wave++ << 3;
    }
  }
}

// The tiled layout's owner step as a call, not inlined (kTiled): there
// the kernel's registers bound how many lanes an SM keeps in flight, and
// the tiled arm is latency-bound, so more lanes win; called, the step
// keeps its own registers and the kernel's other steps fit in fewer
// (PERF.md §6)
template <bool kTrace, bool kWave, int kWin, class Smp>
__device__ __noinline__ void owner_step_call(const Args& a, const Lane& w,
                                             Smp& smp, long long be,
                                             long long bs, int32_t t,
                                             int tid, int nt, bool sup) {
  owner_step<kTrace, kWave, kWin>(a, w, smp, be, bs, t, tid, nt, sup);
}

// ---- the ranked append of a traced tick's marker and receipt events -----
//
// The plain ticks append these events as they happen, in an order that is
// an order of keys, all fixed once the owner step has run:
//   the cascade (ops/tick._cascade_tick): a source pops at most one
//     message a tick, and the fold records, before marker m, the receipts
//     of every source below m's, so the ring takes the popped edges in
//     edge order, a token as its receipt, a marker as its block (its
//     marker-recv, its broadcast's marker-sends in dest order where it was
//     a first receipt, its endSnapshot where its cell fired): key (source,
//     block before receipts, edge), one key group over the E edges;
//   the wave (ops/tick._wave_tick): wave k records its receipts, its
//     marker-recvs and its marker-sends, each in edge order, then its
//     endSnapshots in [S, N] slot-major order. A token on in-edge g of d
//     is credited in wave wnum[g] (d's markers below it; at the lane's
//     depth, after the last wave, where step 4 records it), a marker is
//     received in wave wnum[f], and a node has at most one marker a wave,
//     so wave k's sends are its first receipts' out-edge rows in node
//     order and its endSnapshots one a node: key (wave, class, index), key
//     group (3 + S) wave + class (the endSnapshots' class by slot), over
//     four classes of E items: the edges (receipts), the edges
//     (marker-recvs), the by_dst positions (a first receipt's row of
//     sends: in-edges in node order) and the by_dst positions again (a
//     fired cell's endSnapshot), the last two read from the owner's
//     records in ``tev``.
// Every item's block of events goes to its rank in (group, item) order:
// each warp counts its contiguous chunk of each class's E items per group
// into a [group][warp] table (a window of groups at a time; a group holds
// one class, so the chunks of each class keep its order), one block scan
// makes the table the blocks' offsets, and the warps walk their chunks
// again and write the events ranked at or past total - K, so no two
// threads write one slot. O(E + events) a tick, with no barrier between
// one node's events and another's.

// item ``i`` of class ``cls``: its key group and the events its block
// holds
template <bool kWave>
__device__ __forceinline__ void rank_item(const Args& a, const Lane& w,
                                          int cls, int i, int per, bool sup,
                                          int& grp, int& size) {
  grp = 0;
  size = 0;
  if constexpr (!kWave) {
    if (w.tok[i]) {
      size = 1;
    } else if (w.mk[i]) {
      const int d = a.edge_dst[i], fl = w.first[i];
      size = 1 + ((fl & 1) ? a.src_hi[d] - a.src_lo[d] : 0) + (fl >> 1);
    }
  } else if (cls < 2) {
    if (cls == 0 ? w.tok[i] != 0 : w.mk[i] != 0) {
      grp = per * w.wnum[i] + cls;
      size = 1;
    }
  } else {
    const int rec = w.tev[i];
    if (cls == 2 && (rec & 2)) {
      const int d = a.edge_dst[a.by_dst[i]];
      grp = per * (rec >> 3) + 2;
      size = a.src_hi[d] - a.src_lo[d];
    } else if (cls == 3 && (rec & 4)) {
      grp = per * (rec >> 3) + 3 +
            marker_sid(w.head_data[a.by_dst[i]], a.s, sup);
      size = 1;
    }
  }
}

// whether item ``i`` of class ``cls`` holds events, by one load
// (record_step's tiled walk)
template <bool kWave>
__device__ __forceinline__ bool rank_peek(const Lane& w, int cls, int i) {
  if constexpr (!kWave) return (w.tok[i] | w.mk[i]) != 0;
  if (cls < 2) return (cls == 0 ? w.tok[i] : w.mk[i]) != 0;
  return (w.tev[i] & (cls == 2 ? 2 : 4)) != 0;
}

// writes item ``i`` of class ``cls``'s events, the first at rank ``pos``,
// those ranked at or past ``keep``; ``c`` is the lane's count before the
// append
template <bool kWave>
__device__ __forceinline__ void rank_emit(const Args& a, const Lane& w,
                                          const Ring& r, int cls, int i,
                                          int pos, int keep, int32_t c,
                                          int32_t t, bool sup) {
  const int f = kWave && cls >= 2 ? a.by_dst[i] : i;
  if (kWave ? cls == 0 : w.tok[f] != 0) {
    if (pos >= keep)
      put_event(r, wrap_add(c, pos), pack_event(f, kEvRecv), w.head_data[f],
                t);
    return;
  }
  const int sid = marker_sid(w.head_data[f], a.s, sup);
  const int d = a.edge_dst[f], fl = w.first[f];
  if (!kWave || cls == 1) {
    if (pos >= keep)
      put_event(r, wrap_add(c, pos), pack_event(f, kEvMRecv), sid, t);
    ++pos;
  }
  if (kWave ? cls == 2 : (fl & 1) != 0) {
    const int lo = a.src_lo[d], hi = a.src_hi[d];
    int g = lo;
    if (pos < keep) {                   // skip the sends overwritten later
      g = keep - pos < hi - lo ? lo + (keep - pos) : hi;
      pos += g - lo;
    }
    for (; g < hi; ++g, ++pos)
      put_event(r, wrap_add(c, pos), pack_event(g, kEvMSend), sid, t);
  }
  if ((kWave ? cls == 3 : (fl & 2) != 0) && pos >= keep)
    put_event(r, wrap_add(c, pos), pack_event(d, kEvSnapEnd), sid, t);
}

// The ranked append of step 3's and step 4's events in the body's key
// order (above), by the whole block, after step 4's credits; the count
// table lies in ``base`` (its draw bases read), the total's warp sums in
// the schedule's (read) draw sums. A lane with tr_on == 0 appends nothing.
// kTiled: the planes lie in device memory, where a tile's loads wait a
// memory latency, so the walks peek at four tiles at once and skip the
// empty ones; in shared memory they go tile by tile.
template <bool kWave, bool kTiled>
__device__ __forceinline__ void record_step(const Args& a, const Lane& w,
                                            const Ring& r, int32_t t,
                                            int tid, int nt, bool sup) {
  if (!r.on) return;                    // the lane's: uniform in the block
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;
  const unsigned full = 0xffffffffu;
  int depth = 0;
  for (int k = 0; k < nw; ++k)
    depth = w.wctl[kCtlDepths + k] > depth ? w.wctl[kCtlDepths + k] : depth;
  const int per = 3 + a.s;
  const int groups = kWave ? per * (depth + 1) : 1;
  const int classes = kWave ? 4 : 1;
  const int cap = (a.e < kRankMin ? kRankMin : a.e) / nw;  // groups a window
  // each warp's contiguous chunk of a class's E items, in whole tiles of 32
  const int chunk = (a.e + nw * 32 - 1) / (nw * 32) * 32;
  const int lo = warp * chunk < a.e ? warp * chunk : a.e;
  const int hi = lo + chunk < a.e ? lo + chunk : a.e;
  int32_t* const table = w.base;
  const int32_t c = w.tctl[0];
  int total = 0, done = 0;
  // every tile of 32 items of the warp's chunks, class by class, in order,
  // passed to ``tile(cls, x0)`` (kTiled: unless it holds no event, four
  // tiles peeked at once, their loads in flight together)
  auto walk = [&](auto&& tile) {
    for (int cls = 0; cls < classes; ++cls) {
      if constexpr (!kTiled) {
        for (int x0 = lo; x0 < hi; x0 += 32) tile(cls, x0);
        continue;
      }
      for (int x0 = lo; x0 < hi; x0 += 128) {
        bool any[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int x = x0 + 32 * u + lane;
          any[u] = x < hi && rank_peek<kWave>(w, cls, x);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (__any_sync(full, any[u])) tile(cls, x0 + 32 * u);
      }
    }
  };
  for (int g0 = 0; g0 < groups; g0 += cap) {
    const int gw = groups - g0 < cap ? groups - g0 : cap;
    for (int i = tid; i < gw * nw; i += nt) table[i] = 0;
    __syncthreads();
    // the count walk: each warp's events per group of the window
    int all = 0;
    walk([&](int cls, int x0) {
      const int x = x0 + lane;
      int grp = 0, size = 0;
      if (x < hi) rank_item<kWave>(a, w, cls, x, per, sup, grp, size);
      all += size;
      const bool in = size > 0 && grp >= g0 && grp < g0 + gw;
      unsigned todo = __ballot_sync(full, in);
      while (todo) {
        const int lead = __ffs(todo) - 1;
        const int gl = __shfl_sync(full, grp, lead);
        const bool mine = in && grp == gl;
        const int sum = (int)__reduce_add_sync(full, mine ? size : 0);
        if (lane == lead) table[(gl - g0) * nw + warp] += sum;
        __syncwarp();
        todo &= ~__ballot_sync(full, mine);
      }
    });
    __syncthreads();                    // every warp's counts are in
    // the offsets: an exclusive scan of the table in (group, warp) order
    // from the events of the windows before; the first window also sums
    // every group's events, the tick's total
    const int m = gw * nw, each = (m + nt - 1) / nt;
    const int tlo = tid * each < m ? tid * each : m;
    const int thi = tlo + each < m ? tlo + each : m;
    int part = 0;
    for (int i = tlo; i < thi; ++i) part += table[i];
    int incl = part;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(full, incl, o);
      if (lane >= o) incl += y;
    }
    const bool first = g0 == 0, more = groups > cap;
    if (first && more) {
      const int ws = (int)__reduce_add_sync(full, all);
      if (lane == 0) w.wctl[kCtlSums + warp] = ws;
    }
    if (lane == 31) w.tctl[1 + warp] = incl;
    __syncthreads();
    int off = done + incl - part, wsum = 0;
    for (int k = 0; k < nw; ++k) {
      const int y = w.tctl[1 + k];
      if (k < warp) off += y;
      wsum += y;
    }
    if (first) {
      total = wsum;
      if (more) {
        total = 0;
        for (int k = 0; k < nw; ++k) total += w.wctl[kCtlSums + k];
      }
    }
    for (int i = tlo; i < thi; ++i) {
      const int y = table[i];
      table[i] = off;
      off += y;
    }
    __syncthreads();
    // the write walk: each block at its offset, ranks by the warp's scan
    const int keep = total - r.k;
    walk([&](int cls, int x0) {
      const int x = x0 + lane;
      int grp = 0, size = 0;
      if (x < hi) rank_item<kWave>(a, w, cls, x, per, sup, grp, size);
      const bool in = size > 0 && grp >= g0 && grp < g0 + gw;
      unsigned todo = __ballot_sync(full, in);
      while (todo) {
        const int lead = __ffs(todo) - 1;
        const int gl = __shfl_sync(full, grp, lead);
        const bool mine = in && grp == gl;
        int run = mine ? size : 0;
        for (int o = 1; o < 32; o <<= 1) {
          const int y = __shfl_up_sync(full, run, o);
          if (lane >= o) run += y;
        }
        int32_t* const at = &table[(gl - g0) * nw + warp];
        const int from = *at;
        if (mine)
          rank_emit<kWave>(a, w, r, cls, x, from + run - size, keep, c, t,
                           sup);
        const int sum = __shfl_sync(full, run, 31);
        __syncwarp();
        if (lane == lead) *at = from + sum;
        __syncwarp();
        todo &= ~__ballot_sync(full, mine);
      }
    });
    done += wsum;
    __syncthreads();                    // the table read before it clears
  }
  if (tid == 0) w.tctl[0] = wrap_add(c, total);
  __syncthreads();
}

// kExt: the fault arm (the adversary or the supervisor armed) is compiled
// in; the fault-free instantiation carries none of it, so its registers
// and occupancy are the fault-free kernel's own. kWave: with kTrace, the
// wave's key for the ranked append in place of the cascade's (the step
// body is one, owner_step); untraced, only kWave = false is
// instantiated. kTiled: the
// lane's planes are carved from its stride of the device-memory workspace
// instead of shared memory; the bodies are the same code, every access
// goes through the Lane's pointers (generic: shared or global), and the
// block's barriers order global writes for the block as they do shared
// ones. A compile-time parameter, so the resident instantiations keep
// their shared-memory addressing and registers. kTrace: the recorder arm
// (the module comment); the untraced instantiations compile none of it.
// kTf: the threefry sampler's (the module comment), and no other's; kWin
// the window planes' width (put_window). The body of every kernel below.
template <bool kExt, bool kWave, bool kTiled, bool kTrace, bool kTf,
          int kWin>
__device__ __forceinline__ void fused_ticks(const Args a) {
  extern __shared__ __align__(16) char smem[];
  const long long b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = a.n, e = a.e, S = a.s, C = a.c, L = a.l;
  const long long be = b * e, bn = b * n, bs = b * S;
  const bool faulted = kExt && a.faulted != 0;
  const bool sup =
      kExt && (a.snapshot_timeout > 0 || a.snapshot_every > 0);
  const bool ext = kExt;
  // TickKernel._quiescent: never under crashes or the daemon
  const bool never_quiet =
      kExt && (a.crash_kind != 0 || a.snapshot_every > 0);
  int32_t time = a.time[b];

  // A lane that takes no step of this launch is left exactly as it was,
  // and returns before it loads anything: not live at launch (any mode:
  // the streaming engine gates its drain slice and flush per lane, and
  // the gate holds for the whole launch), errored under quarantine
  // (sticky), or not draining at the first step (a condition-false drain
  // step is the identity, so it stays false).
  if (a.live != nullptr && !a.live[b]) return;
  if (a.mode != kTicks) {
    if (a.quarantine && a.error[b] != 0) return;
    if (a.mode == kDrain) {
      bool pend = false;
      for (int k = 0; k < S; ++k)
        pend = pend || (a.started[bs + k] && !a.snap_failed[bs + k] &&
                        a.completed[bs + k] < n);
      if (!pend || time >= a.limit[b]) return;
    }
  }

  uintptr_t lane_base;
  if constexpr (kTiled)
    lane_base = reinterpret_cast<uintptr_t>(a.workspace + b * a.smem_bytes);
  else
    lane_base = reinterpret_cast<uintptr_t>(smem);
  const Lane w = carve(lane_base, n, e, S, ext, kWave, kTrace,
                       ordered(a.sampler));
  Ring ring{nullptr, nullptr, nullptr, 1, false};
  if constexpr (kTrace) {
    const long long bk = b * a.tr_k;
    ring = Ring{a.tr_meta + bk, a.tr_data + bk, a.tr_tick + bk, a.tr_k,
                a.tr_on[b] > 0};
    if (tid == 0) w.tctl[0] = a.tr_count[b];
  }
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
    if (ext) {
      w.epoch[k] = a.snap_epoch[bs + k];
      w.deadline[k] = a.snap_deadline[bs + k];
      w.retries[k] = a.snap_retries[bs + k];
      w.initiator[k] = a.snap_initiator[bs + k];
    }
  }
  if (ext)
    for (int k = tid; k < kClasses; k += nt)
      w.counts[k] = a.fault_counts[b * kClasses + k];
  Sampler<kTf> smp{a.sampler, a.max_delay, a.fixed_delay, 0u, 0u, 0u,
                   nullptr, 0, 0, 0u, 0u};
  if (tid == 0) {
    *w.err = a.error[b];
    if (ext) {
      *w.next_sid = a.next_sid[b];
      *w.skew = a.fault_skew[b];
      *w.stale = a.stale_markers[b];
    }
    if constexpr (kTf) {
      smp.tk0 = (uint32_t)static_cast<const int64_t*>(a.dw0)[2 * b];
      smp.tk1 = (uint32_t)static_cast<const int64_t*>(a.dw0)[2 * b + 1];
    } else if (a.sampler == kHash) {
      smp.key = (uint32_t)static_cast<const int64_t*>(a.dw0)[b];
      smp.ctr = (uint32_t)static_cast<const int64_t*>(a.dw1)[b];
      smp.epoch = (uint32_t)static_cast<const int64_t*>(a.dw2)[b];
    } else if (a.sampler == kGoExact) {
      smp.vec = static_cast<uint64_t*>(a.dw0) + b * kGoLen;
      smp.tap = static_cast<const int32_t*>(a.dw1)[b];
      smp.feed = static_cast<const int32_t*>(a.dw2)[b];
    }
  }
  const Fault flt{faulted ? (uint32_t)a.fault_key[b] : 0u, a.rates,
                  a.crash_kind, a.crash_len, a.crash_period, a.crash_start};
  __syncthreads();

  // every thread tracks the lane's clock and quiet flag identically
  bool quiet = false;
  for (int step = 0; step < a.length; ++step) {
    if (a.mode == kTicks) {
      int busy = 0;
      for (int f = tid; f < e; f += nt) busy |= w.q_len[f] > 0;
      busy = __syncthreads_or(busy);         // also the step's barrier
      bool quiescent = !busy && !never_quiet;
      if (quiescent && sup && a.snapshot_timeout > 0)
        quiescent = !pending(w, S, n);
      const bool poisoned = a.quarantine && *w.err != 0;
      quiet = quiet || quiescent || poisoned;
      if (quiet) {                            // bump: a pure time increment
        if (!poisoned) time = wrap_add(time, 1);
        continue;
      }
    } else {
      __syncthreads();
      if (a.quarantine && *w.err != 0) continue;
      if (a.mode == kDrain) {
        if (!pending(w, S, n) || time >= a.limit[b]) continue;
      }
    }
    const int32_t t = time = wrap_add(time, 1);
    const uint32_t tmix = faulted ? time_mix(t) : 0u;
    // every thread has taken the step's decision from err and the [S]
    // vectors before the restarts or the supervisor may change them
    if (ext) __syncthreads();

    // 0. the step's fault flags and the crash restarts
    if (faulted) {
      for (int f = tid; f < e; f += nt) w.eflags[f] = edge_flags(flt, tmix, f);
      int restarts = 0, unrecovered = 0;
      uint32_t skew = 0;
      int done_sid = -1;                      // newest completed slot
      if (a.crash_lossy)
        for (int k = S - 1; k >= 0 && done_sid < 0; --k)
          if (w.started[k] && w.completed[k] >= n) done_sid = k;
      for (int v = tid; v < n; v += nt) {
        const bool now = down_at(flt, t, v);
        w.down[v] = now;
        if (!restarted_at(flt, t, v, now)) continue;
        restarts += 1;
        if (!a.crash_lossy) continue;
        const int32_t restored = done_sid >= 0 ? w.frozen[done_sid * n + v] : 0;
        skew += (uint32_t)restored - (uint32_t)w.tokens[v];
        w.tokens[v] = restored;
        if (done_sid < 0) unrecovered = 1;
      }
      if (restarts) {
        atomicAdd(&w.counts[kFcCrash], restarts);
        atomicAdd(w.skew, (int32_t)skew);
      }
      if (unrecovered) atomicOr(w.err, kErrFaultUnrecovered);
      __syncthreads();
      if constexpr (kTrace)   // the restarts, node by node
        block_record(ring, w, n, t, kEvFault,
                     [&](int v) { return restarted_at(flt, t, v, w.down[v]); },
                     [&](int v, int& actor, int32_t& data) {
                       actor = v;
                       data = kFcCrash;
                     });
    }

    // 1. the supervisor
    if (sup) {
      if (tid < 32)
        supervise<kTrace, kWin>(a, w, ring, smp, be, bs, t, tid);
      __syncthreads();
    }

    // 2. selection + pop: each source's first eligible head in dest order,
    // behind the fault gates; the drop / dup split and the stale check
    {
      int c_jit = 0, c_mjit = 0, c_drop = 0, c_dup = 0, c_mdrop = 0,
          c_mdup = 0, c_stale = 0;
      uint32_t skew = 0;
      for (int v = tid; v < n; v += nt) {
        bool found = false;
        for (int f = a.src_lo[v]; f < a.src_hi[v]; ++f) {
          const int32_t len = w.q_len[f];
          const uint8_t fl = faulted ? w.eflags[f] : 0;
          int32_t meta = 0;
          bool sel = false;
          int evbits = 0;   // traced: the edge's fault events, kFc* bits
          // under faults every non-empty head is read: its stalls count
          if ((faulted || !found) && len > 0) {
            const int32_t h = w.q_head[f];
            const long long slot = (be + f) * C + h;
            const int32_t m = a.q_meta[slot];
            bool elig = (m >> 1) <= t;          // arithmetic, as jnp's
            if (elig && faulted) {
              const bool jit = fl & kFJit;
              const bool mjit = (m & 1) && (fl & kFMJit);
              c_jit += jit;
              c_mjit += mjit;
              if constexpr (kTrace)
                evbits |= (jit ? 1 << kFcJitter : 0) |
                          (mjit ? 1 << kFcMJitter : 0);
              elig = !jit && !mjit && !w.down[a.edge_dst[f]];
            }
            if (elig && !found) {
              found = sel = true;
              meta = m;
              w.head_data[f] = a.q_data[slot];
              w.q_head[f] = (h + 1) % C;
              w.q_len[f] = len - 1;
            }
          }
          bool tok = sel && !(meta & 1);
          bool mk = sel && (meta & 1);
          uint8_t dup = kDupNone;
          if (tok && faulted) {                 // _fault_split_tokens
            const uint32_t amt = (uint32_t)w.head_data[f];
            if (fl & kFDrop) {
              tok = false;
              c_drop += 1;
              skew -= amt;
              if constexpr (kTrace) evbits |= 1 << kFcDrop;
            } else if (fl & kFDup) {
              dup = kDupToken;
              c_dup += 1;
              skew += amt;
              if constexpr (kTrace) evbits |= 1 << kFcDup;
            }
          }
          if (mk && faulted) {                  // _fault_split_markers
            if (fl & kFMDrop) {
              mk = false;
              c_mdrop += 1;
              if constexpr (kTrace) evbits |= 1 << kFcMDrop;
            } else if (fl & kFMDup) {
              dup = kDupMarker;
              c_mdup += 1;
              if constexpr (kTrace) evbits |= 1 << kFcMDup;
            }
          }
          if (mk && sup) {                      // _reject_stale
            const int32_t p = w.head_data[f];
            if (floor_div(p, S) != w.epoch[floor_mod(p, S)]) {
              mk = false;
              c_stale += 1;
            }
          }
          w.tok[f] = tok;
          w.mk[f] = mk;
          w.app[f] = 0;
          if (ext) w.dupk[f] = dup;
          // every edge is written here each step, so ``tev`` needs no
          // clearing at launch (a tiled workspace is left dirty)
          if constexpr (kTrace) w.tev[f] = evbits;
        }
      }
      if (faulted) {
        if (c_jit) atomicAdd(&w.counts[kFcJitter], c_jit);
        if (c_mjit) atomicAdd(&w.counts[kFcMJitter], c_mjit);
        if (c_drop) atomicAdd(&w.counts[kFcDrop], c_drop);
        if (c_dup) atomicAdd(&w.counts[kFcDup], c_dup);
        if (c_mdrop) atomicAdd(&w.counts[kFcMDrop], c_mdrop);
        if (c_mdup) atomicAdd(&w.counts[kFcMDup], c_mdup);
        if (c_drop || c_dup) atomicAdd(w.skew, (int32_t)skew);
      }
      if (c_stale) atomicAdd(w.stale, c_stale);
    }
    __syncthreads();
    if constexpr (kTrace) {
      if (faulted) {
        // TickKernel's order: the jitter stalls (tokens, then markers),
        // the token drops and duplicates, the marker drops and duplicates
        const int order[6] = {kFcJitter, kFcMJitter, kFcDrop, kFcDup,
                              kFcMDrop, kFcMDup};
        for (int j = 0; j < 6; ++j) {
          const int fc = order[j];
          block_record(ring, w, e, t, kEvFault,
                       [&](int f) { return ((w.tev[f] >> fc) & 1) != 0; },
                       [&](int f, int& actor, int32_t& data) {
                         actor = f;
                         data = fc;
                       });
        }
      }
    }

    // 3. the markers: one destination-owned step (owner_step), for the
    // cascade and the wave alike
    if constexpr (kTiled)
      owner_step_call<kTrace, kWave, kWin>(a, w, smp, be, bs, t, tid, nt,
                                           sup);
    else
      owner_step<kTrace, kWave, kWin>(a, w, smp, be, bs, t, tid, nt, sup);
    __syncthreads();

    // 4. the remaining credits, then (traced) the ranked append of the
    // tick's marker and receipt events, the log append, the duplicates'
    // re-appends (after the broadcasts) and the stamp
    for (int f = w.ctl[0] + tid; f < e; f += nt) credit<kTrace>(a, w, f);
    __syncthreads();
    if constexpr (kTrace)
      record_step<kWave, kTiled>(a, w, ring, t, tid, nt, sup);
    for (int f = tid; f < e; f += nt) {
      if (w.app[f]) {
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
      if (faulted && w.dupk[f]) {
        const bool marker = w.dupk[f] == kDupMarker;
        append(a, w, be, f, dup_time(flt, t, marker, tmix, f, a.dup_mod),
               marker, w.head_data[f]);
      }
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
    if (sup) {
      a.started[bs + k] = w.started[k];
      a.snap_failed[bs + k] = w.failed[k];
      a.snap_epoch[bs + k] = w.epoch[k];
      a.snap_deadline[bs + k] = w.deadline[k];
      a.snap_retries[bs + k] = w.retries[k];
      a.snap_initiator[bs + k] = w.initiator[k];
    }
  }
  if (faulted)
    for (int k = tid; k < kClasses; k += nt)
      a.fault_counts[b * kClasses + k] = w.counts[k];
  if (tid == 0) {
    a.time[b] = time;
    a.error[b] = *w.err;
    if constexpr (kTrace) a.tr_count[b] = w.tctl[0];
    if (faulted) a.fault_skew[b] = *w.skew;
    if (sup) {
      a.next_sid[b] = *w.next_sid;
      a.stale_markers[b] = *w.stale;
    }
    if constexpr (kTf) {
      static_cast<int64_t*>(a.dw0)[2 * b] = (int64_t)smp.tk0;
      static_cast<int64_t*>(a.dw0)[2 * b + 1] = (int64_t)smp.tk1;
    } else if (a.sampler == kHash) {
      static_cast<int64_t*>(a.dw1)[b] = (int64_t)smp.ctr;
      static_cast<int64_t*>(a.dw2)[b] = (int64_t)smp.epoch;
    } else if (a.sampler == kGoExact) {
      static_cast<int32_t*>(a.dw1)[b] = smp.tap;
      static_cast<int32_t*>(a.dw2)[b] = smp.feed;
    }
  }
}

// the untraced instantiations, int32 or uint16 windows (kWin)
template <bool kExt, bool kTiled, int kWin>
__global__ void __launch_bounds__(kThreads)
fused_ticks_kernel(const Args a) {
  fused_ticks<kExt, false, kTiled, false, false, kWin>(a);
}

// The traced instantiations (the recorder arm), bound to 3 blocks an SM
// resident (80 registers) and 4 tiled (64), with spills: unbound they
// take 128, 2 lanes an SM, and the step is latency-bound, so lanes in
// flight win (drain megatick on config 5 18.2 ms bound against 24.3, the
// resident 8-12 % faster; PERF.md §6). A kernel template of its own, so
// the untraced instantiations keep their allocation.
template <bool kExt, bool kWave, bool kTiled>
__global__ void __launch_bounds__(kThreads, kTiled ? 4 : 3)
fused_ticks_traced(const Args a) {
  fused_ticks<kExt, kWave, kTiled, true, false, kWinAny>(a);
}

// The threefry sampler's instantiations (kTf; the cascade only: the wave
// takes no order-dependent sampler), untraced and traced, each bound to
// the lanes an SM keeps in flight in the others: unbound, the draw's call
// took the fault-free resident kernel from 80 registers to 120-123 (2
// lanes an SM, not 3), and bound to 1 lane the faulted one to 147.
// Resident 3 / 2 blocks (fault-free / faulted), tiled 4 / 2; traced 3 / 4
// as above.
template <bool kExt, bool kTiled, bool kTrace>
__global__ void __launch_bounds__(kThreads, kTrace ? (kTiled ? 4 : 3)
                                  : (kExt ? 2 : (kTiled ? 4 : 3)))
fused_ticks_threefry(const Args a) {
  fused_ticks<kExt, false, kTiled, kTrace, true, kWinAny>(a);
}

// Faults.fault_planes from the device hash above: block (lane, step),
// threads over edges and nodes; row j is tick time time[b] + 1 + j
__global__ void __launch_bounds__(kThreads)
fault_planes_kernel(const int64_t* key, const int32_t* time, int32_t* edge,
                    int32_t* node, int k, int e, int n, Fault f,
                    int dup_mod) {
  const long long b = blockIdx.x / k;
  const int j = blockIdx.x % k;
  f.key = (uint32_t)key[b];
  const int32_t t = wrap_add(time[b], 1 + j);
  const uint32_t tmix = time_mix(t);
  int32_t* ep = edge + (long long)blockIdx.x * 8 * e;
  int32_t* np = node + (long long)blockIdx.x * 2 * n;
  for (int x = threadIdx.x; x < e; x += blockDim.x) {
    const uint8_t fl = edge_flags(f, tmix, x);
    ep[0 * e + x] = (fl & kFDrop) != 0;
    ep[1 * e + x] = (fl & kFDup) != 0;
    ep[2 * e + x] = (fl & kFJit) != 0;
    ep[3 * e + x] = dup_time(f, t, false, tmix, x, dup_mod);
    ep[4 * e + x] = (fl & kFMDrop) != 0;
    ep[5 * e + x] = (fl & kFMDup) != 0;
    ep[6 * e + x] = (fl & kFMJit) != 0;
    ep[7 * e + x] = dup_time(f, t, true, tmix, x, dup_mod);
  }
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const bool now = down_at(f, t, v);
    np[v] = now;
    np[n + v] = restarted_at(f, t, v, now);
  }
}

}  // namespace

extern "C" {

int clsim_fused_ticks(const Args* a, void* stream) {
  const long long share = a->smem_bytes;
  const bool ext = a->ext != 0, wave = a->wave != 0, tiled = a->tiled != 0;
  const bool traced = a->traced != 0;
  // the traced wave reads its draws by stream position
  if (carve(0, a->n, a->e, a->s, ext, wave, traced,
            ordered(a->sampler)).bytes > share ||
      share % 16 || (wave && traced && ordered(a->sampler)))
    return (int)cudaErrorInvalidValue;
  // the window planes: the int32 pair, or the uint16 pair
  if ((a->rec_start16 == nullptr) != (a->rec_end16 == nullptr) ||
      (a->rec_start16 != nullptr) == (a->rec_start != nullptr) ||
      (a->rec_start == nullptr) != (a->rec_end == nullptr))
    return (int)cudaErrorInvalidValue;
  // the ring: K slots a lane, and its count and arm flag
  if (traced && (a->tr_k < 1 || a->tr_meta == nullptr ||
                 a->tr_data == nullptr || a->tr_tick == nullptr ||
                 a->tr_count == nullptr || a->tr_on == nullptr))
    return (int)cudaErrorInvalidValue;
  // the resident share must fit a block; the tiled layout, the workspace
  if (tiled ? (a->workspace == nullptr ||
               a->workspace_bytes < (long long)a->b * share)
            : share > 232448)
    return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const Args);
  // untraced: one body for the cascade and the wave (kWave = false)
  static const Kernel untraced[8] = {
      fused_ticks_kernel<false, false, kWin32>,
      fused_ticks_kernel<true, false, kWin32>,
      fused_ticks_kernel<false, true, kWin32>,
      fused_ticks_kernel<true, true, kWin32>,
      fused_ticks_kernel<false, false, kWin16>,
      fused_ticks_kernel<true, false, kWin16>,
      fused_ticks_kernel<false, true, kWin16>,
      fused_ticks_kernel<true, true, kWin16>};
  static const Kernel traced_arms[8] = {
      fused_ticks_traced<false, false, false>,
      fused_ticks_traced<true, false, false>,
      fused_ticks_traced<false, true, false>,
      fused_ticks_traced<true, true, false>,
      fused_ticks_traced<false, false, true>,
      fused_ticks_traced<true, false, true>,
      fused_ticks_traced<false, true, true>,
      fused_ticks_traced<true, true, true>};
  static const Kernel threefry_arms[8] = {
      fused_ticks_threefry<false, false, false>,
      fused_ticks_threefry<true, false, false>,
      fused_ticks_threefry<false, true, false>,
      fused_ticks_threefry<true, true, false>,
      fused_ticks_threefry<false, false, true>,
      fused_ticks_threefry<true, false, true>,
      fused_ticks_threefry<false, true, true>,
      fused_ticks_threefry<true, true, true>};
  const Kernel kernel =
      a->sampler == kThreefry
          ? threefry_arms[(ext ? 1 : 0) + (tiled ? 2 : 0) + (traced ? 4 : 0)]
      : traced
          ? traced_arms[(ext ? 1 : 0) + (wave ? 2 : 0) + (tiled ? 4 : 0)]
          : untraced[(ext ? 1 : 0) + (tiled ? 2 : 0) +
                     (a->rec_start16 != nullptr ? 4 : 0)];
  const size_t smem = tiled ? 0 : (size_t)share;
  // resident: raised for every share (the default limit counts static
  // bytes too); tiled: no shared memory, so the SM's L1 takes the most
  // room for the workspace's lines
  const cudaError_t st =
      tiled ? cudaFuncSetAttribute(
                  kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                  (int)cudaSharedmemCarveoutMaxL1)
            : cudaFuncSetAttribute(
                  kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                  (int)smem);
  if (st != cudaSuccess) return (int)st;
  if (a->b > 0 && a->length > 0)
    kernel<<<(unsigned int)a->b, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}

int clsim_fault_planes(const int64_t* key, const int32_t* time,
                       int32_t* edge, int32_t* node, int b, int k, int e,
                       int n, int crash_kind, int crash_len, int crash_period,
                       int crash_start, int dup_mod,
                       const ClsimFaultRates* rates, void* stream) {
  if (crash_period < 1 || dup_mod < 1) return (int)cudaErrorInvalidValue;
  const Fault f{0u, *rates, crash_kind, crash_len, crash_period, crash_start};
  if ((long long)b * k > 0)
    fault_planes_kernel<<<(unsigned int)((long long)b * k), kThreads, 0,
                          (cudaStream_t)stream>>>(key, time, edge, node, k, e,
                                                  n, f, dup_mod);
  return (int)cudaGetLastError();
}

}  // extern "C"
