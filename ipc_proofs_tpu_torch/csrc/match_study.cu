// Measurement-only kernels for chip_smoke.py's device match phase. The
// package never builds or loads this file (it is not in
// ops.build.KERNEL_LIBRARIES): chip_smoke.py builds it beside the package's
// libraries and times the full-word mask against what is here.
//
// It compiles match.cu into its own library and adds:
//   event_match_mask_streaming(topics, n_topics, valid, spec0, spec1, N) -> mask[N]
//       the full-word mask with the row's four words read as streaming
//       loads (__ldcs: evict first), a design measured and not kept;
//   store_floor(N) -> mask[N]
//       the launch floor: a kernel that only stores one zero mask byte a
//       thread (no load), at a flat mask's grid;
//   match_pipeline_memset, _ticket, _persistent, _tma, _pair:
//       match_pipeline's arguments (match.cu), other designs of it, measured
//       against the package's (PERF.md section 6) and not kept:
//       - memset: the kernel as PR 16 wrote it, before it wrote into a
//         mesh's outputs (whole outputs only: no offsets or flags);
//       - ticket: the package's block with the count in the same launch:
//         the block that arrives last (a 64-bit ticket, one for the
//         study's one stream) stores the count, so no cudaMemsetAsync
//         goes before the kernel;
//       - persistent: as many blocks as fit on the card at once
//         (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), each
//         walking as many tiles of whole receipts (match_pipeline_kernel's
//         block) with the next tile's event loaded into registers before
//         the current tile's compare: two events a thread in flight;
//       - tma: the same grid with each tile's contiguous topic rows (at
//         most 256 events x 64 B) brought into a two-stage shared-memory
//         ring by a 1-D bulk copy (cp.async.bulk) from one thread, an
//         mbarrier a stage; n_topics, emitters and valid by plain loads;
//       - pair: two events a thread, both loaded before either compare.
//       All but ticket zero the count first and add to it, as the
//       package's does;
//   match_kernel_info(which) -> registers, shared bytes, blocks an SM, SMs.
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include "match.cu"

namespace {

__global__ void __launch_bounds__(kThreads)
topic_mask_streaming_kernel(const uint4* __restrict__ topics, const int32_t* __restrict__ n_topics,
                            const uint8_t* __restrict__ valid, const int32_t* __restrict__ spec0,
                            const int32_t* __restrict__ spec1, int64_t n, uint8_t* __restrict__ mask) {
  __shared__ uint32_t spec[16];
  load_spec(spec, spec0, spec1);
  __syncthreads();
  const int64_t ev = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (ev >= n) return;
  const uint4* row = topics + ev * 4;
  const uint4 w[4] = {__ldcs(row), __ldcs(row + 1), __ldcs(row + 2), __ldcs(row + 3)};
  uint32_t diff = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    diff |= (w[j].x ^ spec[4 * j]) | (w[j].y ^ spec[4 * j + 1]) | (w[j].z ^ spec[4 * j + 2]) |
            (w[j].w ^ spec[4 * j + 3]);
  mask[ev] = uint8_t((diff == 0) & (valid[ev] != 0) & (n_topics[ev] >= 2));
}

__global__ void __launch_bounds__(kThreads) store_floor_kernel(int64_t n, uint8_t* __restrict__ mask) {
  const int64_t ev = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (ev < n) mask[ev] = 0;
}

// match_pipeline_kernel as PR 16 wrote it: contiguous outputs, the count
// summed by an atomicAdd a block into an int32 zeroed before.
__global__ void __launch_bounds__(kThreads)
match_memset_kernel(const MatchIn in, int64_t receipts, int e, int per_block,
                    uint8_t* __restrict__ hits, uint8_t* __restrict__ mask,
                    int32_t* __restrict__ count) {
  __shared__ uint32_t spec[16];
  __shared__ int flag[kThreads];
  __shared__ int warp_sum[kWarps];
  const int t = threadIdx.x;
  load_spec(spec, in.spec0, in.spec1);
  flag[t] = 0;
  __syncthreads();
  const int32_t actor = *in.actor;
  const int64_t r0 = int64_t(blockIdx.x) * per_block;
  const int64_t r_end = r0 + per_block < receipts ? r0 + per_block : receipts;
  const int64_t ev0 = r0 * e;
  const int64_t ev_end = r_end * e;
  int found = 0;
  for (int64_t ev = ev0 + t; ev < ev_end; ev += kThreads) {
    const bool m = event_matches(in, spec, actor, ev);
    mask[ev] = uint8_t(m);
    if (m) {
      flag[(ev - ev0) / e] = 1;
      ++found;
    }
  }
  found = __reduce_add_sync(0xffffffffu, found);
  if ((t & 31) == 0) warp_sum[t >> 5] = found;
  __syncthreads();
  if (t < per_block && r0 + t < receipts) hits[r0 + t] = uint8_t(flag[t] != 0);
  if (t == 0) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    if (total) atomicAdd(count, total);
  }
}

// The count with no zeroed output and no second launch: every block adds
// (1 << 32) | its count to a 64-bit ticket that is zero before the launch
// (the low half sums the counts, the high half counts the blocks arrived);
// the block that arrives last reads the total in the value its add returns,
// stores (or adds) the count and zeroes the ticket. Every block waits for
// its add's return before it ends. One ticket for the study's one stream.
__device__ unsigned long long g_ticket;

struct TicketCount {
  __device__ __forceinline__ void operator()(const MatchOut& out, uint32_t total) const {
    const unsigned long long old = atomicAdd(&g_ticket, (1ull << 32) | total);
    if (uint32_t(old >> 32) != gridDim.x - 1) return;
    uint32_t sum = uint32_t(old) + total;
    if (out.flags & kAddCount) sum += uint32_t(*out.count);
    *out.count = int32_t(sum);
    atomicExch(&g_ticket, 0ull);
  }
};

__global__ void __launch_bounds__(kThreads)
match_ticket_kernel(const MatchIn in, int64_t receipts, int e, int per_block, const MatchOut out) {
  match_block(in, receipts, e, per_block, out, TicketCount());
}

// One event's inputs, held in registers from their loads to its compare.
struct EventRegs {
  uint4 a, b, c, d;
  int32_t n_topics, emitter;
  uint8_t valid;
};

__device__ __forceinline__ EventRegs load_event(const MatchIn& in, int64_t ev) {
  const uint4* row = in.topics + ev * 4;
  return EventRegs{row[0], row[1], row[2], row[3], in.n_topics[ev], in.emitters[ev], in.valid[ev]};
}

__device__ __forceinline__ uint32_t quarter_diff(const uint4 w, const uint32_t* spec) {
  return (w.x ^ spec[0]) | (w.y ^ spec[1]) | (w.z ^ spec[2]) | (w.w ^ spec[3]);
}

__device__ __forceinline__ bool rest_match(uint32_t diff, int32_t n_topics, int32_t emitter,
                                           uint8_t valid, int32_t actor) {
  return (diff == 0) & (valid != 0) & (n_topics >= 2) & ((actor < 0) | (emitter == actor));
}

__device__ __forceinline__ bool regs_match(const EventRegs& x, const uint32_t spec[16], int32_t actor) {
  const uint32_t diff = quarter_diff(x.a, spec) | quarter_diff(x.b, spec + 4) |
                        quarter_diff(x.c, spec + 8) | quarter_diff(x.d, spec + 12);
  return rest_match(diff, x.n_topics, x.emitter, x.valid, actor);
}

// The receipts a block of match_pair_kernel owns: two events a thread.
int pair_receipts_per_block(int e) {
  return e > 0 && e < 2 * kThreads ? 2 * kThreads / e : (e == 0 ? 2 * kThreads : 1);
}

// match_pipeline_kernel's block with two events a thread: a block owns
// 512 / E receipts (one at E > 512), and a thread loads both its events
// (t and t + 256) before it compares either, so at 262,144 events the grid
// is 512 blocks, one wave at four blocks an SM; past the first 512 events
// of a receipt (E > 512) the rest are walked one at a time.
__global__ void __launch_bounds__(kThreads, 4)
match_pair_kernel(const MatchIn in, int64_t receipts, int e, int per_block, const MatchOut out) {
  __shared__ uint32_t spec[16];
  __shared__ int flag[2 * kThreads];
  __shared__ uint32_t warp_sum[kWarps];
  const int t = threadIdx.x;
  load_spec(spec, in.spec0, in.spec1);
  flag[t] = 0;
  flag[t + kThreads] = 0;
  __syncthreads();
  const int32_t actor = *in.actor;
  const int64_t r0 = int64_t(blockIdx.x) * per_block;
  const int64_t r_end = r0 + per_block < receipts ? r0 + per_block : receipts;
  const int64_t ev0 = r0 * e;
  const int64_t ev_end = r_end * e;
  const bool have_a = ev0 + t < ev_end, have_b = ev0 + t + kThreads < ev_end;
  EventRegs a, b;
  if (have_a) a = load_event(in, ev0 + t);
  if (have_b) b = load_event(in, ev0 + t + kThreads);
  uint32_t found = 0;
  if (have_a) {
    const uint32_t local = uint32_t(t), rl = local / uint32_t(e);
    const bool m = regs_match(a, spec, actor);
    out.mask[(r0 + rl) * out.mask_stride + (local - rl * uint32_t(e))] = uint8_t(m);
    if (m) {
      flag[rl] = 1;
      ++found;
    }
  }
  if (have_b) {
    const uint32_t local = uint32_t(t + kThreads), rl = local / uint32_t(e);
    const bool m = regs_match(b, spec, actor);
    out.mask[(r0 + rl) * out.mask_stride + (local - rl * uint32_t(e))] = uint8_t(m);
    if (m) {
      flag[rl] = 1;
      ++found;
    }
  }
  if (e > 2 * kThreads) {
#pragma unroll 1
    for (int64_t ev = ev0 + t + 2 * kThreads; ev < ev_end; ev += kThreads) {
      const bool m = event_matches(in, spec, actor, ev);
      out.mask[r0 * out.mask_stride + (ev - ev0)] = uint8_t(m);
      if (m) {
        flag[0] = 1;
        ++found;
      }
    }
  }
  found = __reduce_add_sync(0xffffffffu, found);
  if ((t & 31) == 0) warp_sum[t >> 5] = found;
  __syncthreads();
  const int64_t n_r = r_end - r0;
  if (t < n_r) store_hit(out, r0 + t, flag[t] != 0);
  if (t + kThreads < n_r) store_hit(out, r0 + t + kThreads, flag[t + kThreads] != 0);
  if (t == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    AddCount()(out, total);
  }
}

// The tiles of a persistent grid: a tile is match_pipeline_kernel's block
// (per_block whole receipts, tile_events = per_block * E events; at E > 256
// one receipt, its events past the first 256 walked in strides).
struct Tiles {
  int64_t receipts, n_events, count, tile_events;
  int e, per_block;
};

__device__ __forceinline__ Tiles tiles_of(int64_t receipts, int e, int per_block) {
  const int64_t tile_events = int64_t(per_block) * e;
  return Tiles{receipts, receipts * e, (receipts + per_block - 1) / per_block, tile_events, e,
               per_block};
}

// A tile's events past each thread's first (E > 256), read and compared
// one at a time.
__device__ __forceinline__ uint32_t tile_rest(const MatchIn& in, const uint32_t spec[16],
                                              int32_t actor, const Tiles& tl, int64_t tile,
                                              const MatchOut& out, int* flag) {
  uint32_t found = 0;
  const int64_t ev0 = tile * tl.tile_events;
  const int64_t end = ev0 + tl.tile_events < tl.n_events ? ev0 + tl.tile_events : tl.n_events;
  for (int64_t ev = ev0 + threadIdx.x + kThreads; ev < end; ev += kThreads) {
    const bool m = event_matches(in, spec, actor, ev);
    // one receipt a tile here: its row of the mask
    out.mask[tile * out.mask_stride + (ev - ev0)] = uint8_t(m);
    if (m) {
      flag[0] = 1;
      ++found;
    }
  }
  return found;
}

// The hits of a persistent block's tile from its flags, which it zeroes for
// the tile after next.
__device__ __forceinline__ void tile_hits(const MatchOut& out, const Tiles& tl, int64_t tile, int* flag) {
  const int t = threadIdx.x;
  const int64_t r0 = tile * tl.per_block;
  const int64_t n_r = r0 + tl.per_block < tl.receipts ? tl.per_block : tl.receipts - r0;
  if (t < n_r) {
    store_hit(out, r0 + t, flag[t] != 0);
    flag[t] = 0;
  }
}

__device__ __forceinline__ void persistent_end(const MatchOut& out, uint32_t found, uint32_t* warp_sum) {
  const int t = threadIdx.x;
  found = __reduce_add_sync(0xffffffffu, found);
  if ((t & 31) == 0) warp_sum[t >> 5] = found;
  __syncthreads();
  if (t == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    AddCount()(out, total);
  }
}

__global__ void __launch_bounds__(kThreads)
match_persistent_kernel(const MatchIn in, int64_t receipts, int e, int per_block, const MatchOut out) {
  __shared__ uint32_t spec[16];
  __shared__ int flag[2][kThreads];
  __shared__ uint32_t warp_sum[kWarps];
  const int t = threadIdx.x;
  load_spec(spec, in.spec0, in.spec1);
  flag[0][t] = 0;
  flag[1][t] = 0;
  __syncthreads();
  const int32_t actor = *in.actor;
  const Tiles tl = tiles_of(receipts, e, per_block);
  // a thread's event in every tile: receipt rl of the tile, event j of it
  const bool mine = t < tl.tile_events;
  const uint32_t rl = e > 0 ? uint32_t(t) / uint32_t(e) : 0;
  const int64_t at = int64_t(rl) * out.mask_stride + (t - int64_t(rl) * e);
  uint32_t found = 0;
  int64_t tile = blockIdx.x;
  int64_t ev = tile * tl.tile_events + t;
  bool have = mine && tile < tl.count && ev < tl.n_events;
  EventRegs cur;
  if (have) cur = load_event(in, ev);
#pragma unroll 1
  for (int buf = 0; tile < tl.count; tile += gridDim.x, buf ^= 1) {
    const int64_t next_ev = (tile + gridDim.x) * tl.tile_events + t;
    const bool have_next = mine && tile + gridDim.x < tl.count && next_ev < tl.n_events;
    EventRegs next;
    if (have_next) next = load_event(in, next_ev);
    if (have) {
      const bool m = regs_match(cur, spec, actor);
      out.mask[tile * tl.per_block * out.mask_stride + at] = uint8_t(m);
      if (m) {
        flag[buf][rl] = 1;
        ++found;
      }
    }
    if (tl.tile_events > kThreads) found += tile_rest(in, spec, actor, tl, tile, out, flag[buf]);
    __syncthreads();
    tile_hits(out, tl, tile, flag[buf]);
    cur = next;
    have = have_next;
  }
  persistent_end(out, found, warp_sum);
}

constexpr int kStages = 2;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return uint32_t(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// Copies ``bytes`` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; the stage's mbarrier completes when they land.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Thread 0 fills ``stage`` with the topic rows of the tile's first (at most
// kThreads) events.
__device__ __forceinline__ void load_tile(const MatchIn& in, const Tiles& tl, int64_t tile,
                                          uint4* stage, uint64_t* bar) {
  const int64_t ev0 = tile * tl.tile_events;
  int64_t rows = tl.tile_events < kThreads ? tl.tile_events : kThreads;
  if (ev0 + rows > tl.n_events) rows = tl.n_events - ev0;
  if (rows <= 0) {  // E = 0: no rows, the stage completes on the arrival alone
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
    return;
  }
  // the stage was read through the generic proxy; the copy writes through
  // the async one
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bulk_load(stage, in.topics + ev0 * 4, uint32_t(rows * 64), bar);
}

__global__ void __launch_bounds__(kThreads)
match_tma_kernel(const MatchIn in, int64_t receipts, int e, int per_block, const MatchOut out) {
  __shared__ __align__(128) uint4 ring[kStages][kThreads * 4];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ uint32_t spec[16];
  __shared__ int flag[2][kThreads];
  __shared__ uint32_t warp_sum[kWarps];
  const int t = threadIdx.x;
  const Tiles tl = tiles_of(receipts, e, per_block);
  load_spec(spec, in.spec0, in.spec1);
  flag[0][t] = 0;
  flag[1][t] = 0;
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      const int64_t tile = blockIdx.x + int64_t(s) * gridDim.x;
      if (tile < tl.count) load_tile(in, tl, tile, ring[s], &full[s]);
    }
  }
  const int32_t actor = *in.actor;
  const bool mine = t < tl.tile_events && t < kThreads;
  const uint32_t rl = e > 0 ? uint32_t(t) / uint32_t(e) : 0;
  const int64_t at = int64_t(rl) * out.mask_stride + (t - int64_t(rl) * e);
  // the order a thread reads its row's four 16-byte quarters in: eight
  // neighbouring threads' rows sit 64 B apart, so this rotation puts their
  // loads of one instruction in eight different 16-byte bank groups
  const int turn = (t >> 1) & 3;
  uint32_t found = 0;
  int i = 0;
#pragma unroll 1
  for (int64_t tile = blockIdx.x; tile < tl.count; tile += gridDim.x, ++i) {
    const int s = i & 1;
    const int64_t ev = tile * tl.tile_events + t;
    const bool have = mine && ev < tl.n_events;
    int32_t n_topics = 0, emitter = 0;
    uint8_t valid = 0;
    if (have) {
      n_topics = in.n_topics[ev];
      emitter = in.emitters[ev];
      valid = in.valid[ev];
    }
    while (!mbar_try_wait(&full[s], uint32_t(i >> 1) & 1)) {
    }
    if (have) {
      const uint4* row = ring[s] + t * 4;
      uint32_t diff = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = (q + turn) & 3;
        diff |= quarter_diff(row[k], spec + 4 * k);
      }
      const bool m = rest_match(diff, n_topics, emitter, valid, actor);
      out.mask[tile * tl.per_block * out.mask_stride + at] = uint8_t(m);
      if (m) {
        flag[s][rl] = 1;
        ++found;
      }
    }
    if (tl.tile_events > kThreads) found += tile_rest(in, spec, actor, tl, tile, out, flag[s]);
    __syncthreads();  // every thread is done with stage s: refill it
    if (t == 0 && tile + 2 * int64_t(gridDim.x) < tl.count)
      load_tile(in, tl, tile + 2 * int64_t(gridDim.x), ring[s], &full[s]);
    tile_hits(out, tl, tile, flag[s]);
  }
  persistent_end(out, found, warp_sum);
}

// Blocks of ``kernel`` resident on the current device at once (its SMs x
// the blocks an SM holds), cached per device.
int resident_blocks(const void* kernel, int* cache) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device >= 64) return 0;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess)
      return 0;
    cache[device] = sms * per_sm;
  }
  return cache[device];
}

int persistent_cache[64];
int tma_cache[64];

// match_pipeline's entry (match.cu) over ``kernel`` with ``per_block``
// receipts a block (a tile): the count zeroed first where ``zero_count``
// and the launch stores it; ``resident`` > 0: a persistent grid of at most
// that many blocks, each walking as many tiles.
template <class Kernel>
int launch_match(Kernel kernel, int per_block, const void* topics, const void* n_topics,
                 const void* emitters, const void* valid, const void* spec0, const void* spec1,
                 const void* actor_id, long long receipts, int e, long long receipt0,
                 long long col0, long long mask_e, int flags, void* hits, void* mask, void* count,
                 void* stream, bool zero_count = true, long long resident = 0) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MatchOut out;
  if (!match_out(receipts, e, receipt0, col0, mask_e, flags, hits, mask, count, &out))
    return int(cudaErrorInvalidValue);
  if ((zero_count || receipts == 0) && !(flags & kAddCount)) {
    const cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    if (rc != cudaSuccess) return int(rc);
  }
  if (receipts == 0) return 0;
  long long grid = (receipts + per_block - 1) / per_block;
  if (resident > 0) {
    const long long rounds = (grid + resident - 1) / resident;
    grid = (grid + rounds - 1) / rounds;
  }
  kernel<<<unsigned(grid), kThreads, 0, s>>>(
      match_in(topics, n_topics, emitters, valid, spec0, spec1, actor_id), receipts, e, per_block,
      out);
  return int(cudaGetLastError());
}

// the study's kernels, in match_kernel_info's order
const void* study_kernel(int which) {
  switch (which) {
    case 0: return reinterpret_cast<const void*>(match_pipeline_kernel);
    case 1: return reinterpret_cast<const void*>(match_memset_kernel);
    case 2: return reinterpret_cast<const void*>(match_ticket_kernel);
    case 3: return reinterpret_cast<const void*>(match_persistent_kernel);
    case 4: return reinterpret_cast<const void*>(match_tma_kernel);
    case 5: return reinterpret_cast<const void*>(match_pair_kernel);
    default: return nullptr;
  }
}

}  // namespace

extern "C" int event_match_mask_streaming(const void* topics, const void* n_topics,
                                          const void* valid, const void* spec0, const void* spec1,
                                          long long n, void* mask, void* stream) {
  if (n <= 0) return 0;
  topic_mask_streaming_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(topics), static_cast<const int32_t*>(n_topics),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(spec0),
      static_cast<const int32_t*>(spec1), n, static_cast<uint8_t*>(mask));
  return int(cudaGetLastError());
}

extern "C" int store_floor(long long n, void* mask, void* stream) {
  if (n <= 0) return 0;
  store_floor_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n, static_cast<uint8_t*>(mask));
  return int(cudaGetLastError());
}

// The designs below take match_pipeline's arguments (match.cu).

extern "C" int match_pipeline_memset(const void* topics, const void* n_topics, const void* emitters,
                                     const void* valid, const void* spec0, const void* spec1,
                                     const void* actor_id, long long receipts, int e,
                                     long long receipt0, long long col0, long long mask_e,
                                     int flags, void* hits, void* mask, void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (receipts < 0 || e < 0 || receipt0 != 0 || col0 != 0 || mask_e != e || flags != 0)
    return int(cudaErrorInvalidValue);
  cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (rc != cudaSuccess || receipts == 0) return int(rc);
  const int per_block = receipts_per_block(e);
  const long long grid = (receipts + per_block - 1) / per_block;
  match_memset_kernel<<<unsigned(grid), kThreads, 0, s>>>(
      match_in(topics, n_topics, emitters, valid, spec0, spec1, actor_id), receipts, e, per_block,
      static_cast<uint8_t*>(hits), static_cast<uint8_t*>(mask), static_cast<int32_t*>(count));
  return int(cudaGetLastError());
}

extern "C" int match_pipeline_ticket(const void* topics, const void* n_topics, const void* emitters,
                                     const void* valid, const void* spec0, const void* spec1,
                                     const void* actor_id, long long receipts, int e,
                                     long long receipt0, long long col0, long long mask_e,
                                     int flags, void* hits, void* mask, void* count, void* stream) {
  return launch_match(match_ticket_kernel, receipts_per_block(e), topics, n_topics, emitters, valid,
                      spec0, spec1, actor_id, receipts, e, receipt0, col0, mask_e, flags, hits,
                      mask, count, stream, false);
}

extern "C" int match_pipeline_persistent(const void* topics, const void* n_topics,
                                         const void* emitters, const void* valid, const void* spec0,
                                         const void* spec1, const void* actor_id,
                                         long long receipts, int e, long long receipt0,
                                         long long col0, long long mask_e, int flags, void* hits,
                                         void* mask, void* count, void* stream) {
  const int resident = resident_blocks(study_kernel(3), persistent_cache);
  if (resident <= 0) return int(cudaErrorInvalidConfiguration);
  return launch_match(match_persistent_kernel, receipts_per_block(e), topics, n_topics, emitters,
                      valid, spec0, spec1, actor_id, receipts, e, receipt0, col0, mask_e, flags,
                      hits, mask, count, stream, true, resident);
}

extern "C" int match_pipeline_tma(const void* topics, const void* n_topics, const void* emitters,
                                  const void* valid, const void* spec0, const void* spec1,
                                  const void* actor_id, long long receipts, int e,
                                  long long receipt0, long long col0, long long mask_e, int flags,
                                  void* hits, void* mask, void* count, void* stream) {
  const int resident = resident_blocks(study_kernel(4), tma_cache);
  if (resident <= 0) return int(cudaErrorInvalidConfiguration);
  return launch_match(match_tma_kernel, receipts_per_block(e), topics, n_topics, emitters, valid,
                      spec0, spec1, actor_id, receipts, e, receipt0, col0, mask_e, flags, hits,
                      mask, count, stream, true, resident);
}

extern "C" int match_pipeline_pair(const void* topics, const void* n_topics, const void* emitters,
                                   const void* valid, const void* spec0, const void* spec1,
                                   const void* actor_id, long long receipts, int e,
                                   long long receipt0, long long col0, long long mask_e, int flags,
                                   void* hits, void* mask, void* count, void* stream) {
  return launch_match(match_pair_kernel, pair_receipts_per_block(e), topics, n_topics, emitters,
                      valid, spec0, spec1, actor_id, receipts, e, receipt0, col0, mask_e, flags,
                      hits, mask, count, stream);
}

// What the card makes of match_pipeline's kernels (``which``: 0 the
// package's, 1 PR 16's, 2 the ticket's, 3 the persistent one's, 4 the tma
// one's, 5 the pair one's): registers a thread, static shared bytes a
// block, blocks an SM holds at once (at 256 threads) and the card's SMs.
extern "C" int match_kernel_info(int which, int* regs, int* smem, int* per_sm, int* sms) {
  const void* kernel = study_kernel(which);
  if (kernel == nullptr) return int(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, kernel);
  int device = 0;
  if (rc == cudaSuccess) rc = cudaGetDevice(&device);
  if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (rc == cudaSuccess) rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, kThreads, 0);
  if (rc != cudaSuccess) return int(rc);
  *regs = attr.numRegs;
  *smem = int(attr.sharedSizeBytes);
  return 0;
}
