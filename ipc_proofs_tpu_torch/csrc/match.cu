// Event-match kernels for Hopper (sm_90a): the batch match pipeline, the two
// flat event masks and the per-receipt any-reduce.
//
// Replaces four TPU device functions of ipc_proofs_tpu, each a jit that XLA
// fuses into device code outside any Pallas kernel:
//   parallel/pipeline.py:105 match_pipeline (its sharded jit :141)
//   ops/match_jax.py:36      _match_mask_topics
//   ops/match_jax.py:76-81   _match_mask_fp (its sharded jit :85-101)
//   ops/match_jax.py:137     receipts_with_match
//
// What bounds them on an H100: bytes, and at the paths' small calls the
// launch. Each is one compare or one scatter an event, a few integer
// operations against 10-74 bytes read, far under the ~5 operations a byte at
// which the ALU pipe and HBM take equal time. match_pipeline reads 64 B of
// topic words, 4 + 4 B of n_topics and emitter and 1 B of valid an event
// and writes 1 B of mask; the fingerprint mask reads 8 + 1 B and writes 1 B.
// HBM3 moves 64-byte bursts: reading topic0's 32-byte sector of a row costs
// about what reading the whole row does (PERF.md section 6). At
// chip_smoke.py phase 3a's 262,144 events (0.24 % matching) match_pipeline's
// inputs need 8.8 MB counted in 32-byte sectors (2.63 us at 3.35 TB/s) and
// 17.2 MB in 64-byte bursts (5.14 us).
//
// What the design does about it: every input byte is read once and every
// output byte written once, in one pass; a thread owns one event.
// - The full-word mask reads its event's 64-byte row as four 16-byte
//   loads, then n_topics and valid, and compares once: one trip to memory
//   an event. Reading topic1, n_topics and valid only under a matching
//   topic0 saves no HBM bytes (the card moves the whole row) and adds a
//   second, dependent trip wherever a call holds a match: up to 1.6x
//   slower at a high topic0 share, and slower at the paths' small calls.
//   Streaming loads (__ldcs) were ~10 % faster over back-to-back calls on
//   cold rows, level right after a host copy (the paths' case) and up to
//   1.5x slower on rows already in the L2 (PERF.md section 6).
// - match_pipeline reads the event's 64-byte row as four 16-byte loads, so
//   a warp's loads cover 2 KB of contiguous rows; the fingerprint mask reads
//   its 8 + 1 bytes in one trip. Designs that read valid only under a
//   matching fingerprint, or several fingerprints a thread, were slower on
//   the H100 (PERF.md section 6).
// The spec words and the actor id are read from device memory (never from
// the host, so a launch neither syncs nor breaks a CUDA-graph capture) into
// shared memory once a block. The per-receipt any of match_pipeline stays
// on chip: a block owns whole receipts (256 / E of them, or one receipt at
// E > 256, its events walked in strides of the block), ORs its events' bits
// into a shared flag per receipt and writes each receipt's hit once, for
// any E. The proof count is a warp reduction, then one integer atomicAdd a
// block into a zeroed int32, so it is exact. Bool outputs hold only the
// bytes 0 and 1.
//
// match_pipeline on a mesh: a launch is one block of a sharded world and
// writes straight into the whole mesh's outputs (its receipts' hits at
// ``receipt0``, its mask rows at event column ``col0`` of rows ``mask_e``
// bytes apart, its count), so a mesh on one card needs no concatenation,
// stack, sum or OR kernel after its blocks. A row's first block stores its
// hits and later blocks of the row (sp > 1) write only their hits
// (kOrHits); the mesh's first block zeroes the count by one
// cudaMemsetAsync and every block adds to it (kAddCount: no memset).
// Measured and not kept on the H100 (PERF.md section 6,
// csrc/match_study.cu): the count in the same launch (the last block to
// arrive stores it): no memset, faster by CUDA events at every shape and on
// the device at 65,536 and 64 events, but ~1 us slower on the device at
// 262,144 events, where the grid (54 registers a thread, four blocks an
// SM) runs in two waves and every block waits for its ticket's round trip;
// a persistent grid, the same grid fed by a TMA (cp.async.bulk) ring, and
// two events a thread, each slower than this kernel somewhere.
//
// C entry points (the caller passes u32 data as int32 bit views):
//   match_pipeline(topics[R,E,2,8], n_topics[R,E], emitters[R,E], valid[R,E],
//                  spec0[8], spec1[8], actor[], R, E, receipt0, col0, mask_e,
//                  flags)
//       -> hits[receipt0 + R], mask[(receipt0 + R) * mask_e], count[]
//          (R = tipsets x receipts of the launch's block)
//   event_match_mask(topics[N,2,8], n_topics[N], valid[N], spec0[8], spec1[8], N)
//       -> mask[N]
//   event_match_mask_fp(fp[N], valid[N], N, target) -> mask[N]
//   receipts_with_match(mask[N], ids[N], N, num, id_bytes) -> hits[num]
// Each launches on the given stream (match_pipeline without kAddCount and
// receipts_with_match zero their count or output with one cudaMemsetAsync
// there first), does not synchronise, and returns cudaGetLastError();
// arguments no launch takes return cudaErrorInvalidValue.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Loads the 16 spec words (topic0's 8, then topic1's) into shared memory.
__device__ __forceinline__ void load_spec(uint32_t spec[16], const int32_t* __restrict__ spec0,
                                          const int32_t* __restrict__ spec1) {
  const int t = threadIdx.x;
  if (t < 8) spec[t] = uint32_t(spec0[t]);
  else if (t < 16) spec[t] = uint32_t(spec1[t - 8]);
}

// True when the event's two topics equal the spec, it is valid and has at
// least two topics. All 73 bytes are read whatever the outcome.
__device__ __forceinline__ bool topics_match(const uint4* __restrict__ topics,
                                             const int32_t* __restrict__ n_topics,
                                             const uint8_t* __restrict__ valid,
                                             const uint32_t spec[16], int64_t ev) {
  const uint4* row = topics + ev * 4;
  const uint4 a = row[0], b = row[1], c = row[2], d = row[3];
  const uint32_t diff = (a.x ^ spec[0]) | (a.y ^ spec[1]) | (a.z ^ spec[2]) | (a.w ^ spec[3]) |
                        (b.x ^ spec[4]) | (b.y ^ spec[5]) | (b.z ^ spec[6]) | (b.w ^ spec[7]) |
                        (c.x ^ spec[8]) | (c.y ^ spec[9]) | (c.z ^ spec[10]) | (c.w ^ spec[11]) |
                        (d.x ^ spec[12]) | (d.y ^ spec[13]) | (d.z ^ spec[14]) | (d.w ^ spec[15]);
  return (diff == 0) & (valid[ev] != 0) & (n_topics[ev] >= 2);
}

// What a match_pipeline launch reads (one block of a mesh, or the whole
// world on one device).
struct MatchIn {
  const uint4* topics;
  const int32_t* n_topics;
  const int32_t* emitters;
  const uint8_t* valid;
  const int32_t* spec0;
  const int32_t* spec1;
  const int32_t* actor;
};

// match_pipeline's flags: OR the launch's hits into the output's (a block
// of a mesh row after its first) instead of storing them; add the launch's
// count to the output's (every block after a mesh's first) instead of
// storing it.
constexpr int kOrHits = 1;
constexpr int kAddCount = 2;

// Where a match_pipeline launch writes: its receipts' hits, its events' mask
// bytes and its share of the count, inside the whole mesh's outputs.
struct MatchOut {
  uint8_t* hits;        // the launch's first receipt's hit
  uint8_t* mask;        // the launch's first receipt's first event in the whole mask
  int64_t mask_stride;  // bytes from one receipt's mask row to the next (the whole mask's E)
  int32_t* count;
  int flags;
};

// True when the event's two topics equal the spec, it is valid, has at
// least two topics and its emitter passes the actor filter. All 77 bytes
// are read whatever the outcome: one trip to memory.
__device__ __forceinline__ bool event_matches(const MatchIn& in, const uint32_t spec[16],
                                              int32_t actor, int64_t ev) {
  return topics_match(in.topics, in.n_topics, in.valid, spec, ev) &
         ((actor < 0) | (in.emitters[ev] == actor));
}

__device__ __forceinline__ void store_hit(const MatchOut& out, int64_t r, bool hit) {
  if (!(out.flags & kOrHits)) out.hits[r] = uint8_t(hit);
  else if (hit) out.hits[r] = 1;
}

// A block's count, added to the output by an atomicAdd that nothing waits
// for: the entry zeroed the count first (a mesh's first block), or it holds
// the earlier blocks' sum.
struct AddCount {
  __device__ __forceinline__ void operator()(const MatchOut& out, uint32_t total) const {
    if (total) atomicAdd(reinterpret_cast<unsigned int*>(out.count), total);
  }
};

// The end of a block's work: its receipts' hits from the shared flags
// (flag[i] for receipt r0 + i, n_receipts of them), and its count (each
// thread's ``found``) by ``count``.
template <class Count>
__device__ __forceinline__ void finish_block(const MatchOut& out, const int* flag, uint32_t found,
                                             int64_t r0, int64_t n_receipts, uint32_t* warp_sum,
                                             const Count& count) {
  const int t = threadIdx.x;
  found = __reduce_add_sync(0xffffffffu, found);
  if ((t & 31) == 0) warp_sum[t >> 5] = found;
  __syncthreads();
  if (t < n_receipts) store_hit(out, r0 + t, flag[t] != 0);
  if (t == 0) {
    uint32_t total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += warp_sum[w];
    count(out, total);
  }
}

// A block owns receipts [r0, r0 + per_block); per_block <= kThreads. A
// thread owns one event (E <= 256) or walks its receipt's events in strides
// of the block (E > 256, one receipt a block).
template <class Count = AddCount>
__device__ __forceinline__ void match_block(const MatchIn& in, int64_t receipts, int e, int per_block,
                                            const MatchOut& out, const Count& count = Count()) {
  __shared__ uint32_t spec[16];
  __shared__ int flag[kThreads];
  __shared__ uint32_t warp_sum[kWarps];
  const int t = threadIdx.x;
  load_spec(spec, in.spec0, in.spec1);
  flag[t] = 0;
  __syncthreads();
  const int32_t actor = *in.actor;
  const int64_t r0 = int64_t(blockIdx.x) * per_block;
  const int64_t r_end = r0 + per_block < receipts ? r0 + per_block : receipts;
  const int64_t ev0 = r0 * e;
  const int64_t ev_end = r_end * e;
  uint32_t found = 0;
  for (int64_t ev = ev0 + t; ev < ev_end; ev += kThreads) {
    const bool m = event_matches(in, spec, actor, ev);
    const uint32_t local = uint32_t(ev - ev0);
    const uint32_t rl = local / uint32_t(e);
    out.mask[(r0 + rl) * out.mask_stride + (local - rl * uint32_t(e))] = uint8_t(m);
    if (m) {
      flag[rl] = 1;
      ++found;
    }
  }
  finish_block(out, flag, found, r0, r_end - r0, warp_sum, count);
}

__global__ void __launch_bounds__(kThreads)
match_pipeline_kernel(const MatchIn in, int64_t receipts, int e, int per_block, const MatchOut out) {
  match_block(in, receipts, e, per_block, out);
}

__global__ void __launch_bounds__(kThreads)
topic_mask_kernel(const uint4* __restrict__ topics, const int32_t* __restrict__ n_topics,
                  const uint8_t* __restrict__ valid, const int32_t* __restrict__ spec0,
                  const int32_t* __restrict__ spec1, int64_t n, uint8_t* __restrict__ mask) {
  __shared__ uint32_t spec[16];
  load_spec(spec, spec0, spec1);
  __syncthreads();
  const int64_t ev = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (ev < n) mask[ev] = uint8_t(topics_match(topics, n_topics, valid, spec, ev));
}

__global__ void __launch_bounds__(kThreads)
fp_mask_kernel(const int64_t* __restrict__ fp, const uint8_t* __restrict__ valid, int64_t n,
               int64_t target, uint8_t* __restrict__ mask) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n) mask[i] = uint8_t((valid[i] != 0) & (fp[i] == target));
}

// The reference's `.at[ids].add`: an id in [-num, 0) wraps to id + num, any
// other id outside [0, num) is dropped. Every write stores 1, so racing
// writes to one receipt agree. Designs that zero hits in the same launch
// (a cooperative grid with a grid-wide barrier, one cluster with its
// hardware barrier, a last-arriving block that writes every kept id) were
// all slower on the H100 than this kernel after its memset (PERF.md
// section 6).
template <class Id>
__global__ void __launch_bounds__(kThreads)
receipts_kernel(const uint8_t* __restrict__ mask, const Id* __restrict__ ids, int64_t n,
                int64_t num, uint8_t* __restrict__ hits) {
  const int64_t i = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n || !mask[i]) return;
  int64_t id = int64_t(ids[i]);
  if (id < 0) id += num;
  if (id >= 0 && id < num) hits[id] = 1;
}

unsigned blocks_for(int64_t n) { return unsigned((n + kThreads - 1) / kThreads); }

// The receipts a block of match_pipeline_kernel owns at E events a receipt.
int receipts_per_block(int e) { return e > 0 && e < kThreads ? kThreads / e : (e == 0 ? kThreads : 1); }

// Checks match_pipeline's arguments and fills in where its launch writes:
// false (nothing launched) for arguments no launch takes.
bool match_out(long long receipts, int e, long long receipt0, long long col0, long long mask_e,
               int flags, void* hits, void* mask, void* count, MatchOut* out) {
  if (receipts < 0 || e < 0 || receipt0 < 0 || col0 < 0 || col0 + e > mask_e ||
      (flags & ~(kOrHits | kAddCount)))
    return false;
  *out = MatchOut{static_cast<uint8_t*>(hits) + receipt0,
                  static_cast<uint8_t*>(mask) + receipt0 * mask_e + col0, int64_t(mask_e),
                  static_cast<int32_t*>(count), flags};
  return true;
}

MatchIn match_in(const void* topics, const void* n_topics, const void* emitters, const void* valid,
                 const void* spec0, const void* spec1, const void* actor_id) {
  return MatchIn{static_cast<const uint4*>(topics),    static_cast<const int32_t*>(n_topics),
                 static_cast<const int32_t*>(emitters), static_cast<const uint8_t*>(valid),
                 static_cast<const int32_t*>(spec0),    static_cast<const int32_t*>(spec1),
                 static_cast<const int32_t*>(actor_id)};
}

}  // namespace

extern "C" int match_pipeline(const void* topics, const void* n_topics, const void* emitters,
                              const void* valid, const void* spec0, const void* spec1,
                              const void* actor_id, long long receipts, int e, long long receipt0,
                              long long col0, long long mask_e, int flags, void* hits, void* mask,
                              void* count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  MatchOut out;
  if (!match_out(receipts, e, receipt0, col0, mask_e, flags, hits, mask, count, &out))
    return int(cudaErrorInvalidValue);
  if (!(flags & kAddCount)) {  // a mesh's first block: the count starts at 0
    const cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
    if (rc != cudaSuccess || receipts == 0) return int(rc);
  }
  if (receipts == 0) return 0;
  const int per_block = receipts_per_block(e);
  const long long grid = (receipts + per_block - 1) / per_block;
  match_pipeline_kernel<<<unsigned(grid), kThreads, 0, s>>>(
      match_in(topics, n_topics, emitters, valid, spec0, spec1, actor_id), receipts, e, per_block,
      out);
  return int(cudaGetLastError());
}

extern "C" int event_match_mask(const void* topics, const void* n_topics, const void* valid,
                                const void* spec0, const void* spec1, long long n, void* mask,
                                void* stream) {
  if (n <= 0) return 0;
  topic_mask_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(topics), static_cast<const int32_t*>(n_topics),
      static_cast<const uint8_t*>(valid), static_cast<const int32_t*>(spec0),
      static_cast<const int32_t*>(spec1), n, static_cast<uint8_t*>(mask));
  return int(cudaGetLastError());
}

extern "C" int event_match_mask_fp(const void* fp, const void* valid, long long n,
                                   long long target, void* mask, void* stream) {
  if (n <= 0) return 0;
  fp_mask_kernel<<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(fp), static_cast<const uint8_t*>(valid), n, target,
      static_cast<uint8_t*>(mask));
  return int(cudaGetLastError());
}

extern "C" int receipts_with_match(const void* mask, const void* ids, long long n, long long num,
                                   int id_bytes, void* hits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (num <= 0) return 0;
  cudaError_t rc = cudaMemsetAsync(hits, 0, size_t(num), s);
  if (rc != cudaSuccess) return int(rc);
  if (n <= 0) return int(cudaGetLastError());
  if (id_bytes == 8) {
    receipts_kernel<int64_t><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(ids), n, num,
        static_cast<uint8_t*>(hits));
  } else if (id_bytes == 4) {
    receipts_kernel<int32_t><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const uint8_t*>(mask), static_cast<const int32_t*>(ids), n, num,
        static_cast<uint8_t*>(hits));
  } else {
    return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
