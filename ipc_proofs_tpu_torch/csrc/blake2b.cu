// blake2b-256 batch kernels for Hopper (sm_90a).
//
// Replaces three TPU device functions of ipc_proofs_tpu:
//   ops/pallas_kernels.py:337 blake2b256_single_block_pallas (_blake2b_kernel :251)
//   ops/pallas_kernels.py:363 blake2b256_two_block_pallas    (_blake2b2_kernel :205)
//   ops/blake2b_jax.py:140    blake2b256_blocks (XLA lax.scan over blocks)
//
// What bounds it on an H100: integer operations. One compression is
// 12 rounds x 8 G mixes of 64-bit adds, xors and rotations. The algorithm
// needs 1,360 operations a compression that only the ALU pipe runs (per G,
// 8 LOP3 for four 64-bit xors and 6 funnel shifts for the rotations by 24,
// 16 and 63, the rotation by 32 being a swap of halves; 16 LOP3 fold v into
// h), and 384 64-bit adds whose halves the FMA pipe can take as IMAD. It
// reads 128 bytes a block and writes 32 a digest: at 64 ALU results a clock
// on each SM that is ~15 operations a byte, against the ~5 a byte at which
// the ALU pipe and HBM take equal time. chip_smoke.py's bound counts the
// algorithm's operations (BLAKE2B_OPS) and the bytes needed; it prints the
// build's own SASS counts per pipe and instantiation beside them. This
// build issues, per compression (thread-instructions, a message's lanes
// summed): one lane 1,949 ALU and 193 FMA over PaddedBlocks, 1,953 and 194
// over SplitPlanes (784 LOP3, 576 SHF, 385 IADD3 + 196 IADD3.X, 189
// IMAD.X: ptxas puts the high half of most two-operand adds on the FMA
// pipe); four lanes 2,036 ALU, 200 FMA and 576 SHFL over PaddedBlocks,
// 2,048, 240 and 576 over SplitPlanes.
//
// That bound spreads a batch's work over the whole card. At the row counts
// the paths send (a witness batch is a few thousand rows), what bounds a
// launch is one warp's chain of compressions: a warp-wide integer
// instruction takes two issue slots of a sub-partition's 16-lane ALU pipe,
// so one lane a message runs ~3,900 clocks a compression (~2 us), and
// 2,048 rows are 64 warps for the card's 528 schedulers.
//
// What the design does about it:
// - Each message's 16 words, the working vector v and the state h live in
//   registers; the sigma schedule and the rotation amounts are literals, so
//   the unrolled rounds index registers, never local memory.
// - Few rows cannot fill the card with one thread a message, and each lane
//   then runs the chain of its row's compressions alone. Every kernel can
//   put a message over four lanes (a quad; the wrappers pick the lanes
//   from the row count, ops/blake2b.py quad_rows_max): lane q owns column
//   q of v, __shfl_sync moves a, c and d between the column and the
//   diagonal step, and the quad's block sits in shared memory, each lane
//   reading the sigma-indexed words at 40 shared addresses it computes
//   once. The chain a lane runs is then 24 G mixes a compression instead
//   of 96, on four times the warps; b stays in its lane across the
//   diagonal step, so the shuffles of a, c and d overlap the end of each
//   mix. Above a kernel's crossover the card is full with one lane a
//   message, and the four lanes' extra instructions (~1.35x issued) cost
//   more than the shorter chain gains. On the H100 (700 W) the crossover
//   is 4,224 rows for the single-block kernel (one 32-message block an
//   SM) and 8,448 for the two-block and multi-block kernels (two), where
//   a row's longer chain pays for a second warp a scheduler; the
//   measurements are beside each constant in ops/blake2b.py. At the event
//   path's witness rows four lanes took the single-block kernel from 4.06
//   to 3.07 us on the device (1,969 rows) and the two-block kernel from
//   6.64 to 4.23 us (1,312 rows), against a store-only floor of ~0.93 us
//   (PERF.md section 6). What is left is latency: each lane's 24
//   dependent G mixes and 72 64-bit shuffles a compression, one warp a
//   scheduler.
// - Tried and dropped (PERF.md section 6): adds written for the FMA pipe
//   (IMAD.WIDE.U32 + IMAD with a runtime multiplier 1, and PTX
//   mad.lo.cc / madc pairs). ptxas turned the freed ALU slots into VIADD
//   and IMAD.MOV; none issued fewer than ~1,750 ALU instructions a
//   compression and every one ran slower, 1.04-1.39x at 349,526 rows.
//   Loading the next block during the current compression gained ~1 %
//   with one lane a message; only the four-lane kernel does it. A row
//   order from the host (longest rows first, so a warp's lanes run equal
//   block counts) took 349,526 rows of 257-520 B 1.31x faster, but no path
//   sends that many multi-block rows in one call, and at the event path's
//   witness rows it did not help.
//
// Three C entry points keep the JAX package's layouts at the boundary
// (the caller passes u32 data as int32 bit views), so a test feeds both
// packages the same arrays:
//   blake2b256_single_block(m_lo[N,16], m_hi[N,16], lengths[N,1], lanes 1 or 4) -> out[N,8]
//   blake2b256_two_block   (m_lo[N,32], m_hi[N,32], lengths[N,1], lanes 1 or 4) -> out[N,8]
//   blake2b256_blocks      (blocks[N,B,32], n_blocks[N], lengths[N], lanes 1 or 4) -> out[N,8]
// Digest words are [lo0, hi0, lo1, hi1, ...], the little-endian u32 view of
// the 32-byte digest. Each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError() (cudaErrorInvalidValue, with
// no launch, for lanes other than 1 or 4).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kQuads = kThreads / 4;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64u - n));
}

// The G mix. The message word joins `a` before `b` does: `a` and the word
// are ready early, `b` is the value the step before produced.
__device__ __forceinline__ void mix(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d,
                                    uint64_t x, uint64_t y) {
  a = a + x + b;
  d = rotr64(d ^ a, 32);
  c = c + d;
  b = rotr64(b ^ c, 24);
  a = a + y + b;
  d = rotr64(d ^ a, 16);
  c = c + d;
  b = rotr64(b ^ c, 63);
}

// One round: four column mixes, then four diagonal mixes; s0..s15 is the
// round's sigma row, written out as literals so m[] stays in registers.
#define B2B_ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  mix(v[0], v[4], v[8], v[12], m[s0], m[s1]);                                          \
  mix(v[1], v[5], v[9], v[13], m[s2], m[s3]);                                          \
  mix(v[2], v[6], v[10], v[14], m[s4], m[s5]);                                         \
  mix(v[3], v[7], v[11], v[15], m[s6], m[s7]);                                         \
  mix(v[0], v[5], v[10], v[15], m[s8], m[s9]);                                         \
  mix(v[1], v[6], v[11], v[12], m[s10], m[s11]);                                       \
  mix(v[2], v[7], v[8], v[13], m[s12], m[s13]);                                        \
  mix(v[3], v[4], v[9], v[14], m[s14], m[s15]);

#define B2B_IV0 0x6A09E667F3BCC908ull
#define B2B_IV1 0xBB67AE8584CAA73Bull
#define B2B_IV2 0x3C6EF372FE94F82Bull
#define B2B_IV3 0xA54FF53A5F1D36F1ull
#define B2B_IV4 0x510E527FADE682D1ull
#define B2B_IV5 0x9B05688C2B3E6C1Full
#define B2B_IV6 0x1F83D9ABFB41BD6Bull
#define B2B_IV7 0x5BE0CD19137E2179ull
#define B2B_PARAM0 0x01010020ull  // digest_length=32, key=0, fanout=1, depth=1

__constant__ uint64_t kIV[8] = {B2B_IV0, B2B_IV1, B2B_IV2, B2B_IV3,
                                B2B_IV4, B2B_IV5, B2B_IV6, B2B_IV7};

// The sigma rows, for the four-lane kernel: kSigma[r][i] is the message word
// that round r's mixes take in position i.
__constant__ uint8_t kSigma[10][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
};

__device__ __forceinline__ void compress(uint64_t h[8], const uint64_t m[16], uint64_t t,
                                         bool last) {
  uint64_t v[16] = {h[0], h[1], h[2], h[3], h[4], h[5], h[6], h[7],
                    B2B_IV0, B2B_IV1, B2B_IV2, B2B_IV3,
                    B2B_IV4 ^ t, B2B_IV5, last ? ~B2B_IV6 : B2B_IV6, B2B_IV7};
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
  B2B_ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4)
  B2B_ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8)
  B2B_ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13)
  B2B_ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9)
  B2B_ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11)
  B2B_ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10)
  B2B_ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5)
  B2B_ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0)
  B2B_ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
  B2B_ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3)
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// The reference's Pallas layout: separate lo/hi u32 planes, `words` u32 per
// row (16 for one block, 32 for two); block `blk` is words [16*blk, 16*blk+16).
struct SplitPlanes {
  const uint32_t* lo;
  const uint32_t* hi;
  int words;

  __device__ __forceinline__ void load(int64_t row, int blk, uint64_t m[16]) const {
    const uint4* lo4 = reinterpret_cast<const uint4*>(lo + row * words + blk * 16);
    const uint4* hi4 = reinterpret_cast<const uint4*>(hi + row * words + blk * 16);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 l = lo4[q];
      const uint4 h = hi4[q];
      m[4 * q + 0] = uint64_t(l.x) | (uint64_t(h.x) << 32);
      m[4 * q + 1] = uint64_t(l.y) | (uint64_t(h.y) << 32);
      m[4 * q + 2] = uint64_t(l.z) | (uint64_t(h.z) << 32);
      m[4 * q + 3] = uint64_t(l.w) | (uint64_t(h.w) << 32);
    }
  }

  // words 4q..4q+3 of a block (one lane of a quad): one uint4 from each
  // plane, interleaved as PaddedBlocks::load_quarter gives them
  __device__ __forceinline__ void load_quarter(int64_t row, int blk, int q, ulonglong2 w[2]) const {
    const uint4 l = reinterpret_cast<const uint4*>(lo + row * words + blk * 16)[q];
    const uint4 h = reinterpret_cast<const uint4*>(hi + row * words + blk * 16)[q];
    w[0] = make_ulonglong2(uint64_t(l.x) | (uint64_t(h.x) << 32), uint64_t(l.y) | (uint64_t(h.y) << 32));
    w[1] = make_ulonglong2(uint64_t(l.z) | (uint64_t(h.z) << 32), uint64_t(l.w) | (uint64_t(h.w) << 32));
  }
};

// The pad_blake2b layout: [N, B, 32] interleaved u32 words, i.e. each
// 128-byte block is 16 little-endian u64 message words.
struct PaddedBlocks {
  const ulonglong2* blocks;
  int max_blocks;

  __device__ __forceinline__ void load(int64_t row, int blk, uint64_t m[16]) const {
    const ulonglong2* p = blocks + (row * max_blocks + blk) * 8;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const ulonglong2 w = p[q];
      m[2 * q] = w.x;
      m[2 * q + 1] = w.y;
    }
  }

  // words 4q..4q+3 of a block (one lane of a quad)
  __device__ __forceinline__ void load_quarter(int64_t row, int blk, int q, ulonglong2 w[2]) const {
    const ulonglong2* p = blocks + (row * max_blocks + blk) * 8 + 2 * q;
    w[0] = p[0];
    w[1] = p[1];
  }
};

// The compressions a row runs. n_blocks == nullptr: the count follows from
// the length, clamped to [1, max_blocks] (the Pallas kernels' semantics:
// one block at len <= 128, two above). Otherwise rows compress blocks
// 0..n_blocks-1, at most max_blocks of them, the final flag on block
// n_blocks-1 (so a row past max_blocks never sets it, and a count below 1
// compresses nothing) — the XLA kernel's masked scan. Returns the count of
// compressions; `*nb` is the row's block count.
__device__ __forceinline__ int row_blocks(const int32_t* __restrict__ n_blocks, int64_t row,
                                          uint32_t len, int max_blocks, int* nb) {
  if (n_blocks != nullptr) {
    *nb = n_blocks[row];
  } else {
    const uint64_t need = (uint64_t(len) + 127) / 128;
    *nb = need < 1 ? 1 : (need > uint64_t(max_blocks) ? max_blocks : int(need));
  }
  return *nb < max_blocks ? (*nb > 0 ? *nb : 0) : max_blocks;
}

// One thread a message.
template <class Words>
__global__ void __launch_bounds__(kThreads)
blake2b256_kernel(Words words, const int32_t* __restrict__ n_blocks,
                  const int32_t* __restrict__ lengths, int64_t n, int max_blocks,
                  uint64_t* __restrict__ out) {
  const int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint32_t len = uint32_t(lengths[row]);
  int nb;
  const int count = row_blocks(n_blocks, row, len, max_blocks, &nb);
  uint64_t h[8] = {B2B_IV0 ^ B2B_PARAM0, B2B_IV1, B2B_IV2, B2B_IV3,
                   B2B_IV4, B2B_IV5, B2B_IV6, B2B_IV7};
#pragma unroll 1  // one compression a trip: chip_smoke.py counts the loop's SASS as one
  for (int i = 0; i < count; ++i) {
    uint64_t m[16];
    words.load(row, i, m);
    const bool last = (i == nb - 1);
    compress(h, m, last ? uint64_t(len) : uint64_t(128) * uint64_t(i + 1), last);
  }
  uint64_t* o = out + row * 4;
  o[0] = h[0];
  o[1] = h[1];
  o[2] = h[2];
  o[3] = h[3];
}

__device__ __forceinline__ uint64_t lds64(uint32_t addr) {
  uint64_t x;
  asm volatile("ld.shared.u64 %0, [%1];" : "=l"(x) : "r"(addr));
  return x;
}

// Four lanes a message, over either layout. Lane q of a quad holds column q
// of v (a = v[q], b = v[4+q], c = v[8+q], d = v[12+q]) and the state words
// h[q], h[4+q]. For the diagonal step lane q runs diagonal mix q-1, the one
// whose b is its own: b, the last value a mix finishes, never moves, and
// a, c and d (finished one to three steps earlier) travel from lanes q-1,
// q+1 and q+2 while the mix ends, and back after. The quad's current
// block sits in shared memory; round r's four message words of lane q are
// read at addresses the lane computes once (rounds 10 and 11 reuse rows 0
// and 1). Every lane of a warp runs the warp's longest row count (a quad
// past its own count or past the rows computes and discards), so each
// shuffle is a whole-warp one: ptxas emits a plain SHFL, where a quad's
// own mask made it wrap each in a collective warp sync. In the split
// layouts a row's count follows from its length, so the two-block
// kernel's rows of one block and of two share a warp, which runs two.
template <class Words>
__global__ void __launch_bounds__(kThreads)
blake2b256_quad_kernel(Words words, const int32_t* __restrict__ n_blocks,
                       const int32_t* __restrict__ lengths, int64_t n, int max_blocks,
                       uint64_t* __restrict__ out) {
  __shared__ __align__(16) uint64_t msg[kQuads][16];
  const int q = threadIdx.x & 3;
  const int slot = threadIdx.x >> 2;
  const int64_t row = int64_t(blockIdx.x) * kQuads + slot;
  const bool real = row < n;
  const uint32_t len = real ? uint32_t(lengths[row]) : 0u;
  int nb = 0;
  const int count = real ? row_blocks(n_blocks, row, len, max_blocks, &nb) : 0;
  const int trips = __reduce_max_sync(0xffffffffu, count);

  const uint32_t base = uint32_t(__cvta_generic_to_shared(&msg[slot][0]));
  const int diag = (q + 3) & 3;  // the diagonal mix this lane runs
  uint32_t addr[10][4];  // round r: column x, column y, diagonal x, diagonal y
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    addr[r][0] = base + 8u * kSigma[r][2 * q];
    addr[r][1] = base + 8u * kSigma[r][2 * q + 1];
    addr[r][2] = base + 8u * kSigma[r][8 + 2 * diag];
    addr[r][3] = base + 8u * kSigma[r][9 + 2 * diag];
  }
  const uint64_t iv_c = kIV[q];
  const uint64_t iv_d = kIV[4 + q];
  uint64_t h0 = q == 0 ? B2B_IV0 ^ B2B_PARAM0 : kIV[q];  // h[q]
  uint64_t h1 = kIV[4 + q];                              // h[4+q]
  const int lane = threadIdx.x & 31;
  const int up = (lane & ~3) | ((q + 1) & 3);
  const int across = (lane & ~3) | ((q + 2) & 3);
  const int down = (lane & ~3) | ((q + 3) & 3);

  ulonglong2 w[2] = {};
  if (count > 0) words.load_quarter(row, 0, q, w);
#pragma unroll 1
  for (int i = 0; i < trips; ++i) {
    __syncwarp();  // every lane is done with the last block's words
    reinterpret_cast<ulonglong2*>(&msg[slot][4 * q])[0] = w[0];
    reinterpret_cast<ulonglong2*>(&msg[slot][4 * q])[1] = w[1];
    __syncwarp();
    if (i + 1 < count) words.load_quarter(row, i + 1, q, w);
    const bool last = (i == nb - 1);
    const uint64_t t = last ? uint64_t(len) : uint64_t(128) * uint64_t(i + 1);
    uint64_t a = h0, b = h1, c = iv_c, d = iv_d;
    if (q == 0) d ^= t;
    if (q == 2 && last) d = ~d;
#pragma unroll
    for (int r = 0; r < 12; ++r) {
      const uint32_t* s = addr[r % 10];
      mix(a, b, c, d, lds64(s[0]), lds64(s[1]));
      a = __shfl_sync(0xffffffffu, a, down);
      c = __shfl_sync(0xffffffffu, c, up);
      d = __shfl_sync(0xffffffffu, d, across);
      mix(a, b, c, d, lds64(s[2]), lds64(s[3]));
      a = __shfl_sync(0xffffffffu, a, up);
      c = __shfl_sync(0xffffffffu, c, down);
      d = __shfl_sync(0xffffffffu, d, across);
    }
    if (i < count) {
      h0 ^= a ^ c;
      h1 ^= b ^ d;
    }
  }
  if (real) out[row * 4 + q] = h0;  // digest words h[0..3], one a lane
}

// lanes: 1 puts a message on one lane, 4 over four; any other value is
// refused.
template <class Words>
int launch(Words words, const int32_t* n_blocks, const int32_t* lengths, long long n,
           int max_blocks, int lanes, void* out, void* stream) {
  if (lanes != 1 && lanes != 4) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint64_t*>(out);
  if (lanes == 1) {
    const long long grid = (n + kThreads - 1) / kThreads;
    blake2b256_kernel<Words><<<unsigned(grid), kThreads, 0, s>>>(words, n_blocks, lengths, n, max_blocks, o);
  } else {
    const long long grid = (n + kQuads - 1) / kQuads;
    blake2b256_quad_kernel<Words><<<unsigned(grid), kThreads, 0, s>>>(words, n_blocks, lengths, n, max_blocks, o);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int blake2b256_single_block(const void* m_lo, const void* m_hi, const void* lengths,
                                       long long n, int lanes, void* out, void* stream) {
  return launch(SplitPlanes{static_cast<const uint32_t*>(m_lo),
                            static_cast<const uint32_t*>(m_hi), 16},
                nullptr, static_cast<const int32_t*>(lengths), n, 1, lanes, out, stream);
}

extern "C" int blake2b256_two_block(const void* m_lo, const void* m_hi, const void* lengths,
                                    long long n, int lanes, void* out, void* stream) {
  return launch(SplitPlanes{static_cast<const uint32_t*>(m_lo),
                            static_cast<const uint32_t*>(m_hi), 32},
                nullptr, static_cast<const int32_t*>(lengths), n, 2, lanes, out, stream);
}

extern "C" int blake2b256_blocks(const void* blocks, const void* n_blocks, const void* lengths,
                                 long long n, int max_blocks, int lanes, void* out, void* stream) {
  return launch(PaddedBlocks{static_cast<const ulonglong2*>(blocks), max_blocks},
                static_cast<const int32_t*>(n_blocks), static_cast<const int32_t*>(lengths), n,
                max_blocks, lanes, out, stream);
}
