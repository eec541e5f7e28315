// blake2b-256 batch kernels for Hopper (sm_90a), one thread per message.
//
// Replaces three TPU device functions of ipc_proofs_tpu:
//   ops/pallas_kernels.py:337 blake2b256_single_block_pallas (_blake2b_kernel :251)
//   ops/pallas_kernels.py:363 blake2b256_two_block_pallas    (_blake2b2_kernel :205)
//   ops/blake2b_jax.py:140    blake2b256_blocks (XLA lax.scan over blocks)
//
// What bounds it on an H100: integer operations. One compression is
// 12 rounds x 8 G mixes of 64-bit adds, xors and rotations (by 32 a register
// swap, by 24/16/63 two funnel shifts). In the sm_90a SASS it is about 2,150
// instructions: about 1,950 on the ALU pipe (LOP3 xors, SHF.L.W shifts,
// IADD3/IADD3.X adds) and about 190 high-word adds that ptxas puts on the
// FMA pipe as IMAD.X. That is ~15 ALU operations per byte of block read,
// against the ~5 per byte at which the ALU pipe and HBM take equal time.
// chip_smoke.py counts these from the built library for its bound.
//
// What the design does about it: the TPU kernels' lane-major [16, TILE]
// layout, u32-pair emulation and "run both compressions, then mask" all
// exist for Mosaic. Here each thread owns one message: the 16-word working
// vector v, the 8-word state h and the 16 message words live in uint64_t
// registers; the sigma schedule and the rotation amounts are literals, so
// the unrolled rounds index registers, never local memory; each thread runs
// exactly its own row's block count (divergence inside a warp only idles
// the lanes of shorter rows). Message words arrive through 16-byte vector
// loads.
//
// Three C entry points keep the JAX package's layouts at the boundary
// (the caller passes u32 data as int32 bit views), so a test feeds both
// packages the same arrays:
//   blake2b256_single_block(m_lo[N,16], m_hi[N,16], lengths[N,1]) -> out[N,8]
//   blake2b256_two_block   (m_lo[N,32], m_hi[N,32], lengths[N,1]) -> out[N,8]
//   blake2b256_blocks      (blocks[N,B,32], n_blocks[N], lengths[N]) -> out[N,8]
// Digest words are [lo0, hi0, lo1, hi1, ...], the little-endian u32 view of
// the 32-byte digest. Each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ uint64_t rotr64(uint64_t x, unsigned n) {
  return (x >> n) | (x << (64u - n));
}

__device__ __forceinline__ void mix(uint64_t& a, uint64_t& b, uint64_t& c, uint64_t& d,
                                    uint64_t x, uint64_t y) {
  a = a + b + x;
  d = rotr64(d ^ a, 32);
  c = c + d;
  b = rotr64(b ^ c, 24);
  a = a + b + y;
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
};

// n_blocks == nullptr: the row's block count follows from its length,
// clamped to [1, max_blocks] (the Pallas kernels' semantics: one block at
// len <= 128, two above). Otherwise rows compress blocks 0..n_blocks-1 (at
// most max_blocks), the final flag on block n_blocks-1 — the XLA kernel's
// masked scan.
template <class Words>
__global__ void __launch_bounds__(kThreads)
blake2b256_kernel(Words words, const int32_t* __restrict__ n_blocks,
                  const int32_t* __restrict__ lengths, int64_t n, int max_blocks,
                  uint64_t* __restrict__ out) {
  const int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const uint32_t len = uint32_t(lengths[row]);
  int nb;
  if (n_blocks != nullptr) {
    nb = n_blocks[row];
  } else {
    const uint64_t need = (uint64_t(len) + 127) / 128;
    nb = need < 1 ? 1 : (need > uint64_t(max_blocks) ? max_blocks : int(need));
  }
  uint64_t h[8] = {B2B_IV0 ^ 0x01010020ull, B2B_IV1, B2B_IV2, B2B_IV3,
                   B2B_IV4, B2B_IV5, B2B_IV6, B2B_IV7};
  for (int i = 0; i < max_blocks && i < nb; ++i) {
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

template <class Words>
int launch(Words words, const int32_t* n_blocks, const int32_t* lengths, long long n,
           int max_blocks, void* out, void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + kThreads - 1) / kThreads;
  blake2b256_kernel<Words><<<unsigned(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      words, n_blocks, lengths, n, max_blocks, static_cast<uint64_t*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int blake2b256_single_block(const void* m_lo, const void* m_hi, const void* lengths,
                                       long long n, void* out, void* stream) {
  return launch(SplitPlanes{static_cast<const uint32_t*>(m_lo),
                            static_cast<const uint32_t*>(m_hi), 16},
                nullptr, static_cast<const int32_t*>(lengths), n, 1, out, stream);
}

extern "C" int blake2b256_two_block(const void* m_lo, const void* m_hi, const void* lengths,
                                    long long n, void* out, void* stream) {
  return launch(SplitPlanes{static_cast<const uint32_t*>(m_lo),
                            static_cast<const uint32_t*>(m_hi), 32},
                nullptr, static_cast<const int32_t*>(lengths), n, 2, out, stream);
}

extern "C" int blake2b256_blocks(const void* blocks, const void* n_blocks, const void* lengths,
                                 long long n, int max_blocks, void* out, void* stream) {
  return launch(PaddedBlocks{static_cast<const ulonglong2*>(blocks), max_blocks},
                static_cast<const int32_t*>(n_blocks), static_cast<const int32_t*>(lengths), n,
                max_blocks, out, stream);
}
