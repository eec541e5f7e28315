// keccak-256 batch kernels for Hopper (sm_90a), one thread per message.
//
// Replaces two TPU device functions of ipc_proofs_tpu:
//   ops/pallas_kernels.py:304 keccak256_single_block_pallas (_keccak_kernel :99)
//   ops/keccak_jax.py:123     keccak256_blocks (XLA lax.scan over rate blocks,
//                                               keccak_f1600_batch :73)
//
// What bounds it on an H100: integer operations. One keccak-f[1600]
// permutation is 24 rounds; each round is theta (5 five-way xors, 5
// rotations by 1, 25 xors), rho+pi (24 rotations by constants), chi
// (25 x ^ (~y & z)) and iota (one xor with a round constant), all on 64-bit
// lanes that the card runs as 32-bit halves: each rotation two SHF funnel
// shifts, each xor or chi a LOP3 per half (LOP3 takes three inputs, so
// a ^ (~b & c) and the three-way theta xors are one instruction each).
// In the sm_90a SASS a round is about 200 instructions and one absorbed
// 136-byte rate block about 4,700 on the ALU pipe: ~35 ALU operations per
// byte read, against the ~5 per byte at which the ALU pipe and HBM take
// equal time. chip_smoke.py counts the round loop's instructions from the
// built library for its bound.
//
// What the design does about it: the TPU kernel's lane-major [17, TILE]
// layout, its u32-pair emulation and its fori_loop over rounds exist for
// Mosaic. Here each thread owns one message: the 25 state lanes are
// uint64_t registers; the rotation offsets and the rho/pi permutation are
// literals, so the unrolled round indexes registers, never local memory.
// The 24 rounds stay a loop (#pragma unroll 1) over a __constant__ table of
// round constants, which keeps the code ~24x smaller than the fully unrolled
// permutation at no cost in operations (one uniform load a round).
//
// Two C entry points keep the JAX package's layouts at the boundary (the
// caller passes u32 data as int32 bit views), so a test feeds both packages
// the same arrays:
//   keccak256_single_block(blocks_lo[N,17], blocks_hi[N,17]) -> out[N,8]
//       one pre-padded rate block; lanes 17..24 start at zero
//   keccak256_blocks(blocks[N,B,34], n_blocks[N])             -> out[N,8]
//       absorbs blocks 0..n_blocks-1 (at most B); n_blocks <= 0 keeps the
//       all-zero state, so the digest is 32 zero bytes (the XLA kernel's
//       `idx < n_blocks` mask)
// Digest words are lanes 0..3 as [lo, hi] pairs, the little-endian u32 view
// of the 32-byte digest. Each entry launches on the given stream, does not
// synchronise, and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRateLanes = 17;  // 136-byte rate = 17 u64 lanes

__constant__ uint64_t kRoundConstants[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808Aull, 0x8000000080008000ull,
    0x000000000000808Bull, 0x0000000080000001ull, 0x8000000080008081ull, 0x8000000000008009ull,
    0x000000000000008Aull, 0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000Aull,
    0x000000008000808Bull, 0x800000000000008Bull, 0x8000000000008089ull, 0x8000000000008003ull,
    0x8000000000008002ull, 0x8000000000000080ull, 0x000000000000800Aull, 0x800000008000000Aull,
    0x8000000080008081ull, 0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};

template <int N>
__device__ __forceinline__ uint64_t rotl(uint64_t x) {
  if constexpr (N == 0) {
    return x;
  } else {
    return (x << N) | (x >> (64 - N));
  }
}

// rho+pi as one permutation: b[dest] = rotl(a[src], r), lane index x + 5y,
// dest = y + 5((2x + 3y) mod 5), r the rotation offset of lane (x, y).
#define KECCAK_RHO_PI(dest, src, r) b[dest] = rotl<r>(a[src]);

// chi over row y: a[x + 5y] = b[x + 5y] ^ (~b[x+1 + 5y] & b[x+2 + 5y]).
#define KECCAK_CHI_ROW(y)                          \
  a[5 * y + 0] = b[5 * y + 0] ^ (~b[5 * y + 1] & b[5 * y + 2]); \
  a[5 * y + 1] = b[5 * y + 1] ^ (~b[5 * y + 2] & b[5 * y + 3]); \
  a[5 * y + 2] = b[5 * y + 2] ^ (~b[5 * y + 3] & b[5 * y + 4]); \
  a[5 * y + 3] = b[5 * y + 3] ^ (~b[5 * y + 4] & b[5 * y + 0]); \
  a[5 * y + 4] = b[5 * y + 4] ^ (~b[5 * y + 0] & b[5 * y + 1]);

// keccak-f[1600] on 25 register lanes.
__device__ __forceinline__ void keccak_f1600(uint64_t a[25]) {
#pragma unroll 1
  for (int round = 0; round < 24; ++round) {
    uint64_t c[5], b[25];
#pragma unroll
    for (int x = 0; x < 5; ++x) c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
#pragma unroll
    for (int x = 0; x < 5; ++x) {
      const uint64_t d = c[(x + 4) % 5] ^ rotl<1>(c[(x + 1) % 5]);
#pragma unroll
      for (int y = 0; y < 25; y += 5) a[x + y] ^= d;
    }
    KECCAK_RHO_PI(0, 0, 0) KECCAK_RHO_PI(1, 6, 44) KECCAK_RHO_PI(2, 12, 43)
    KECCAK_RHO_PI(3, 18, 21) KECCAK_RHO_PI(4, 24, 14) KECCAK_RHO_PI(5, 3, 28)
    KECCAK_RHO_PI(6, 9, 20) KECCAK_RHO_PI(7, 10, 3) KECCAK_RHO_PI(8, 16, 45)
    KECCAK_RHO_PI(9, 22, 61) KECCAK_RHO_PI(10, 1, 1) KECCAK_RHO_PI(11, 7, 6)
    KECCAK_RHO_PI(12, 13, 25) KECCAK_RHO_PI(13, 19, 8) KECCAK_RHO_PI(14, 20, 18)
    KECCAK_RHO_PI(15, 4, 27) KECCAK_RHO_PI(16, 5, 36) KECCAK_RHO_PI(17, 11, 10)
    KECCAK_RHO_PI(18, 17, 15) KECCAK_RHO_PI(19, 23, 56) KECCAK_RHO_PI(20, 2, 62)
    KECCAK_RHO_PI(21, 8, 55) KECCAK_RHO_PI(22, 14, 39) KECCAK_RHO_PI(23, 15, 41)
    KECCAK_RHO_PI(24, 21, 2)
    KECCAK_CHI_ROW(0) KECCAK_CHI_ROW(1) KECCAK_CHI_ROW(2) KECCAK_CHI_ROW(3) KECCAK_CHI_ROW(4)
    a[0] ^= kRoundConstants[round];
  }
}

// The reference's Pallas layout: one pre-padded rate block per row as
// separate lo/hi u32 planes [N, 17].
struct SplitPlanes17 {
  const uint32_t* lo;
  const uint32_t* hi;

  __device__ __forceinline__ void load(int64_t row, int /*blk*/, uint64_t m[kRateLanes]) const {
    const uint32_t* l = lo + row * kRateLanes;
    const uint32_t* h = hi + row * kRateLanes;
#pragma unroll
    for (int i = 0; i < kRateLanes; ++i) m[i] = uint64_t(l[i]) | (uint64_t(h[i]) << 32);
  }
};

// The pad_keccak layout: [N, B, 34] interleaved u32 words, i.e. each
// 136-byte rate block is 17 little-endian u64 lanes.
struct PaddedBlocks34 {
  const uint64_t* blocks;
  int max_blocks;

  __device__ __forceinline__ void load(int64_t row, int blk, uint64_t m[kRateLanes]) const {
    const uint64_t* p = blocks + (row * max_blocks + blk) * kRateLanes;
#pragma unroll
    for (int i = 0; i < kRateLanes; ++i) m[i] = p[i];
  }
};

// n_blocks == nullptr: one block per row (the single-block kernel).
// Otherwise rows absorb blocks 0..n_blocks-1, at most max_blocks.
template <class Blocks>
__global__ void __launch_bounds__(kThreads)
keccak256_kernel(Blocks blocks, const int32_t* __restrict__ n_blocks, int64_t n,
                 int max_blocks, uint64_t* __restrict__ out) {
  const int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  const int nb = n_blocks != nullptr ? n_blocks[row] : 1;
  uint64_t a[25];
#pragma unroll
  for (int i = 0; i < 25; ++i) a[i] = 0;
  for (int blk = 0; blk < max_blocks && blk < nb; ++blk) {
    uint64_t m[kRateLanes];
    blocks.load(row, blk, m);
#pragma unroll
    for (int i = 0; i < kRateLanes; ++i) a[i] ^= m[i];
    keccak_f1600(a);
  }
  uint64_t* o = out + row * 4;
  o[0] = a[0];
  o[1] = a[1];
  o[2] = a[2];
  o[3] = a[3];
}

template <class Blocks>
int launch(Blocks blocks, const int32_t* n_blocks, long long n, int max_blocks, void* out,
           void* stream) {
  if (n <= 0) return 0;
  const long long grid = (n + kThreads - 1) / kThreads;
  keccak256_kernel<Blocks><<<unsigned(grid), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      blocks, n_blocks, n, max_blocks, static_cast<uint64_t*>(out));
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int keccak256_single_block(const void* blocks_lo, const void* blocks_hi, long long n,
                                      void* out, void* stream) {
  return launch(SplitPlanes17{static_cast<const uint32_t*>(blocks_lo),
                              static_cast<const uint32_t*>(blocks_hi)},
                nullptr, n, 1, out, stream);
}

extern "C" int keccak256_blocks(const void* blocks, const void* n_blocks, long long n,
                                int max_blocks, void* out, void* stream) {
  return launch(PaddedBlocks34{static_cast<const uint64_t*>(blocks), max_blocks},
                static_cast<const int32_t*>(n_blocks), n, max_blocks, out, stream);
}
