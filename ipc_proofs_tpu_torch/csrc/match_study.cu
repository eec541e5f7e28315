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
//       thread (no load), at a flat mask's grid.
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
