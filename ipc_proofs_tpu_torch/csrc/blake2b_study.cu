// Measurement-only kernels for chip_smoke.py's blake2b phases. The package
// never builds or loads this file (it is not in ops.build.KERNEL_LIBRARIES):
// chip_smoke.py builds it beside the package's libraries and times the
// hash kernels against what is here.
//
// It compiles blake2b.cu into its own library and adds:
//   blake2b_store_floor(N, lanes) -> out[N,8]
//       the launch floor: a kernel that loads nothing and stores each
//       row's 32-byte digest as zeros, at the grid and block of the hash
//       kernel with `lanes` (1 or 4) lanes a message: one lane stores the
//       row's four u64 words, four lanes one word each.
// It launches on the given stream, does not synchronise, and returns
// cudaGetLastError().

#include "blake2b.cu"

namespace {

// one lane a row: its four digest words
__global__ void __launch_bounds__(kThreads) blake2b_store_floor_lane(int64_t n, uint64_t* __restrict__ out) {
  const int64_t row = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= n) return;
  uint64_t* o = out + row * 4;
  o[0] = 0;
  o[1] = 0;
  o[2] = 0;
  o[3] = 0;
}

// four lanes a row: one digest word each
__global__ void __launch_bounds__(kThreads) blake2b_store_floor_quad(int64_t n, uint64_t* __restrict__ out) {
  const int64_t row = int64_t(blockIdx.x) * kQuads + (threadIdx.x >> 2);
  if (row < n) out[row * 4 + (threadIdx.x & 3)] = 0;
}

}  // namespace

extern "C" int blake2b_store_floor(long long n, int lanes, void* out, void* stream) {
  if (lanes != 1 && lanes != 4) return int(cudaErrorInvalidValue);
  if (n <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* o = static_cast<uint64_t*>(out);
  if (lanes == 1) {
    blake2b_store_floor_lane<<<unsigned((n + kThreads - 1) / kThreads), kThreads, 0, s>>>(n, o);
  } else {
    blake2b_store_floor_quad<<<unsigned((n + kQuads - 1) / kQuads), kThreads, 0, s>>>(n, o);
  }
  return int(cudaGetLastError());
}
