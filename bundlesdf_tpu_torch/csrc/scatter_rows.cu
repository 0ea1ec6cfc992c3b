// Row scatter-add for the hash-grid table gradient, for Hopper (sm_90a).
//
//   out[r, c] += vals[m, c]   for every m with 0 <= rows[m] < n_rows
//
// `out` is an (n_rows, C) float32 buffer that the caller zeroes; `vals` is
// (M, C) float32 or bfloat16; `rows` is (M,) int32. A row id outside
// [0, n_rows) -- in practice the sentinel n_rows -- drops its row.
//
// Replaces the TPU kernel bundlesdf_tpu/ops/scatter.py::scatter_rows_sorted_tiles
// (Pallas body `_sorted_tiles_kernel`, pallas_call at scatter.py:221). That
// kernel sorts the rows, compacts the occupied 1024-row tiles, DMAs
// 512-row windows and places them with a one-hot matmul, because XLA's
// scatter on a TPU is serialised row by row. None of that is needed here:
// Hopper has native float32 atomics in L2, so this kernel computes WHAT the
// TPU kernel computes with one thread per (row m, channel c) and one
// atomicAdd each. The sum is accumulated in float32 whatever the input
// type; bf16 values are widened with __bfloat162float.
//
// What bounds it on this card: atomic throughput and contention, not
// bytes. On the port's main path one launch per training step adds
// M = 2048 rays x 192 samples x 4 levels x 8 corners = 12.58M rows of
// C = 2 into the 2,462,164-row table. The coarse levels are the hot spots:
// level 0's 4,913 rows receive 393,216 x 8 adds per step, so atomics to
// the same address serialise in L2. Reading vals and rows is ~150 MB a
// step, a few tens of microseconds at HBM rate.
//
// Later work, not done here: warp-level pre-aggregation of equal row ids
// (match_any + shuffle reduction) or sorted segments to cut the hot-row
// contention, and bf16x2 / float2 vector atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void scatter_rows_kernel(const T* __restrict__ vals,
                                    const int32_t* __restrict__ rows,
                                    float* __restrict__ out, int64_t total,
                                    int C, int n_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const int64_t m = i / C;
    const int c = static_cast<int>(i - m * C);
    const int32_t r = __ldg(rows + m);
    // unsigned compare drops negative ids and the sentinel n_rows alike
    if (static_cast<uint32_t>(r) >= static_cast<uint32_t>(n_rows)) continue;
    atomicAdd(out + static_cast<int64_t>(r) * C + c, to_f32(vals[i]));
  }
}

constexpr int kThreads = 256;
// grid-stride loop: more blocks than this only add scheduling overhead
constexpr int64_t kMaxBlocks = 132 * 64;

}  // namespace

// Plain C entry point, loaded with ctypes. Launches on @stream and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int bsdf_scatter_rows(const void* vals, int vals_is_bf16,
                                 const int32_t* rows, float* out, int64_t M,
                                 int C, int n_rows, void* stream) {
  const int64_t total = M * static_cast<int64_t>(C);
  if (total <= 0) return 0;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vals_is_bf16) {
    scatter_rows_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks),
                                         kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(vals), rows, out, total, C, n_rows);
  } else {
    scatter_rows_kernel<float><<<static_cast<unsigned>(blocks), kThreads, 0,
                                 s>>>(static_cast<const float*>(vals), rows,
                                      out, total, C, n_rows);
  }
  return static_cast<int>(cudaGetLastError());
}
