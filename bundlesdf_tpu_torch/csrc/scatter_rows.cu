// Row scatter-add for the hash-grid table gradient, for Hopper (sm_90a).
//
//   out[r, c] += vals[m, c]   for every m with 0 <= rows[m] < n_rows
//
// `out` is an (n_rows, C) float32 buffer that the caller zeroes; `vals` is
// (M, C) float32 or bfloat16; `rows` is (M,) int32. A row id outside
// [0, n_rows) -- in practice the sentinel n_rows -- drops its row. The
// result is right for any order of the rows; only the speed depends on it.
// The sum is float32 whatever the input type.
//
// Replaces the TPU kernel bundlesdf_tpu/ops/scatter.py::scatter_rows_sorted_tiles
// (Pallas body `_sorted_tiles_kernel`, pallas_call at scatter.py:221). That
// kernel sorts the rows, compacts the occupied 1024-row tiles and places
// 512-row windows with one-hot matmuls, because a TPU scatters row by row.
// Hopper adds floats atomically in L2; the work here is to issue few
// atomics.
//
// The bound. On the main path (one launch per NOF training step) M = 2048
// rays x 192 samples x 4 levels x 8 corners = 12,582,912 entries of C = 2
// bf16 values go into the 2,462,164-row table: 50.3 MB of values and
// 50.3 MB of row ids read once, 19.7 MB of float32 table written once,
// 120.4 MB in all, 35.9 us at 3.35 TB/s. The adds themselves are
// negligible, so bytes bound it. The first version (one thread per value,
// one scalar atomicAdd each) reached 8 % of that bound inside the step,
// held back by three things; what this design does about each:
//  1. Atomic throughput: 25.2M scalar atomics a step. Here one thread owns
//     the C channels of an entry, in chunks of W = 4, 2 or 1 floats (the
//     largest that divides C), and adds a chunk with one vector reduction
//     (red.global.add.v4/.v2.f32, sm_90), which halves the count for C = 2.
//  2. Hot rows serialise: level 0's 4,913 rows take 3.1M of the 12.6M
//     row-adds of a step, level 1's 35,937 rows another 3.1M. Equal rows
//     are summed in registers first (3.), so a coarse voxel that a ray
//     crosses in many samples costs one atomic per run, not one per sample.
//  3. The layout hides the duplicates: the encoder's rows are (sample,
//     level, corner) with samples ray-major and sorted along each ray, so
//     equal rows sit `group` = L*8 entries apart, never side by side. With
//     group > 1 a thread walks one (level, corner) column over kSamples
//     consecutive samples and flushes one atomic per run of equal rows; the
//     lanes of a warp take neighbouring columns, so every step's loads are
//     coalesced. group == 1 is one entry per thread, no runs.
// Values and row ids are read once with streaming loads (__ldcs), so they
// do not push the table's lines out of L2, where the atomics land.
//
// What bounds it now: bytes. On the rows of a real step (chip_smoke.py
// phase 3, H100 80GB HBM3 at 700 W) group 32 issues 1.17M vector atomics
// for the 12.58M entries, and the call takes ~50 us, ~72 % of the bound,
// of which ~7 us is the wrapper's zero fill of the table; the kernel reads
// its 100.6 MB at ~2.3 TB/s. On rows with no runs (uniform random rows,
// group 1) every entry is one atomic, and L2 atomic throughput bounds it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// samples a thread walks along its column when group > 1; a run is cut at
// this boundary, so it bounds the atomics of a long run to one per kSamples
constexpr int kSamples = 32;
// entries whose loads a thread has in flight at once
constexpr int kUnroll = 8;
// grid-stride loop: more blocks than this only add scheduling overhead
constexpr int64_t kMaxBlocks = 132 * 64;

// W consecutive values at @p, widened to float, with one streaming load of
// 4 x W bytes (float32) or 2 x W bytes (bfloat16, stored as uint16_t: a
// bf16 is the top half of a float32)
template <int W>
__device__ __forceinline__ void load(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (W == 2) {
    const float2 q = __ldcs(reinterpret_cast<const float2*>(p));
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = __ldcs(p);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xffff0000u);
}

template <int W>
__device__ __forceinline__ void load(const uint16_t* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
    v[0] = bf16_lo(q.x); v[1] = bf16_hi(q.x);
    v[2] = bf16_lo(q.y); v[3] = bf16_hi(q.y);
  } else if constexpr (W == 2) {
    const uint32_t q = __ldcs(reinterpret_cast<const unsigned int*>(p));
    v[0] = bf16_lo(q); v[1] = bf16_hi(q);
  } else {
    v[0] = bf16_lo(__ldcs(reinterpret_cast<const unsigned short*>(p)));
  }
}

// out[0:W] += a, one vector reduction (no return value); @p is aligned to
// 4 x W bytes
template <int W>
__device__ __forceinline__ void red_add(float* p, const float (&a)[W]) {
  if constexpr (W == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(p), "f"(a[0]), "f"(a[1]), "f"(a[2]), "f"(a[3])
                 : "memory");
  } else if constexpr (W == 2) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
                 :: "l"(p), "f"(a[0]), "f"(a[1]) : "memory");
  } else {
    atomicAdd(p, a[0]);
  }
}

// One work item: channel chunk k (W floats) of column j over S consecutive
// samples of segment seg, i.e. entries m = (seg * S + t) * group + j for
// t < S and m < M. Items run chunk-fastest, then column, so a warp's lanes
// read neighbouring entries at every step.
template <typename T, int W, int S>
__global__ void __launch_bounds__(kThreads)
    scatter_rows_kernel(const T* __restrict__ vals,
                        const int32_t* __restrict__ rows,
                        float* __restrict__ out, int64_t M, int C, int n_rows,
                        int group, int64_t items) {
  constexpr int U = S < kUnroll ? S : kUnroll;
  const int K = C / W;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t item = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
       item < items; item += stride) {
    const int64_t col = item / K;
    const int k = static_cast<int>(item - col * K);
    const int64_t seg = col / group;
    const int j = static_cast<int>(col - seg * group);
    const int64_t m0 = seg * S * group + j;
    const T* vk = vals + k * W;
    float* ok = out + k * W;
    int32_t cur = -1;  // row of the open run; out of range: dropped
    float acc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) acc[w] = 0.f;
#pragma unroll
    for (int t0 = 0; t0 < S; t0 += U) {
      if (m0 + static_cast<int64_t>(t0) * group >= M) break;
      int32_t r[U];
      float v[U][W];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t m = m0 + static_cast<int64_t>(t0 + u) * group;
        if (m < M) {
          r[u] = __ldcs(rows + m);
          load<W>(vk + m * C, v[u]);
        } else {  // ragged tail: an out-of-range row ends the run
          r[u] = -1;
#pragma unroll
          for (int w = 0; w < W; ++w) v[u][w] = 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (r[u] == cur) {
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] += v[u][w];
        } else {
          // unsigned compare drops negative ids and the sentinel alike
          if (static_cast<uint32_t>(cur) < static_cast<uint32_t>(n_rows))
            red_add<W>(ok + static_cast<int64_t>(cur) * C, acc);
          cur = r[u];
#pragma unroll
          for (int w = 0; w < W; ++w) acc[w] = v[u][w];
        }
      }
    }
    if (static_cast<uint32_t>(cur) < static_cast<uint32_t>(n_rows))
      red_add<W>(ok + static_cast<int64_t>(cur) * C, acc);
  }
}

template <typename T, int S>
void launch(int W, unsigned blocks, cudaStream_t s, const void* vals,
            const int32_t* rows, float* out, int64_t M, int C, int n_rows,
            int group, int64_t items) {
  const T* v = static_cast<const T*>(vals);
  if (W == 4)
    scatter_rows_kernel<T, 4, S><<<blocks, kThreads, 0, s>>>(
        v, rows, out, M, C, n_rows, group, items);
  else if (W == 2)
    scatter_rows_kernel<T, 2, S><<<blocks, kThreads, 0, s>>>(
        v, rows, out, M, C, n_rows, group, items);
  else
    scatter_rows_kernel<T, 1, S><<<blocks, kThreads, 0, s>>>(
        v, rows, out, M, C, n_rows, group, items);
}

}  // namespace

// Plain C entry point, loaded with ctypes. @group: the stride between
// entries that tend to repeat (1: no run aggregation). Launches on @stream
// and returns cudaGetLastError() of the launch (0 on success).
extern "C" int bsdf_scatter_rows(const void* vals, int vals_is_bf16,
                                 const int32_t* rows, float* out, int64_t M,
                                 int C, int n_rows, int group, void* stream) {
  if (M <= 0) return 0;
  if (C <= 0 || n_rows <= 0 || group <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int elem = vals_is_bf16 ? 2 : 4;
  int W = C % 4 == 0 ? 4 : C % 2 == 0 ? 2 : 1;
  while (W > 1 && (reinterpret_cast<uintptr_t>(vals) % (W * elem) != 0 ||
                   reinterpret_cast<uintptr_t>(out) % (W * 4) != 0))
    W /= 2;
  const int S = group > 1 ? kSamples : 1;
  const int64_t samples = (M + group - 1) / group;
  const int64_t items = (samples + S - 1) / S * group * (C / W);
  int64_t blocks = (items + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned b = static_cast<unsigned>(blocks);
  if (vals_is_bf16) {
    if (S == 1)
      launch<uint16_t, 1>(W, b, s, vals, rows, out, M, C, n_rows, group, items);
    else
      launch<uint16_t, kSamples>(W, b, s, vals, rows, out, M, C, n_rows, group,
                                 items);
  } else {
    if (S == 1)
      launch<float, 1>(W, b, s, vals, rows, out, M, C, n_rows, group, items);
    else
      launch<float, kSamples>(W, b, s, vals, rows, out, M, C, n_rows, group,
                              items);
  }
  return static_cast<int>(cudaGetLastError());
}

// kSamples, for the wrapper to check against its own copy
extern "C" int bsdf_scatter_rows_samples() { return kSamples; }
