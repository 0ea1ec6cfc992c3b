// The multiresolution hash-grid encoder, forward and backward, for Hopper
// (sm_90a).
//
//   out[n, l*C + k] = sum over the 8 corners j of the cell of x[n] at level l
//                     of wc[n, l, j] * table[row[n, l, j], k]
//
// `x` is (N, 3) float32 in [-1, 1] (clamped into it), `table` the flat
// (rows, C) float32 table of `ops/hashgrid.py::HashGridSpec.layout`,
// gathered through bfloat16 when the spec says so, and `out` (N, L*C)
// float32. The backward recomputes the cells from `x` and writes, for each
// (point, level, corner) entry in (N, L, 8) order, the value bf16(g * wc)
// (float32 for a float32 gather) and the corner's int32 row: the input of
// `scatter_rows` (csrc/scatter_rows.cu), which the wrapper launches next
// for the table gradient. It also writes dL/dx.
//
// Replaces no TPU kernel: the JAX package's encoder
// (bundlesdf_tpu/ops/hashgrid.py::hashgrid_encode) is jnp, and the port's
// plain torch version (`hashgrid_corners` + `GatherRows`) built the
// (N, L, 8, 3) corner tensors in device memory: int64 corners, float32
// factors, row products, the hash's where/xor, the gather, the products
// and the corner sum, each saved by autograd and read again by its
// backward. Counted op by op, one forward and backward moved ~51 GB in a
// refine step of the `custom` configuration (2048 rays x 320 samples, 16
// levels), >= 15 ms at 3.35 TB/s of a 34.9 ms step on an H100, and
// ~38.5 GB in the `ho3d` refine (192 samples, 4 of 16 levels hashed).
//
// The bound. The work per (point, level) is a few dozen float operations,
// so bytes bound it. At L = 16, C = 2 a point costs: forward, x (12 B)
// read, 8 L corner rows (1,024 B at most; neighbouring samples share
// them in L2) gathered, L C floats (128 B) written; backward, x and g
// (140 B) read, the rows gathered again, L 8 bf16 pairs and row ids
// (1,024 B) and dx (12 B) written: ~3.4 KB a point, ~2.2 GB a `custom`
// refine step, 0.7 ms at the card's bandwidth. What the design does:
//  1. Nothing per corner touches device memory but the table's rows and
//     the scatter's input; weights, rows and factors live in registers,
//     and the backward recomputes them from x instead of reading them.
//  2. Thread t of a block takes point t / L, level t % L: a warp's
//     stores of out, vals and rows, and its loads of g, cover one
//     contiguous span, and the block's points are consecutive samples
//     of a ray, so its threads of one level mostly read the same rows.
//     The level's resolution and offset come from shared memory.
//  3. The point gradient sums the levels in a fixed order through shared
//     memory, so it is the same on every run (the CUDA graph's replays
//     are held bit for bit against eager steps); no atomics.
//  4. The layout is passed by value at launch, so a captured step holds
//     it and nothing is uploaded.
//
// Rounding. The weights, rows and the values handed to the scatter are
// computed with __fmul_rn / __fadd_rn / __fsub_rn in the order of the plain
// torch path's ops, so no multiply-add is contracted and they are
// bit-equal to that path's. Only the order of the forward's 8-corner sum
// and of the point gradient's chain differ from autograd's, at float32
// rounding; `hashgrid_encode_backward_torch` writes the backward's own
// order out in torch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
// NGP spatial hash primes (the first is 1)
constexpr uint32_t kPrime1 = 2654435761u;
constexpr uint32_t kPrime2 = 805459861u;

struct Layout {
  int n_levels;
  uint32_t dense;      // bit l set: level l indexes its (res+1)^3 rows
  uint32_t hash_mask;  // table_size - 1
  int res[kMaxLevels];
  int offset[kMaxLevels];
};

// One (point, level): the in-cell position w, and each corner's flat row
// and trilinear weight
struct Cell {
  float w[3];
  int32_t row[8];
  float wc[8];
};

__device__ __forceinline__ float factor(float w, int bit) {
  return bit ? w : __fsub_rn(1.f, w);
}

__device__ __forceinline__ float to_unit(float x) {
  return __fmul_rn(__fadd_rn(x, 1.f), 0.5f);
}

// `hashgrid_corners`' arithmetic for one level of one point
__device__ __forceinline__ void make_cell(const float (&x01)[3], int res,
                                          int offset, bool dense,
                                          uint32_t hash_mask, Cell& c) {
  const float rf = static_cast<float>(res);
  int x0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float xl = __fmul_rn(x01[k], rf);
    const int i = max(0, min(static_cast<int>(floorf(xl)), res - 1));
    x0[k] = i;
    c.w[k] = __fsub_rn(xl, static_cast<float>(i));
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int b0 = j >> 2 & 1, b1 = j >> 1 & 1, b2 = j & 1;
    c.wc[j] = __fmul_rn(__fmul_rn(factor(c.w[0], b0), factor(c.w[1], b1)),
                        factor(c.w[2], b2));
    const uint32_t c0 = x0[0] + b0, c1 = x0[1] + b1, c2 = x0[2] + b2;
    uint32_t r;
    if (dense) {
      const uint32_t s = res + 1;  // (res+1)^3 <= table_size <= 2^31
      r = (c0 * s + c1) * s + c2;
    } else {  // uint32 products wrap as the reference's do
      r = (c0 ^ (c1 * kPrime1) ^ (c2 * kPrime2)) & hash_mask;
    }
    c.row[j] = static_cast<int32_t>(r + static_cast<uint32_t>(offset));
  }
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// C floats at @p (aligned to 4 C bytes for C = 2, 16 bytes for C % 4 == 0)
template <int C>
__device__ __forceinline__ void load_row(const float* p, float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + q);
      v[4 * q] = t.x; v[4 * q + 1] = t.y; v[4 * q + 2] = t.z;
      v[4 * q + 3] = t.w;
    }
  } else if constexpr (C == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) v[k] = __ldg(p + k);
  }
}

template <int C>
__device__ __forceinline__ void store_row(float* p, const float (&v)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int q = 0; q < C / 4; ++q)
      reinterpret_cast<float4*>(p)[q] =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else if constexpr (C == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int k = 0; k < C; ++k) p[k] = v[k];
  }
}

// A corner's features as the gather hands them to the interpolation
template <int C, bool kBf16>
__device__ __forceinline__ void gather(const float* table, int32_t row,
                                       float (&f)[C]) {
  load_row<C>(table + static_cast<int64_t>(row) * C, f);
  if constexpr (kBf16) {
#pragma unroll
    for (int k = 0; k < C; ++k) f[k] = round_bf16(f[k]);
  }
}

// Block setup shared by both kernels: the layout's per-level numbers into
// shared memory; this thread's point and level
struct Slot {
  int64_t n;
  int l, P;
};

__device__ __forceinline__ Slot slot_of(const Layout& lay, int* s_res,
                                        int* s_off) {
  const int L = lay.n_levels;
  if (threadIdx.x < L) {
    s_res[threadIdx.x] = lay.res[threadIdx.x];
    s_off[threadIdx.x] = lay.offset[threadIdx.x];
  }
  __syncthreads();
  Slot s;
  s.P = blockDim.x / L;
  const int p = threadIdx.x / L;
  s.l = threadIdx.x - p * L;
  s.n = static_cast<int64_t>(blockIdx.x) * s.P + p;
  return s;
}

template <int C, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hashgrid_forward_kernel(const float* __restrict__ x,
                            const float* __restrict__ table,
                            float* __restrict__ out, int64_t n_points,
                            Layout lay) {
  __shared__ int s_res[kMaxLevels], s_off[kMaxLevels];
  const Slot s = slot_of(lay, s_res, s_off);
  if (s.n >= n_points) return;
  const int L = lay.n_levels;
  float x01[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    x01[k] = fminf(fmaxf(to_unit(x[s.n * 3 + k]), 0.f), 1.f);
  Cell c;
  make_cell(x01, s_res[s.l], s_off[s.l], lay.dense >> s.l & 1, lay.hash_mask,
            c);
  float acc[C];
#pragma unroll
  for (int k = 0; k < C; ++k) acc[k] = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float f[C];
    gather<C, kBf16>(table, c.row[j], f);
#pragma unroll
    for (int k = 0; k < C; ++k)
      acc[k] = __fadd_rn(acc[k], __fmul_rn(f[k], c.wc[j]));
  }
  store_row<C>(out + (s.n * L + s.l) * C, acc);
}

// bf16 bits of v, round to nearest even (torch's `.to(torch.bfloat16)`)
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// @vals and @rows (either both or neither): the scatter's input, entries
// (n, l, j) of 8 corners; @dx (or null): dL/dx. Every thread reaches the
// block's barrier, so none returns early.
template <int C, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    hashgrid_backward_kernel(const float* __restrict__ x,
                             const float* __restrict__ table,
                             const float* __restrict__ g,
                             void* __restrict__ vals,
                             int32_t* __restrict__ rows,
                             float* __restrict__ dx, int64_t n_points,
                             Layout lay) {
  __shared__ int s_res[kMaxLevels], s_off[kMaxLevels];
  __shared__ float s_dx[kThreads][3];
  const Slot s = slot_of(lay, s_res, s_off);
  const int L = lay.n_levels;
  if (s.n < n_points) {
    float x01[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      x01[k] = fminf(fmaxf(to_unit(x[s.n * 3 + k]), 0.f), 1.f);
    const int res = s_res[s.l];
    Cell c;
    make_cell(x01, res, s_off[s.l], lay.dense >> s.l & 1, lay.hash_mask, c);
    float gl[C];
    load_row<C>(g + (s.n * L + s.l) * C, gl);
    const int64_t e = (s.n * L + s.l) * 8;  // the first of the 8 entries
    if (rows != nullptr) {
      int4* rp = reinterpret_cast<int4*>(rows + e);
      rp[0] = make_int4(c.row[0], c.row[1], c.row[2], c.row[3]);
      rp[1] = make_int4(c.row[4], c.row[5], c.row[6], c.row[7]);
      // 8 C values: 16 C bytes in bf16, 32 C in float32, 16-byte stores
      if constexpr (kBf16) {
        uint32_t word[4 * C];
#pragma unroll
        for (int i = 0; i < 8 * C; ++i) {
          const uint32_t b = bf16_bits(__fmul_rn(gl[i % C], c.wc[i / C]));
          if (i & 1) word[i >> 1] |= b << 16;
          else word[i >> 1] = b;
        }
        uint4* vp = reinterpret_cast<uint4*>(static_cast<uint16_t*>(vals) +
                                             e * C);
#pragma unroll
        for (int q = 0; q < C; ++q)
          vp[q] = make_uint4(word[4 * q], word[4 * q + 1], word[4 * q + 2],
                             word[4 * q + 3]);
      } else {
        float v[8 * C];
#pragma unroll
        for (int i = 0; i < 8 * C; ++i)
          v[i] = __fmul_rn(gl[i % C], c.wc[i / C]);
        float4* vp = reinterpret_cast<float4*>(static_cast<float*>(vals) +
                                               e * C);
#pragma unroll
        for (int q = 0; q < 2 * C; ++q)
          vp[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                              v[4 * q + 3]);
      }
    }
    if (dx != nullptr) {
      // dL/dw through wc = (f0 f1) f2, f_k = w_k or 1 - w_k, as autograd
      // takes the products apart; corners in order
      float gw[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int b[3] = {j >> 2 & 1, j >> 1 & 1, j & 1};
        float f[C];
        gather<C, kBf16>(table, c.row[j], f);
        float d = __fmul_rn(gl[0], f[0]);  // dL/dwc = sum_k g_k f_k
#pragma unroll
        for (int k = 1; k < C; ++k) d = __fadd_rn(d, __fmul_rn(gl[k], f[k]));
        const float f0 = factor(c.w[0], b[0]), f1 = factor(c.w[1], b[1]);
        const float f2 = factor(c.w[2], b[2]);
        const float d01 = __fmul_rn(d, f2);
        const float df[3] = {__fmul_rn(d01, f1), __fmul_rn(d01, f0),
                             __fmul_rn(d, __fmul_rn(f0, f1))};
#pragma unroll
        for (int k = 0; k < 3; ++k)
          gw[k] = b[k] ? __fadd_rn(gw[k], df[k]) : __fsub_rn(gw[k], df[k]);
      }
      const float rf = static_cast<float>(res);
#pragma unroll
      for (int k = 0; k < 3; ++k) s_dx[threadIdx.x][k] = __fmul_rn(gw[k], rf);
    }
  }
  if (dx == nullptr) return;  // the same for the whole block
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * s.P + threadIdx.x;
  if (threadIdx.x < s.P && m < n_points) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.f;  // levels in order
      for (int l = 0; l < L; ++l)
        acc = __fadd_rn(acc, s_dx[threadIdx.x * L + l][k]);
      // clamp's gradient flows where 0 <= (x + 1) / 2 <= 1
      const float u = to_unit(x[m * 3 + k]);
      dx[m * 3 + k] = (u >= 0.f && u <= 1.f) ? __fmul_rn(acc, 0.5f) : 0.f;
    }
  }
}

int make_layout(int n_levels, const int* res, const int* offset,
                uint32_t dense, uint32_t hash_mask, Layout& lay) {
  if (n_levels <= 0 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  lay.n_levels = n_levels;
  lay.dense = dense;
  lay.hash_mask = hash_mask;
  for (int l = 0; l < kMaxLevels; ++l) {
    lay.res[l] = l < n_levels ? res[l] : 0;
    lay.offset[l] = l < n_levels ? offset[l] : 0;
  }
  return 0;
}

// blocks of P = kThreads / L points x L levels
bool grid_of(int64_t n_points, int n_levels, unsigned& blocks,
             unsigned& threads) {
  const int P = kThreads / n_levels;
  const int64_t b = (n_points + P - 1) / P;
  if (b > 0x7fffffff) return false;
  blocks = static_cast<unsigned>(b);
  threads = static_cast<unsigned>(P * n_levels);
  return true;
}

#define BSDF_DISPATCH(C_, BF16_, LAUNCH)               \
  switch (C_) {                                        \
    case 1: if (BF16_) LAUNCH(1, true) else LAUNCH(1, false) break; \
    case 2: if (BF16_) LAUNCH(2, true) else LAUNCH(2, false) break; \
    case 4: if (BF16_) LAUNCH(4, true) else LAUNCH(4, false) break; \
    case 8: if (BF16_) LAUNCH(8, true) else LAUNCH(8, false) break; \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }

}  // namespace

// Plain C entry points, loaded with ctypes. @res and @offset: host arrays of
// @n_levels ints (copied into the launch's arguments); @dense: bit l set
// for a dense level; @hash_mask: table_size - 1. C is 1, 2, 4 or 8. Each
// launches one kernel on @stream and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int bsdf_hashgrid_forward(const float* x, const float* table,
                                     float* out, int64_t n_points, int C,
                                     int table_bf16, int n_levels,
                                     const int* res, const int* offset,
                                     uint32_t dense, uint32_t hash_mask,
                                     void* stream) {
  if (n_points <= 0) return 0;
  Layout lay;
  if (const int err = make_layout(n_levels, res, offset, dense, hash_mask,
                                  lay))
    return err;
  unsigned blocks, threads;
  if (!grid_of(n_points, n_levels, blocks, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BSDF_FORWARD(C_, B_)                                              \
  { hashgrid_forward_kernel<C_, B_><<<blocks, threads, 0, s>>>(          \
        x, table, out, n_points, lay); }
  BSDF_DISPATCH(C, table_bf16, BSDF_FORWARD)
#undef BSDF_FORWARD
  return static_cast<int>(cudaGetLastError());
}

// @vals / @rows: the scatter's input, written when not null (both or
// neither); @dx: dL/dx, written when not null.
extern "C" int bsdf_hashgrid_backward(const float* x, const float* table,
                                      const float* g, void* vals,
                                      int32_t* rows, float* dx,
                                      int64_t n_points, int C, int table_bf16,
                                      int n_levels, const int* res,
                                      const int* offset, uint32_t dense,
                                      uint32_t hash_mask, void* stream) {
  if (n_points <= 0) return 0;
  if ((vals == nullptr) != (rows == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Layout lay;
  if (const int err = make_layout(n_levels, res, offset, dense, hash_mask,
                                  lay))
    return err;
  unsigned blocks, threads;
  if (!grid_of(n_points, n_levels, blocks, threads))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BSDF_BACKWARD(C_, B_)                                             \
  { hashgrid_backward_kernel<C_, B_><<<blocks, threads, 0, s>>>(         \
        x, table, g, vals, rows, dx, n_points, lay); }
  BSDF_DISPATCH(C, table_bf16, BSDF_BACKWARD)
#undef BSDF_BACKWARD
  return static_cast<int>(cudaGetLastError());
}

// kMaxLevels, for the wrapper to check against its own copy
extern "C" int bsdf_hashgrid_max_levels() { return kMaxLevels; }
