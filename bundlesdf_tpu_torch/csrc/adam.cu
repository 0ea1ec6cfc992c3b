// Adam's update of one parameter group in one pass, for Hopper (sm_90a).
//
// For each tensor of the group, element by element, as torch.optim.Adam's
// foreach path (`_multi_tensor_adam`, no amsgrad, weight decay or maximize)
// computes it, op for op and in float32:
//
//   m = lerp(m, g, 1 - beta1)                      _foreach_lerp_
//   v = v * beta2                                  _foreach_mul_
//   v = v + (1 - beta2) * (g * g)                  _foreach_addcmul_
//   d = sqrt(v) / sqrt(1 - beta2^t) + eps          _foreach_sqrt, div_, add_
//   p = p + (-lr / (1 - beta1^t)) * (m / d)        _foreach_addcdiv_
//
// Every scalar comes from the host, computed there in double as torch does
// and rounded to float once, as torch's kernels receive it; the two bias
// corrections are per tensor, as torch keeps a step count per tensor. Each
// product that torch's kernels add in one expression is one fused
// multiply-add here (`__fmaf_rn`), and every other operation is written
// with its round-to-nearest intrinsic, so that no compiler contraction
// changes the result: the pass gives torch's bits.
//
// Replaces no TPU kernel: the JAX package's Adam is `optax.scale_by_adam`
// (bundlesdf_tpu/nof/train.py:41), which XLA fuses itself. It replaces the
// seven foreach ops the PyTorch Adam issues after each NOF step, which read
// or write the table-sized float32 tensors about 18 times between them.
//
// The bound. Each element is read once (p, g, m, v) and written once (p,
// m, v): 28 bytes. At ho3d.refine's 84,133,278 x 2 table that is 4.71 GB a
// step, 1.41 ms at 3.35 TB/s; the arithmetic (two IEEE divisions and a
// square root an element) stays under the memory time. So bytes bound it,
// and the design streams: 16-byte vector loads and stores where all four
// pointers of a tensor are 16-byte aligned, evict-first hints (nothing is
// read twice), a grid-stride loop over each tensor of the group in turn
// with two waves of resident blocks, and one launch a group with the
// tensors' pointers passed by value (`__grid_constant__`, read in place).
#include <cuda_runtime.h>
#include <stdint.h>

// One tensor of a launch, as the wrapper (ops/adam.py::AdamTensor) lays it
// out; outside the anonymous namespace, since the C entry point takes it.
struct AdamTensor {
  float* p;
  const float* g;
  float* m;
  float* v;
  int64_t n;
  float step_size;  // -lr / (1 - beta1^t)
  float bc2_sqrt;   // sqrt(1 - beta2^t)
};

namespace {

constexpr int kThreads = 256;
// tensors one launch takes; a larger group is split by the wrapper
constexpr int kMaxTensors = 48;
// devices whose resident block count is kept
constexpr int kMaxDevices = 64;

struct AdamArgs {
  AdamTensor t[kMaxTensors];
  int n_tensors;
  float w1;     // 1 - beta1, lerp's weight
  float beta2;
  float c2;     // 1 - beta2
  float eps;
};

__device__ __forceinline__ void update(float& p, float g, float& m, float& v,
                                       const AdamArgs& a, float step_size,
                                       float bc2_sqrt) {
  // ATen's lerp: self + w * (end - self) for |w| < 0.5, else
  // end - (end - self) * (1 - w)
  const float diff = __fsub_rn(g, m);
  m = fabsf(a.w1) < 0.5f ? __fmaf_rn(a.w1, diff, m)
                         : __fmaf_rn(-diff, __fsub_rn(1.f, a.w1), g);
  v = __fmaf_rn(a.c2, __fmul_rn(g, g), __fmul_rn(v, a.beta2));
  const float d = __fadd_rn(__fdiv_rn(__fsqrt_rn(v), bc2_sqrt), a.eps);
  p = __fmaf_rn(step_size, __fdiv_rn(m, d), p);
}

__global__ void __launch_bounds__(kThreads)
    adam_step_kernel(const __grid_constant__ AdamArgs a) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads +
                        threadIdx.x;
  for (int k = 0; k < a.n_tensors; ++k) {
    const AdamTensor& t = a.t[k];
    const bool vec = ((reinterpret_cast<uintptr_t>(t.p) |
                       reinterpret_cast<uintptr_t>(t.g) |
                       reinterpret_cast<uintptr_t>(t.m) |
                       reinterpret_cast<uintptr_t>(t.v)) & 15) == 0;
    const int64_t n4 = vec ? t.n / 4 : 0;
    float4* p4 = reinterpret_cast<float4*>(t.p);
    const float4* g4 = reinterpret_cast<const float4*>(t.g);
    float4* m4 = reinterpret_cast<float4*>(t.m);
    float4* v4 = reinterpret_cast<float4*>(t.v);
    for (int64_t i = first; i < n4; i += stride) {
      float4 p = __ldcs(p4 + i), m = __ldcs(m4 + i), v = __ldcs(v4 + i);
      const float4 g = __ldcs(g4 + i);
      update(p.x, g.x, m.x, v.x, a, t.step_size, t.bc2_sqrt);
      update(p.y, g.y, m.y, v.y, a, t.step_size, t.bc2_sqrt);
      update(p.z, g.z, m.z, v.z, a, t.step_size, t.bc2_sqrt);
      update(p.w, g.w, m.w, v.w, a, t.step_size, t.bc2_sqrt);
      __stcs(p4 + i, p);
      __stcs(m4 + i, m);
      __stcs(v4 + i, v);
    }
    // the tail past the last whole vector, or every element of a tensor
    // whose pointers are not all 16-byte aligned
    for (int64_t i = 4 * n4 + first; i < t.n; i += stride) {
      float p = __ldcs(t.p + i), m = __ldcs(t.m + i), v = __ldcs(t.v + i);
      update(p, __ldcs(t.g + i), m, v, a, t.step_size, t.bc2_sqrt);
      __stcs(t.p + i, p);
      __stcs(t.m + i, m);
      __stcs(t.v + i, v);
    }
  }
}

// The blocks of adam_step_kernel that fit on the current device at once
// (its SMs times the blocks an SM holds at the kernel's registers), kept
// per device; 0 with *err set where the runtime cannot say.
int resident_blocks(cudaError_t* err) {
  static int blocks[kMaxDevices] = {0};
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (blocks[dev] == 0) {
    int sms = 0, per_sm = 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err == cudaSuccess)
      *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, adam_step_kernel, kThreads, 0);
    if (*err != cudaSuccess) return 0;
    blocks[dev] = sms * per_sm;
  }
  return blocks[dev];
}

}  // namespace

// Plain C entry point, loaded with ctypes: one launch over @n_tensors
// tensors (1..kMaxTensors) of float32, each contiguous, on @stream. Returns
// cudaGetLastError() of the launch (0 on success).
extern "C" int bsdf_adam_step(const AdamTensor* tensors, int n_tensors,
                              float w1, float beta2, float c2, float eps,
                              void* stream) {
  if (n_tensors < 1 || n_tensors > kMaxTensors)
    return static_cast<int>(cudaErrorInvalidValue);
  AdamArgs a;
  a.n_tensors = n_tensors;
  a.w1 = w1;
  a.beta2 = beta2;
  a.c2 = c2;
  a.eps = eps;
  int64_t work = 0;  // the most elements (or vectors) one tensor asks for
  for (int k = 0; k < n_tensors; ++k) {
    const AdamTensor& t = tensors[k];
    if (t.n < 0) return static_cast<int>(cudaErrorInvalidValue);
    a.t[k] = t;
    const bool vec = ((reinterpret_cast<uintptr_t>(t.p) |
                       reinterpret_cast<uintptr_t>(t.g) |
                       reinterpret_cast<uintptr_t>(t.m) |
                       reinterpret_cast<uintptr_t>(t.v)) & 15) == 0;
    const int64_t w = vec ? (t.n + 3) / 4 : t.n;
    if (w > work) work = w;
  }
  if (work == 0) return 0;
  cudaError_t err = cudaSuccess;
  const int resident = resident_blocks(&err);
  if (resident <= 0)
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorUnknown);
  // two waves of resident blocks: on an H100 at 700 W this read 84.5 % of
  // the byte bound at ho3d.refine's tensors and 64.2 % at custom.online's,
  // one wave 84.3 / 55.6 %, a fixed 1,056 blocks 82.4 / 63.4 %
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 2 * static_cast<int64_t>(resident)) blocks = 2 * resident;
  adam_step_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// kMaxTensors and sizeof(AdamTensor), for the wrapper to check against its
// own copies
extern "C" int bsdf_adam_max_tensors() { return kMaxTensors; }
extern "C" int bsdf_adam_tensor_bytes() {
  return static_cast<int>(sizeof(AdamTensor));
}
