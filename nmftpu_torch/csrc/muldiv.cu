// Fused multiply-divide for Hopper (sm_90a), with a plain C interface
// loaded through ctypes (nmftpu_torch/kernels/_build.py). Replaces
// nmftpu/kernels/dense_mu.py:341 fused_multiply_divide (_muldiv_kernel):
//
//   out = X * numer / (denom + eps)
//
// over three arrays of one shape and type (float or double), in one
// grid-stride pass. The operations are the plain version's, each rounded
// once and in the same order: a multiply, an add of eps (cast to the
// element type, as torch casts a Python float), then a divide. They are
// written as __fmul_rn/__fadd_rn/__fdiv_rn (and the double forms), which
// the compiler never contracts into an FMA or turns into a reciprocal,
// so the result equals `X * numer / (denom + eps)` bit for bit.
//
// What bounds it on the H100: 3 reads and 1 write per element, 2 flops:
// bytes bound (4 * 4 bytes per float element over 3.35 TB/s). Where all
// four pointers are 16-byte aligned the loads and stores are 16 bytes a
// thread (float4 / double2), with a scalar pass for the tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float muldiv(float x, float n, float d, float e) {
  return __fdiv_rn(__fmul_rn(x, n), __fadd_rn(d, e));
}

__device__ __forceinline__ double muldiv(double x, double n, double d,
                                         double e) {
  return __ddiv_rn(__dmul_rn(x, n), __dadd_rn(d, e));
}

// VEC = elements per vector load (1: scalar). Elements [0, count / VEC *
// VEC) go by vectors, the rest one by one.
template <typename T, typename TV, int VEC>
__global__ void muldiv_kernel(const T* __restrict__ x,
                              const T* __restrict__ num,
                              const T* __restrict__ den, T* __restrict__ out,
                              long long count, T eps) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = static_cast<long long>(blockIdx.x) * blockDim.x +
                          threadIdx.x;
  const long long nvec = count / VEC;
  for (long long i = first; i < nvec; i += stride) {
    TV vx = reinterpret_cast<const TV*>(x)[i];
    TV vn = reinterpret_cast<const TV*>(num)[i];
    TV vd = reinterpret_cast<const TV*>(den)[i];
    T* px = reinterpret_cast<T*>(&vx);
    const T* pn = reinterpret_cast<const T*>(&vn);
    const T* pd = reinterpret_cast<const T*>(&vd);
#pragma unroll
    for (int l = 0; l < VEC; ++l) px[l] = muldiv(px[l], pn[l], pd[l], eps);
    reinterpret_cast<TV*>(out)[i] = vx;
  }
  for (long long i = nvec * VEC + first; i < count; i += stride)
    out[i] = muldiv(x[i], num[i], den[i], eps);
}

template <typename T, typename TV>
int launch(const T* x, const T* num, const T* den, T* out, long long count,
           double eps, cudaStream_t stream) {
  constexpr int VEC = sizeof(TV) / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(num) |
        reinterpret_cast<uintptr_t>(den) | reinterpret_cast<uintptr_t>(out)) &
       (sizeof(TV) - 1)) == 0;
  const int threads = 256;
  const long long work = aligned ? count / VEC + 1 : count;
  const long long want = (work + threads - 1) / threads;
  const unsigned blocks =
      static_cast<unsigned>(want < 132LL * 16 ? (want > 0 ? want : 1)
                                              : 132LL * 16);
  if (aligned)
    muldiv_kernel<T, TV, VEC><<<blocks, threads, 0, stream>>>(
        x, num, den, out, count, static_cast<T>(eps));
  else
    muldiv_kernel<T, T, 1><<<blocks, threads, 0, stream>>>(
        x, num, den, out, count, static_cast<T>(eps));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface: launches on `stream`, returns cudaGetLastError().
extern "C" {

int nmftpu_muldiv_f32(const float* x, const float* num, const float* den,
                      float* out, long long count, double eps,
                      cudaStream_t stream) {
  return launch<float, float4>(x, num, den, out, count, eps, stream);
}

int nmftpu_muldiv_f64(const double* x, const double* num, const double* den,
                      double* out, long long count, double eps,
                      cudaStream_t stream) {
  return launch<double, double2>(x, num, den, out, count, eps, stream);
}

}  // extern "C"
