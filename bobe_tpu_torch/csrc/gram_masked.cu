// Masked, padded GP Gram matrix on Hopper (sm_90a), one thread per entry.
//
// Replaces bobe_tpu/ops/pallas_gram.py::gram_masked_pallas (kernel body
// _gram_kernel). It computes
//
//   K[i, j] = m_i m_j * amp * corr(sum_k ((x_ik - x_jk) / l_k)^2)
//             + (noise * m_i + 1 - m_i) * [i == j]
//
// with corr the RBF exp(-r^2 / 2) or the Matern-5/2
// (1 + sqrt5 r + 5/3 r^2) exp(-sqrt5 r). Pad rows (m_i = 0) come out as the
// identity, so the padded Cholesky factor is [[L, 0], [0, I]].
//
// Design. A 2-D grid of 16x16 blocks; threadIdx.x runs along j so the store
// of each row segment is coalesced. Each thread sums exact per-dimension
// differences, not the |a|^2 + |b|^2 - 2ab expansion the TPU kernel feeds to
// its matrix unit: (i, j) and (j, i) then evaluate bit-identical sums (the
// two differences are exact negations), so K is exactly symmetric and has no
// cancellation near the diagonal. None of the TPU kernel's constraints carry
// over: any capacity and any d, no 128-lane padding, no packed aux array.
// ls and amp are read through device pointers, so the caller never
// synchronises to pass them; noise is a host scalar.
//
// What bounds it: at cap 1024 in float64 it writes 8 MB and does about
// 3 * d * cap^2 flops, so at the slice's capacities (128..2048) it is bound
// by launch latency and the store, not by arithmetic. Tiling x into shared
// memory, using the symmetry to halve the work, or wgmma/TMA tiles are work
// for later changes.
#include <cuda_runtime.h>

namespace {

constexpr double kSqrt5 = 2.23606797749978969641;

__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }

template <typename T, int KIND>
__global__ void gram_masked_kernel(const T* __restrict__ x,
                                   const T* __restrict__ mask,
                                   const T* __restrict__ ls,
                                   const T* __restrict__ amp, T noise,
                                   T* __restrict__ out, int cap, int d) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= cap || j >= cap) return;
  const T* xi = x + static_cast<size_t>(i) * d;
  const T* xj = x + static_cast<size_t>(j) * d;
  T dsq = T(0);
  for (int k = 0; k < d; ++k) {
    const T diff = (xi[k] - xj[k]) / ls[k];
    dsq += diff * diff;
  }
  T corr;
  if (KIND == 0) {
    corr = dev_exp(T(-0.5) * dsq);
  } else {
    const T r = dev_sqrt(dsq > T(1e-30) ? dsq : T(1e-30));
    corr = (T(1) + T(kSqrt5) * r + T(5.0 / 3.0) * dsq) * dev_exp(-T(kSqrt5) * r);
  }
  const T mi = mask[i];
  T k = (amp[0] * corr) * (mi * mask[j]);
  if (i == j) k += noise * mi + (T(1) - mi);
  out[static_cast<size_t>(i) * cap + j] = k;
}

template <typename T>
int launch(const T* x, const T* mask, const T* ls, const T* amp, double noise,
           T* out, int cap, int d, int kind, void* stream) {
  if (cap <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(16, 16);
  const dim3 grid((cap + 15) / 16, (cap + 15) / 16);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kind == 0) {
    gram_masked_kernel<T, 0><<<grid, block, 0, s>>>(x, mask, ls, amp, T(noise),
                                                    out, cap, d);
  } else if (kind == 1) {
    gram_masked_kernel<T, 1><<<grid, block, 0, s>>>(x, mask, ls, amp, T(noise),
                                                    out, cap, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// kind: 0 = RBF, 1 = Matern-5/2. Returns the cudaError_t of the launch.
extern "C" int bobe_gram_masked_f64(const double* x, const double* mask,
                                    const double* ls, const double* amp,
                                    double noise, double* out, int cap, int d,
                                    int kind, void* stream) {
  return launch<double>(x, mask, ls, amp, noise, out, cap, d, kind, stream);
}

extern "C" int bobe_gram_masked_f32(const float* x, const float* mask,
                                    const float* ls, const float* amp,
                                    double noise, float* out, int cap, int d,
                                    int kind, void* stream) {
  return launch<float>(x, mask, ls, amp, noise, out, cap, d, kind, stream);
}
