// weighted_vote_update: the elastic-participation majority-vote step on Hopper.
//
// Replaces: src/repro/kernels/vote_update/kernel.py:58 (weighted_vote_update_2d, Pallas TPU).
//
//   out[j] = w[j] - eta * sign(v[j])   where |v[j]| >= q_frac * W[j]
//          = w[j] - eta * 0            otherwise
//
// v is the weighted vote sum_m w_m * sign_m (float32) and W the realized
// participation sum_{reporting} w_m: one device scalar, or one float32 per
// coordinate (the psum wires carry it per coordinate). sign is jnp.sign
// (+-0.0 and NaN pass through; a NaN vote never clears the deadband). Computed
// in float32, rounded back to w's type (round to nearest even for bf16).
//
// Bound on an H100 (3.35 TB/s): bytes. Reads w and v once and writes w':
// 12 B/coord for f32 w with a scalar W, 16 B/coord with W per coordinate.
//
// Design: one flat elementwise pass, four coordinates a thread (16-byte loads
// of v, and of W when it is per coordinate). A scalar W is read from device
// memory by every thread (it is computed on the device each round, so the host
// never waits for it); eta and q_frac are launch arguments. The threshold
// product and the update are written with _rn intrinsics, so no contraction can
// change a bit against the plain version.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int N = 4;

template <typename T>
__global__ void __launch_bounds__(kThreads)
weighted_vote_update_kernel(const T* __restrict__ w, const float* __restrict__ v,
                            const float* __restrict__ wtot, T* __restrict__ out, long long n,
                            float eta, float q_frac, int wtot_per_coord, bool vec_ok) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= n) return;
  const Vec<T, N> wv = load_vec<T, N>(w, i, n, vec_ok);
  const Vec<float, N> vv = load_vec<float, N>(v, i, n, vec_ok);
  Vec<float, N> tv;
  if (wtot_per_coord) {
    tv = load_vec<float, N>(wtot, i, n, vec_ok);
  } else {
    const float t = *wtot;
#pragma unroll
    for (int k = 0; k < N; ++k) tv.v[k] = t;
  }
  Vec<T, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float x = vv.v[k];
    const float step = (fabsf(x) >= __fmul_rn(q_frac, tv.v[k])) ? jnp_sign(x) : 0.0f;
    o.v[k] = from_f32<T>(__fsub_rn(to_f32<T>(wv.v[k]), __fmul_rn(eta, step)));
  }
  store_vec<T, N>(out, i, n, vec_ok, o);
}

template <typename T>
int launch(const void* w, const void* v, const void* wtot, void* out, long long n, float eta,
           float q_frac, int wtot_per_coord, cudaStream_t stream) {
  const bool vec_ok = aligned(w, sizeof(T) * N) && aligned(v, sizeof(float) * N) &&
                      aligned(out, sizeof(T) * N) &&
                      (!wtot_per_coord || aligned(wtot, sizeof(float) * N));
  weighted_vote_update_kernel<T><<<grid_for(n, N), kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const float*>(v), static_cast<const float*>(wtot),
      static_cast<T*>(out), n, eta, q_frac, wtot_per_coord, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_dtype: 0 = float32, 1 = bfloat16. v: float32[n]. wtot: float32[n] when
// wtot_per_coord, else float32[1].
extern "C" int weighted_vote_update_launch(const void* w, const void* v, const void* wtot,
                                           void* out, long long n, float eta, float q_frac,
                                           int wtot_per_coord, int w_dtype, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch<float>(w, v, wtot, out, n, eta, q_frac, wtot_per_coord, s);
  if (w_dtype == 1)
    return launch<__nv_bfloat16>(w, v, wtot, out, n, eta, q_frac, wtot_per_coord, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
