// vote_update: fused majority-vote sign + SGD step on Hopper.
//
// Replaces: src/repro/kernels/vote_update/kernel.py:32 (vote_update_2d, Pallas TPU).
//
//   out[j] = w[j] - eta * sign(v[j])   where |v[j]| >= quorum
//          = w[j] - eta * 0            otherwise
//
// computed in float32 and rounded back to the weight type (round to nearest
// even for bf16). v holds integer vote sums (int8 or int32).
//
// Bound on an H100 (3.35 TB/s): bytes. Reads w and v once, writes w': 12 B/coord
// for f32 weights and int32 votes.
//
// Design: one flat elementwise pass, four coordinates a thread (one 16-byte
// load of f32 weights or int32 votes). eta and quorum are launch arguments.
// The product eta * step is exact (step is -1, 0 or +1) and the subtraction is
// written with __fsub_rn, so no contraction can change a bit.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int N = 4;

template <typename T, typename V>
__global__ void __launch_bounds__(kThreads)
vote_update_kernel(const T* __restrict__ w, const V* __restrict__ v, T* __restrict__ out,
                   long long n, float eta, int quorum, bool vec_ok) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= n) return;
  const Vec<T, N> wv = load_vec<T, N>(w, i, n, vec_ok);
  const Vec<V, N> vv = load_vec<V, N>(v, i, n, vec_ok);
  Vec<T, N> o;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const int x = static_cast<int>(vv.v[k]);
    // |x| with int32 wrap-around, as jnp.abs: |INT_MIN| stays negative
    const int a = x < 0 ? static_cast<int>(0u - static_cast<unsigned int>(x)) : x;
    const float step = (a >= quorum) ? (x > 0 ? 1.0f : (x < 0 ? -1.0f : 0.0f)) : 0.0f;
    o.v[k] = from_f32<T>(__fsub_rn(to_f32<T>(wv.v[k]), __fmul_rn(eta, step)));
  }
  store_vec<T, N>(out, i, n, vec_ok, o);
}

template <typename T, typename V>
int launch(const void* w, const void* v, void* out, long long n, float eta, int quorum,
           cudaStream_t stream) {
  const bool vec_ok = aligned(w, sizeof(T) * N) && aligned(v, sizeof(V) * N) &&
                      aligned(out, sizeof(T) * N);
  vote_update_kernel<T, V><<<grid_for(n, N), kThreads, 0, stream>>>(
      static_cast<const T*>(w), static_cast<const V*>(v), static_cast<T*>(out), n, eta,
      quorum, vec_ok);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w_dtype: 0 = float32, 1 = bfloat16. v_dtype: 0 = int8, 1 = int32.
extern "C" int vote_update_launch(const void* w, const void* v, void* out, long long n,
                                  float eta, int quorum, int w_dtype, int v_dtype,
                                  void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0 && v_dtype == 0)
    return launch<float, int8_t>(w, v, out, n, eta, quorum, s);
  if (w_dtype == 0 && v_dtype == 1)
    return launch<float, int32_t>(w, v, out, n, eta, quorum, s);
  if (w_dtype == 1 && v_dtype == 0)
    return launch<__nv_bfloat16, int8_t>(w, v, out, n, eta, quorum, s);
  if (w_dtype == 1 && v_dtype == 1)
    return launch<__nv_bfloat16, int32_t>(w, v, out, n, eta, quorum, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
