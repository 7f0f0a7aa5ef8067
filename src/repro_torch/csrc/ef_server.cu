// ef_server: fused server error-feedback step (Alg. 2, Eq. 8) on Hopper.
//
// Replaces: src/repro/kernels/ef_server/kernel.py:30 (ef_server_2d, Pallas TPU).
//
//   acc    = d + e
//   out    = scale * sign(acc)       (jnp.sign: +-0.0 and NaN pass through)
//   new_e  = acc - out
//
// scale = ||d + e||_1 / n is reduced on the device beforehand and read here
// from a device pointer, so the host never waits for it.
//
// Bound on an H100 (3.35 TB/s): bytes. Reads d and e, writes out and new_e,
// all float32: 16 B/coord.
//
// Design: one flat elementwise pass, four coordinates a thread with 16-byte
// loads and stores. Every operation is spelled with its _rn intrinsic, so no
// multiply-add contraction can move a bit away from the plain version.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int N = 4;

__global__ void __launch_bounds__(kThreads)
ef_server_kernel(const float* __restrict__ d, const float* __restrict__ e,
                 const float* __restrict__ scale_ptr, float* __restrict__ out,
                 float* __restrict__ new_e, long long n, bool vec_ok) {
  const long long i = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * N;
  if (i >= n) return;
  const float scale = *scale_ptr;
  const Vec<float, N> dv = load_vec<float, N>(d, i, n, vec_ok);
  const Vec<float, N> ev = load_vec<float, N>(e, i, n, vec_ok);
  Vec<float, N> o, ne;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float acc = __fadd_rn(dv.v[k], ev.v[k]);
    const float u = __fmul_rn(scale, jnp_sign(acc));
    o.v[k] = u;
    ne.v[k] = __fsub_rn(acc, u);
  }
  store_vec<float, N>(out, i, n, vec_ok, o);
  store_vec<float, N>(new_e, i, n, vec_ok, ne);
}

}  // namespace

extern "C" int ef_server_launch(const void* d, const void* e, const void* scale, void* out,
                                void* new_e, long long n, void* stream) {
  if (n <= 0) return 0;
  const int bytes = sizeof(float) * N;
  const bool vec_ok = aligned(d, bytes) && aligned(e, bytes) && aligned(out, bytes) &&
                      aligned(new_e, bytes);
  ef_server_kernel<<<grid_for(n, N), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(d), static_cast<const float*>(e),
      static_cast<const float*>(scale), static_cast<float*>(out), static_cast<float*>(new_e),
      n, vec_ok);
  return static_cast<int>(cudaGetLastError());
}
