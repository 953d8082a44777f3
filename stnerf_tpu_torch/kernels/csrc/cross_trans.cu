// Cross-stream successor and log transmittance of the sort-free merged
// compositor, on Hopper (sm_90a).
//
// Replaces stnerf_tpu/kernels/cross_trans.py: K4 cross_successor
// (_succ_kernel) and K5 cross_log_transmittance, its forward (_cross_call,
// _cross_kernel) and its backward (_clt_bwd, _cross_bwd_kernel).
//
// Inputs are (L, N, S) float32, one depth stream per layer and ray; outputs
// the same shape, float32. Sample a's j-th depth "precedes" b's s-th when
// t[a,n,j] <= t[b,n,s] for a < b and t[a,n,j] < t[b,n,s] for a > b (ties
// follow the stable stream order).
//   * stnerf_cross_successor: per sample (b, n, s), the smallest depth of any
//     other stream that follows it: t[a,n,j] > t[b,n,s] for a < b, >= for
//     a > b; 3.4e38 where there is none.
//   * stnerf_cross_logt_fwd: cross[b,n,s] = sum over a != b and j of
//     [a's j precedes b's s] * logf[a,n,j].
//   * stnerf_cross_logt_bwd: its transpose, d_logf[a,n,j] = sum over b != a
//     and s of [a's j precedes b's s] * g[b,n,s].
// No input is assumed sorted.
//
// Bound: (L-1) * L * S^2 compares and adds per ray (1.7e8 of each at L=3,
// N=2000, S=120) against 12-24 bytes moved per sample, so operations bound
// all three on paper; at these sizes they sit near launch cost either way.
//
// The simple design: one block per ray. The block loads the ray's L*S depths
// (and log factors or cotangents) into shared memory (2.9 KB at L=3, S=120);
// each thread owns output samples and loops over the other streams' samples
// in index order, so every float32 sum runs in a fixed order and the
// successor is an exact min. All threads of a warp read the same shared word
// at once (a broadcast). Any N; nothing is padded and nothing is written past
// N. The masks are rebuilt from the depths, never stored: no (N, S, S) cube
// touches device memory.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNoSuccessor = 3.4e38f;  // the JAX package's finite sentinel
constexpr int kThreads = 128;
constexpr int kMaxSharedBytes = 48 * 1024;

__device__ __forceinline__ size_t at(int l, int n, int s, int N, int S) {
  return (static_cast<size_t>(l) * N + n) * S + s;
}

// the ray's L*S values of x into shared memory, stream-major
__device__ __forceinline__ void load_ray(const float* __restrict__ x, float* sm, int n, int L,
                                         int N, int S) {
  for (int i = threadIdx.x; i < L * S; i += blockDim.x) {
    const int l = i / S;
    sm[i] = x[at(l, n, i - l * S, N, S)];
  }
}

__global__ void successor_kernel(const float* __restrict__ t, float* __restrict__ out, int L,
                                 int N, int S) {
  extern __shared__ float sm[];
  const int n = blockIdx.x;
  load_ray(t, sm, n, L, N, S);
  __syncthreads();
  for (int i = threadIdx.x; i < L * S; i += blockDim.x) {
    const int b = i / S;
    const float tb = sm[i];
    float best = kNoSuccessor;
    for (int a = 0; a < L; ++a) {
      if (a == b) continue;
      const float* ta = sm + a * S;
      if (a < b) {
        for (int j = 0; j < S; ++j) best = fminf(best, ta[j] > tb ? ta[j] : kNoSuccessor);
      } else {
        for (int j = 0; j < S; ++j) best = fminf(best, ta[j] >= tb ? ta[j] : kNoSuccessor);
      }
    }
    out[at(b, n, i - b * S, N, S)] = best;
  }
}

__global__ void logt_fwd_kernel(const float* __restrict__ t, const float* __restrict__ logf,
                                float* __restrict__ out, int L, int N, int S) {
  extern __shared__ float sm[];
  float* st = sm;
  float* sf = sm + L * S;
  const int n = blockIdx.x;
  load_ray(t, st, n, L, N, S);
  load_ray(logf, sf, n, L, N, S);
  __syncthreads();
  for (int i = threadIdx.x; i < L * S; i += blockDim.x) {
    const int b = i / S;
    const float tb = st[i];
    float acc = 0.0f;
    for (int a = 0; a < L; ++a) {
      if (a == b) continue;
      const float* ta = st + a * S;
      const float* fa = sf + a * S;
      if (a < b) {
        for (int j = 0; j < S; ++j) acc += ta[j] <= tb ? fa[j] : 0.0f;
      } else {
        for (int j = 0; j < S; ++j) acc += ta[j] < tb ? fa[j] : 0.0f;
      }
    }
    out[at(b, n, i - b * S, N, S)] = acc;
  }
}

__global__ void logt_bwd_kernel(const float* __restrict__ t, const float* __restrict__ g,
                                float* __restrict__ d_logf, int L, int N, int S) {
  extern __shared__ float sm[];
  float* st = sm;
  float* sg = sm + L * S;
  const int n = blockIdx.x;
  load_ray(t, st, n, L, N, S);
  load_ray(g, sg, n, L, N, S);
  __syncthreads();
  for (int i = threadIdx.x; i < L * S; i += blockDim.x) {
    const int a = i / S;
    const float ta = st[i];
    float acc = 0.0f;
    for (int b = 0; b < L; ++b) {
      if (b == a) continue;
      const float* tb = st + b * S;
      const float* gb = sg + b * S;
      if (a < b) {
        for (int s = 0; s < S; ++s) acc += ta <= tb[s] ? gb[s] : 0.0f;
      } else {
        for (int s = 0; s < S; ++s) acc += ta < tb[s] ? gb[s] : 0.0f;
      }
    }
    d_logf[at(a, n, i - a * S, N, S)] = acc;
  }
}

bool valid(int L, int N, int S, int operands) {
  if (L < 1 || N < 0 || S < 1) return false;
  const long long bytes = 4LL * operands * L * S;
  return bytes <= kMaxSharedBytes;
}

}  // namespace

extern "C" int stnerf_cross_successor(const void* t, void* out, int L, int N, int S,
                                      void* stream) {
  if (!valid(L, N, S, 1)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  successor_kernel<<<N, kThreads, 4 * L * S, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<float*>(out), L, N, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stnerf_cross_logt_fwd(const void* t, const void* logf, void* out, int L, int N,
                                     int S, void* stream) {
  if (!valid(L, N, S, 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  logt_fwd_kernel<<<N, kThreads, 8 * L * S, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(logf), static_cast<float*>(out),
      L, N, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int stnerf_cross_logt_bwd(const void* t, const void* g, void* d_logf, int L, int N,
                                     int S, void* stream) {
  if (!valid(L, N, S, 2)) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  logt_bwd_kernel<<<N, kThreads, 8 * L * S, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(g), static_cast<float*>(d_logf),
      L, N, S);
  return static_cast<int>(cudaGetLastError());
}
