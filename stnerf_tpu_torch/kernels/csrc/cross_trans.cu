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
// The sorted route. The compositor's streams come sorted (each layer's
// depths ascend), and then every mask above is a prefix or a suffix of the
// other stream. For x = t[b,n,s] and another stream a, the count of a's
// samples that precede x is c = #{j : t[a,n,j] <= x} for a < b and
// #{j : t[a,n,j] < x} for a > b, one binary search. The successor from a is
// t[a,n,c] (none where c = S), so K4 is an exact min and bitwise the plain
// form's; K5's forward reads the prefix sum of a's log factors over j < c;
// its backward, for y = t[a,n,j] in stream b, the suffix sum of g[b] over
// s >= c' with c' = #{s : t[b,n,s] < y} for a < b and #{s : t[b,n,s] <= y}
// for a > b. The side of a tie is one rule in all three: the count is
// inclusive where the searched stream comes first. Prefix and suffix sums
// are scans over the same terms as the plain sum, never a total minus a
// prefix (the cotangents have mixed signs). Work per ray: L(L-1) S searches
// of ceil(log2 S) + 1 compares, against (L-1) L S^2 for the all-pairs form.
//
// The all-pairs route. A ray with a stream that is not non-decreasing, or
// with a NaN depth, takes the all-pairs loop of the plain form instead,
// inside the same kernel: every sample against every sample of the other
// streams, in index order. K4 there follows the plain (cube) form's NaN
// rule: for a > b a candidate is every t[a,n,j] that is not < x, a NaN
// included, and a NaN candidate wins the min. Each such ray adds one to the
// optional device counter `pairwise` (null: not counted).
//
// One warp per ray, up to kMaxRays rays a block, each warp in its own part
// of shared memory, never waiting on another warp. A warp copies its ray's
// depths (and log factors or cotangents) into shared memory with cp.async,
// every copy in flight at once (one round trip to device memory; no row
// alignment is assumed: S = 90 gives 360-byte rows), checks that each stream
// is non-decreasing with a warp vote (a NaN reads as unsorted), scans the
// log factors (prefix) or cotangents (suffix) in place by shuffles, 32 at a
// time with the chunks chained in order, so that every output is bitwise the
// same from run to run, and then searches. Each lane takes kGroup samples of
// one stream (32 apart) and searches the other streams for all of them side
// by side, so that their dependent shared-memory reads overlap. A search
// halves lengths that do not depend on the data (the branchless lower
// bound), so all lanes step together; the strict side compares <= against
// the next float below x. Shared memory keeps one spare word after every 32
// samples: the searches read at power-of-two strides, which would otherwise
// fall in one bank (bank conflicts made the search 85% of a first build's
// time, tools/torch_cross_timeline.py).
//
// Bound: the bytes. Each operand is read once and the output written once
// (8 or 12 bytes a sample: 5.8 MB for K4 and 8.6 MB for K5 at L = 3,
// N = 2000, S = 120, 1.7 and 2.6 us at 3.35 TB/s), against 1.2e7 compares.
// At that size 2000 rays give 15 warps an SM, and the instructions of the
// vote, the searches and the stores, not the bytes, set the time.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr float kNoSuccessor = 3.4e38f;  // the JAX package's finite sentinel
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxRays = 4;  // warps a block, fewer where a ray's operands are large
constexpr int kMaxSharedBytes = 48 * 1024;
constexpr int kGroup = 4;  // a lane's samples (scan chunks) worked side by side

enum Mode { kSuccessor, kForward, kBackward };

// a probe build's per-warp time stamps at the phase boundaries
// (tools/torch_cross_timeline.py); nothing in the library
#ifndef CROSS_STAMP
#define CROSS_STAMP(phase, n, lane)
#endif

__device__ __forceinline__ size_t at(int l, int n, int s, int N, int S) {
  return (static_cast<size_t>(l) * N + n) * S + s;
}

// sample s's word in a stream's shared memory: one spare word every 32
__device__ __forceinline__ int pad(int s) { return s + (s >> 5); }

// the words of one stream in shared memory
__host__ __device__ constexpr int padded(int S) { return S + (S + 31) / 32; }

// the ray's L streams of x into the warp's shared memory, stream l from
// word l * padded(S): asynchronous copies (cp.async), every one in flight
// at once
__device__ __forceinline__ void load_ray(const float* __restrict__ x, float* sm, int n, int L,
                                        int N, int S, int lane) {
  for (int l = 0; l < L; ++l) {
    const float* row = x + at(l, n, 0, N, S);
    float* dst = sm + l * padded(S);
    for (int s = lane; s < S; s += kWarp) {
      const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + pad(s)));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(row + s)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void wait_loads() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();
}

// every stream of the ray non-decreasing and free of NaN, by a warp vote
__device__ __forceinline__ bool ray_sorted(const float* st, int L, int S, int lane) {
  bool bad = false;
  for (int l = 0; l < L; ++l) {
    const float* x = st + l * padded(S);
    for (int s = lane; s < S; s += kWarp) {
      const float a = x[pad(s)], b = x[pad(min(s + 1, S - 1))];
      bad |= (a != a) | (a > b);  // a NaN b is caught at its own sample
    }
  }
  return !__any_sync(kFull, bad);
}

// inclusive prefix sums of each of the L streams in place (reverse: suffix
// sums, from the stream's end): a shuffle scan of each chunk of 32, kGroup
// chunks side by side, then each chunk adds the running total of the ones
// before it, in order
__device__ __forceinline__ void scan_streams(float* sm, int L, int S, bool reverse, int lane) {
  for (int l = 0; l < L; ++l) {
    float* x = sm + l * padded(S);
    float carry = 0.0f;
    for (int base = 0; base < S; base += kWarp * kGroup) {
      float v[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int r = base + g * kWarp + lane;
        v[g] = r < S ? x[pad(reverse ? S - 1 - r : r)] : 0.0f;
      }
#pragma unroll
      for (int d = 1; d < kWarp; d <<= 1) {
#pragma unroll
        for (int g = 0; g < kGroup; ++g) {
          const float u = __shfl_up_sync(kFull, v[g], d);
          if (lane >= d) v[g] += u;
        }
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        v[g] += carry;
        const int r = base + g * kWarp + lane;
        if (r < S) x[pad(reverse ? S - 1 - r : r)] = v[g];
        carry = __shfl_sync(kFull, v[g], kWarp - 1);
      }
    }
  }
}

// the largest float below x (x not NaN), so that t < x is t <= below(x)
// for every t that is not NaN; NaN for x = -inf, below which lies nothing
__device__ __forceinline__ float below(float x) {
  if (x == 0.0f) return -__int_as_float(1);  // -0 and +0: the negative denormal
  if (x < -3.4028235e38f) return __int_as_float(0x7fffffff);
  const int b = __float_as_int(x);
  return __int_as_float(x > 0.0f ? b - 1 : b + 1);
}

// outputs s0 + 32 g (kGroup of them) of stream o on sorted streams, sv
// holding the scans; out_row is stream o's row of the ray
template <int kMode>
__device__ __forceinline__ void searched(const float* st, const float* sv,
                                         float* __restrict__ out_row, int L, int S, int o,
                                         int s0) {
  const int Sp = padded(S);
  float x[kGroup], acc[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    x[g] = st[o * Sp + pad(min(s0 + g * kWarp, S - 1))];
    acc[g] = kMode == kSuccessor ? kNoSuccessor : 0.0f;
  }
  for (int p = 0; p < L; ++p) {
    if (p == o) continue;
    const float* tp = st + p * Sp;
    // the count c of p's samples <= y: a branchless lower bound over
    // lengths that halve alike for every lane, then one compare
    float y[kGroup];
    int c[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      y[g] = p < o ? x[g] : below(x[g]);
      c[g] = 0;
    }
    for (int len = S; len > 1;) {
      const int half = len >> 1;
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        c[g] = tp[pad(c[g] + half - 1)] <= y[g] ? c[g] + half : c[g];
      len -= half;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      c[g] += tp[pad(c[g])] <= y[g] ? 1 : 0;
      if (kMode == kSuccessor) {
        if (c[g] < S) acc[g] = fminf(acc[g], tp[pad(c[g])]);
      } else if (kMode == kForward) {  // sum of p's log factors over j < c
        if (c[g] > 0) acc[g] += sv[p * Sp + pad(c[g] - 1)];
      } else {  // sum of p's cotangents over s >= c
        if (c[g] < S) acc[g] += sv[p * Sp + pad(c[g])];
      }
    }
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g)
    if (s0 + g * kWarp < S) out_row[s0 + g * kWarp] = acc[g];
}

// the plain form's min: a NaN candidate wins
__device__ __forceinline__ float min_nan(float best, float cand) {
  return (cand < best || cand != cand) ? cand : best;
}

// output s of stream o of the ray by the all-pairs loop
template <int kMode>
__device__ __forceinline__ float all_pairs(const float* st, const float* sv, int L, int S, int o,
                                           int s) {
  const int Sp = padded(S);
  const float x = st[o * Sp + pad(s)];
  float acc = kMode == kSuccessor ? kNoSuccessor : 0.0f;
  for (int p = 0; p < L; ++p) {
    if (p == o) continue;
    const float* tp = st + p * Sp;
    const float* vp = sv + p * Sp;
    for (int j = 0; j < S; ++j) {
      const float t = tp[pad(j)];
      if (kMode == kSuccessor) {
        acc = min_nan(acc, p < o ? (t > x ? t : kNoSuccessor) : (t < x ? kNoSuccessor : t));
      } else if (kMode == kForward) {  // p's sample j precedes x
        acc += (p < o ? t <= x : t < x) ? vp[pad(j)] : 0.0f;
      } else {  // x precedes p's sample j
        acc += (o < p ? x <= t : x < t) ? vp[pad(j)] : 0.0f;
      }
    }
  }
  return acc;
}

// t (L, N, S) depths; v the log factors (forward), the cotangents
// (backward) or unused (successor); out (L, N, S)
template <int kMode>
__global__ void cross_kernel(const float* __restrict__ t, const float* __restrict__ v,
                             float* __restrict__ out, int* __restrict__ pairwise, int L, int N,
                             int S) {
  extern __shared__ float sm[];
  constexpr int kOperands = kMode == kSuccessor ? 1 : 2;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n = blockIdx.x * (blockDim.x / kWarp) + warp;
  if (n >= N) return;  // the whole warp
  CROSS_STAMP(0, n, lane);
  float* st = sm + warp * kOperands * L * padded(S);
  float* sv = st + L * padded(S);
  load_ray(t, st, n, L, N, S, lane);
  if (kMode != kSuccessor) load_ray(v, sv, n, L, N, S, lane);
  wait_loads();
  CROSS_STAMP(1, n, lane);
  const bool sorted = ray_sorted(st, L, S, lane);
  CROSS_STAMP(2, n, lane);
  if (!sorted) {
    if (lane == 0 && pairwise != nullptr) atomicAdd(pairwise, 1);
    for (int o = 0; o < L; ++o)
      for (int s = lane; s < S; s += kWarp)
        out[at(o, n, s, N, S)] = all_pairs<kMode>(st, sv, L, S, o, s);
    return;
  }
  if (kMode != kSuccessor) {
    scan_streams(sv, L, S, kMode == kBackward, lane);
    __syncwarp();
  }
  CROSS_STAMP(3, n, lane);
  for (int o = 0; o < L; ++o)
    for (int s0 = lane; s0 < S; s0 += kWarp * kGroup)
      searched<kMode>(st, sv, out + at(o, n, 0, N, S), L, S, o, s0);
  CROSS_STAMP(4, n, lane);
}

// rays a block for one ray's operands in shared memory; 0 where one does
// not fit
int rays_per_block(int L, int S, int operands) {
  const long long ray_bytes = 4LL * operands * L * padded(S);
  if (ray_bytes > kMaxSharedBytes) return 0;
  const long long fit = kMaxSharedBytes / ray_bytes;
  return fit < kMaxRays ? static_cast<int>(fit) : kMaxRays;
}

template <int kMode>
int launch(const void* t, const void* v, void* out, void* pairwise, int L, int N, int S,
           void* stream) {
  constexpr int kOperands = kMode == kSuccessor ? 1 : 2;
  if (L < 1 || N < 0 || S < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int rays = rays_per_block(L, S, kOperands);
  if (rays == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const size_t shared = 4ull * rays * kOperands * L * padded(S);
  cross_kernel<kMode><<<(N + rays - 1) / rays, rays * kWarp, shared,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(t), static_cast<const float*>(v), static_cast<float*>(out),
      static_cast<int*>(pairwise), L, N, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stnerf_cross_successor(const void* t, void* out, void* pairwise, int L, int N,
                                      int S, void* stream) {
  return launch<kSuccessor>(t, nullptr, out, pairwise, L, N, S, stream);
}

extern "C" int stnerf_cross_logt_fwd(const void* t, const void* logf, void* out, void* pairwise,
                                     int L, int N, int S, void* stream) {
  return launch<kForward>(t, logf, out, pairwise, L, N, S, stream);
}

extern "C" int stnerf_cross_logt_bwd(const void* t, const void* g, void* d_logf, void* pairwise,
                                     int L, int N, int S, void* stream) {
  return launch<kBackward>(t, g, d_logf, pairwise, L, N, S, stream);
}
