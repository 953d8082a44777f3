// Block-level products of the float32 backward kernels on CUDA cores: pass
// 1 of K2's and K3's backward (f32_bwd.cuh, field_bwd.cu) recomputes the
// forward with them.
//
// A block of THREADS threads works on BM samples whose activations sit in
// shared memory as float32 (rows, BM); weights are (in, out) row-major in
// global memory (read through L2):
//   * fwd_seg: acc += W^T x over one segment of a split product, each output
//     a chain of FMAs over k in order: the chain of the float32 forwards
//     (ring_dense.cuh), so the recompute gives their bits and ReLU masks;
//   * fwd_small: y = W^T x + b for a 1- or 3-wide output layer.
// The forwards themselves run on the weight ring (w_ring.cuh,
// ring_dense.cuh); the backward's products (dx = W dy, dW = x dy^T) are
// f32_bwd.cuh's.
#pragma once

#include "field_common.cuh"

namespace {

constexpr int THREADS = 256;

// N values of one row of floats from shared memory
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&a)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x, a[1] = v.y;
  } else if constexpr (N == 8) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    const float4 u = *reinterpret_cast<const float4*>(p + 4);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w, a[4] = u.x, a[5] = u.y, a[6] = u.z, a[7] = u.w;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = p[i];
  }
}

// acc[i][j] += sum_k W[k, to*TO + i] * in[k, tm*CPT + j]; W (K, O) row-major
// in global memory, in (K, BM) in shared memory. UNROLL k steps are
// unrolled: their weight loads from L2 in flight together. A thread's TO
// weights of a k step come as vectors of at most 8 (the operands are 64-byte
// aligned).
template <typename WS, typename AS, int BM, int TO, int UNROLL = 4>
__device__ __forceinline__ void fwd_seg(float (&acc)[TO][BM / 8], const WS* __restrict__ w,
                                        int O, int K, const AS* in, int to, int tm) {
  constexpr int CPT = BM / 8;
  constexpr int CH = TO < 8 ? TO : 8;
  const WS* wp = w + to * TO;
  const AS* ip = in + tm * CPT;
#pragma unroll UNROLL
  for (int k = 0; k < K; ++k) {
    float wv[TO], a[CPT];
#pragma unroll
    for (int c = 0; c < TO / CH; ++c) {
      float wc[CH];
      load_w<WS, CH>(wp + static_cast<size_t>(k) * O + c * CH, wc);
#pragma unroll
      for (int i = 0; i < CH; ++i) wv[c * CH + i] = wc[i];
    }
    ld_vec<CPT>(ip + k * BM, a);
#pragma unroll
    for (int i = 0; i < TO; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
    }
  }
}

// out = W^T in + bias for an O <= 4 wide output (no activation), float32
template <typename WS, typename AS, int BM>
__device__ void fwd_small(const WS* __restrict__ w, const AS* in, int K,
                          const float* __restrict__ bias, int O, float* out) {
  for (int i = threadIdx.x; i < O * BM; i += THREADS) {
    const int o = i / BM, m = i % BM;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(to_f(w[k * O + o]), to_f(in[k * BM + m]), acc);
    out[i] = acc + bias[o];
  }
}

}  // namespace
