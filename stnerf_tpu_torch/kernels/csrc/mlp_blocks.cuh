// Block-level matrix products of the SpaceNet-style MLP kernels on CUDA
// cores, shared by the float32 kernels: the SpaceNet forward on encoded
// inputs (spacenet.cu) and pass 1 of K2's and K3's backward (f32_bwd.cuh,
// field_bwd.cu).
//
// A block of THREADS threads works on BM samples whose activations sit in
// shared memory as (rows, BM), float or bf16 bits; weights are (in, out)
// row-major in global memory (read through L2), float or bf16 bits:
//   * fwd_seg / fwd_dense / fwd_dense1 / fwd_small: y = W^T x + b (+ ReLU
//     and rounding to the compute dtype), the concat inputs as split
//     products.
// The backward's products (dx = W dy, dW = x dy^T) are f32_bwd.cuh's.
#pragma once

#include "field_common.cuh"

namespace {

constexpr int THREADS = 256;

// N values of one row from shared memory (float or bf16 bits)
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

template <int N>
__device__ __forceinline__ void ld_vec(const unsigned short* p, float (&a)[N]) {
  if constexpr (N == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    a[0] = __uint_as_float(v.x << 16), a[1] = __uint_as_float(v.x & 0xffff0000u);
    a[2] = __uint_as_float(v.y << 16), a[3] = __uint_as_float(v.y & 0xffff0000u);
  } else if constexpr (N == 2) {
    const unsigned v = *reinterpret_cast<const unsigned*>(p);
    a[0] = __uint_as_float(v << 16), a[1] = __uint_as_float(v & 0xffff0000u);
  } else if constexpr (N == 8) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[2 * i] = __uint_as_float(w[i] << 16), a[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) a[i] = to_f(p[i]);
  }
}

// ---------------------------------------------------------------- forward

// acc[i][j] += sum_k W[k, to*TO + i] * in[k, tm*CPT + j]; W (K, O) row-major
// in global memory, in (K, BM) in shared memory. UNROLL k steps are
// unrolled: their weight loads from L2 in flight together.
template <typename WS, typename AS, int BM, int TO, int UNROLL = 4>
__device__ __forceinline__ void fwd_seg(float (&acc)[TO][BM / 8], const WS* __restrict__ w,
                                        int O, int K, const AS* in, int to, int tm) {
  constexpr int CPT = BM / 8;
  const WS* wp = w + to * TO;
  const AS* ip = in + tm * CPT;
#pragma unroll UNROLL
  for (int k = 0; k < K; ++k) {
    float wv[TO], a[CPT];
    load_w<WS, TO>(wp + static_cast<size_t>(k) * O, wv);
    ld_vec<CPT>(ip + k * BM, a);
#pragma unroll
    for (int i = 0; i < TO; ++i) {
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
    }
  }
}

// out = round(relu(W0^T in0 + W1^T in1 + W2^T in2 + bias)), O = 32 * TO rows;
// a segment with K = 0 is absent (the split products of a concat input).
template <typename WS, typename AS, bool RND, int BM, int TO>
__device__ void fwd_dense_t(const WS* w0, const AS* in0, int k0, const WS* w1, const AS* in1,
                            int k1, const WS* w2, const AS* in2, int k2,
                            const float* __restrict__ bias, AS* out) {
  constexpr int O = 32 * TO, CPT = BM / 8;
  const int to = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TO][CPT];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  fwd_seg<WS, AS, BM, TO>(acc, w0, O, k0, in0, to, tm);
  if (k1) fwd_seg<WS, AS, BM, TO>(acc, w1, O, k1, in1, to, tm);
  if (k2) fwd_seg<WS, AS, BM, TO>(acc, w2, O, k2, in2, to, tm);
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = to * TO + i;
    const float b = bias[o];
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      put(out + o * BM + tm * CPT + j, rnd<RND>(fmaxf(acc[i][j] + b, 0.f)));
    }
  }
}

template <typename WS, typename AS, bool RND, int BM>
__device__ void fwd_dense(const WS* w0, const AS* in0, int k0, const WS* w1, const AS* in1,
                          int k1, const WS* w2, const AS* in2, int k2, const float* bias,
                          int O, AS* out) {
  switch (O) {
    case 256: fwd_dense_t<WS, AS, RND, BM, 8>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 128: fwd_dense_t<WS, AS, RND, BM, 4>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 64: fwd_dense_t<WS, AS, RND, BM, 2>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 32: fwd_dense_t<WS, AS, RND, BM, 1>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
  }
}

template <typename WS, typename AS, bool RND, int BM>
__device__ __forceinline__ void fwd_dense1(const WS* w, const AS* in, int k, const float* bias,
                                           int O, AS* out) {
  fwd_dense<WS, AS, RND, BM>(w, in, k, w, in, 0, w, in, 0, bias, O, out);
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
