// Block-level matrix products of the SpaceNet-style MLP kernels on CUDA
// cores, shared by the backward of the fused field (field_bwd.cu) and the
// SpaceNet forward and backward on encoded inputs (spacenet.cu).
//
// A block of THREADS threads works on BM samples whose activations sit in
// shared memory as (rows, BM), float or bf16 bits; weights are (in, out)
// row-major in global memory (read through L2), float or bf16 bits:
//   * fwd_dense / fwd_dense1 / fwd_small: y = W^T x + b (+ ReLU and rounding
//     to the compute dtype), the concat inputs as split products;
//   * grad_w / grad_b: the weight and bias gradients of one layer over the
//     block's samples, added to global memory with float4 / scalar atomics;
//   * bwd_dx: d(input) = W dy, handed to an epilogue per (row, sample).
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
// in global memory, in (K, BM) in shared memory.
template <typename WS, typename AS, int BM, int TO>
__device__ __forceinline__ void fwd_seg(float (&acc)[TO][BM / 8], const WS* __restrict__ w,
                                        int O, int K, const AS* in, int to, int tm) {
  constexpr int CPT = BM / 8;
  const WS* wp = w + to * TO;
  const AS* ip = in + tm * CPT;
#pragma unroll 4
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

// --------------------------------------------------------------- backward

// gw[k, o] += sum_m X[k, m] * dY[o, m] over the block's BM samples; X (K, BM)
// stored activations, dY (O, BM) float32 cotangents, gw (K, O) row-major
// float32 in global memory. Each thread owns 4 x 4 outputs and walks the
// samples from a rotated start, so that the threads of a quarter warp read
// different 16-byte chunks of a row (rows are BM values long and would
// otherwise all start on the same bank). It adds each row of 4 with one
// float4 atomic (sm_90): a quarter of the scalar atomics' instructions.
template <typename AS, int BM>
__device__ void grad_w(const AS* X, int K, const float* dY, int O, float* __restrict__ gw) {
  const int kt_n = (K + 3) / 4, ot_n = (O + 3) / 4;
  const int rot = (threadIdx.x % 8) * 4 % BM;
  for (int tile = threadIdx.x; tile < kt_n * ot_n; tile += THREADS) {
    const int k0 = (tile % kt_n) * 4, o0 = (tile / kt_n) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    }
    for (int s = 0; s < BM; s += 4) {
      const int m = (s + rot) % BM;
      float x[4][4], y[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (k0 + i < K) {
          ld_vec<4>(X + (k0 + i) * BM + m, x[i]);
        } else {
          x[i][0] = x[i][1] = x[i][2] = x[i][3] = 0.f;
        }
        if (o0 + i < O) {
          ld_vec<4>(dY + (o0 + i) * BM + m, y[i]);
        } else {
          y[i][0] = y[i][1] = y[i][2] = y[i][3] = 0.f;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j] = fmaf(x[i][c], y[j][c], acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + i >= K) continue;
      float* g = gw + (k0 + i) * O + o0;
      if (O % 4 == 0) {  // 16-byte aligned: offsets are multiples of 16 elements
        atomicAdd(reinterpret_cast<float4*>(g),
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
      } else {
        for (int j = 0; j < 4 && o0 + j < O; ++j) atomicAdd(g + j, acc[i][j]);
      }
    }
  }
}

// gb[o] += sum_m dY[o, m]; each thread starts at its own sample (no bank
// conflicts between rows)
template <int BM>
__device__ void grad_b(const float* dY, int O, float* __restrict__ gb) {
  for (int o = threadIdx.x; o < O; o += THREADS) {
    float s = 0.f;
    for (int i = 0; i < BM; ++i) s += dY[o * BM + (i + o) % BM];
    atomicAdd(gb + o, s);
  }
}

// epi(k, m, sum_o W[k, o] dY[o, m]) for K = 32 * TK rows; W (K, O) row-major
// in global memory (the forward's (in, out) operand), dY (O, BM).
template <typename WS, int BM, int TK, class Epi>
__device__ void bwd_dx_t(const WS* __restrict__ w, int O, const float* dY, Epi epi) {
  constexpr int CPT = BM / 8;
  const int tk = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TK][CPT];
#pragma unroll
  for (int i = 0; i < TK; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  if (O % 4 == 0) {
    for (int o = 0; o < O; o += 4) {
      float y[4][CPT];
#pragma unroll
      for (int q = 0; q < 4; ++q) ld_vec<CPT>(dY + (o + q) * BM + tm * CPT, y[q]);
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        float wv[4];
        load_w<WS, 4>(w + static_cast<size_t>(tk * TK + i) * O + o, wv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv[q], y[q][j], acc[i][j]);
        }
      }
    }
  } else {
    for (int o = 0; o < O; ++o) {
      float y[CPT];
      ld_vec<CPT>(dY + o * BM + tm * CPT, y);
#pragma unroll
      for (int i = 0; i < TK; ++i) {
        const float wv = to_f(w[(tk * TK + i) * O + o]);
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv, y[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < TK; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) epi(tk * TK + i, tm * CPT + j, acc[i][j]);
  }
}

// the same for any K (the encodings' 63, 27 and 84 rows): one thread per
// (row, 4 samples)
template <typename WS, int BM, class Epi>
__device__ void bwd_dx_any(const WS* __restrict__ w, int K, int O, const float* dY, Epi epi) {
  constexpr int Q = BM / 4;
  for (int i = threadIdx.x; i < K * Q; i += THREADS) {
    const int k = i / Q, m = (i % Q) * 4;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int o = 0; o < O; ++o) {
      const float wv = to_f(w[k * O + o]);
      float y[4];
      ld_vec<4>(dY + o * BM + m, y);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = fmaf(wv, y[c], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) epi(k, m + c, acc[c]);
  }
}

template <typename WS, int BM, class Epi>
__device__ void bwd_dx(const WS* w, int K, int O, const float* dY, Epi epi) {
  switch (K) {
    case 256: bwd_dx_t<WS, BM, 8>(w, O, dY, epi); break;
    case 128: bwd_dx_t<WS, BM, 4>(w, O, dY, epi); break;
    case 64: bwd_dx_t<WS, BM, 2>(w, O, dY, epi); break;
    case 32: bwd_dx_t<WS, BM, 1>(w, O, dY, epi); break;
    default: bwd_dx_any<WS, BM>(w, K, O, dY, epi); break;
  }
}

}  // namespace
