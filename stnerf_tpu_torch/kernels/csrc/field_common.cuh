// Device helpers shared by the field kernels (fused_field*.cu, field_bwd*.cu,
// spacenet*.cu): the packed operand slots, bf16 storage and rounding, vector
// weight loads, the TPU kernels' positional encoding by double-angle
// recursion and its VJP, and the backward's fixed-order sum of partials.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int N_W = 21;  // weight slots, fused_field.py W_SLOTS
constexpr int N_B = 18;  // bias slots, fused_field.py B_SLOTS

enum WSlot { W_M0 = 0, W_1 = 6, W_S2A = 10, W_S2B, W_S2W2, W_S2W3, W_DW,
             W_R1A, W_R1B, W_R1C, W_RGB1, W_RGB2, W_RGB3 };
enum BSlot { B_M0 = 0, B_1 = 6, B_SB1 = 10, B_SB2, B_SB3, B_DB, B_RB1,
             B_RGB1, B_RGB2, B_RGB3 };

// weights and stored activations are float (f32 mode) or the 16 bits of a bf16
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}

// store a value that is already rounded to the storage type (exact)
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(unsigned short* p, float v) {
  *p = static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

template <bool RND>
__device__ __forceinline__ float rnd(float v) {
  if constexpr (RND) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

template <typename WS, int N>
struct alignas(sizeof(WS) * N) WVec {
  WS v[N];
};

// N consecutive values as one vector load: pack_field aligns every operand
// to 16 elements, and callers keep the offset a multiple of N.
template <typename WS, int N>
__device__ __forceinline__ void load_w(const WS* __restrict__ p, float (&w)[N]) {
  const WVec<WS, N> v = *reinterpret_cast<const WVec<WS, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = to_f(v.v[i]);
}

// sin/cos(2^(k+1) v) from sin/cos(2^k v), rounded as the PyTorch expression
// 2 * s * c, 1 - 2 * s * s (no FMA contraction)
__device__ __forceinline__ void next_octave(float& s, float& c) {
  const float ts = __fmul_rn(2.f, s);
  const float ns = __fmul_rn(ts, c);
  c = __fsub_rn(1.f, __fmul_rn(ts, s));
  s = ns;
}

// One channel (of C) of the TPU kernel's _encode, as the blend
// (1 - wt) * enc(v_lo) + wt * enc(v_hi) (wt = 0 and v_hi = v_lo give
// enc(v_lo) exactly), each row's value handed to emit(row, value). Rows:
// [v (C) | sin, cos (C each) per octave]; every value rounded to the compute
// dtype, and clipped at 0 when `relu`.
template <bool RND, class Emit>
__device__ void encode_rows(float v_lo, float v_hi, float wt, int ch, int C, int freqs,
                            int inc, bool relu, Emit emit) {
  const float omw = __fsub_rn(1.f, wt);
  auto blend = [&](int row, float lo, float hi) {
    const float v = rnd<RND>(__fadd_rn(__fmul_rn(omw, lo), __fmul_rn(wt, hi)));
    emit(row, relu ? fmaxf(v, 0.f) : v);
  };
  int base = 0;
  if (inc) {
    blend(ch, v_lo, v_hi);
    base = C;
  }
  float s0 = sinf(v_lo), c0 = cosf(v_lo), s1 = sinf(v_hi), c1 = cosf(v_hi);
  for (int k = 0; k < freqs; ++k) {
    if (k) {
      next_octave(s0, c0);
      next_octave(s1, c1);
    }
    blend(base + 2 * C * k + ch, s0, s1);
    blend(base + 2 * C * k + C + ch, c0, c1);
  }
}

// encode_rows into rows of `stride` samples at column m
template <bool RND, typename DS>
__device__ void encode(float v_lo, float v_hi, float wt, int ch, int C, int freqs,
                       int inc, bool relu, DS* dst, int stride, int m) {
  encode_rows<RND>(v_lo, v_hi, wt, ch, C, freqs, inc, relu,
                   [=](int row, float v) { put(dst + row * stride + m, v); });
}

// VJP of one channel (of C) of the encoding wrt its raw input v, with the
// cotangent rows dE (float32, stride samples) scaled by `mul`: the
// forward's sin/cos, recomputed by the same recursion, are the derivative
// factors (field_vjp.py::_encode_vjp).
__device__ float encode_vjp(float v, const float* dE, int ch, int C, int freqs, int inc,
                            float mul, int stride, int m) {
  float d = 0.f;
  int base = 0;
  if (inc) {
    d = __fmul_rn(mul, dE[ch * stride + m]);
    base = C;
  }
  float s = sinf(v), c = cosf(v), scale = 1.f;
  for (int k = 0; k < freqs; ++k) {
    if (k) next_octave(s, c);
    const float ds = __fmul_rn(mul, dE[(base + 2 * C * k + ch) * stride + m]);
    const float dc = __fmul_rn(mul, dE[(base + 2 * C * k + C + ch) * stride + m]);
    d = __fadd_rn(d, __fmul_rn(scale, __fsub_rn(__fmul_rn(c, ds), __fmul_rn(s, dc))));
    scale = 2.f * scale;
  }
  return d;
}

// The layer widths the kernels tile (fused_field.py KERNEL_WIDTHS). Every
// kernel, forward and backward, picks a sample block per launch that fits
// the activations of a layer up to 1024 wide in shared memory.
bool fwd_width(int w) {
  return w == 32 || w == 64 || w == 128 || w == 256 || w == 512 || w == 1024;
}

// Pass 3 of the backward kernels' weight gradients (tc_bwd.cuh, f32_bwd.cuh):
// out[i] = sum over ranges of partial[range][i], in range order: the weight
// gradients, then the bias gradients. The same sum on every run.
__global__ void field_dw_reduce(const float* __restrict__ partial, int ranges, int n_w, int n_b,
                                float* __restrict__ gw, float* __restrict__ gb) {
  const int n = n_w + n_b;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < ranges; ++r) s += partial[static_cast<size_t>(r) * n + i];
  if (i < n_w) {
    gw[i] = s;
  } else {
    gb[i - n_w] = s;
  }
}

}  // namespace
