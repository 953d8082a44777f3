// Backward of the fused field on Hopper (sm_90a).
//
// Replaces stnerf_tpu/kernels/field_vjp.py::_call_bwd (the Pallas TPU kernel
// _field_bwd_kernel / _field_bwd_body, with spacenet_vjp._bwd_math). Per
// block of BM samples it recomputes the whole field forward — motion
// encoding, the 6-layer flow MLP, the encoding of the displaced positions,
// the SpaceNet trunk and both heads — then backpropagates the rgb and sigma
// cotangents through all of it and emits:
//   * weight and bias gradients in float32, in the packed operand layout of
//     fused_field.py (pack_field's offsets), summed over every block;
//   * d_xyz (3, M) and d_dir_enc (dir_rows, M) in float32.
// A sample tile whose skip flag is 0 (flags cover 64 samples, the tile of
// fused_field.cu) writes zero d_xyz and d_dir and adds nothing.
//
// Bound: about 3x the forward's arithmetic per sample (recompute, dx = W dy,
// dW = x dy^T) against ~80 bytes of sample input and output, so arithmetic
// bounds it, as the forward. The weights stream from L2.
//
// The simple design, and what it gives up:
//   * CUDA-core FMA loops, no tensor cores, no TMA, one block per SM
//     (8 warps), as fused_field.cu.
//   * Shared memory holds one tile's activations in the compute dtype
//     (bf16 or float32, exactly the rounding the TPU kernel applies to its
//     saved activations), float32 cotangents, and the encodings. The seven
//     trunk activations, both heads' and the motion net's do not fit at
//     width 256 (7 x 256 x 64 x 2 bytes for the trunk alone), so a block
//     covers BM = 32 samples in bf16 and 16 in float32 (2 or 4 blocks per
//     skip flag), keeps only trunk layers 4-7 through the head and stage-2
//     backward, recomputes layers 1-3 after it, and recomputes the motion
//     net at the end (about 13% more arithmetic than saving everything).
//   * The cross-block sum of the weight gradients: the TPU kernel revisits
//     one output block in grid order; CUDA blocks run in no order, so each
//     block adds its partial sums to global memory with atomics (atomicAdd
//     with the result unused: a reduction in L2), four weights per float4
//     atomic. The order of the additions changes from run to run, so
//     float32 results agree with the plain version to a tolerance, not
//     bitwise. With scalar atomics, one per weight and block, the bf16
//     performer field took 49.0 ms at M = 240,000; with float4 atomics
//     35.5 ms (chip_smoke.py on an H100 80GB HBM3, 700 W; PERF.md).
// Numerics follow the TPU kernel: every cotangent is rounded to the compute
// dtype where it casts (dy.astype(dtype) after each product), the masks of
// ReLU compare the stored activation with 0, the position-encoding and
// direction gradients and the motion net's input gradient stay float32.

#include "field_common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int FLAG_TILE = 64;  // samples per skip flag (fused_field.cu's BM)

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb,
      motion_mode;
  int pos_rows, time_rows, menc_rows, g_rows, u_rows;
};

// N values of one row from shared memory (float or bf16 bits)
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&a)[N]) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x, a[1] = v.y, a[2] = v.z, a[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x, a[1] = v.y;
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

// VJP of one channel (of C) of the encoding wrt its raw input v, with the
// cotangent rows dE (stride BM) scaled by `mul`: the forward's sin/cos,
// recomputed by the same recursion, are the derivative factors
// (field_vjp.py::_encode_vjp).
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

// Motion net forward: encode (xyz, id) into U's first menc_rows rows, the
// five hidden layers after them, the flow (3 rows, float32) into R.
template <typename WS, bool RND, int BM>
__device__ void motion_forward(const Params& p, const WS* wts, const float* bias,
                               const float* X, WS* U, float* R) {
  const int t = threadIdx.x;
  if (t < 4 * BM) {
    const int ch = t / BM, m = t % BM;
    const float v = X[ch * BM + m];
    if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
      const float id = X[3 * BM + m];
      const float lo = floorf(id);
      const float wt = __fsub_rn(id, lo);
      encode<RND>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v, wt, ch, 4, p.freqs,
                  p.inc, false, U, BM, m);
    } else {
      encode<RND>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, U, BM, m);
    }
  }
  __syncthreads();
  const int mw = p.motion_width;
  const WS* prev = U;
  int k_in = p.menc_rows;
  for (int k = 0; k < 5; ++k) {
    WS* out = U + (p.menc_rows + k * mw) * BM;
    fwd_dense1<WS, WS, RND, BM>(wts + p.w_off[W_M0 + k], prev, k_in, bias + p.b_off[B_M0 + k],
                                mw, out);
    __syncthreads();
    prev = out;
    k_in = mw;
  }
  fwd_small<WS, WS, BM>(wts + p.w_off[W_M0 + 5], prev, mw, bias + p.b_off[B_M0 + 5], 3, R);
  __syncthreads();
}

template <typename WS, bool RND, int BM>
__global__ void __launch_bounds__(THREADS, 1)
field_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                 const float* __restrict__ dir, const float* __restrict__ drgb,
                 const float* __restrict__ dsig, const int* __restrict__ flags,
                 const WS* __restrict__ wts, const float* __restrict__ bias,
                 float* __restrict__ gw, float* __restrict__ gb, float* __restrict__ dxyz,
                 float* __restrict__ ddir, const Params p) {
  static_assert(BM % 8 == 0 && FLAG_TILE % BM == 0 && 4 * BM <= THREADS, "tile shape");
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (flags != nullptr && flags[m0 / FLAG_TILE] == 0) {
    for (int i = t; i < (3 + p.dir_rows) * BM; i += THREADS) {
      const int r = i / BM, gm = m0 + i % BM;
      if (gm < M) {
        if (r < 3) {
          dxyz[static_cast<size_t>(r) * M + gm] = 0.f;
        } else {
          ddir[static_cast<size_t>(r - 3) * M + gm] = 0.f;
        }
      }
    }
    return;
  }
  const int W = p.width, H = p.head, kp = p.pos_rows;
  float* X = reinterpret_cast<float*>(smem4);  // 4: xyz, id
  float* XD = X + 4 * BM;                      // 3: displaced xyz
  float* R = XD + 3 * BM;                      // 4: flow, or the sigma cotangent
  float* G0 = R + 4 * BM;                      // g_rows: cotangents, ping
  float* G1 = G0 + p.g_rows * BM;              // g_rows: pong
  float* DP = G1 + p.g_rows * BM;              // pos_rows: d(position encoding)
  WS* P = reinterpret_cast<WS*>(DP + kp * BM);  // pos_rows: position encoding
  WS* D = P + kp * BM;                         // dir_rows: relu(direction encoding)
  WS* T = D + p.dir_rows * BM;                 // time_rows: relu(time encoding)
  WS* U = T + p.time_rows * BM;                // u_rows: trunk and head, or motion
  WS* S0 = U;                                  // four trunk slots of W rows
  WS* S1 = U + W * BM;
  WS* S2 = U + 2 * W * BM;
  WS* S3 = U + 3 * W * BM;
  WS* HS[3] = {U + 4 * W * BM, U + (4 * W + H) * BM, U + (4 * W + 2 * H) * BM};

  const auto Wt = [&](int slot) { return wts + p.w_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const auto GW = [&](int slot) { return gw + p.w_off[slot]; };
  const auto GB = [&](int slot) { return gb + p.b_off[slot]; };
  // the next cotangent: round(W dy), masked where the stored activation is 0
  const auto mask_round = [](float* out, const WS* act) {
    return [=](int k, int m, float acc) {
      out[k * BM + m] = to_f(act[k * BM + m]) > 0.f ? rnd<RND>(acc) : 0.f;
    };
  };

  for (int i = t; i < 4 * BM; i += THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  // ---- forward: deformation, encodings, trunk, rgb head ----
  if (p.motion_mode) {
    motion_forward<WS, RND, BM>(p, wts, bias, X, U, R);
    if (t < 3 * BM) XD[t] = __fadd_rn(X[t], R[t]);
  } else if (t < 3 * BM) {
    XD[t] = X[t];
  }
  __syncthreads();
  if (t < 4 * BM) {
    const int ch = t / BM, m = t % BM;
    if (ch < 3) {
      const float v = XD[ch * BM + m];
      encode<RND>(v, v, 0.f, ch, 3, p.freqs, p.inc, false, P, BM, m);
    } else if (p.use_time) {
      const float v = X[3 * BM + m];
      encode<RND>(v, v, 0.f, 0, 1, p.freqs, p.inc, true, T, BM, m);
    }
  }
  for (int i = t; i < p.dir_rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? dir[static_cast<size_t>(i / BM) * M + gm] : 0.f;
    put(D + i, fmaxf(rnd<RND>(v), 0.f));
  }
  __syncthreads();
  // a0 -> S0, a1 -> S2, a2 -> S3, a3 -> S1, a4 -> S2, a5 -> S3, a6 -> S0
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1), P, kp, Bi(B_1), W, S0);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 1), S0, W, Bi(B_1 + 1), W, S2);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 2), S2, W, Bi(B_1 + 2), W, S3);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 3), S3, W, Bi(B_1 + 3), W, S1);
  __syncthreads();
  fwd_dense<WS, WS, RND, BM>(Wt(W_S2A), S1, W, Wt(W_S2B), P, kp, Wt(W_S2B), P, 0, Bi(B_SB1),
                             W, S2);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_S2W2), S2, W, Bi(B_SB2), W, S3);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_S2W3), S3, W, Bi(B_SB3), W, S0);
  __syncthreads();
  // rgb head: relu([a6 | dir | time]); a6 >= 0, D and T hold relu'd values
  fwd_dense<WS, WS, RND, BM>(Wt(W_R1A), S0, W, Wt(W_R1B), D, p.dir_rows, Wt(W_R1C), T,
                             p.use_time ? p.time_rows : 0, Bi(B_RB1), H, HS[0]);
  __syncthreads();
  for (int i = 1; i < p.n_rgb - 1; ++i) {
    fwd_dense1<WS, WS, RND, BM>(Wt(W_RGB1 + i - 1), HS[i - 1], H, Bi(B_RGB1 + i - 1), H, HS[i]);
    __syncthreads();
  }

  // ---- rgb head backward ----
  for (int i = t; i < 3 * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    G0[i] = gm < M ? rnd<RND>(drgb[static_cast<size_t>(i / BM) * M + gm]) : 0.f;
  }
  for (int i = t; i < BM; i += THREADS) {
    const int gm = m0 + i;
    R[i] = gm < M ? rnd<RND>(dsig[gm]) : 0.f;
  }
  __syncthreads();
  float* gc = G0;
  float* gn = G1;
  const auto swap = [&]() {
    float* tmp = gc;
    gc = gn;
    gn = tmp;
  };
  for (int i = p.n_rgb - 2; i >= 0; --i) {
    const int O = i == p.n_rgb - 2 ? 3 : H;
    grad_w<WS, BM>(HS[i], H, gc, O, GW(W_RGB1 + i));
    grad_b<BM>(gc, O, GB(B_RGB1 + i));
    bwd_dx<WS, BM>(Wt(W_RGB1 + i), H, O, gc, mask_round(gn, HS[i]));
    __syncthreads();
    swap();
  }
  // gc: d(first head layer, pre-ReLU); its inputs are [a6 | dir | time]
  grad_b<BM>(gc, H, GB(B_RB1));
  grad_w<WS, BM>(S0, W, gc, H, GW(W_R1A));
  grad_w<WS, BM>(D, p.dir_rows, gc, H, GW(W_R1B));
  if (p.use_time) grad_w<WS, BM>(T, p.time_rows, gc, H, GW(W_R1C));
  bwd_dx<WS, BM>(Wt(W_R1B), p.dir_rows, H, gc, [=](int k, int m, float acc) {
    const int gm = m0 + m;
    if (gm < M) ddir[static_cast<size_t>(k) * M + gm] = to_f(D[k * BM + m]) > 0.f ? acc : 0.f;
  });
  // d(a6) from the head, plus the density head's dw * d_sigma, masked by a6
  const WS* dw = Wt(W_DW);
  bwd_dx<WS, BM>(Wt(W_R1A), W, H, gc, [=](int k, int m, float acc) {
    const float v = rnd<RND>(__fadd_rn(rnd<RND>(acc), __fmul_rn(to_f(dw[k]), R[m])));
    gn[k * BM + m] = to_f(S0[k * BM + m]) > 0.f ? v : 0.f;
  });
  grad_w<WS, BM>(S0, W, R, 1, GW(W_DW));
  grad_b<BM>(R, 1, GB(B_DB));
  __syncthreads();
  swap();

  // ---- stage 2 backward ----
  grad_w<WS, BM>(S3, W, gc, W, GW(W_S2W3));  // a6 = relu(s2w3^T a5 + sb3)
  grad_b<BM>(gc, W, GB(B_SB3));
  bwd_dx<WS, BM>(Wt(W_S2W3), W, W, gc, mask_round(gn, S3));
  __syncthreads();
  swap();
  grad_w<WS, BM>(S2, W, gc, W, GW(W_S2W2));  // a5 = relu(s2w2^T a4 + sb2)
  grad_b<BM>(gc, W, GB(B_SB2));
  bwd_dx<WS, BM>(Wt(W_S2W2), W, W, gc, mask_round(gn, S2));
  __syncthreads();
  swap();
  grad_w<WS, BM>(S1, W, gc, W, GW(W_S2A));  // a4 = relu(s2a^T a3 + s2b^T p + sb1)
  grad_w<WS, BM>(P, kp, gc, W, GW(W_S2B));
  grad_b<BM>(gc, W, GB(B_SB1));
  bwd_dx<WS, BM>(Wt(W_S2B), kp, W, gc, [=](int k, int m, float acc) { DP[k * BM + m] = acc; });
  bwd_dx<WS, BM>(Wt(W_S2A), W, W, gc, mask_round(gn, S1));
  __syncthreads();
  swap();

  // ---- stage 1: recompute a0-a2 into the dead slots, then backward ----
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1), P, kp, Bi(B_1), W, S0);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 1), S0, W, Bi(B_1 + 1), W, S2);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 2), S2, W, Bi(B_1 + 2), W, S3);
  __syncthreads();
  WS* const a_in[3] = {S3, S2, S0};  // inputs of layers 4, 3, 2: a2, a1, a0
  for (int l = 3; l >= 1; --l) {
    WS* x = a_in[3 - l];
    grad_w<WS, BM>(x, W, gc, W, GW(W_1 + l));
    grad_b<BM>(gc, W, GB(B_1 + l));
    bwd_dx<WS, BM>(Wt(W_1 + l), W, W, gc, mask_round(gn, x));
    __syncthreads();
    swap();
  }
  grad_w<WS, BM>(P, kp, gc, W, GW(W_1));
  grad_b<BM>(gc, W, GB(B_1));
  bwd_dx<WS, BM>(Wt(W_1), kp, W, gc,
                 [=](int k, int m, float acc) { DP[k * BM + m] = __fadd_rn(acc, DP[k * BM + m]); });
  __syncthreads();

  // ---- d(displaced xyz) through the position encoding ----
  const int ch = t / BM, m = t % BM;
  float dx_out = 0.f;
  if (t < 3 * BM) dx_out = encode_vjp(XD[t], DP, ch, 3, p.freqs, p.inc, 1.f, BM, m);

  // ---- motion net backward (its forward recomputed) ----
  if (p.motion_mode) {
    if (t < 3 * BM) gc[t] = rnd<RND>(dx_out);
    motion_forward<WS, RND, BM>(p, wts, bias, X, U, R);
    const int mw = p.motion_width;
    for (int k = 5; k >= 1; --k) {
      WS* x = U + (p.menc_rows + (k - 1) * mw) * BM;
      const int O = k == 5 ? 3 : mw;
      grad_w<WS, BM>(x, mw, gc, O, GW(W_M0 + k));
      grad_b<BM>(gc, O, GB(B_M0 + k));
      bwd_dx<WS, BM>(Wt(W_M0 + k), mw, O, gc, mask_round(gn, x));
      __syncthreads();
      swap();
    }
    grad_w<WS, BM>(U, p.menc_rows, gc, mw, GW(W_M0));
    grad_b<BM>(gc, mw, GB(B_M0));
    bwd_dx<WS, BM>(Wt(W_M0), p.menc_rows, mw, gc,
                   [=](int k, int m, float acc) { gn[k * BM + m] = acc; });
    __syncthreads();
    swap();
    // gc: d(motion encoding), float32; x_d = xyz + flow(xyz), both paths feed d_xyz
    if (t < 3 * BM) {
      const float v = X[t];
      float d_m;
      if (p.motion_mode == 2) {  // enc = (1-w) e_lo + w e_hi; w is not differentiated
        const float id = X[3 * BM + m];
        const float wt = __fsub_rn(id, floorf(id));
        d_m = __fadd_rn(encode_vjp(v, gc, ch, 4, p.freqs, p.inc, __fsub_rn(1.f, wt), BM, m),
                        encode_vjp(v, gc, ch, 4, p.freqs, p.inc, wt, BM, m));
      } else {
        d_m = encode_vjp(v, gc, ch, 4, p.freqs, p.inc, 1.f, BM, m);
      }
      dx_out = __fadd_rn(dx_out, d_m);
    }
  }
  if (t < 3 * BM && m0 + m < M) dxyz[static_cast<size_t>(ch) * M + m0 + m] = dx_out;
}

template <typename WS, bool RND, int BM>
cudaError_t launch(const Params& p, const float* xyz, const float* ids, const float* dir,
                   const float* drgb, const float* dsig, const int* flags, const void* weights,
                   const float* biases, float* gw, float* gb, float* dxyz, float* ddir,
                   cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(4 + 3 + 4 + 2 * p.g_rows + p.pos_rows) * BM * sizeof(float) +
      static_cast<size_t>(p.pos_rows + p.dir_rows + p.time_rows + p.u_rows) * BM * sizeof(WS);
  auto kern = field_bwd_kernel<WS, RND, BM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(xyz, ids, dir, drgb, dsig, flags,
                                        static_cast<const WS*>(weights), biases, gw, gb, dxyz,
                                        ddir, p);
  return cudaGetLastError();
}

int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

// C entry point. Pointers are device pointers except `offsets`, a host array
// of N_W weight then N_B bias element offsets (-1 = absent operand). gw and
// gb (float32, the packed buffers' sizes) must be zeroed by the caller: the
// kernel adds into them. Returns the CUDA error of the launch (0 = launched).
extern "C" int stnerf_field_bwd(const void* xyz, const void* ids, const void* dir,
                                const void* drgb, const void* dsig, const void* flags,
                                const void* weights, const void* biases, const void* offsets,
                                void* gw, void* gb, void* dxyz, void* ddir, int M, int dir_rows,
                                int width, int head, int motion_width, int freqs,
                                int include_input, int use_time, int n_rgb, int motion_mode,
                                int bf16, void* stream) {
  if (M <= 0 || dir_rows <= 0 || !kernel_width(width) || !kernel_width(head) ||
      (motion_mode != 0 && !kernel_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const int* off = static_cast<const int*>(offsets);
  for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
  const int per = (include_input ? 1 : 0) + 2 * freqs;
  p.M = M;
  p.dir_rows = dir_rows;
  p.width = width;
  p.head = head;
  p.motion_width = motion_width;
  p.freqs = freqs;
  p.inc = include_input ? 1 : 0;
  p.use_time = use_time ? 1 : 0;
  p.n_rgb = n_rgb;
  p.motion_mode = motion_mode;
  p.pos_rows = 3 * per;
  p.time_rows = use_time ? per : 0;
  p.menc_rows = motion_mode ? 4 * per : 0;
  p.g_rows = imax(imax(width, head), motion_mode ? imax(motion_width, p.menc_rows) : 0);
  p.u_rows = imax(4 * width + (n_rgb - 1) * head,
                  motion_mode ? p.menc_rows + 5 * motion_width : 0);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(xyz);
  const auto* fi = static_cast<const float*>(ids);
  const auto* fd = static_cast<const float*>(dir);
  const auto* fr = static_cast<const float*>(drgb);
  const auto* fs = static_cast<const float*>(dsig);
  const auto* fl = static_cast<const int*>(flags);
  const auto* fb = static_cast<const float*>(biases);
  auto* gwf = static_cast<float*>(gw);
  auto* gbf = static_cast<float*>(gb);
  auto* fdx = static_cast<float*>(dxyz);
  auto* fdd = static_cast<float*>(ddir);
  // bf16: activations in bf16, 32 samples a block (~172 KB of shared memory
  // at the taekwondo widths); float32: 16 samples a block (~135 KB)
  const cudaError_t e =
      bf16 ? launch<unsigned short, true, 32>(p, fx, fi, fd, fr, fs, fl, weights, fb, gwf, gbf,
                                              fdx, fdd, s)
           : launch<float, false, 16>(p, fx, fi, fd, fr, fs, fl, weights, fb, gwf, gbf, fdx,
                                      fdd, s);
  return static_cast<int>(e);
}
