// Fused field evaluation on Hopper (sm_90a).
//
// Replaces stnerf_tpu/kernels/fused_field.py::fused_field (the Pallas TPU
// kernel: _kernel, _kernel_body, _encode). Per block of BM = 64 samples,
// with every intermediate in shared memory:
//   1. optional MotionNet: encode (xyz, id) — for "lerp" the floor/ceil
//      blend of the id's encoding — run the 6-layer flow MLP, add the flow
//      to xyz;
//   2. encode xyz (double-angle recursion, as the TPU kernel's _encode);
//   3. SpaceNet: 4 trunk layers, the skip layer as split products over
//      [trunk | pos_enc], 2 more layers, the density head, and the rgb head
//      behind a ReLU over [features | dir_enc | time_enc].
// Outputs raw rgb (rows 0-2) and sigma (row 3) of a (4, M) float32 array.
// A block whose skip flag is 0 writes zeros and computes nothing.
//
// Bound: about 1 MFLOP per sample against ~40 bytes of sample input and
// output (fused_field.py:184-188), so arithmetic, not memory, bounds it.
// The weights (~1.1 MB in bf16 per field) are read from global memory by
// every block and stay resident in the 50 MB L2.
//
// The simple design, and what it gives up:
//   * CUDA-core FMA loops: each of 256 threads keeps a TO x 8 register tile
//     of one layer's outputs (TO = width / 32) and walks the reduction
//     axis, reading a vector of TO weights from global memory (L2) and 8
//     activations from shared memory per step. No tensor cores (no wmma or
//     wgmma), no TMA, no staging of weights in shared memory, no overlap of
//     loads with math: the FMA pipes' peak is the ceiling, far below the
//     tensor cores'.
//   * Activations are float32 in shared memory (two ping-pong buffers of
//     width x 64, ~160 KB in all at width 256), so one block fits per SM:
//     8 warps to hide the latency of L2 weight reads.
//   * The 1- and 3-wide output layers use one thread per output, with idle
//     threads beside them.
// Numerics: products accumulate in float32. In bf16 mode the weights are
// stored in bf16 and every activation is rounded to bf16 where the TPU
// kernel casts it (astype(dtype)); a product of two bf16 values is exact in
// float32, so this equals a bf16 matmul with float32 accumulation. The
// encodings use IEEE sinf/cosf and explicitly rounded products (no FMA
// contraction), matching the plain PyTorch version's elementwise ops.

#include "field_common.cuh"

namespace {

constexpr int BM = 64;        // samples per block: the tile of the skip flags
constexpr int THREADS = 256;  // 4 * BM: one thread per (channel, sample) when
                              // encoding (xyz, id)
static_assert(THREADS == 4 * BM, "encoding assigns one thread per (channel, sample)");

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb,
      motion_mode;
  int rows_a, pos_rows, time_rows, menc_rows;
};

// acc[i][j] += sum_k W[k, to*TO + i] * in[k, col(j)], W (K, O) row-major in
// global memory, in (K, BM) in shared memory. A thread's 8 columns are
// tm*4 + {0..3} and 32 + tm*4 + {0..3}: each quarter-warp's float4 loads
// then cover 128 contiguous bytes (no bank conflicts).
template <typename WS, int TO>
__device__ __forceinline__ void mm_seg(float (&acc)[TO][8], const WS* __restrict__ w,
                                       int O, int K, const float* in, int to, int tm) {
  const WS* wp = w + to * TO;
  const float* ip = in + tm * 4;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float wv[TO];
    load_w<WS, TO>(wp + static_cast<size_t>(k) * O, wv);
    const float4 a0 = *reinterpret_cast<const float4*>(ip + k * BM);
    const float4 a1 = *reinterpret_cast<const float4*>(ip + k * BM + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < TO; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
    }
  }
}

// out = round(relu(W0 in0 + W1 in1 + W2 in2 + bias)), O = 32 * TO rows;
// a segment with K = 0 is absent (the split products of a concat input).
template <typename WS, bool RND, int TO>
__device__ void dense_t(const WS* w0, const float* in0, int k0,
                        const WS* w1, const float* in1, int k1,
                        const WS* w2, const float* in2, int k2,
                        const float* __restrict__ bias, float* out) {
  constexpr int O = 32 * TO;
  const int to = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TO][8];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  mm_seg<WS, TO>(acc, w0, O, k0, in0, to, tm);
  if (k1) mm_seg<WS, TO>(acc, w1, O, k1, in1, to, tm);
  if (k2) mm_seg<WS, TO>(acc, w2, O, k2, in2, to, tm);
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = to * TO + i;
    const float b = bias[o];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = rnd<RND>(fmaxf(acc[i][j] + b, 0.f));
    *reinterpret_cast<float4*>(out + o * BM + tm * 4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(out + o * BM + 32 + tm * 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

template <typename WS, bool RND>
__device__ void dense(const WS* w0, const float* in0, int k0,
                      const WS* w1, const float* in1, int k1,
                      const WS* w2, const float* in2, int k2,
                      const float* bias, int O, float* out) {
  switch (O) {
    case 256: dense_t<WS, RND, 8>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 128: dense_t<WS, RND, 4>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 64: dense_t<WS, RND, 2>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
    case 32: dense_t<WS, RND, 1>(w0, in0, k0, w1, in1, k1, w2, in2, k2, bias, out); break;
  }
}

template <typename WS, bool RND>
__device__ __forceinline__ void dense1(const WS* w, const float* in, int k,
                                       const float* bias, int O, float* out) {
  dense<WS, RND>(w, in, k, w, in, 0, w, in, 0, bias, O, out);
}

// out = W in + bias for an O <= 4 wide output layer (no activation): one
// thread per (output, sample).
template <typename WS>
__device__ void dense_small(const WS* __restrict__ w, const float* in, int K,
                            const float* __restrict__ bias, int O, float* out) {
  const int t = threadIdx.x;
  if (t < O * BM) {
    const int o = t / BM, m = t % BM;
    float acc = 0.f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) acc = fmaf(to_f(w[k * O + o]), in[k * BM + m], acc);
    out[o * BM + m] = acc + bias[o];
  }
}

template <typename WS, bool RND>
__global__ void __launch_bounds__(THREADS, 1)
fused_field_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                   const float* __restrict__ dir, const int* __restrict__ flags,
                   const WS* __restrict__ wts, const float* __restrict__ bias,
                   float* __restrict__ out, const Params p) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (flags != nullptr && flags[blockIdx.x] == 0) {
    // a skipped tile must still be finite downstream (0 * NaN = NaN)
    for (int i = t; i < 4 * BM; i += THREADS) {
      const int gm = m0 + i % BM;
      if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = 0.f;
    }
    return;
  }
  float* X = reinterpret_cast<float*>(smem4);  // 4 x BM: xyz rows, id row
  float* A = X + 4 * BM;                       // rows_a x BM
  float* B = A + p.rows_a * BM;                // rows_a x BM
  float* P = B + p.rows_a * BM;                // pos_rows x BM
  float* D = P + p.pos_rows * BM;              // dir_rows x BM
  float* T = D + p.dir_rows * BM;              // time_rows x BM
  float* R = T + p.time_rows * BM;             // 4 x BM: flow or rgb, sigma

  for (int i = t; i < 4 * BM; i += THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  const auto W = [&](int slot) { return wts + p.w_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const int ch = t / BM, m = t % BM;

  if (p.motion_mode) {
    const float v = X[ch * BM + m];
    if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
      const float id = X[3 * BM + m];
      const float lo = floorf(id);
      const float wt = __fsub_rn(id, lo);
      encode<RND>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v, wt, ch, 4,
                  p.freqs, p.inc, false, A, BM, m);
    } else {
      encode<RND>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, A, BM, m);
    }
    __syncthreads();
    const int mw = p.motion_width;
    dense1<WS, RND>(W(W_M0), A, p.menc_rows, Bi(B_M0), mw, B);
    __syncthreads();
    dense1<WS, RND>(W(W_M0 + 1), B, mw, Bi(B_M0 + 1), mw, A);
    __syncthreads();
    dense1<WS, RND>(W(W_M0 + 2), A, mw, Bi(B_M0 + 2), mw, B);
    __syncthreads();
    dense1<WS, RND>(W(W_M0 + 3), B, mw, Bi(B_M0 + 3), mw, A);
    __syncthreads();
    dense1<WS, RND>(W(W_M0 + 4), A, mw, Bi(B_M0 + 4), mw, B);
    __syncthreads();
    dense_small<WS>(W(W_M0 + 5), B, mw, Bi(B_M0 + 5), 3, R);
    __syncthreads();
    if (t < 3 * BM) X[t] = __fadd_rn(X[t], R[t]);  // displaced positions
    __syncthreads();
  }

  // encodings: threads of channels 0-2 encode xyz, those of channel 3 the time
  if (ch < 3) {
    const float v = X[ch * BM + m];
    encode<RND>(v, v, 0.f, ch, 3, p.freqs, p.inc, false, P, BM, m);
  } else if (p.use_time) {
    const float v = X[3 * BM + m];
    encode<RND>(v, v, 0.f, 0, 1, p.freqs, p.inc, true, T, BM, m);
  }
  for (int i = t; i < p.dir_rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? dir[static_cast<size_t>(i / BM) * M + gm] : 0.f;
    D[i] = fmaxf(rnd<RND>(v), 0.f);
  }
  __syncthreads();

  const int wd = p.width, kp = p.pos_rows;
  dense1<WS, RND>(W(W_1), P, kp, Bi(B_1), wd, A);
  __syncthreads();
  dense1<WS, RND>(W(W_1 + 1), A, wd, Bi(B_1 + 1), wd, B);
  __syncthreads();
  dense1<WS, RND>(W(W_1 + 2), B, wd, Bi(B_1 + 2), wd, A);
  __syncthreads();
  dense1<WS, RND>(W(W_1 + 3), A, wd, Bi(B_1 + 3), wd, B);
  __syncthreads();
  dense<WS, RND>(W(W_S2A), B, wd, W(W_S2B), P, kp, W(W_S2B), P, 0, Bi(B_SB1), wd, A);
  __syncthreads();
  dense1<WS, RND>(W(W_S2W2), A, wd, Bi(B_SB2), wd, B);
  __syncthreads();
  dense1<WS, RND>(W(W_S2W3), B, wd, Bi(B_SB3), wd, A);
  __syncthreads();
  dense_small<WS>(W(W_DW), A, wd, Bi(B_DB), 1, R + 3 * BM);  // sigma
  // rgb head: relu([x | dir | time]); x >= 0 already, D and T hold relu'd values
  dense<WS, RND>(W(W_R1A), A, wd, W(W_R1B), D, p.dir_rows, W(W_R1C), T,
                 p.use_time ? p.time_rows : 0, Bi(B_RB1), p.head, B);
  __syncthreads();
  if (p.n_rgb == 2) {
    dense_small<WS>(W(W_RGB1), B, p.head, Bi(B_RGB1), 3, R);
  } else {
    dense1<WS, RND>(W(W_RGB1), B, p.head, Bi(B_RGB1), p.head, A);
    __syncthreads();
    dense1<WS, RND>(W(W_RGB2), A, p.head, Bi(B_RGB2), p.head, B);
    __syncthreads();
    dense_small<WS>(W(W_RGB3), B, p.head, Bi(B_RGB3), 3, R);
  }
  __syncthreads();
  for (int i = t; i < 4 * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = R[i];
  }
}

template <typename WS, bool RND>
cudaError_t launch(const Params& p, const float* xyz, const float* ids,
                   const float* dir, const int* flags, const void* weights,
                   const float* biases, float* out, size_t smem,
                   cudaStream_t stream) {
  auto kern = fused_field_kernel<WS, RND>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(xyz, ids, dir, flags,
                                        static_cast<const WS*>(weights), biases, out, p);
  return cudaGetLastError();
}

}  // namespace

// C entry point. Pointers are device pointers except `offsets`, a host array
// of N_W weight then N_B bias element offsets (-1 = absent operand).
// Returns the CUDA error of the launch (0 = launched).
extern "C" int stnerf_fused_field(const void* xyz, const void* ids, const void* dir,
                                  const void* flags, const void* weights,
                                  const void* biases, const void* offsets, void* out,
                                  int M, int dir_rows, int width, int head,
                                  int motion_width, int freqs, int include_input,
                                  int use_time, int n_rgb, int motion_mode, int bf16,
                                  void* stream) {
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
  int rows_a = width > head ? width : head;
  if (motion_mode) {
    rows_a = rows_a > motion_width ? rows_a : motion_width;
    rows_a = rows_a > p.menc_rows ? rows_a : p.menc_rows;
  }
  p.rows_a = rows_a;
  const size_t smem = static_cast<size_t>(4 + 2 * rows_a + p.pos_rows + dir_rows +
                                          p.time_rows + 4) * BM * sizeof(float);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fx = static_cast<const float*>(xyz);
  const auto* fi = static_cast<const float*>(ids);
  const auto* fd = static_cast<const float*>(dir);
  const auto* fl = static_cast<const int*>(flags);
  const auto* fb = static_cast<const float*>(biases);
  auto* fo = static_cast<float*>(out);
  const cudaError_t e =
      bf16 ? launch<unsigned short, true>(p, fx, fi, fd, fl, weights, fb, fo, smem, s)
           : launch<float, false>(p, fx, fi, fd, fl, weights, fb, fo, smem, s);
  return static_cast<int>(e);
}
