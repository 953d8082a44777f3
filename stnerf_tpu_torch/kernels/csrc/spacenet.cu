// SpaceNet forward and backward on encoded inputs in float32, on Hopper
// (sm_90a) CUDA cores.
//
// Replaces stnerf_tpu/kernels/spacenet_vjp.py::spacenet_planar_trainable for
// float32 fields (bf16 fields run the tensor-core kernels of
// spacenet_tc.cu): its forward Pallas kernel (_call_fwd, _fwd_kernel) and its
// backward one (_call_bwd, _bwd_kernel with _bwd_math). The forward is also
// the float32 kernel of stnerf_tpu/kernels/fused_spacenet.py's three entry
// points, which compute the same function (_kernel_planar).
//
// Inputs are planar float32: the position encoding (pos_rows, M), the
// direction encoding (dir_rows, M; a zero row without directions) and the
// time encoding (time_rows, M; absent without a time input). The direction
// and time rows feed the rgb head through its leading ReLU, so they are
// stored clipped at 0.
//   * stnerf_spacenet_fwd: trunk (4 layers, the stage-2 skip layer as split
//     products over [trunk | pos_enc], 2 more), the density head and the
//     rgb head over [features | dir | time] -> (4, M) float32: raw rgb in
//     rows 0-2, raw sigma in row 3.
//   * stnerf_spacenet_bwd: recomputes the forward per block of samples and
//     backpropagates the rgb and sigma cotangents (_bwd_math): weight and
//     bias gradients in float32 in the packed layout of fused_field.py
//     (pack_field's offsets), summed over every block; d_pos_enc (pos_rows,
//     M) and d_dir_enc (dir_rows, M) in float32. The time encoding gets no
//     gradient (frame ids are integral inputs).
// Both take an optional device int `active` (null = 1): when it reads 0, the
// field is skipped as the JAX path's chunk-level lax.cond skips a performer
// that is hidden or that no ray of the chunk hits. Every block then writes
// zeros (rgb and sigma; d_pos_enc and d_dir_enc) and exits, and adds nothing
// to the weight gradients. The flag lives on the device, so no host sync.
//
// Bound: ~0.93 MFLOP per sample in the forward at width 256, head 128, about
// three times that in the backward, against ~450 bytes of sample input
// (the encodings in float32), so arithmetic bounds both, as K1 and K2.
//
// The simple design: the fused field's kernels without the motion net and
// without the in-kernel encoding, on the same block products
// (mlp_blocks.cuh): CUDA-core FMA loops, no tensor cores, one block of 8
// warps per SM, weights streamed from L2, activations in shared memory. The
// forward takes 64 samples a block. The backward takes K2's float32
// blocking: 16 samples a block, trunk layers 4-7 kept through the head and
// stage-2 backward and layers 1-3 recomputed after it, weight gradients
// added across blocks with float4 atomics (so the results agree with the
// plain version to a tolerance, not bitwise). The ragged tail of M is
// guarded: samples past M read as zeros, get zero cotangents and are not
// written.
// Numerics follow the TPU kernel: ReLU masks compare the stored activation
// with 0,
// d_pos_enc sums the first trunk layer's and the stage-2 skip input's
// products, d_dir_enc is masked where the (rounded) direction encoding is
// not positive.

#include "field_common.cuh"
#include "mlp_blocks.cuh"

namespace {

constexpr int FWD_BM = 64;

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, pos_rows, dir_rows, time_rows, width, head, n_rgb;
  int rows_a, g_rows, u_rows;
};

// rows x BM values of a planar (rows, M) float32 input from sample m0 on,
// rounded to the compute dtype (and clipped at 0 with `relu`); zeros past M
template <typename WS, bool RND, int BM>
__device__ void load_rows(const float* __restrict__ src, int rows, int M, int m0, bool relu,
                          WS* dst) {
  for (int i = threadIdx.x; i < rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? rnd<RND>(src[static_cast<size_t>(i / BM) * M + gm]) : 0.f;
    put(dst + i, relu ? fmaxf(v, 0.f) : v);
  }
}

// zeros into rows x BM values of a planar (rows, M) float32 output from
// sample m0 on (a skipped field's block)
template <int BM>
__device__ void zero_rows(float* __restrict__ dst, int rows, int M, int m0) {
  for (int i = threadIdx.x; i < rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < M) dst[static_cast<size_t>(i / BM) * M + gm] = 0.f;
  }
}

template <typename WS, bool RND>
__global__ void __launch_bounds__(THREADS, 1)
spacenet_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ time, const WS* __restrict__ wts,
                    const float* __restrict__ bias, const int* __restrict__ active,
                    float* __restrict__ out, const Params p) {
  constexpr int BM = FWD_BM;
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  if (active != nullptr && *active == 0) {
    zero_rows<BM>(out, 4, p.M, m0);
    return;
  }
  const int W = p.width, H = p.head, kp = p.pos_rows;
  float* R = reinterpret_cast<float*>(smem4);  // 4: rgb, sigma
  WS* P = reinterpret_cast<WS*>(R + 4 * BM);  // pos_rows: position encoding
  WS* D = P + kp * BM;                        // dir_rows: relu(direction encoding)
  WS* T = D + p.dir_rows * BM;                // time_rows: relu(time encoding)
  WS* A = T + p.time_rows * BM;               // rows_a: ping
  WS* B = A + p.rows_a * BM;                  // rows_a: pong
  const auto Wt = [&](int slot) { return wts + p.w_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };

  load_rows<WS, RND, BM>(pos, kp, p.M, m0, false, P);
  load_rows<WS, RND, BM>(dir, p.dir_rows, p.M, m0, true, D);
  if (p.time_rows) load_rows<WS, RND, BM>(time, p.time_rows, p.M, m0, true, T);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1), P, kp, Bi(B_1), W, A);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 1), A, W, Bi(B_1 + 1), W, B);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 2), B, W, Bi(B_1 + 2), W, A);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_1 + 3), A, W, Bi(B_1 + 3), W, B);
  __syncthreads();
  fwd_dense<WS, WS, RND, BM>(Wt(W_S2A), B, W, Wt(W_S2B), P, kp, Wt(W_S2B), P, 0, Bi(B_SB1), W,
                             A);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_S2W2), A, W, Bi(B_SB2), W, B);
  __syncthreads();
  fwd_dense1<WS, WS, RND, BM>(Wt(W_S2W3), B, W, Bi(B_SB3), W, A);
  __syncthreads();
  fwd_small<WS, WS, BM>(Wt(W_DW), A, W, Bi(B_DB), 1, R + 3 * BM);  // sigma
  // rgb head: relu([a6 | dir | time]); a6 >= 0, D and T hold relu'd values
  fwd_dense<WS, WS, RND, BM>(Wt(W_R1A), A, W, Wt(W_R1B), D, p.dir_rows, Wt(W_R1C), T,
                             p.time_rows, Bi(B_RB1), H, B);
  __syncthreads();
  if (p.n_rgb == 2) {
    fwd_small<WS, WS, BM>(Wt(W_RGB1), B, H, Bi(B_RGB1), 3, R);
  } else {
    fwd_dense1<WS, WS, RND, BM>(Wt(W_RGB1), B, H, Bi(B_RGB1), H, A);
    __syncthreads();
    fwd_dense1<WS, WS, RND, BM>(Wt(W_RGB2), A, H, Bi(B_RGB2), H, B);
    __syncthreads();
    fwd_small<WS, WS, BM>(Wt(W_RGB3), B, H, Bi(B_RGB3), 3, R);
  }
  __syncthreads();
  for (int i = t; i < 4 * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < p.M) out[static_cast<size_t>(i / BM) * p.M + gm] = R[i];
  }
}

template <typename WS, bool RND, int BM>
__global__ void __launch_bounds__(THREADS, 1)
spacenet_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ time, const float* __restrict__ drgb,
                    const float* __restrict__ dsig, const WS* __restrict__ wts,
                    const float* __restrict__ bias, const int* __restrict__ active,
                    float* __restrict__ gw, float* __restrict__ gb, float* __restrict__ dpos,
                    float* __restrict__ ddir, const Params p) {
  static_assert(BM % 8 == 0 && 4 * BM <= THREADS, "tile shape");
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  const int W = p.width, H = p.head, kp = p.pos_rows;
  if (active != nullptr && *active == 0) {
    zero_rows<BM>(dpos, kp, M, m0);
    zero_rows<BM>(ddir, p.dir_rows, M, m0);
    return;
  }
  float* R = reinterpret_cast<float*>(smem4);  // 1: the sigma cotangent
  float* G0 = R + BM;                          // g_rows: cotangents, ping
  float* G1 = G0 + p.g_rows * BM;              // g_rows: pong
  float* DP = G1 + p.g_rows * BM;              // pos_rows: d(position encoding)
  WS* P = reinterpret_cast<WS*>(DP + kp * BM);  // pos_rows: position encoding
  WS* D = P + kp * BM;                         // dir_rows: relu(direction encoding)
  WS* T = D + p.dir_rows * BM;                 // time_rows: relu(time encoding)
  WS* U = T + p.time_rows * BM;                // u_rows: trunk and head
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

  // ---- forward: trunk and rgb head, keeping what the backward reads ----
  load_rows<WS, RND, BM>(pos, kp, M, m0, false, P);
  load_rows<WS, RND, BM>(dir, p.dir_rows, M, m0, true, D);
  if (p.time_rows) load_rows<WS, RND, BM>(time, p.time_rows, M, m0, true, T);
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
  fwd_dense<WS, WS, RND, BM>(Wt(W_R1A), S0, W, Wt(W_R1B), D, p.dir_rows, Wt(W_R1C), T,
                             p.time_rows, Bi(B_RB1), H, HS[0]);
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
  if (p.time_rows) grad_w<WS, BM>(T, p.time_rows, gc, H, GW(W_R1C));
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
  // the skip input: the stage-2 first layer reads the position encoding
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
  // d_pos_enc = w1 dy + s2b dy4, float32, not rounded
  bwd_dx<WS, BM>(Wt(W_1), kp, W, gc,
                 [=](int k, int m, float acc) { DP[k * BM + m] = __fadd_rn(acc, DP[k * BM + m]); });
  __syncthreads();
  for (int i = t; i < kp * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < M) dpos[static_cast<size_t>(i / BM) * M + gm] = DP[i];
  }
}

template <typename WS, bool RND>
cudaError_t launch_fwd(const Params& p, const float* pos, const float* dir, const float* time,
                       const void* weights, const float* biases, const int* active, float* out,
                       cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(4) * FWD_BM * sizeof(float) +
      static_cast<size_t>(p.pos_rows + p.dir_rows + p.time_rows + 2 * p.rows_a) * FWD_BM *
          sizeof(WS);
  auto kern = spacenet_fwd_kernel<WS, RND>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + FWD_BM - 1) / FWD_BM);
  kern<<<grid, THREADS, smem, stream>>>(pos, dir, time, static_cast<const WS*>(weights), biases,
                                        active, out, p);
  return cudaGetLastError();
}

template <typename WS, bool RND, int BM>
cudaError_t launch_bwd(const Params& p, const float* pos, const float* dir, const float* time,
                       const float* drgb, const float* dsig, const void* weights,
                       const float* biases, const int* active, float* gw, float* gb,
                       float* dpos, float* ddir, cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(1 + 2 * p.g_rows + p.pos_rows) * BM * sizeof(float) +
      static_cast<size_t>(p.pos_rows + p.dir_rows + p.time_rows + p.u_rows) * BM * sizeof(WS);
  auto kern = spacenet_bwd_kernel<WS, RND, BM>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((p.M + BM - 1) / BM);
  kern<<<grid, THREADS, smem, stream>>>(pos, dir, time, drgb, dsig,
                                        static_cast<const WS*>(weights), biases, active, gw,
                                        gb, dpos, ddir, p);
  return cudaGetLastError();
}

int imax(int a, int b) { return a > b ? a : b; }

// -> false for shapes the kernels do not take
bool fill_params(Params& p, const void* offsets, int M, int pos_rows, int dir_rows,
                 int time_rows, int width, int head, int n_rgb) {
  if (M <= 0 || pos_rows <= 0 || dir_rows <= 0 || time_rows < 0 || !kernel_width(width) ||
      !kernel_width(head) || (n_rgb != 2 && n_rgb != 4)) {
    return false;
  }
  const int* off = static_cast<const int*>(offsets);
  for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
  p.M = M;
  p.pos_rows = pos_rows;
  p.dir_rows = dir_rows;
  p.time_rows = time_rows;
  p.width = width;
  p.head = head;
  p.n_rgb = n_rgb;
  p.rows_a = imax(width, head);
  p.g_rows = imax(width, head);
  p.u_rows = 4 * width + (n_rgb - 1) * head;
  return true;
}

}  // namespace

// C entry points. Pointers are device pointers except `offsets`, a host
// array of N_W weight then N_B bias element offsets (-1 = absent operand);
// `time` may be null when time_rows is 0, `active` (one int) null for a field
// that always runs. Each returns the CUDA error of its launch (0 = launched).
extern "C" int stnerf_spacenet_fwd(const void* pos, const void* dir, const void* time,
                                   const void* weights, const void* biases,
                                   const void* offsets, const void* active, void* out, int M,
                                   int pos_rows, int dir_rows, int time_rows, int width,
                                   int head, int n_rgb, void* stream) {
  Params p;
  if (!fill_params(p, offsets, M, pos_rows, dir_rows, time_rows, width, head, n_rgb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(launch_fwd<float, false>(
      p, static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), weights, static_cast<const float*>(biases),
      static_cast<const int*>(active), static_cast<float*>(out),
      static_cast<cudaStream_t>(stream)));
}

// gw and gb (float32, the packed buffers' sizes) must be zeroed by the
// caller: the kernel adds into them.
extern "C" int stnerf_spacenet_bwd(const void* pos, const void* dir, const void* time,
                                   const void* drgb, const void* dsig, const void* weights,
                                   const void* biases, const void* offsets, const void* active,
                                   void* gw, void* gb, void* dpos, void* ddir, int M,
                                   int pos_rows, int dir_rows, int time_rows, int width,
                                   int head, int n_rgb, void* stream) {
  Params p;
  if (!fill_params(p, offsets, M, pos_rows, dir_rows, time_rows, width, head, n_rgb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // 16 samples a block (~134 KB of shared memory at the taekwondo widths)
  return static_cast<int>(launch_bwd<float, false, 16>(
      p, static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const float*>(drgb),
      static_cast<const float*>(dsig), weights, static_cast<const float*>(biases),
      static_cast<const int*>(active), static_cast<float*>(gw), static_cast<float*>(gb),
      static_cast<float*>(dpos), static_cast<float*>(ddir), static_cast<cudaStream_t>(stream)));
}
