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
//     (pack_field's offsets), summed over every block in a fixed order;
//     d_pos_enc (pos_rows, M) and d_dir_enc (dir_rows, M) in float32. The
//     time encoding gets no gradient (frame ids are integral inputs).
// Both take an optional device int `active` (null = 1): when it reads 0, the
// field is skipped as the JAX path's chunk-level lax.cond skips a performer
// that is hidden or that no ray of the chunk hits. Every block then writes
// zeros (rgb and sigma; d_pos_enc and d_dir_enc) and exits, writes no
// record, and the weight-gradient passes read the flag, add nothing and give
// zeros. The flag lives on the device, so no host sync.
//
// Bound: ~0.93 MFLOP per sample in the forward at width 256, head 128, about
// three times that in the backward, against ~450 bytes of sample input
// (the encodings in float32), so arithmetic bounds both, as K1 and K2.
//
// The forward: the fused field's kernel without the motion net and without
// the in-kernel encoding, on the same block products (mlp_blocks.cuh):
// CUDA-core FMA loops, no tensor cores, one block of 8 warps per SM, 64
// samples a block, weights streamed from L2, activations in shared memory.
// The backward is f32_bwd.cuh's three passes, shared with K2's float32
// backward (field_bwd.cu): spacenet_bwd_kernel is pass 1 (the encodings'
// load, then spacenet_block), writing each layer's x and dy to the block's
// record (~16 KB a sample at the taekwondo widths); f32_dw_kernel and
// field_dw_reduce make the weight gradients from the records in a fixed
// order, so every result is the same on every run. The former design (16
// samples a block, trunk layers 1-3 recomputed, float4 atomics) took 52.02
// ms at M = 240,000, 2.2x its plain version (PERF.md). The ragged tail of M
// is guarded: samples past M read as zeros, get zero cotangents and are not
// written.
// Numerics follow the TPU kernel: ReLU masks compare the stored activation
// with 0, d_pos_enc sums the first trunk layer's and the stage-2 skip
// input's products, d_dir_enc is masked where the direction encoding is not
// positive.

#include "f32_bwd.cuh"
#include "field_common.cuh"
#include "mlp_blocks.cuh"

namespace {

constexpr int FWD_BM = 64;

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, pos_rows, dir_rows, time_rows, width, head, n_rgb;
  int rows_a;
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

// Pass 1 of the backward for the blocks b0 + blockIdx.x (f32_bwd.cuh)
__global__ void __launch_bounds__(THREADS, 1)
spacenet_bwd_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ time, const float* __restrict__ drgb,
                    const float* __restrict__ dsig, const float* __restrict__ wts,
                    const float* __restrict__ frags, const float* __restrict__ bias,
                    const int* __restrict__ active, float* __restrict__ records,
                    float* __restrict__ dpos,
                    float* __restrict__ ddir, const __grid_constant__ BwdParams p, int b0) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int m0 = (b0 + blockIdx.x) * RBM;
  const int M = p.M, kp = p.pos_rows;
  if (active != nullptr && *active == 0) {
    zero_rows<RBM>(dpos, kp, M, m0);
    zero_rows<RBM>(ddir, p.dir_rows, M, m0);
    return;
  }
  const Smem s = carve(p, smem4);
  const Blk c{p, wts, frags, bias, records + static_cast<size_t>(blockIdx.x) * p.rec_floats,
              s.MK};
  load_rows<float, false, RBM>(pos, kp, M, m0, false, s.P);
  load_rows<float, false, RBM>(dir, p.dir_rows, M, m0, true, s.D);
  if (p.time_rows) load_rows<float, false, RBM>(time, p.time_rows, M, m0, true, s.T);
  sync_async();
  c.save(T_POS, s.P, kp);
  c.save(T_DIR, s.D, p.dir_rows);
  if (p.time_rows) c.save(T_TIME, s.T, p.time_rows);
  spacenet_block(c, m0, s, drgb, dsig, ddir);
  // d_pos_enc = w1 dy + s2b dy4, float32
  for (int i = t; i < kp * RBM; i += THREADS) {
    const int gm = m0 + i % RBM;
    if (gm < M) dpos[static_cast<size_t>(i / RBM) * M + gm] = s.DP[i];
  }
  c.done();
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

// `plan` is the host int array of kernels/f32_bwd.py::make_plan for these
// shapes (`frags` holds the dx fragments at its offsets), n_w and n_b the packed weights' and biases' element counts; gw and
// gb (float32, n_w and n_b entries) are overwritten; `workspace` holds the
// plan's workspace bytes.
extern "C" int stnerf_spacenet_bwd(const void* pos, const void* dir, const void* time,
                                   const void* drgb, const void* dsig, const void* weights,
                                   const void* frags, const void* biases, const void* offsets,
                                   const void* plan,
                                   const void* active, void* gw, void* gb, void* dpos,
                                   void* ddir, void* workspace, int M, int pos_rows,
                                   int dir_rows, int time_rows, int width, int head, int n_rgb,
                                   int n_w, int n_b, void* stream) {
  Params fp;
  Plan P;
  if (!fill_params(fp, offsets, M, pos_rows, dir_rows, time_rows, width, head, n_rgb) ||
      n_w <= 0 || n_b <= 0 || !read_plan(static_cast<const int*>(plan), P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  set_plan(p, static_cast<const int*>(offsets), P);
  p.M = M;
  p.pos_rows = pos_rows;
  p.dir_rows = dir_rows;
  p.time_rows = time_rows;
  p.width = width;
  p.head = head;
  p.n_rgb = n_rgb;
  p.motion_mode = p.motion_width = p.menc_rows = p.freqs = p.inc = 0;
  p.rows_a = fp.rows_a;
  const size_t smem = smem_bytes(p);
  cudaError_t e = cudaFuncSetAttribute(spacenet_bwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const int*>(active);
  const auto pass1 = [&](int b0, int nb, float* records) {
    spacenet_bwd_kernel<<<nb, THREADS, smem, s>>>(
        static_cast<const float*>(pos), static_cast<const float*>(dir),
        static_cast<const float*>(time), static_cast<const float*>(drgb),
        static_cast<const float*>(dsig), static_cast<const float*>(weights),
        static_cast<const float*>(frags), static_cast<const float*>(biases), act, records,
        static_cast<float*>(dpos),
        static_cast<float*>(ddir), p, b0);
    return cudaGetLastError();
  };
  // every record's flag is the field's `active` flag
  return static_cast<int>(run_f32_bwd(P, M, act, 0, static_cast<float*>(workspace), n_w, n_b,
                                      static_cast<float*>(gw), static_cast<float*>(gb), s,
                                      pass1));
}
