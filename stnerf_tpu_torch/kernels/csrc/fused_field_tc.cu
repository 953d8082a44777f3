// Fused field evaluation in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces stnerf_tpu/kernels/fused_field.py::fused_field (the Pallas TPU
// kernel: _kernel, _kernel_body, _encode) for bf16 fields; float32 fields
// keep the CUDA-core kernel of fused_field.cu. The same function as there:
// optional MotionNet displacement, the double-angle encodings, the SpaceNet
// trunk with its skip layer as split products, the density head and the rgb
// head behind a ReLU over [features | dir_enc | time_enc]; raw rgb (rows
// 0-2) and sigma (row 3) of a (4, M) float32 array.
//
// Bound: about 1.2 MFLOP per sample against ~40 bytes of sample input and
// output, so the tensor cores' rate bounds it (989 TFLOP/s in bf16), not
// memory.
//
// The design (tc_blocks.cuh has the building blocks):
//   * A block covers BM = 128 samples, two tiles of the skip flags, with two
//     warpgroups. Each weight byte fetched from L2 serves 128 samples.
//   * Every layer of width >= 32 is a wgmma product: the weights are the A
//     operand, loaded from L2 straight into registers in fragment order
//     (gathered on the host by fused_field.py PackedField.tc, zero-padded to 64
//     output rows and 16 inputs), the activations are the B operand, bf16
//     in shared memory (two ping-pong tiles of up to 256 x 128, 64 KB
//     each). The epilogue adds the bias, applies the ReLU, rounds to bf16
//     and writes the next tile; fence.proxy.async and a barrier separate
//     the layers.
//   * The encodings are padded with zero rows to a multiple of 16 (pos
//     63 -> 64, dir 27 -> 32, time 21 -> 32, motion 84 -> 96), as their
//     weights are, so no unset value reaches a product.
//   * The 1- and 3-wide outputs (density, rgb, flow) and the encodings run
//     on CUDA cores.
//   * A tile whose flag is 0 writes exact zeros; its half of the block is
//     not computed (the products run 64 columns wide). A block with both
//     flags 0 writes its zeros and exits.
// Numerics as the CUDA-core kernel and the TPU kernel: bf16 products,
// float32 accumulation, bias, ReLU, then one rounding to bf16 per layer.

#include "field_common.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int BM = 128;        // samples per block
constexpr int FLAG_TILE = 64;  // samples per skip flag (fused_field.py TILE)

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int f_off[N_W];  // forward fragments (PackedField.tc), in 16-byte units; -1 = absent
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb, motion_mode;
  int rows_a, pos_rows, time_rows, menc_rows, pos_pad, dir_pad, time_pad, menc_pad;
};

__global__ void __launch_bounds__(TC_THREADS, 1)
fused_field_tc_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                      const float* __restrict__ dir, const int* __restrict__ flags,
                      const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                      const float* __restrict__ bias, float* __restrict__ out, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  int on0 = 1, on1 = m0 + FLAG_TILE < M;
  if (flags != nullptr) {
    on0 = flags[m0 / FLAG_TILE];
    on1 = on1 && flags[m0 / FLAG_TILE + 1];
  }
  if (!on0 && !on1) {
    for (int i = t; i < 4 * BM; i += TC_THREADS) {
      const int gm = m0 + i % BM;
      if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = 0.f;
    }
    return;
  }
  // the computed columns: both tiles, or the one whose flag is set
  const int n_lo = on0 ? 0 : FLAG_TILE;
  const int n_cnt = on0 && on1 ? BM : FLAG_TILE;

  unsigned short* A = reinterpret_cast<unsigned short*>(smem);  // rows_a x BM
  unsigned short* B = A + p.rows_a * BM;                         // rows_a x BM
  unsigned short* P = B + p.rows_a * BM;                         // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                        // dir_pad: relu(dir encoding)
  unsigned short* T = D + p.dir_pad * BM;                        // time_pad: relu(time encoding)
  float* X = reinterpret_cast<float*>(T + p.time_pad * BM);      // 4 x BM: xyz rows, id row
  float* R = X + 4 * BM;                                         // 4 x BM: flow or rgb, sigma

  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  const auto W = [&](int slot) { return wts + p.w_off[slot]; };
  const auto F = [&](int slot) { return frags + p.f_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const auto dense1 = [&](int slot, const unsigned short* in, int k_rows, int bslot, int O,
                          unsigned short* o) {
    const Seg s{F(slot), in, k_rows / 16};
    tc_dense<BM>(&s, 1, O, Bi(bslot), o, n_lo, n_cnt);
    layer_sync();
  };

  if (p.motion_mode) {
    for (int i = t; i < 4 * BM; i += TC_THREADS) {
      const int ch = i / BM, m = i % BM;
      const float v = X[ch * BM + m];
      const auto emit = [=](int row, float val) { A[act_idx<BM>(row, m)] = f_bf(val); };
      if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
        const float id = X[3 * BM + m];
        const float lo = floorf(id);
        encode_rows<true>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v,
                          __fsub_rn(id, lo), ch, 4, p.freqs, p.inc, false, emit);
      } else {
        encode_rows<true>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, emit);
      }
    }
    zero_rows<BM>(A, p.menc_rows, p.menc_pad);
    layer_sync();
    const int mw = p.motion_width;
    dense1(W_M0, A, p.menc_pad, B_M0, mw, B);
    dense1(W_M0 + 1, B, mw, B_M0 + 1, mw, A);
    dense1(W_M0 + 2, A, mw, B_M0 + 2, mw, B);
    dense1(W_M0 + 3, B, mw, B_M0 + 3, mw, A);
    dense1(W_M0 + 4, A, mw, B_M0 + 4, mw, B);
    small_fwd<BM>(W(W_M0 + 5), B, mw, Bi(B_M0 + 5), 3, R);
    __syncthreads();
    for (int i = t; i < 3 * BM; i += TC_THREADS) X[i] = __fadd_rn(X[i], R[i]);  // displaced
    __syncthreads();
  }

  // encodings: xyz into P, time into T (ReLU'd: only the rgb head reads it)
  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int ch = i / BM, m = i % BM;
    const float v = X[ch * BM + m];
    if (ch < 3) {
      encode_rows<true>(v, v, 0.f, ch, 3, p.freqs, p.inc, false,
                        [=](int row, float val) { P[act_idx<BM>(row, m)] = f_bf(val); });
    } else if (p.use_time) {
      encode_rows<true>(v, v, 0.f, 0, 1, p.freqs, p.inc, true,
                        [=](int row, float val) { T[act_idx<BM>(row, m)] = f_bf(val); });
    }
  }
  for (int i = t; i < p.dir_rows * BM; i += TC_THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? dir[static_cast<size_t>(i / BM) * M + gm] : 0.f;
    D[act_idx<BM>(i / BM, i % BM)] = f_bf(fmaxf(rnd<true>(v), 0.f));
  }
  zero_rows<BM>(P, p.pos_rows, p.pos_pad);
  zero_rows<BM>(D, p.dir_rows, p.dir_pad);
  zero_rows<BM>(T, p.time_rows, p.time_pad);
  layer_sync();

  const int wd = p.width, kp = p.pos_pad;
  dense1(W_1, P, kp, B_1, wd, A);
  dense1(W_1 + 1, A, wd, B_1 + 1, wd, B);
  dense1(W_1 + 2, B, wd, B_1 + 2, wd, A);
  dense1(W_1 + 3, A, wd, B_1 + 3, wd, B);
  {
    const Seg s[2] = {{F(W_S2A), B, wd / 16}, {F(W_S2B), P, kp / 16}};
    tc_dense<BM>(s, 2, wd, Bi(B_SB1), A, n_lo, n_cnt);
    layer_sync();
  }
  dense1(W_S2W2, A, wd, B_SB2, wd, B);
  dense1(W_S2W3, B, wd, B_SB3, wd, A);
  small_fwd<BM>(W(W_DW), A, wd, Bi(B_DB), 1, R + 3 * BM);  // sigma
  {
    // rgb head: relu([x | dir | time]); x >= 0 already, D and T hold relu'd values
    const Seg s[3] = {{F(W_R1A), A, wd / 16}, {F(W_R1B), D, p.dir_pad / 16},
                      {F(W_R1C), T, p.time_pad / 16}};
    tc_dense<BM>(s, p.use_time ? 3 : 2, p.head, Bi(B_RB1), B, n_lo, n_cnt);
    layer_sync();
  }
  if (p.n_rgb == 2) {
    small_fwd<BM>(W(W_RGB1), B, p.head, Bi(B_RGB1), 3, R);
  } else {
    dense1(W_RGB1, B, p.head, B_RGB1, p.head, A);
    dense1(W_RGB2, A, p.head, B_RGB2, p.head, B);
    small_fwd<BM>(W(W_RGB3), B, p.head, Bi(B_RGB3), 3, R);
  }
  __syncthreads();
  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int m = i % BM, gm = m0 + m;
    const int on = m < FLAG_TILE ? on0 : on1;
    if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = on ? R[i] : 0.f;
  }
}

int round16(int v) { return (v + 15) / 16 * 16; }

}  // namespace

// C entry point. Pointers are device pointers except `offsets`, a host array
// of N_W weight, N_B bias and N_W forward-fragment offsets (-1 = absent
// operand): weights are the packed bf16 buffer (fused_field.py pack_field),
// frags its PackedField.tc fragments. Returns the CUDA error of the launch
// (0 = launched).
extern "C" int stnerf_fused_field_tc(const void* xyz, const void* ids, const void* dir,
                                     const void* flags, const void* weights, const void* frags,
                                     const void* biases, const void* offsets, void* out, int M,
                                     int dir_rows, int width, int head, int motion_width,
                                     int freqs, int include_input, int use_time, int n_rgb,
                                     int motion_mode, void* stream) {
  if (M <= 0 || dir_rows <= 0 || !kernel_width(width) || !kernel_width(head) ||
      (motion_mode != 0 && !kernel_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  const int* off = static_cast<const int*>(offsets);
  for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
  for (int i = 0; i < N_W; ++i) p.f_off[i] = off[N_W + N_B + i];
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
  p.pos_pad = round16(p.pos_rows);
  p.dir_pad = round16(dir_rows);
  p.time_pad = round16(p.time_rows);
  p.menc_pad = round16(p.menc_rows);
  int rows_a = width > head ? width : head;
  if (motion_mode) {
    rows_a = rows_a > motion_width ? rows_a : motion_width;
    rows_a = rows_a > p.menc_pad ? rows_a : p.menc_pad;
  }
  p.rows_a = rows_a;
  const size_t smem =
      static_cast<size_t>(2 * rows_a + p.pos_pad + p.dir_pad + p.time_pad) * BM * 2 +
      static_cast<size_t>(8) * BM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(fused_field_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_field_tc_kernel<<<(M + BM - 1) / BM, TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ids),
      static_cast<const float*>(dir), static_cast<const int*>(flags),
      static_cast<const unsigned short*>(weights), static_cast<const uint4*>(frags),
      static_cast<const float*>(biases), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}
