// SpaceNet forward and backward on encoded inputs in bf16 on Hopper's tensor
// cores (sm_90a).
//
// Replaces stnerf_tpu/kernels/spacenet_vjp.py::spacenet_planar_trainable for
// bf16 fields: its forward Pallas kernel (_call_fwd, _fwd_kernel with
// _fwd_chain) and its backward one (_call_bwd, _bwd_kernel with _bwd_math).
// The forward is also the bf16 kernel of fused_spacenet.py's three entry
// points (_kernel_planar). float32 fields keep the CUDA-core kernels of
// spacenet.cu. The same functions as there:
//   * stnerf_spacenet_fwd_tc: trunk (4 layers, the stage-2 skip layer as
//     split products over [trunk | pos_enc], 2 more), the density head and
//     the rgb head over [features | dir | time] -> (4, M) float32: raw rgb
//     in rows 0-2, raw sigma in row 3.
//   * stnerf_spacenet_bwd_tc: recomputes the forward per block of samples
//     and backpropagates the rgb and sigma cotangents: weight and bias
//     gradients in float32 in the packed layout (pack_field's offsets),
//     summed over every block in a fixed order; d_pos_enc (pos_rows, M) and
//     d_dir_enc (dir_rows, M) in float32. The time encoding gets no
//     gradient (frame ids are integral inputs).
// Inputs are planar float32: the position encoding (pos_rows, M), the
// direction encoding (dir_rows, M; a zero row without directions) and the
// time encoding (time_rows, M; absent without a time input). Each is rounded
// to bf16 on load (the TPU kernel's astype(dtype)) into an act tile padded
// with zero rows to a multiple of 16 (63 -> 64, 27 -> 32, 1 -> 16, 21 -> 32),
// as the fragments' k-steps are; the direction and time rows feed the rgb
// head through its leading ReLU, so they are stored clipped at 0.
// Both take an optional device int `active` (null = 1), read at block start:
// when it is 0 the field is skipped, as the JAX path's chunk-level lax.cond
// skips a hidden or missed performer. Every block then writes zeros (rgb
// and sigma; d_pos_enc and d_dir_enc) and exits, writes no record, and the
// weight-gradient passes read none and give zeros. No host sync.
//
// Bound: ~0.93 MFLOP per sample in the forward at width 256, head 128, about
// three times that in the backward, against ~450 bytes of sample input (the
// encodings in float32): the tensor cores' rate bounds both (989 TFLOP/s in
// bf16), not memory.
//
// The design is K1's and K2's (fused_field_tc.cu, field_bwd_tc.cu) without
// the motion net and the in-kernel encoding; tc_blocks.cuh has the products
// and tc_bwd.cuh the backward parts shared with K2:
//   * forward, a block of two warpgroups per 128 samples (64 at widths up
//     to 512, 32 up to 1024: the largest block whose tiles fit shared
//     memory, chosen per launch by fwd_block): every layer of width >= 32
//     a wgmma product, the weights as register A
//     fragments from L2 (PackedField.tc), the activations the B operand in
//     shared memory, bias, ReLU and the rounding to bf16 in the epilogue;
//     the outputs whose sum lies near a bf16 rounding tie or 0 recomputed
//     in float32 on CUDA cores in k order (dense_checked, by tc_blocks.cuh's
//     one rule, WideRule, on the pack's weight-row norms: the rule of the
//     backward's recompute, so the backward differentiates these bits); the
//     1- and 3-wide layers on CUDA cores. Shared memory at the taekwondo
//     widths: two ping-pong tiles of 256 x 128 (128 KB), the encodings (128
//     rows, 32 KB), 2 KB of float32 output rows, the recompute's 4 KB mask,
//     16 KB of lists and 1.5 KB of norms: 184 KB, one block an SM. With
//     `taps` (checks only) each layer's bf16 output and the encodings are
//     copied into the backward's record layout (tc_blocks.cuh tap).
//   * backward, K2's two passes and fixed-order sum (no atomics, so the
//     weight gradients are the same bits on every run):
//     1. spacenet_bwd_tc_kernel, a block per BM samples (64 at widths up
//        to 256; below, chosen per launch by tc_bwd.cuh's choose_block:
//        32 at 512, 16 at 1024): loads the
//        encodings, then tc_bwd.cuh's spacenet_bwd_block (the recompute,
//        near-tie checked as the forward is, and dx = W dy on wgmma, every
//        cotangent rounded to bf16 where the TPU
//        kernel casts it, ReLU masks on the stored bf16 activations, d_dir
//        masked where the rounded direction encoding is not positive) and
//        writes d_pos_enc = w1 dy1 + s2b dy4 from its float32 rows. Each
//        layer's x and dy go to the block's record (25 bf16 tiles: 4000 rows,
//        8000 bytes a sample at the taekwondo widths with the 2-layer rgb
//        head and a time input, 1.92 GB at M = 240,000).
//        Shared memory at those widths: the four trunk slots 128 KB, the rgb
//        head 16 KB (48 KB with the 4-layer head), the encodings 16 KB, the
//        float32 cotangent rows and d_pos_enc 18 KB, the recompute's check
//        7.25 KB: 185 KB (217 KB) of the 227 KB. At 512/256 (BM = 32): the
//        trunk slots 128 KB, the head 16 KB (48 KB), the encodings 8 KB, the
//        float32 rows 8.9 KB, the check 8.1 KB: 169 KB (201 KB); at
//        1024/512 (BM = 16): 128 + 16 (48) + 4 + 4.4 + 10.1 KB: 163 KB (195
//        KB). The records grow with the widths: about 16 KB a sample
//        at 512/256, 31 KB at 1024/512.
//     2. and 3. tc_bwd.cuh's field_dw_kernel and field_dw_reduce, with the
//        `active` flag as every record's flag.
// The ragged tail of M is guarded: samples past M read as zeros, get zero
// cotangents and are not written.

#include <cstdint>

#include "field_common.cuh"
#include "tc_blocks.cuh"
#include "tc_bwd.cuh"

namespace {

// ------------------------------------------------------------------ forward

// rows [0, rows) of a planar (rows, M) float32 input from sample m0 on,
// rounded to bf16 (and clipped at 0 with `relu`), into an act tile of TB
// samples, zero rows up to `pad`; zeros past M
template <int TB>
__device__ void load_tile(const float* __restrict__ src, int rows, int pad, int M, int m0,
                          bool relu, unsigned short* dst) {
  for (int i = threadIdx.x; i < pad * TB; i += TC_THREADS) {
    const int r = i / TB, m = i % TB, gm = m0 + m;
    float v = r < rows && gm < M ? rnd<true>(src[static_cast<size_t>(r) * M + gm]) : 0.f;
    if (relu) v = fmaxf(v, 0.f);
    dst[act_idx<TB>(r, m)] = f_bf(v);
  }
}

// zeros into rows x TB values of a planar (rows, M) float32 output from
// sample m0 on (a skipped field's block)
template <int TB>
__device__ void zero_out(float* __restrict__ dst, int rows, int M, int m0) {
  for (int i = threadIdx.x; i < rows * TB; i += TC_THREADS) {
    const int gm = m0 + i % TB;
    if (gm < M) dst[static_cast<size_t>(i / TB) * M + gm] = 0.f;
  }
}

// One forward block of TB samples: 128, or 64 or 32 for layers wider than
// 256 (fwd_block)
template <int TB>
__global__ void __launch_bounds__(TC_THREADS, 1)
spacenet_fwd_tc_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                       const float* __restrict__ time, const unsigned short* __restrict__ wts,
                       const uint4* __restrict__ frags, const float* __restrict__ bias,
                       const float* __restrict__ norms, const int* __restrict__ active,
                       float* __restrict__ out, unsigned short* __restrict__ taps,
                       const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * TB;
  const int M = p.M;
  if (active != nullptr && *active == 0) {
    zero_out<TB>(out, 4, M, m0);
    return;
  }
  const int rows_a = p.width > p.head ? p.width : p.head;
  unsigned short* A = reinterpret_cast<unsigned short*>(smem);  // rows_a x TB
  unsigned short* B = A + rows_a * TB;                           // rows_a x TB
  unsigned short* P = B + rows_a * TB;                           // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * TB;                        // dir_pad: relu(dir encoding)
  unsigned short* T = D + p.dir_pad * TB;                        // time_pad: relu(time encoding)
  float* R = reinterpret_cast<float*>(T + p.time_pad * TB);      // 4 x TB: rgb, sigma
  const Check ck = make_check(R + 4 * TB, rows_a, TB, LIST);      // the check's scratch

  for (int i = threadIdx.x; i < rows_a * TB / 32; i += TC_THREADS) ck.mask[i] = 0;
  load_tile<TB>(pos, p.pos_rows, p.pos_pad, M, m0, false, P);
  load_tile<TB>(dir, p.dir_rows, p.dir_pad, M, m0, true, D);
  if (p.use_time) load_tile<TB>(time, p.time_rows, p.time_pad, M, m0, true, T);
  layer_sync();
  const auto rec = [&](int r, const unsigned short* tile, int rows) {
    tap<TB>(taps, p.rec_rows, p.rec[r], tile, rows);
  };
  rec(R_POS, P, p.pos_pad);
  rec(R_DIR, D, p.dir_pad);
  if (p.use_time) rec(R_TIME, T, p.time_pad);

  const auto W = [&](int slot) { return wts + p.w_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  // the checked segment of weight slot s over the input tile b (k_rows rows)
  const auto seg = [&](int slot, const unsigned short* b, int k_rows) {
    return Seg{frags + p.f_off[slot], b, k_rows / 16, norms + p.n_off[slot]};
  };
  // a checked layer into o, then its record tile r (with taps)
  const auto dense = [&](const Seg* s, int nseg, int O, int bslot, unsigned short* o, int r) {
    dense_checked<TB, true, LIST>(s, nseg, O, Bi(bslot), o, ck.mask, ck.lists,
                                  wide_rule<TB>(s, nseg, O, 0, TB, ck.wn, ck.xn));
    layer_sync();
    rec(r, o, O);
  };
  const auto dense1 = [&](int slot, const unsigned short* in, int k_pad, int bslot, int O,
                          unsigned short* o, int r) {
    const Seg s = seg(slot, in, k_pad);
    dense(&s, 1, O, bslot, o, r);
  };
  const int wd = p.width, kp = p.pos_pad;
  dense1(W_1, P, kp, B_1, wd, A, R_A0);
  dense1(W_1 + 1, A, wd, B_1 + 1, wd, B, R_A0 + 1);
  dense1(W_1 + 2, B, wd, B_1 + 2, wd, A, R_A0 + 2);
  dense1(W_1 + 3, A, wd, B_1 + 3, wd, B, R_A0 + 3);
  {
    const Seg s[2] = {seg(W_S2A, B, wd), seg(W_S2B, P, kp)};
    dense(s, 2, wd, B_SB1, A, R_A0 + 4);
  }
  dense1(W_S2W2, A, wd, B_SB2, wd, B, R_A0 + 5);
  dense1(W_S2W3, B, wd, B_SB3, wd, A, R_A0 + 6);
  small_fwd<TB>(W(W_DW), A, wd, Bi(B_DB), 1, R + 3 * TB);  // sigma
  {
    // rgb head: relu([x | dir | time]); x >= 0 already, D and T hold relu'd values
    const Seg s[3] = {seg(W_R1A, A, wd), seg(W_R1B, D, p.dir_pad), seg(W_R1C, T, p.time_pad)};
    dense(s, p.use_time ? 3 : 2, p.head, B_RB1, B, R_HS0);
  }
  if (p.n_rgb == 2) {
    small_fwd<TB>(W(W_RGB1), B, p.head, Bi(B_RGB1), 3, R);
  } else {
    dense1(W_RGB1, B, p.head, B_RGB1, p.head, A, R_HS0 + 1);
    dense1(W_RGB2, A, p.head, B_RGB2, p.head, B, R_HS0 + 2);
    small_fwd<TB>(W(W_RGB3), B, p.head, Bi(B_RGB3), 3, R);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * TB; i += TC_THREADS) {
    const int gm = m0 + i % TB;
    if (gm < M) out[static_cast<size_t>(i / TB) * M + gm] = R[i];
  }
}

template <int BM>
__global__ void __launch_bounds__(TC_THREADS, 1)
spacenet_bwd_tc_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                       const float* __restrict__ time, const float* __restrict__ drgb,
                       const float* __restrict__ dsig, const int* __restrict__ active,
                       const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                       const float* __restrict__ bias, const float* __restrict__ norms,
                       unsigned short* __restrict__ records, float* __restrict__ dpos,
                       float* __restrict__ ddir, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (active != nullptr && *active == 0) {
    zero_out<BM>(dpos, p.pos_rows, M, m0);
    zero_out<BM>(ddir, p.dir_rows, M, m0);
    return;
  }
  unsigned short* U = reinterpret_cast<unsigned short*>(smem);  // u_rows: trunk and head
  unsigned short* P = U + p.u_rows * BM;                        // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                       // dir_pad: relu(direction enc)
  unsigned short* T = D + p.dir_pad * BM;                       // time_pad: relu(time enc)
  float* R = reinterpret_cast<float*>(T + p.time_pad * BM);     // 4: the sigma cotangent
  float* G3 = R + 4 * BM;                                       // 4: the rgb cotangent
  float* DP = G3 + 4 * BM;                                      // pos_rows: d(position enc)
  unsigned* mask = reinterpret_cast<unsigned*>(DP + p.pos_rows * BM);  // the check's
  const Ctx<BM> c = make_ctx<BM>(p, wts, frags, bias, norms, records, mask);
  c.clear_mask();

  load_tile<BM>(pos, p.pos_rows, p.pos_pad, M, m0, false, P);
  load_tile<BM>(dir, p.dir_rows, p.dir_pad, M, m0, true, D);
  if (p.use_time) load_tile<BM>(time, p.time_rows, p.time_pad, M, m0, true, T);
  layer_sync();
  spacenet_bwd_block(c, m0, U, P, D, T, R, G3, DP, drgb, dsig, ddir);
  for (int i = threadIdx.x; i < p.pos_rows * BM; i += TC_THREADS) {
    const int gm = m0 + i % BM;
    if (gm < M) dpos[static_cast<size_t>(i / BM) * M + gm] = DP[i];
  }
  c.done();
}

// The shapes into p (both kernels' parameters but pass 2's jobs; the
// record layout is the backward's and the forward's taps'); -> false for
// shapes the kernels do not take. `off` as the C entry points' (null: only
// the sizes are wanted).
bool fill_params(Params& p, const int* off, int M, int pos_rows, int dir_rows, int time_rows,
                 int width, int head, int n_rgb) {
  if (M <= 0 || pos_rows <= 0 || dir_rows <= 0 || time_rows < 0 || !fwd_width(width) ||
      !fwd_width(head) || (n_rgb != 2 && n_rgb != 4)) {
    return false;
  }
  set_offsets(p, off);
  p.M = M;
  p.dir_rows = dir_rows;
  p.width = width;
  p.head = head;
  p.motion_width = p.freqs = p.inc = p.motion_mode = p.menc_rows = p.menc_pad = 0;
  p.use_time = time_rows > 0 ? 1 : 0;
  p.n_rgb = n_rgb;
  p.pos_rows = pos_rows;
  p.time_rows = time_rows;
  p.pos_pad = round16(pos_rows);
  p.dir_pad = round16(dir_rows);
  p.time_pad = round16(time_rows);
  p.u_rows = 4 * width + (n_rgb - 1) * head;  // pass 1: the trunk and head tiles
  record_layout(p);
  return true;
}

using BwdKernel = decltype(&spacenet_bwd_tc_kernel<64>);

BwdKernel bwd_kernel_for(int bm) {
  return bm == 64 ? spacenet_bwd_tc_kernel<64>
                  : bm == 32 ? spacenet_bwd_tc_kernel<32> : spacenet_bwd_tc_kernel<16>;
}

// the backward's layout: fill_params, pass 1's block and shared memory, the
// records and pass 2's jobs
bool make_layout(Layout& L, const int* off, int M, int pos_rows, int dir_rows, int time_rows,
                 int width, int head, int n_rgb, int n_w, int n_b) {
  Params& p = L.p;
  if (n_w <= 0 || n_b <= 0 ||
      !fill_params(p, off, M, pos_rows, dir_rows, time_rows, width, head, n_rgb)) {
    return false;
  }
  const auto smem = [&](int bm) {
    return static_cast<size_t>(p.u_rows + p.pos_pad + p.dir_pad + p.time_pad) * bm * 2 +
           static_cast<size_t>(4 + 4 + pos_rows) * bm * sizeof(float) + check_bytes(p, bm);
  };
  if (!choose_block(L, smem, bwd_kernel_for)) return false;
  finish_layout(L, n_w, n_b, 0, sm_count());
  return true;
}

using FwdKernel = decltype(&spacenet_fwd_tc_kernel<128>);

FwdKernel fwd_kernel_for(int tb) {
  return tb == 128 ? spacenet_fwd_tc_kernel<128>
                   : tb == 64 ? spacenet_fwd_tc_kernel<64> : spacenet_fwd_tc_kernel<32>;
}

// The forward's block for filled Params and its dynamic shared memory: the
// largest block of 128, 64 or 32 samples whose tiles fit the card's shared
// memory (128 at every width up to 256): two ping-pong tiles as wide as the
// wider of trunk and head, the encodings, the float32 output rows, the
// check's scratch (mask, lists, norms). False if none fits.
bool fwd_block(const Params& p, int* tb, size_t* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  const int rows_a = imax(p.width, p.head);
  for (const int b : {128, 64, 32}) {
    const size_t bytes =
        static_cast<size_t>(2 * rows_a + p.pos_pad + p.dir_pad + p.time_pad) * b * 2 +
        static_cast<size_t>(4) * b * sizeof(float) + check_bytes(rows_a, b, LIST);
    if (bytes <= static_cast<size_t>(optin)) {
      *tb = b;
      *smem = bytes;
      return true;
    }
  }
  return false;
}

}  // namespace

// C entry points. Pointers are device pointers except `offsets`, a host
// array of N_W weight, N_B bias, N_W forward-fragment, N_W
// backward-fragment and N_W row-norm offsets (-1 = absent operand;
// PackedField.tc); the forward's `norms` holds the squared weight-row norms
// (PackedField.tc_norms; the backward makes its own, a pre-pass into its
// workspace); `time` may be null when time_rows is 0, `active`
// (one int) null for a field that always runs; the forward's `taps` null,
// or (checks only) a device buffer for each block's forward tiles of the
// backward's record (stnerf_spacenet_fwd_tc_block's rows x the block's
// samples, bf16). Each returns the CUDA error of its launches (0 =
// launched).
extern "C" int stnerf_spacenet_fwd_tc(const void* pos, const void* dir, const void* time,
                                      const void* weights, const void* frags,
                                      const void* biases, const void* norms,
                                      const void* offsets, const void* active, void* out,
                                      int M, int pos_rows, int dir_rows, int time_rows,
                                      int width, int head, int n_rgb, void* taps,
                                      void* stream) {
  Params p{};
  int tb = 0;
  size_t smem = 0;
  if (!fill_params(p, static_cast<const int*>(offsets), M, pos_rows, dir_rows, time_rows, width,
                   head, n_rgb) ||
      !fwd_block(p, &tb, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdKernel kernel = fwd_kernel_for(tb);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(M + tb - 1) / tb, TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const unsigned short*>(weights),
      static_cast<const uint4*>(frags), static_cast<const float*>(biases),
      static_cast<const float*>(norms), static_cast<const int*>(active),
      static_cast<float*>(out), static_cast<unsigned short*>(taps), p);
  return static_cast<int>(cudaGetLastError());
}

// The forward's launch for the same ints as stnerf_spacenet_fwd_tc: out[0]
// the block's samples, out[1] its dynamic shared memory, out[2] the rows of
// a block's taps. Returns a CUDA error (0 = the launch would be configured).
extern "C" int stnerf_spacenet_fwd_tc_block(int M, int pos_rows, int dir_rows, int time_rows,
                                            int width, int head, int n_rgb, void* out) {
  Params p{};
  int tb = 0;
  size_t smem = 0;
  if (!fill_params(p, nullptr, M, pos_rows, dir_rows, time_rows, width, head, n_rgb) ||
      !fwd_block(p, &tb, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = tb;
  o[1] = static_cast<int>(smem);
  o[2] = p.rec_rows;
  return 0;
}

// The bytes of workspace stnerf_spacenet_bwd_tc needs for these shapes, into
// *bytes (a host int64): the records, then the partial sums. The ints are
// stnerf_spacenet_bwd_tc's. Returns 0 or a CUDA error.
extern "C" int stnerf_spacenet_bwd_tc_workspace(int M, int pos_rows, int dir_rows,
                                                int time_rows, int width, int head, int n_rgb,
                                                int n_w, int n_b, void* bytes) {
  Layout L;
  if (!make_layout(L, nullptr, M, pos_rows, dir_rows, time_rows, width, head, n_rgb, n_w, n_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(bytes) =
      static_cast<long long>(L.rec_bytes + L.part_bytes + L.norm_bytes);
  return 0;
}

// The backward's launch for the same ints as
// stnerf_spacenet_bwd_tc_workspace: out[0] pass 1's block of samples,
// out[1] its dynamic shared memory. Returns 0 or a CUDA error.
extern "C" int stnerf_spacenet_bwd_tc_block(int M, int pos_rows, int dir_rows, int time_rows,
                                            int width, int head, int n_rgb, int n_w, int n_b,
                                            void* out) {
  Layout L;
  if (!make_layout(L, nullptr, M, pos_rows, dir_rows, time_rows, width, head, n_rgb, n_w, n_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = L.bm;
  o[1] = static_cast<int>(L.smem);
  return 0;
}

// n_w and n_b are the packed weights' and biases' element counts; gw and gb
// (float32, n_w and n_b entries) are overwritten; `workspace` holds
// stnerf_spacenet_bwd_tc_workspace's bytes.
extern "C" int stnerf_spacenet_bwd_tc(const void* pos, const void* dir, const void* time,
                                      const void* drgb, const void* dsig, const void* weights,
                                      const void* frags, const void* biases,
                                      const void* offsets, const void* active, void* gw,
                                      void* gb, void* dpos, void* ddir, void* workspace, int M,
                                      int pos_rows, int dir_rows, int time_rows, int width,
                                      int head, int n_rgb, int n_w, int n_b, void* stream) {
  Layout L;
  if (!make_layout(L, static_cast<const int*>(offsets), M, pos_rows, dir_rows, time_rows,
                   width, head, n_rgb, n_w, n_b)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* records = static_cast<unsigned short*>(workspace);
  auto* partial = reinterpret_cast<float*>(static_cast<unsigned char*>(workspace) + L.rec_bytes);
  float* norms = partial + L.part_bytes / sizeof(float);
  const auto* act = static_cast<const int*>(active);
  const auto* wts = static_cast<const unsigned short*>(weights);
  const BwdKernel kernel = bwd_kernel_for(L.bm);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.smem));
  if (e == cudaSuccess) e = launch_norms(L, wts, norms, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<L.dw.n_blocks, TC_THREADS, L.smem, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const float*>(drgb),
      static_cast<const float*>(dsig), act, wts, static_cast<const uint4*>(frags),
      static_cast<const float*>(biases), norms, records, static_cast<float*>(dpos),
      static_cast<float*>(ddir), L.p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_dw(L, records, act, partial, n_w, n_b, static_cast<float*>(gw),
                                    static_cast<float*>(gb), s));
}
