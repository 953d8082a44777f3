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
//     warpgroups. Each weight byte fetched from L2 serves 128 samples. A
//     layer wider than 256 takes a smaller block, chosen per launch: the
//     largest of 128, 64 and 32 samples whose tiles fit shared memory (64
//     at 512, 32 at 1024); such a block covers one flag tile or half of
//     one, the flag of sample m staying flags[m / 64].
//   * Every layer of width >= 32 is a wgmma product: the weights are the A
//     operand, loaded from L2 straight into registers in fragment order
//     (gathered on the host by fused_field.py PackedField.tc, zero-padded to 64
//     output rows and 16 inputs), the activations are the B operand, bf16
//     in shared memory (two ping-pong tiles of up to 256 x 128, 64 KB
//     each; 512 x 64 and 1024 x 32 at the wider widths). The epilogue
//     adds the bias, applies the ReLU, rounds to bf16 and writes the next
//     tile; fence.proxy.async and a barrier separate the layers.
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
// With `checked` (the training forward) every product layer (motion net,
// trunk, rgb head) is tc_blocks.cuh's dense_checked: the outputs whose
// tensor-core sum lies near a bf16 rounding tie or the ReLU's 0 are
// recomputed in float32 as the plain version sums them, so that they round
// as it rounds them. wgmma truncates its float32 accumulation, and in
// training such flips move the pose-refinement gradients past their bar
// (PERF.md, Findings PR 11); rendering keeps the plain products. The check
// is one rule, WideRule, on the pack's weight-row norms
// (PackedField.tc_norms) and the backward's input-norm sum: the rule of
// K2's recompute, so the backward differentiates the bits this forward
// computed. It takes a 4 KB mask, 16
// KB of lists and 1.5 KB of norms of shared memory (186 KB of the 227 KB at
// the taekwondo widths). With `taps` (checks only) the checked forward also
// copies each layer's bf16 output and the encodings into K2's record
// layout (tc_blocks.cuh tap).
//
// stnerf_tc_row_norms: the forwards' pre-pass (tc_blocks.cuh
// row_norms_kernel, which the backward runs once a launch), the squared L2
// norm of each output row of the checked weight slots, made once per packed
// field (PackedField.tc_norms).

#include "field_common.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int FLAG_TILE = 64;  // samples per skip flag (fused_field.py TILE)

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int f_off[N_W];  // forward fragments (PackedField.tc), in 16-byte units; -1 = absent
  int n_off[N_W];  // each checked slot's first row norm (PackedField.tc_norms); -1 = none
  int rec[N_REC];  // the taps: each record tile's first row (record_layout)
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb, motion_mode;
  int rows_a, pos_rows, time_rows, menc_rows, pos_pad, dir_pad, time_pad, menc_pad, rec_rows;
};

// One block of BM samples: 128 (two skip-flag tiles), or 64 or 32 (one
// tile or half of one) for layers wider than 256.
template <int BM, bool CHECKED>
__global__ void __launch_bounds__(TC_THREADS, 1)
fused_field_tc_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                      const float* __restrict__ dir, const int* __restrict__ flags,
                      const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                      const float* __restrict__ bias, const float* __restrict__ norms,
                      float* __restrict__ out, unsigned short* __restrict__ taps,
                      const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  constexpr bool TWO = BM > FLAG_TILE;  // the block covers two flag tiles
  int on0 = 1, on1 = TWO && m0 + FLAG_TILE < M;
  if (flags != nullptr) {
    on0 = flags[m0 / FLAG_TILE];
    if (TWO) on1 = on1 && flags[m0 / FLAG_TILE + 1];
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
  const int n_cnt = !TWO ? BM : on0 && on1 ? BM : FLAG_TILE;

  unsigned short* A = reinterpret_cast<unsigned short*>(smem);  // rows_a x BM
  unsigned short* B = A + p.rows_a * BM;                         // rows_a x BM
  unsigned short* P = B + p.rows_a * BM;                         // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                        // dir_pad: relu(dir encoding)
  unsigned short* T = D + p.dir_pad * BM;                        // time_pad: relu(time encoding)
  float* X = reinterpret_cast<float*>(T + p.time_pad * BM);      // 4 x BM: xyz rows, id row
  float* R = X + 4 * BM;                                         // 4 x BM: flow or rgb, sigma
  const Check ck = make_check(R + 4 * BM, p.rows_a, BM, LIST);   // CHECKED: the check's scratch

  if (CHECKED) {
    for (int i = t; i < p.rows_a * BM / 32; i += TC_THREADS) ck.mask[i] = 0;
  }
  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  const auto W = [&](int slot) { return wts + p.w_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  // the segment of weight slot s over the input tile b (k_rows rows), with
  // its row norms when CHECKED
  const auto seg = [&](int slot, const unsigned short* b, int k_rows) {
    return Seg{frags + p.f_off[slot], b, k_rows / 16, CHECKED ? norms + p.n_off[slot] : nullptr};
  };
  // CHECKED with taps: record tile r of this block <- the tile's rows
  const auto rec = [&](int r, const unsigned short* tile, int rows) {
    if constexpr (CHECKED) tap<BM>(taps, p.rec_rows, p.rec[r], tile, rows);
  };
  // a layer into o, then its record tile r
  const auto dense = [&](const Seg* s, int nseg, int O, int bslot, unsigned short* o, int r) {
    if constexpr (CHECKED) {
      dense_checked<BM, false, LIST>(s, nseg, O, Bi(bslot), o, ck.mask, ck.lists,
                                     wide_rule<BM>(s, nseg, O, n_lo, n_cnt, ck.wn, ck.xn),
                                     n_lo, n_cnt);
    } else {
      tc_dense<BM>(s, nseg, O, Bi(bslot), o, n_lo, n_cnt);
    }
    layer_sync();
    rec(r, o, O);
  };
  const auto dense1 = [&](int slot, const unsigned short* in, int k_rows, int bslot, int O,
                          unsigned short* o, int r) {
    const Seg s = seg(slot, in, k_rows);
    dense(&s, 1, O, bslot, o, r);
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
    rec(R_U0, A, p.menc_pad);
    const int mw = p.motion_width;
    dense1(W_M0, A, p.menc_pad, B_M0, mw, B, R_U0 + 1);
    dense1(W_M0 + 1, B, mw, B_M0 + 1, mw, A, R_U0 + 2);
    dense1(W_M0 + 2, A, mw, B_M0 + 2, mw, B, R_U0 + 3);
    dense1(W_M0 + 3, B, mw, B_M0 + 3, mw, A, R_U0 + 4);
    dense1(W_M0 + 4, A, mw, B_M0 + 4, mw, B, R_U0 + 5);
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
  rec(R_POS, P, p.pos_pad);
  rec(R_DIR, D, p.dir_pad);
  if (p.use_time) rec(R_TIME, T, p.time_pad);

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
  small_fwd<BM>(W(W_DW), A, wd, Bi(B_DB), 1, R + 3 * BM);  // sigma
  {
    // rgb head: relu([x | dir | time]); x >= 0 already, D and T hold relu'd values
    const Seg s[3] = {seg(W_R1A, A, wd), seg(W_R1B, D, p.dir_pad), seg(W_R1C, T, p.time_pad)};
    dense(s, p.use_time ? 3 : 2, p.head, B_RB1, B, R_HS0);
  }
  if (p.n_rgb == 2) {
    small_fwd<BM>(W(W_RGB1), B, p.head, Bi(B_RGB1), 3, R);
  } else {
    dense1(W_RGB1, B, p.head, B_RGB1, p.head, A, R_HS0 + 1);
    dense1(W_RGB2, A, p.head, B_RGB2, p.head, B, R_HS0 + 2);
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

using Kernel = decltype(&fused_field_tc_kernel<128, false>);

Kernel kernel_for(int bm, bool checked) {
  if (bm == 128) {
    return checked ? fused_field_tc_kernel<128, true> : fused_field_tc_kernel<128, false>;
  }
  if (bm == 64) {
    return checked ? fused_field_tc_kernel<64, true> : fused_field_tc_kernel<64, false>;
  }
  return checked ? fused_field_tc_kernel<32, true> : fused_field_tc_kernel<32, false>;
}

// Params of a launch with the C entry point's ints, its block and the
// block's dynamic shared memory: the largest block of 128, 64 or 32 samples
// whose tiles fit the card's shared memory (128 at every width up to 256);
// false for shapes the kernel does not take.
bool configure(Params& p, const int* off, int M, int dir_rows, int width, int head,
               int motion_width, int freqs, int include_input, int use_time, int n_rgb,
               int motion_mode, int checked, int* bm, size_t* smem) {
  if (M <= 0 || dir_rows <= 0 || !fwd_width(width) || !fwd_width(head) ||
      (motion_mode != 0 && !fwd_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2) {
    return false;
  }
  if (off != nullptr) {
    for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
    for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
    for (int i = 0; i < N_W; ++i) p.f_off[i] = off[N_W + N_B + i];
    for (int i = 0; i < N_W; ++i) p.n_off[i] = off[3 * N_W + N_B + i];
  }
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
  record_layout(p);
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  for (const int b : {128, 64, 32}) {
    // the act tiles, the encodings, the float32 rows; checked: the check's scratch
    size_t bytes = static_cast<size_t>(2 * rows_a + p.pos_pad + p.dir_pad + p.time_pad) * b * 2 +
                   static_cast<size_t>(8) * b * sizeof(float);
    if (checked) bytes += check_bytes(rows_a, b, LIST);
    if (bytes <= static_cast<size_t>(optin)) {
      *bm = b;
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
// PackedField.tc): weights are the packed bf16 buffer (fused_field.py
// pack_field), frags its PackedField.tc fragments, norms its
// PackedField.tc_norms (null when not `checked`). `checked` != 0 recomputes
// the near-tie outputs (the training forward); `taps`, null or (checks
// only, with `checked`) a device buffer for each block's forward tiles of
// K2's record (stnerf_fused_field_tc_block's rows x the block's samples,
// bf16). Each returns the CUDA error of its launch (0 = launched).
extern "C" int stnerf_fused_field_tc(const void* xyz, const void* ids, const void* dir,
                                     const void* flags, const void* weights, const void* frags,
                                     const void* biases, const void* norms, const void* offsets,
                                     void* out, int M, int dir_rows, int width, int head,
                                     int motion_width, int freqs, int include_input,
                                     int use_time, int n_rgb, int motion_mode, int checked,
                                     void* taps, void* stream) {
  Params p;
  int bm = 0;
  size_t smem = 0;
  if (!configure(p, static_cast<const int*>(offsets), M, dir_rows, width, head, motion_width,
                 freqs, include_input, use_time, n_rgb, motion_mode, checked, &bm, &smem) ||
      (checked && norms == nullptr) || (!checked && taps != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Kernel kernel = kernel_for(bm, checked != 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<(M + bm - 1) / bm, TC_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ids),
      static_cast<const float*>(dir), static_cast<const int*>(flags),
      static_cast<const unsigned short*>(weights), static_cast<const uint4*>(frags),
      static_cast<const float*>(biases), static_cast<const float*>(norms),
      static_cast<float*>(out), static_cast<unsigned short*>(taps), p);
  return static_cast<int>(cudaGetLastError());
}

// The launch of stnerf_fused_field_tc with the same ints: out[0] the
// block's samples, out[1] its dynamic shared memory, out[2] the rows of a
// block's taps. Returns a CUDA error (0 = the launch would be configured).
extern "C" int stnerf_fused_field_tc_block(int M, int dir_rows, int width, int head,
                                           int motion_width, int freqs, int include_input,
                                           int use_time, int n_rgb, int motion_mode, int checked,
                                           void* out) {
  Params p;
  int bm = 0;
  size_t smem = 0;
  if (!configure(p, nullptr, M, dir_rows, width, head, motion_width, freqs, include_input,
                 use_time, n_rgb, motion_mode, checked, &bm, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = bm;
  o[1] = static_cast<int>(smem);
  o[2] = p.rec_rows;
  return 0;
}

// The squared L2 norm of every output row of n_jobs weight slots into out
// (floats, the jobs' rows in order): `jobs` a host int array of (packed
// offset, k inputs, o outputs) per slot (fused_field.py PackedField.tc_norms).
extern "C" int stnerf_tc_row_norms(const void* weights, const void* jobs, int n_jobs, void* out,
                                   void* stream) {
  if (n_jobs <= 0 || n_jobs > N_W) return static_cast<int>(cudaErrorInvalidValue);
  NormJobs nj;
  const int* in = static_cast<const int*>(jobs);
  nj.n = n_jobs;
  nj.at[0] = 0;
  for (int j = 0; j < n_jobs; ++j) {
    nj.w_off[j] = in[3 * j];
    nj.k[j] = in[3 * j + 1];
    nj.o[j] = in[3 * j + 2];
    nj.at[j + 1] = nj.at[j] + nj.o[j];
  }
  const int n = nj.at[n_jobs];
  row_norms_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned short*>(weights), nj, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
