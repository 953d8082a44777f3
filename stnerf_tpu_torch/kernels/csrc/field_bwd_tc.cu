// Backward of the fused field in bf16 on Hopper's tensor cores (sm_90a).
//
// Replaces stnerf_tpu/kernels/field_vjp.py::_call_bwd (the Pallas TPU kernel
// _field_bwd_kernel / _field_bwd_body, with spacenet_vjp._bwd_math) for bf16
// fields; float32 fields keep the CUDA-core kernel of field_bwd.cu. The same
// function as there: per block, recompute the field forward (motion net,
// encodings, trunk, heads), backpropagate the rgb and sigma cotangents
// through all of it, and emit float32 weight and bias gradients in the
// packed layout (summed over all blocks), d_xyz (3, M) and d_dir_enc
// (dir_rows, M). A tile whose skip flag is 0 writes zero d_xyz and d_dir and
// adds nothing.
//
// Bound: about 3x the forward's arithmetic per sample (recompute, dx = W dy,
// dW = x dy^T), so the tensor cores' rate bounds it, as the forward.
//
// Two passes and a fixed-order sum, no atomics (tc_blocks.cuh has the
// building blocks):
//   1. field_bwd_tc_kernel, a block per 64 samples (one skip flag): the
//      recompute and dx = W dy on wgmma, with the weights as register A
//      fragments (PackedField.tc's forward and backward packings) and the
//      activations or cotangents as the B tile; the 1- and 3-wide layers and
//      the encodings on CUDA cores. Every cotangent a product reads is
//      rounded to bf16 (the TPU kernel's dy.astype(dtype)), so it is stored
//      in bf16, in place of the activation that masks it: once a layer's
//      input x has been saved, dx = W dy masked by x > 0 overwrites x. d(pos
//      enc), d_dir and d(motion enc) stay float32. Each layer's input x and
//      output cotangent dy is copied, as it stands in shared memory, into the
//      block's record in global memory (Rec: 37 bf16 tiles, ~10.5 KB a
//      sample at the taekwondo widths) by bulk copies marked evict-first in
//      L2: plain stores of the same bytes pushed out of L2 the weight
//      fragments that every product reads from it, and were slower.
//   2. field_dw_kernel: dW = x dy^T and db = sum dy for every layer, K
//      running over the samples, on wgmma with both operands from shared
//      memory. A block takes one 128 x NT tile of one layer's dW over one
//      range of 64-sample records, streamed through a 4-stage ring by bulk
//      copies (cp.async.bulk, one per operand per record) signalled on
//      mbarriers. Each record's product starts a fresh accumulator and is
//      added into a float32 total; a record whose skip flag is 0 is skipped.
//      Each range writes its own float32 partials.
//   3. field_dw_reduce: each gradient entry is the sum of its ranges'
//      partials in range order. The result is the same on every run.
// The weight gradients as float4 atomics from pass 1 (the former design)
// took 34.7% of the kernel on the performer field (PERF.md, PR 5).
//
// Shared memory of pass 1, reckoned at the taekwondo widths (W = 256, H =
// 128, motion 128): BM = 64 samples a block, the four trunk slots 4 x 256 x
// 64 x 2 B = 128 KB (trunk layers 4-7 are kept through the heads' and stage
// 2's backward; layers 1-3 are recomputed after it), the rgb head 16 KB (48
// KB with the 4-layer head), the encodings 16 KB, float32 d(pos enc) and
// per-sample rows 20 KB: 180 KB (213 KB with the 4-layer head) of the 227
// KB. 128 samples would need 256 KB for the trunk slots alone. The motion
// net's tiles (its encoding, five hidden layers and float32 d(motion enc),
// 108 KB) reuse the trunk's space, recomputed at the end.

#include <cstdint>

#include "field_common.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int BM = 64;  // samples per block = one skip-flag tile (fused_field.py TILE)

// The tiles of a block's record, in rows of BM bf16 samples (act layout).
enum Rec {
  R_HS0 = 0,     // rgb head activations (3)
  R_DHS0 = 3,    // their cotangents (3)
  R_G3RGB = 6,   // the rgb cotangent, 3 rows padded to 16
  R_A0 = 7,      // trunk activations a0-a6 (7)
  R_D0 = 14,     // their cotangents (7)
  R_POS = 21,    // position encoding
  R_DIR = 22,    // relu(direction encoding)
  R_TIME = 23,   // relu(time encoding)
  R_SIG = 24,    // the sigma cotangent, 1 row padded to 16
  R_U0 = 25,     // motion encoding and hidden layers u0-u5 (6)
  R_DU1 = 31,    // the hidden layers' cotangents du1-du5 (5)
  R_G3M = 36,    // the flow cotangent, 3 rows padded to 16
  N_REC = 37
};

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int f_off[N_W];  // forward fragments (PackedField.tc), 16-byte units; -1 = absent
  int g_off[N_W];  // backward (dx) fragments
  int rec[N_REC];  // row offset of each record tile; -1 = absent
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb, motion_mode;
  int pos_rows, time_rows, menc_rows, pos_pad, dir_pad, time_pad, menc_pad, u_rows, rec_rows;
};

struct Ctx {
  const Params& p;
  const unsigned short* wts;
  const uint4* frags;
  const float* bias;
  unsigned short* rec;  // this block's record
  __device__ const unsigned short* W(int s) const { return wts + p.w_off[s]; }
  __device__ const uint4* F(int s) const { return frags + p.f_off[s]; }
  __device__ const uint4* G(int s) const { return frags + p.g_off[s]; }
  __device__ const float* Bi(int s) const { return bias + p.b_off[s]; }

  // out = dense(in) on the tensor cores, then the barrier before the next product
  __device__ void dense(int slot, const unsigned short* in, int k_rows, int bslot, int O,
                        unsigned short* out) const {
    const Seg s{F(slot), in, k_rows / 16};
    tc_dense<BM>(&s, 1, O, Bi(bslot), out, 0, BM);
    layer_sync();
  }
  // dx = W dy (K = O rows of dy) for the layer's `rows` inputs, to epi
  template <class Epi>
  __device__ void dx(int slot, const unsigned short* dy, int O, int rows, Epi epi) const {
    const Seg s{G(slot), dy, O / 16};
    tc_product<BM>(&s, 1, rows, 0, BM, epi);
  }
  // copy an act tile of `rows` rows (a multiple of 8; written before the
  // last layer_sync) into record tile r: one bulk copy from shared to global
  // memory, issued by thread 0, marked evict-first in L2 so that the
  // records do not push the weight fragments out of it
  __device__ void save(int r, const unsigned short* tile, int rows) const {
    if (threadIdx.x == 0) {
      asm volatile(
          "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, pol;\n}\n"
          ::"l"(rec + static_cast<size_t>(p.rec[r]) * BM),
          "r"(static_cast<uint32_t>(__cvta_generic_to_shared(tile))), "r"(rows * BM * 2)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  // the copies issued so far have read their tiles, which may be
  // overwritten after this barrier
  __device__ void saved() const {
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();
  }
  // every copy complete (before the block exits)
  __device__ void done() const {
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
  // float32 rows (already rounded to bf16) into record tile r, zero-padded to 16 rows
  __device__ void save_rows(int r, const float* rows_f, int rows) const {
    unsigned short* dst = rec + static_cast<size_t>(p.rec[r]) * BM;
    for (int i = threadIdx.x; i < 16 * BM; i += TC_THREADS) {
      const int k = i / BM, m = i % BM;
      dst[act_idx<BM>(k, m)] = k < rows ? f_bf(rows_f[k * BM + m]) : 0;
    }
  }
  // the next cotangent: round(dx), masked where the stored activation x is 0
  static __device__ auto mask_round(unsigned short* x) {
    return [=](int r, int c, float v0, float v1) {
      unsigned* q = reinterpret_cast<unsigned*>(x + act_idx<BM>(r, c));
      const unsigned a = *q;
      const float y0 = __uint_as_float(a << 16) > 0.f ? rnd<true>(v0) : 0.f;
      const float y1 = __uint_as_float(a & 0xffff0000u) > 0.f ? rnd<true>(v1) : 0.f;
      *q = static_cast<unsigned>(f_bf(y0)) | (static_cast<unsigned>(f_bf(y1)) << 16);
    };
  }
  // the backward of a hidden layer x (K_in rows, record tile rx) -> dy (O
  // rows, record tile ry): save both for pass 2, then dx masked by x > 0 and
  // rounded, in place of x
  __device__ void hidden_bwd(int slot, unsigned short* x, int K_in, int rx,
                             const unsigned short* dy, int O, int ry) const {
    save(rx, x, K_in);
    save(ry, dy, O);
    saved();
    dx(slot, dy, O, K_in, mask_round(x));
    layer_sync();
  }
};

// Motion net forward: encode (xyz, id) into U[0] (menc_pad rows), the five
// hidden layers into U[1..5] (motion_width rows each), the flow (3 rows,
// float32) into R.
__device__ void motion_forward(const Ctx& c, const float* X, unsigned short* const* U,
                               float* R) {
  const Params& p = c.p;
  for (int i = threadIdx.x; i < 4 * BM; i += TC_THREADS) {
    const int ch = i / BM, m = i % BM;
    const float v = X[ch * BM + m];
    unsigned short* u0 = U[0];
    const auto emit = [=](int row, float val) { u0[act_idx<BM>(row, m)] = f_bf(val); };
    if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
      const float id = X[3 * BM + m];
      const float lo = floorf(id);
      encode_rows<true>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v, __fsub_rn(id, lo),
                        ch, 4, p.freqs, p.inc, false, emit);
    } else {
      encode_rows<true>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, emit);
    }
  }
  zero_rows<BM>(U[0], p.menc_rows, p.menc_pad);
  layer_sync();
  const int mw = p.motion_width;
  for (int k = 0; k < 5; ++k) c.dense(W_M0 + k, U[k], k ? mw : p.menc_pad, B_M0 + k, mw, U[k + 1]);
  small_fwd<BM>(c.W(W_M0 + 5), U[5], mw, c.Bi(B_M0 + 5), 3, R);
  __syncthreads();
}

__global__ void __launch_bounds__(TC_THREADS, 1)
field_bwd_tc_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                    const float* __restrict__ dir, const float* __restrict__ drgb,
                    const float* __restrict__ dsig, const int* __restrict__ flags,
                    const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                    const float* __restrict__ bias, unsigned short* __restrict__ records,
                    float* __restrict__ dxyz, float* __restrict__ ddir, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (flags != nullptr && flags[blockIdx.x] == 0) {
    for (int i = t; i < (3 + p.dir_rows) * BM; i += TC_THREADS) {
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
  const Ctx c{p, wts, frags, bias,
              records + static_cast<size_t>(blockIdx.x) * p.rec_rows * BM};
  const int W = p.width, H = p.head, mw = p.motion_width;
  unsigned short* U = reinterpret_cast<unsigned short*>(smem);  // u_rows
  unsigned short* S0 = U;                                        // four trunk slots of W rows
  unsigned short* S1 = U + W * BM;
  unsigned short* S2 = U + 2 * W * BM;
  unsigned short* S3 = U + 3 * W * BM;
  unsigned short* HS[3] = {U + 4 * W * BM, U + (4 * W + H) * BM, U + (4 * W + 2 * H) * BM};
  unsigned short* P = U + p.u_rows * BM;                        // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                       // dir_pad: relu(direction enc)
  unsigned short* T = D + p.dir_pad * BM;                       // time_pad: relu(time enc)
  float* X = reinterpret_cast<float*>(T + p.time_pad * BM);     // 4: xyz, id
  float* XD = X + 4 * BM;    // 3: displaced xyz
  float* R = XD + 3 * BM;    // 4: flow, or the sigma cotangent
  float* G3 = R + 4 * BM;    // 4: the rgb or flow cotangent
  float* DP = G3 + 4 * BM;   // pos_rows: d(position encoding)
  // the motion net's tiles, in the trunk's space
  unsigned short* MU[6];
  MU[0] = U;
  for (int k = 1; k < 6; ++k) MU[k] = U + (p.menc_pad + (k - 1) * mw) * BM;
  float* DM = reinterpret_cast<float*>(U + (p.menc_pad + 5 * mw) * BM);  // d(motion enc)

  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  // ---- forward: deformation, encodings, trunk, rgb head ----
  if (p.motion_mode) {
    motion_forward(c, X, MU, R);
    for (int i = t; i < 3 * BM; i += TC_THREADS) XD[i] = __fadd_rn(X[i], R[i]);
  } else {
    for (int i = t; i < 3 * BM; i += TC_THREADS) XD[i] = X[i];
  }
  __syncthreads();
  for (int i = t; i < 4 * BM; i += TC_THREADS) {
    const int ch = i / BM, m = i % BM;
    if (ch < 3) {
      encode_rows<true>(XD[ch * BM + m], XD[ch * BM + m], 0.f, ch, 3, p.freqs, p.inc, false,
                        [=](int row, float val) { P[act_idx<BM>(row, m)] = f_bf(val); });
    } else if (p.use_time) {
      const float v = X[3 * BM + m];
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
  c.save(R_POS, P, p.pos_pad);
  c.save(R_DIR, D, p.dir_pad);
  if (p.use_time) c.save(R_TIME, T, p.time_pad);
  const int kp = p.pos_pad;
  // a0 -> S0, a1 -> S2, a2 -> S3, a3 -> S1, a4 -> S2, a5 -> S3, a6 -> S0
  c.dense(W_1, P, kp, B_1, W, S0);
  c.dense(W_1 + 1, S0, W, B_1 + 1, W, S2);
  c.dense(W_1 + 2, S2, W, B_1 + 2, W, S3);
  c.dense(W_1 + 3, S3, W, B_1 + 3, W, S1);
  {
    const Seg s[2] = {{c.F(W_S2A), S1, W / 16}, {c.F(W_S2B), P, kp / 16}};
    tc_dense<BM>(s, 2, W, c.Bi(B_SB1), S2, 0, BM);
    layer_sync();
  }
  c.dense(W_S2W2, S2, W, B_SB2, W, S3);
  c.dense(W_S2W3, S3, W, B_SB3, W, S0);
  {
    // rgb head: relu([a6 | dir | time]); a6 >= 0, D and T hold relu'd values
    const Seg s[3] = {{c.F(W_R1A), S0, W / 16}, {c.F(W_R1B), D, p.dir_pad / 16},
                      {c.F(W_R1C), T, p.time_pad / 16}};
    tc_dense<BM>(s, p.use_time ? 3 : 2, H, c.Bi(B_RB1), HS[0], 0, BM);
    layer_sync();
  }
  for (int i = 1; i < p.n_rgb - 1; ++i) c.dense(W_RGB1 + i - 1, HS[i - 1], H, B_RGB1 + i - 1, H, HS[i]);

  // ---- rgb head backward ----
  for (int i = t; i < 3 * BM; i += TC_THREADS) {
    const int gm = m0 + i % BM;
    G3[i] = gm < M ? rnd<true>(drgb[static_cast<size_t>(i / BM) * M + gm]) : 0.f;
  }
  for (int i = t; i < BM; i += TC_THREADS) R[i] = m0 + i < M ? rnd<true>(dsig[m0 + i]) : 0.f;
  __syncthreads();
  {
    const int last = p.n_rgb - 2;  // the head's last hidden tile, input of the 3-wide layer
    unsigned short* x = HS[last];
    c.save(R_HS0 + last, x, H);
    c.save_rows(R_G3RGB, G3, 3);
    c.save_rows(R_SIG, R, 1);
    c.saved();
    small_dx<BM>(c.W(W_RGB1 + last), H, 3, G3, [=](int k, int m, float acc) {
      unsigned short* q = x + act_idx<BM>(k, m);
      *q = bf_f(*q) > 0.f ? f_bf(rnd<true>(acc)) : 0;
    });
    layer_sync();
    for (int i = last - 1; i >= 0; --i) {
      c.hidden_bwd(W_RGB1 + i, HS[i], H, R_HS0 + i, HS[i + 1], H, R_DHS0 + i + 1);
    }
  }
  // HS[0]: d(first head layer, pre-ReLU); its inputs are [a6 | dir | time]
  c.save(R_DHS0, HS[0], H);
  c.save(R_A0 + 6, S0, W);
  c.saved();
  c.dx(W_R1B, HS[0], H, p.dir_rows, [=](int r, int cc, float v0, float v1) {
    const unsigned a = *reinterpret_cast<const unsigned*>(D + act_idx<BM>(r, cc));
    const int gm = m0 + cc;
    float* o = ddir + static_cast<size_t>(r) * M + gm;
    if (gm < M) o[0] = __uint_as_float(a << 16) > 0.f ? v0 : 0.f;
    if (gm + 1 < M) o[1] = __uint_as_float(a & 0xffff0000u) > 0.f ? v1 : 0.f;
  });
  {
    // d(a6) from the head, plus the density head's dw * d_sigma, masked by a6
    const unsigned short* dw = c.W(W_DW);
    c.dx(W_R1A, HS[0], H, W, [=](int r, int cc, float v0, float v1) {
      unsigned* q = reinterpret_cast<unsigned*>(S0 + act_idx<BM>(r, cc));
      const unsigned a = *q;
      const float wr = bf_f(dw[r]);
      const float y0 = rnd<true>(__fadd_rn(rnd<true>(v0), __fmul_rn(wr, R[cc])));
      const float y1 = rnd<true>(__fadd_rn(rnd<true>(v1), __fmul_rn(wr, R[cc + 1])));
      *q = static_cast<unsigned>(__uint_as_float(a << 16) > 0.f ? f_bf(y0) : 0) |
           (static_cast<unsigned>(__uint_as_float(a & 0xffff0000u) > 0.f ? f_bf(y1) : 0) << 16);
    });
  }
  layer_sync();

  // ---- stage 2 backward ----
  c.hidden_bwd(W_S2W3, S3, W, R_A0 + 5, S0, W, R_D0 + 6);  // a6 = relu(s2w3^T a5 + sb3)
  c.hidden_bwd(W_S2W2, S2, W, R_A0 + 4, S3, W, R_D0 + 5);  // a5 = relu(s2w2^T a4 + sb2)
  // a4 = relu(s2a^T a3 + s2b^T p + sb1)
  c.save(R_A0 + 3, S1, W);
  c.save(R_D0 + 4, S2, W);
  c.saved();
  c.dx(W_S2B, S2, W, p.pos_rows, [=](int r, int cc, float v0, float v1) {
    DP[r * BM + cc] = v0;
    DP[r * BM + cc + 1] = v1;
  });
  c.dx(W_S2A, S2, W, W, Ctx::mask_round(S1));
  layer_sync();

  // ---- stage 1: recompute a0-a2 into the dead slots, then backward ----
  c.dense(W_1, P, kp, B_1, W, S0);
  c.dense(W_1 + 1, S0, W, B_1 + 1, W, S2);
  c.dense(W_1 + 2, S2, W, B_1 + 2, W, S3);
  c.hidden_bwd(W_1 + 3, S3, W, R_A0 + 2, S1, W, R_D0 + 3);  // x = a2, dy = d(a3)
  c.hidden_bwd(W_1 + 2, S2, W, R_A0 + 1, S3, W, R_D0 + 2);  // x = a1
  c.hidden_bwd(W_1 + 1, S0, W, R_A0, S2, W, R_D0 + 1);      // x = a0
  c.save(R_D0, S0, W);
  c.dx(W_1, S0, W, p.pos_rows, [=](int r, int cc, float v0, float v1) {
    DP[r * BM + cc] = __fadd_rn(v0, DP[r * BM + cc]);
    DP[r * BM + cc + 1] = __fadd_rn(v1, DP[r * BM + cc + 1]);
  });
  layer_sync();
  c.saved();  // the motion net's recompute overwrites the trunk's tiles

  // ---- d(displaced xyz) through the position encoding ----
  const int ch = t / BM, m = t % BM;
  float dx_out = 0.f;
  if (t < 3 * BM) dx_out = encode_vjp(XD[t], DP, ch, 3, p.freqs, p.inc, 1.f, BM, m);

  // ---- motion net backward (its forward recomputed) ----
  if (p.motion_mode) {
    if (t < 3 * BM) G3[t] = rnd<true>(dx_out);
    motion_forward(c, X, MU, R);
    unsigned short* x5 = MU[5];
    c.save(R_U0 + 5, x5, mw);
    c.save_rows(R_G3M, G3, 3);
    c.saved();
    small_dx<BM>(c.W(W_M0 + 5), mw, 3, G3, [=](int k, int mm, float acc) {
      unsigned short* q = x5 + act_idx<BM>(k, mm);
      *q = bf_f(*q) > 0.f ? f_bf(rnd<true>(acc)) : 0;
    });
    layer_sync();
    for (int k = 4; k >= 1; --k) {
      c.hidden_bwd(W_M0 + k, MU[k], mw, R_U0 + k, MU[k + 1], mw, R_DU1 + k);
    }
    c.save(R_U0, MU[0], p.menc_pad);
    c.save(R_DU1, MU[1], mw);
    c.dx(W_M0, MU[1], mw, p.menc_rows, [=](int r, int cc, float v0, float v1) {
      DM[r * BM + cc] = v0;
      DM[r * BM + cc + 1] = v1;
    });
    __syncthreads();
    // DM: d(motion encoding), float32; x_d = xyz + flow(xyz), both paths feed d_xyz
    if (t < 3 * BM) {
      const float v = X[t];
      float d_m;
      if (p.motion_mode == 2) {  // enc = (1-w) e_lo + w e_hi; w is not differentiated
        const float id = X[3 * BM + m];
        const float wt = __fsub_rn(id, floorf(id));
        d_m = __fadd_rn(encode_vjp(v, DM, ch, 4, p.freqs, p.inc, __fsub_rn(1.f, wt), BM, m),
                        encode_vjp(v, DM, ch, 4, p.freqs, p.inc, wt, BM, m));
      } else {
        d_m = encode_vjp(v, DM, ch, 4, p.freqs, p.inc, 1.f, BM, m);
      }
      dx_out = __fadd_rn(dx_out, d_m);
    }
  }
  if (t < 3 * BM && m0 + m < M) dxyz[static_cast<size_t>(ch) * M + m0 + m] = dx_out;
  c.done();
}

// ------------------------------------------------------------------ pass 2

// One layer's gradient: dW[k, o] = sum_m x[k, m] dy[o, m] with x the record
// tile at row x (k_in rows) and dy the one at row y (o rows), into the
// partials at w_off and, when b_off >= 0, db[o] = sum_m dy[o, m] at b_off
// (the bias's packed offset after the n_w weights). Its dW
// is cut into DW_XR x nt tiles, mt_n along k and nt_n along o.
struct Job {
  int x, k_in, y, o, nt, w_off, b_off, mt_n, nt_n;
};
constexpr int MAX_JOBS = 24;
constexpr int DW_XR = 128;     // rows of x a block takes, 64 per warpgroup
constexpr int DW_STAGES = 4;   // records in flight
constexpr int DW_STAGE = (DW_XR + 128) * BM;  // elements of one stage: x, then dy

struct DwParams {
  Job job[MAX_JOBS];
  int tile0[MAX_JOBS + 1];  // first tile of each job; the last entry is the total
  int n_jobs, rec_rows, n_blocks, ranges, n_params;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// This block's tile of job jb over records [b_lo, b_hi): NT columns of dy
template <int NT>
__device__ void dw_tile(const unsigned short* __restrict__ records, const int* __restrict__ flags,
                        float* __restrict__ partial, const DwParams& p, const Job& jb, int k0,
                        int n0, int b_lo, int b_hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t full[DW_STAGES];
  __shared__ int n_active;
  unsigned short* stages = reinterpret_cast<unsigned short*>(smem);
  const int t = threadIdx.x, wg = t >> 7;
  const int xr = jb.k_in - k0 > 64 ? DW_XR : 64;  // rows of x to load
  const int bytes = (xr + NT) * BM * 2;
  const size_t rec_elems = static_cast<size_t>(p.rec_rows) * BM;
  int next = b_lo;  // the next record to load (thread 0)
  const auto issue = [&](int s) {
    while (flags != nullptr && flags[next] == 0) ++next;
    const unsigned short* base = records + static_cast<size_t>(next++) * rec_elems;
    unsigned short* st = stages + s * DW_STAGE;
    mbar_expect_tx(&full[s], bytes);
    bulk_load(st, base + static_cast<size_t>(jb.x + k0) * BM, xr * BM * 2, &full[s]);
    bulk_load(st + DW_XR * BM, base + static_cast<size_t>(jb.y + n0) * BM, NT * BM * 2, &full[s]);
  };
  if (t == 0) {
    int n = 0;
    for (int b = b_lo; b < b_hi; ++b) n += flags == nullptr || flags[b] != 0;
    n_active = n;
    for (int s = 0; s < DW_STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int s = 0; s < DW_STAGES && s < n; ++s) issue(s);
  }
  __syncthreads();
  const int n = n_active;
  const bool bias = jb.b_off >= 0 && k0 == 0 && t < NT;  // warpgroup 0 sums dy's rows
  float tot[NT / 2], d[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) tot[i] = d[i] = 0.f;
  float bsum = 0.f;
  for (int i = 0; i < n; ++i) {
    const int s = i % DW_STAGES;
    mbar_wait(&full[s], (i / DW_STAGES) & 1);
    const unsigned short* x = stages + s * DW_STAGE + wg * 64 * BM;
    const unsigned short* y = stages + s * DW_STAGE + DW_XR * BM;
    // both warpgroups multiply; rows past k_in (unloaded or another tile's)
    // fall in accumulator rows that are never written out
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BM / 16; ++ks) {
      wgmma_ss<0, 0>(d, make_desc(x + ks * 128, 128, 16 * BM), make_desc(y + ks * 128, 128, 16 * BM),
                     ks);
    }
    wg_commit();
    if (bias) {
#pragma unroll
      for (int g = 0; g < BM / 8; ++g) {
        const uint4 v = *reinterpret_cast<const uint4*>(y + act_idx<BM>(t, 8 * g));
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          bsum += __uint_as_float(u[j] << 16);
          bsum += __uint_as_float(u[j] & 0xffff0000u);
        }
      }
    }
    wg_wait0();
    fence_acc(d);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) tot[j] += d[j];
    __syncthreads();  // every thread is done with stage s
    if (t == 0 && i + DW_STAGES < n) issue(s);
  }
  float* out = partial + static_cast<size_t>(blockIdx.y) * p.n_params;
  const int w = (t & 127) >> 5, l = t & 31;
  const int ra = k0 + 64 * wg + 16 * w + (l >> 2);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (l & 3);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = ra + 8 * h;
      if (row < jb.k_in) {
        if (col < jb.o) out[jb.w_off + row * jb.o + col] = tot[4 * j + 2 * h];
        if (col + 1 < jb.o) out[jb.w_off + row * jb.o + col + 1] = tot[4 * j + 2 * h + 1];
      }
    }
  }
  if (bias && n0 + t < jb.o) out[jb.b_off + n0 + t] = bsum;
}

// grid: (tiles of all jobs, ranges of records); 256 threads
__global__ void __launch_bounds__(TC_THREADS, 1)
field_dw_kernel(const unsigned short* __restrict__ records, const int* __restrict__ flags,
                float* __restrict__ partial, const __grid_constant__ DwParams p) {
  int j = 0;
  while (static_cast<int>(blockIdx.x) >= p.tile0[j + 1]) ++j;
  const Job& jb = p.job[j];
  const int local = blockIdx.x - p.tile0[j];
  const int k0 = (local % jb.mt_n) * DW_XR, n0 = (local / jb.mt_n) * jb.nt;
  const int r = blockIdx.y;
  const int b_lo = static_cast<int>(static_cast<long long>(r) * p.n_blocks / p.ranges);
  const int b_hi = static_cast<int>(static_cast<long long>(r + 1) * p.n_blocks / p.ranges);
  switch (jb.nt) {
    case 16: dw_tile<16>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    case 32: dw_tile<32>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    case 64: dw_tile<64>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    default: dw_tile<128>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
  }
}

// out[i] = sum over ranges of partial[range][i], in range order: the
// weight gradients, then the bias gradients
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

int imax(int a, int b) { return a > b ? a : b; }
int round16(int v) { return (v + 15) / 16 * 16; }

// Everything the launches need, from the field's shape: both kernels'
// parameters, their shared memory and the workspace (the records, then the
// partials). `off` (the packed offsets, as the C entry point's) may be null
// when only the sizes are wanted.
struct Layout {
  Params p;
  DwParams dw;
  size_t smem, rec_bytes, part_bytes;
};

bool make_layout(Layout& L, const int* off, int M, int dir_rows, int width, int head,
                 int motion_width, int freqs, int include_input, int use_time, int n_rgb,
                 int motion_mode, int n_w, int n_b, int sms) {
  if (M <= 0 || dir_rows <= 0 || !kernel_width(width) || !kernel_width(head) ||
      (motion_mode != 0 && !kernel_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2 || n_w <= 0 || n_b <= 0) {
    return false;
  }
  Params& p = L.p;
  for (int i = 0; i < N_W; ++i) {
    p.w_off[i] = off ? off[i] : -1;
    p.f_off[i] = off ? off[N_W + N_B + i] : -1;
    p.g_off[i] = off ? off[2 * N_W + N_B + i] : -1;
  }
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off ? off[N_W + i] : -1;
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
  // bf16 rows: the trunk and head tiles, or the motion tiles and (as two bf16
  // rows per float32 row) d(motion enc)
  p.u_rows = imax(4 * width + (n_rgb - 1) * head,
                  motion_mode ? p.menc_pad + 5 * motion_width + 2 * p.menc_pad : 0);
  L.smem = static_cast<size_t>(p.u_rows + p.pos_pad + p.dir_pad + p.time_pad) * BM * 2 +
           static_cast<size_t>(4 + 3 + 4 + 4 + p.pos_rows) * BM * sizeof(float);

  // the record: each tile's rows, in Rec order
  int rows[N_REC];
  for (int r = 0; r < N_REC; ++r) rows[r] = 0;
  for (int i = 0; i < n_rgb - 1; ++i) rows[R_HS0 + i] = rows[R_DHS0 + i] = head;
  rows[R_G3RGB] = rows[R_SIG] = 16;
  for (int k = 0; k < 7; ++k) rows[R_A0 + k] = rows[R_D0 + k] = width;
  rows[R_POS] = p.pos_pad;
  rows[R_DIR] = p.dir_pad;
  rows[R_TIME] = p.time_pad;
  if (motion_mode) {
    rows[R_U0] = p.menc_pad;
    for (int k = 1; k < 6; ++k) rows[R_U0 + k] = rows[R_DU1 + k - 1] = motion_width;
    rows[R_G3M] = 16;
  }
  p.rec_rows = 0;
  for (int r = 0; r < N_REC; ++r) {
    p.rec[r] = rows[r] ? p.rec_rows : -1;
    p.rec_rows += rows[r];
  }

  DwParams& d = L.dw;
  d.n_jobs = 0;
  d.tile0[0] = 0;
  const auto add = [&](int w_slot, int b_slot, int x, int k_in, int y, int o) {
    Job& jb = d.job[d.n_jobs];
    jb.x = p.rec[x];
    jb.k_in = k_in;
    jb.y = p.rec[y];
    jb.o = o;
    jb.nt = o < 16 ? 16 : (o > 128 ? 128 : o);
    jb.w_off = p.w_off[w_slot];
    jb.b_off = b_slot < 0 ? -1 : n_w + p.b_off[b_slot];  // the partials' bias part
    jb.mt_n = (k_in + DW_XR - 1) / DW_XR;
    jb.nt_n = (o + jb.nt - 1) / jb.nt;
    d.tile0[d.n_jobs + 1] = d.tile0[d.n_jobs] + jb.mt_n * jb.nt_n;
    ++d.n_jobs;
  };
  const int W = width, H = head, last = n_rgb - 2;
  add(W_RGB1 + last, B_RGB1 + last, R_HS0 + last, H, R_G3RGB, 3);
  for (int i = last - 1; i >= 0; --i) add(W_RGB1 + i, B_RGB1 + i, R_HS0 + i, H, R_DHS0 + i + 1, H);
  add(W_R1A, B_RB1, R_A0 + 6, W, R_DHS0, H);
  add(W_R1B, -1, R_DIR, dir_rows, R_DHS0, H);
  if (use_time) add(W_R1C, -1, R_TIME, p.time_rows, R_DHS0, H);
  add(W_DW, B_DB, R_A0 + 6, W, R_SIG, 1);
  add(W_S2W3, B_SB3, R_A0 + 5, W, R_D0 + 6, W);
  add(W_S2W2, B_SB2, R_A0 + 4, W, R_D0 + 5, W);
  add(W_S2A, B_SB1, R_A0 + 3, W, R_D0 + 4, W);
  add(W_S2B, -1, R_POS, p.pos_rows, R_D0 + 4, W);
  for (int k = 3; k >= 1; --k) add(W_1 + k, B_1 + k, R_A0 + k - 1, W, R_D0 + k, W);
  add(W_1, B_1, R_POS, p.pos_rows, R_D0, W);
  if (motion_mode) {
    const int mw = motion_width;
    add(W_M0 + 5, B_M0 + 5, R_U0 + 5, mw, R_G3M, 3);
    for (int k = 4; k >= 1; --k) add(W_M0 + k, B_M0 + k, R_U0 + k, mw, R_DU1 + k, mw);
    add(W_M0, B_M0, R_U0, p.menc_rows, R_DU1, mw);
  }
  const int tiles = d.tile0[d.n_jobs];
  d.rec_rows = p.rec_rows;
  d.n_blocks = (M + BM - 1) / BM;
  d.n_params = n_w + n_b;
  // ranges of records: about four blocks per SM in all
  d.ranges = (4 * sms + tiles - 1) / tiles;
  if (d.ranges > d.n_blocks) d.ranges = d.n_blocks;
  // the records, plus the rows a DW_XR-row load may read past the last one
  L.rec_bytes = (static_cast<size_t>(d.n_blocks) * p.rec_rows + DW_XR) * BM * 2;
  L.part_bytes = static_cast<size_t>(d.ranges) * d.n_params * sizeof(float);
  return true;
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return sms;
}

}  // namespace

// The bytes of workspace stnerf_field_bwd_tc needs for these shapes, into
// *bytes (a host int64). The ints are stnerf_field_bwd_tc's, then the
// packed weights' and biases' element counts. Returns 0 or a CUDA error.
extern "C" int stnerf_field_bwd_tc_workspace(int M, int dir_rows, int width, int head,
                                             int motion_width, int freqs, int include_input,
                                             int use_time, int n_rgb, int motion_mode, int n_w,
                                             int n_b, void* bytes) {
  Layout L;
  if (!make_layout(L, nullptr, M, dir_rows, width, head, motion_width, freqs, include_input,
                   use_time, n_rgb, motion_mode, n_w, n_b, sm_count())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *static_cast<long long*>(bytes) = static_cast<long long>(L.rec_bytes + L.part_bytes);
  return 0;
}

// C entry point. Pointers are device pointers except `offsets`, a host array
// of N_W weight, N_B bias, N_W forward-fragment and N_W backward-fragment
// offsets (-1 = absent operand). gw and gb (float32, n_w and n_b entries,
// the packed buffers' sizes) are overwritten; `workspace` holds
// stnerf_field_bwd_tc_workspace's bytes. Returns the CUDA error of the
// launches (0 = launched).
extern "C" int stnerf_field_bwd_tc(const void* xyz, const void* ids, const void* dir,
                                   const void* drgb, const void* dsig, const void* flags,
                                   const void* weights, const void* frags, const void* biases,
                                   const void* offsets, void* gw, void* gb, void* dxyz,
                                   void* ddir, void* workspace, int M, int dir_rows, int width,
                                   int head, int motion_width, int freqs, int include_input,
                                   int use_time, int n_rgb, int motion_mode, int n_w, int n_b,
                                   void* stream) {
  Layout L;
  if (!make_layout(L, static_cast<const int*>(offsets), M, dir_rows, width, head, motion_width,
                   freqs, include_input, use_time, n_rgb, motion_mode, n_w, n_b, sm_count())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  auto* records = static_cast<unsigned short*>(workspace);
  auto* partial = reinterpret_cast<float*>(static_cast<unsigned char*>(workspace) + L.rec_bytes);
  const auto* fl = static_cast<const int*>(flags);
  cudaError_t e = cudaFuncSetAttribute(field_bwd_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  field_bwd_tc_kernel<<<L.dw.n_blocks, TC_THREADS, L.smem, s>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ids),
      static_cast<const float*>(dir), static_cast<const float*>(drgb),
      static_cast<const float*>(dsig), fl, static_cast<const unsigned short*>(weights),
      static_cast<const uint4*>(frags), static_cast<const float*>(biases), records,
      static_cast<float*>(dxyz), static_cast<float*>(ddir), L.p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  // partials of weights no job writes (padding, absent layers) stay zero
  e = cudaMemsetAsync(partial, 0, L.part_bytes, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int dw_smem = DW_STAGES * DW_STAGE * 2;
  e = cudaFuncSetAttribute(field_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  field_dw_kernel<<<dim3(L.dw.tile0[L.dw.n_jobs], L.dw.ranges), TC_THREADS, dw_smem, s>>>(
      records, fl, partial, L.dw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n = n_w + n_b;
  field_dw_reduce<<<(n + 255) / 256, 256, 0, s>>>(partial, L.dw.ranges, n_w, n_b,
                                                  static_cast<float*>(gw), static_cast<float*>(gb));
  return static_cast<int>(cudaGetLastError());
}
