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
// building blocks; tc_bwd.cuh the parts shared with K3's backward,
// spacenet_tc.cu: pass 1's SpaceNet part, passes 2 and 3, the layout):
//   1. field_bwd_tc_kernel, a block per BM samples (64 at widths up to 256,
//      one skip flag; below, shared memory): the recompute and dx = W dy on
//      wgmma, every recomputed layer near-tie checked (Ctx::dense: the
//      outputs near a bf16 tie or 0 recomputed in float32 in k order, as
//      K1's training forward recomputes them; a pre-pass, row_norms_kernel,
//      puts the weight rows' norms that the check's window scales by into
//      the workspace), with the weights as register A
//      fragments (PackedField.tc's forward and backward packings) and the
//      activations or cotangents as the B tile; the 1- and 3-wide layers and
//      the encodings on CUDA cores. Every cotangent a product reads is
//      rounded to bf16 (the TPU kernel's dy.astype(dtype)), so it is stored
//      in bf16, in place of the activation that masks it: once a layer's
//      input x has been saved, dx = W dy masked by x > 0 overwrites x. d(pos
//      enc), d_dir and d(motion enc) stay float32. Each layer's input x and
//      output cotangent dy is copied, as it stands in shared memory, into the
//      block's record in global memory (Rec: 37 bf16 tiles, ~10.5 KB a
//      sample at the taekwondo widths, ~21 KB at 512/256/256, ~42 KB at
//      1024/512/512) by bulk copies marked evict-first in
//      L2: plain stores of the same bytes pushed out of L2 the weight
//      fragments that every product reads from it, and were slower.
//   2. field_dw_kernel: dW = x dy^T and db = sum dy for every layer, K
//      running over the samples, on wgmma with both operands from shared
//      memory. A block takes one 128 x NT tile of one layer's dW over one
//      range of BM-sample records, streamed through a ring of stages (four
//      of 64 samples, as many bytes at smaller blocks) by bulk
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
// per-sample rows 20 KB, the recompute's check 7.25 KB (a 2 KB mask, 4 KB
// of lists, 1.25 KB of norms): 187 KB (224,000 bytes, 219 KB, with the
// 4-layer head and a time input) of the 227 KB. 128 samples would need 256
// KB for the trunk slots alone. The motion
// net's tiles (its encoding, five hidden layers and float32 d(motion enc),
// 108 KB) reuse the trunk's space, recomputed at the end.
// Wider layers take a smaller block (choose_block in tc_bwd.cuh):
//   * 512/256/256: 64 samples would need 256 KB for the trunk slots, so BM
//     = 32: the trunk slots 128 KB, the rgb head 16 KB (48 KB), the
//     encodings 8 KB, the float32 rows 9.75 KB, the check 8.1 KB: 170 KB
//     (202 KB with the 4-layer head). The motion net's tiles (96 + 5 x 256
//     rows and d(motion enc) as 192 bf16 rows: 1568 rows, 98 KB) fit in the
//     trunk's 2304 (2816) rows.
//   * 1024/512/512: BM = 16: the trunk slots 128 KB, the rgb head 16 KB (48
//     KB), the encodings 4 KB, the float32 rows 4.9 KB, the check 10.1 KB:
//     163 KB (195 KB).
//     The motion net's 2848 rows (89 KB) fit in the trunk's 4608 (5632).

#include <cstdint>

#include "field_common.cuh"
#include "tc_blocks.cuh"
#include "tc_bwd.cuh"

namespace {

// Motion net forward: encode (xyz, id) into U[0] (menc_pad rows), the five
// hidden layers into U[1..5] (motion_width rows each), the flow (3 rows,
// float32) into R.
template <int BM>
__device__ void motion_forward(const Ctx<BM>& c, const float* X, unsigned short* const* U,
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

template <int BM>
__global__ void __launch_bounds__(TC_THREADS, 1)
field_bwd_tc_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                    const float* __restrict__ dir, const float* __restrict__ drgb,
                    const float* __restrict__ dsig, const int* __restrict__ flags,
                    const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                    const float* __restrict__ bias, const float* __restrict__ norms,
                    unsigned short* __restrict__ records, float* __restrict__ dxyz,
                    float* __restrict__ ddir, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (flags != nullptr && block_flag<BM>(flags, blockIdx.x, 1) == 0) {
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
  const int mw = p.motion_width;
  unsigned short* U = reinterpret_cast<unsigned short*>(smem);  // u_rows: trunk and head
  unsigned short* P = U + p.u_rows * BM;                        // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                       // dir_pad: relu(direction enc)
  unsigned short* T = D + p.dir_pad * BM;                       // time_pad: relu(time enc)
  float* X = reinterpret_cast<float*>(T + p.time_pad * BM);     // 4: xyz, id
  float* XD = X + 4 * BM;    // 3: displaced xyz
  float* R = XD + 3 * BM;    // 4: flow, or the sigma cotangent
  float* G3 = R + 4 * BM;    // 4: the rgb or flow cotangent
  float* DP = G3 + 4 * BM;   // pos_rows: d(position encoding)
  unsigned* mask = reinterpret_cast<unsigned*>(DP + p.pos_rows * BM);  // the check's
  const Ctx<BM> c = make_ctx<BM>(p, wts, frags, bias, norms, records, mask);
  c.clear_mask();
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

  // ---- forward: deformation, encodings ----
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

  // ---- the SpaceNet: trunk and heads forward and backward, d(pos enc) in DP ----
  spacenet_bwd_block(c, m0, U, P, D, T, R, G3, DP, drgb, dsig, ddir);
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

using BwdKernel = decltype(&field_bwd_tc_kernel<64>);

BwdKernel bwd_kernel_for(int bm) {
  return bm == 64 ? field_bwd_tc_kernel<64>
                  : bm == 32 ? field_bwd_tc_kernel<32> : field_bwd_tc_kernel<16>;
}

bool make_layout(Layout& L, const int* off, int M, int dir_rows, int width, int head,
                 int motion_width, int freqs, int include_input, int use_time, int n_rgb,
                 int motion_mode, int n_w, int n_b, int sms) {
  if (M <= 0 || dir_rows <= 0 || !fwd_width(width) || !fwd_width(head) ||
      (motion_mode != 0 && !fwd_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2 || n_w <= 0 || n_b <= 0) {
    return false;
  }
  Params& p = L.p;
  set_offsets(p, off);
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
  const auto smem = [&](int bm) {
    return static_cast<size_t>(p.u_rows + p.pos_pad + p.dir_pad + p.time_pad) * bm * 2 +
           static_cast<size_t>(4 + 3 + 4 + 4 + p.pos_rows) * bm * sizeof(float) +
           check_bytes(p, bm);
  };
  if (!choose_block(L, smem, bwd_kernel_for)) return false;
  finish_layout(L, n_w, n_b, 1, sms);
  return true;
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
  *static_cast<long long*>(bytes) =
      static_cast<long long>(L.rec_bytes + L.part_bytes + L.norm_bytes);
  return 0;
}

// The launch of stnerf_field_bwd_tc for the same ints as
// stnerf_field_bwd_tc_workspace: out[0] pass 1's block of samples, out[1]
// its dynamic shared memory. Returns 0 or a CUDA error.
extern "C" int stnerf_field_bwd_tc_block(int M, int dir_rows, int width, int head,
                                         int motion_width, int freqs, int include_input,
                                         int use_time, int n_rgb, int motion_mode, int n_w,
                                         int n_b, void* out) {
  Layout L;
  if (!make_layout(L, nullptr, M, dir_rows, width, head, motion_width, freqs, include_input,
                   use_time, n_rgb, motion_mode, n_w, n_b, sm_count())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = L.bm;
  o[1] = static_cast<int>(L.smem);
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
  float* norms = partial + L.part_bytes / sizeof(float);
  const auto* fl = static_cast<const int*>(flags);
  const auto* wts = static_cast<const unsigned short*>(weights);
  const BwdKernel kernel = bwd_kernel_for(L.bm);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.smem));
  if (e == cudaSuccess) e = launch_norms(L, wts, norms, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<L.dw.n_blocks, TC_THREADS, L.smem, s>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ids),
      static_cast<const float*>(dir), static_cast<const float*>(drgb),
      static_cast<const float*>(dsig), fl, wts, static_cast<const uint4*>(frags),
      static_cast<const float*>(biases), norms, records, static_cast<float*>(dxyz),
      static_cast<float*>(ddir), L.p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_dw(L, records, fl, partial, n_w, n_b, static_cast<float*>(gw),
                                    static_cast<float*>(gb), s));
}
