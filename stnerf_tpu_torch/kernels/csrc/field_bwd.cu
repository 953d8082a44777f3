// Backward of the fused field on Hopper (sm_90a), float32 fields on CUDA
// cores.
//
// Replaces stnerf_tpu/kernels/field_vjp.py::_call_bwd (the Pallas TPU kernel
// _field_bwd_kernel / _field_bwd_body, with spacenet_vjp._bwd_math) for
// float32 fields; bf16 fields go to the tensor-core kernel of
// field_bwd_tc.cu. Per block of samples it recomputes the whole field
// forward — motion encoding, the 6-layer flow MLP, the encoding of the
// displaced positions, the SpaceNet trunk and both heads — then
// backpropagates the rgb and sigma cotangents through all of it and emits:
//   * weight and bias gradients in float32, in the packed operand layout of
//     fused_field.py (pack_field's offsets), summed over every block in a
//     fixed order;
//   * d_xyz (3, M) and d_dir_enc (dir_rows, M) in float32.
// A sample tile whose skip flag is 0 (flags cover 64 samples, the tile of
// fused_field.cu) writes zero d_xyz and d_dir and adds nothing. A block is
// 64 samples at widths up to 256, 32 at 512 and 16 at 1024 (the plan's,
// f32_bwd.cuh), part of a tile below 64.
//
// Bound: about 3x the forward's arithmetic per sample (recompute, dx = W dy,
// dW = x dy^T) against ~80 bytes of sample input and output, so arithmetic
// bounds it, as the forward. The records of pass 1 add ~21 KB a sample
// written and read back once (at the taekwondo widths with a motion net).
//
// The design is f32_bwd.cuh's three passes, shared with K3's float32
// backward (spacenet.cu): field_bwd_kernel is pass 1 (the motion net and the
// encodings here, the SpaceNet part in spacenet_block), writing every
// layer's x and dy to the block's record; f32_dw_kernel and field_dw_reduce
// make the weight gradients from the records in a fixed order. The former
// design (16 samples a block, trunk layers 1-3 and the motion net recomputed,
// float4 atomics into the gradients) took 48.80 ms at M = 240,000 on the
// performer field, 1.5x its plain version (PERF.md).
//
// Shared memory of pass 1 at the taekwondo widths (W = 256, H = 128, motion
// 128): two ping-pong tiles of 256 x 64 floats (128 KB; the motion net's
// encoding and layers pass through them first), the encodings and d(pos
// enc) (43.5 KB), the ReLU masks (22 KB) and the per-sample rows (3.5 KB):
// 197 KB. At 512/256/256, 32 samples: the ping-pong tiles 128 KB, the
// encodings and d(pos enc) 21.75 KB, the masks 22 KB, the rows 1.75 KB:
// 173.5 KB (64 samples would need 347 KB). At 1024/512/512, 16 samples:
// 128 + 10.9 + 22 + 0.9 KB: 161.8 KB. The records: ~42 KB a sample at
// 512/256/256 and ~83 KB at 1024/512/512, so a 4 GiB slice holds ~100,000
// and ~52,000 samples (f32_bwd.py SLICE_BYTES).
// Numerics follow the TPU kernel: the masks of ReLU compare the stored
// activation with 0, the position-encoding and direction gradients and the
// motion net's input gradient are unmasked float32 sums.

#include "f32_bwd.cuh"
#include "field_common.cuh"
#include "mlp_blocks.cuh"

namespace {

// Motion net forward: encode (xyz, id) into s.A (menc_rows rows), the five
// hidden layers u1-u5 through the ping-pong tiles (u5 in s.B), the flow (3
// rows) into s.FL; each tile copied to the record.
template <int RBM>
__device__ void motion_forward(const Blk<RBM>& c, const Smem& s) {
  const BwdParams& p = c.p;
  const int t = threadIdx.x;
  if (t < 4 * RBM) {
    const int ch = t / RBM, m = t % RBM;
    const float v = s.X[ch * RBM + m];
    if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
      const float id = s.X[3 * RBM + m];
      const float lo = floorf(id);
      encode<false>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v, __fsub_rn(id, lo), ch,
                    4, p.freqs, p.inc, false, s.A, RBM, m);
    } else {
      encode<false>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, s.A, RBM, m);
    }
  }
  sync_async();
  c.save(T_U0, s.A, p.menc_rows);
  const int mw = p.motion_width;
  float* in = s.A;
  float* out = s.B;
  for (int k = 0; k < 5; ++k) {
    c.dense1(W_M0 + k, in, k ? mw : p.menc_rows, B_M0 + k, mw, out, T_U0 + k + 1,
             c.motion_mask(k));
    float* q = in;
    in = out;
    out = q;
  }
  fwd_small<float, float, RBM>(c.W(W_M0 + 5), in, mw, c.Bi(B_M0 + 5), 3, s.FL);
  __syncthreads();
}

template <int RBM>
__global__ void __launch_bounds__(THREADS, 1)
field_bwd_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                 const float* __restrict__ dir, const float* __restrict__ drgb,
                 const float* __restrict__ dsig, const int* __restrict__ flags,
                 const float* __restrict__ wts, const float* __restrict__ frags,
                 const float* __restrict__ bias, float* __restrict__ records,
                 float* __restrict__ dxyz, float* __restrict__ ddir,
                 const __grid_constant__ BwdParams p, int b0) {
  extern __shared__ float4 smem4[];
  const int t = threadIdx.x;
  const int blk = b0 + blockIdx.x;
  const int m0 = blk * RBM;
  const int M = p.M;
  if (flags != nullptr && block_flag<RBM>(flags, blk, 1) == 0) {
    for (int i = t; i < (3 + p.dir_rows) * RBM; i += THREADS) {
      const int r = i / RBM, gm = m0 + i % RBM;
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
  const Smem s = carve<RBM>(p, smem4);
  const Blk<RBM> c{p, wts, frags, bias, records + static_cast<size_t>(blockIdx.x) * p.rec_floats,
                   s.MK};
  for (int i = t; i < 4 * RBM; i += THREADS) {
    const int r = i / RBM, gm = m0 + i % RBM;
    s.X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  __syncthreads();

  // ---- forward: deformation, encodings ----
  if (p.motion_mode) {
    motion_forward(c, s);
    for (int i = t; i < 3 * RBM; i += THREADS) s.XD[i] = __fadd_rn(s.X[i], s.FL[i]);
  } else {
    for (int i = t; i < 3 * RBM; i += THREADS) s.XD[i] = s.X[i];
  }
  __syncthreads();
  if (t < 4 * RBM) {
    const int ch = t / RBM, m = t % RBM;
    if (ch < 3) {
      const float v = s.XD[ch * RBM + m];
      encode<false>(v, v, 0.f, ch, 3, p.freqs, p.inc, false, s.P, RBM, m);
    } else if (p.time_rows) {
      const float v = s.X[3 * RBM + m];
      encode<false>(v, v, 0.f, 0, 1, p.freqs, p.inc, true, s.T, RBM, m);
    }
  }
  for (int i = t; i < p.dir_rows * RBM; i += THREADS) {
    const int gm = m0 + i % RBM;
    const float v = gm < M ? dir[static_cast<size_t>(i / RBM) * M + gm] : 0.f;
    s.D[i] = fmaxf(v, 0.f);
  }
  sync_async();
  c.save(T_POS, s.P, p.pos_rows);
  c.save(T_DIR, s.D, p.dir_rows);
  if (p.time_rows) c.save(T_TIME, s.T, p.time_rows);

  // ---- the SpaceNet: trunk and heads forward and backward, d(pos enc) in DP ----
  spacenet_block(c, m0, s, drgb, dsig, ddir);

  // ---- d(displaced xyz) through the position encoding ----
  const int ch = t / RBM, m = t % RBM;
  float dx_out = 0.f;
  if (t < 3 * RBM) dx_out = encode_vjp(s.XD[t], s.DP, ch, 3, p.freqs, p.inc, 1.f, RBM, m);

  // ---- motion net backward, from the masks its forward left ----
  if (p.motion_mode) {
    if (t < 3 * RBM) s.G3[t] = dx_out;  // d(flow)
    sync_async();
    c.save(T_G3M, s.G3, 3);
    const int mw = p.motion_width;
    float* y = s.A;  // d(u_k), newest
    float* x = s.B;
    c.hidden(W_M0 + 5, mw, 3, s.G3, c.motion_mask(4), y, T_DU1 + 4);
    for (int k = 4; k >= 1; --k) {
      c.hidden(W_M0 + k, mw, mw, y, c.motion_mask(k - 1), x, T_DU1 + k - 1);
      float* q = x;
      x = y;
      y = q;
    }
    // d(motion encoding) = m0 d(u1), float32, into x
    float* DM = x;
    const int mr = p.menc_rows;
    c.dx(W_M0, mr, mw, y, [=](int k, int mm, float acc) {
      if (k < mr) DM[k * RBM + mm] = acc;
    });
    // x_d = xyz + flow(xyz): both paths feed d_xyz
    if (t < 3 * RBM) {
      const float v = s.X[t];
      float d_m;
      if (p.motion_mode == 2) {  // enc = (1-w) e_lo + w e_hi; w is not differentiated
        const float id = s.X[3 * RBM + m];
        const float wt = __fsub_rn(id, floorf(id));
        d_m = __fadd_rn(encode_vjp(v, DM, ch, 4, p.freqs, p.inc, __fsub_rn(1.f, wt), RBM, m),
                        encode_vjp(v, DM, ch, 4, p.freqs, p.inc, wt, RBM, m));
      } else {
        d_m = encode_vjp(v, DM, ch, 4, p.freqs, p.inc, 1.f, RBM, m);
      }
      dx_out = __fadd_rn(dx_out, d_m);
    }
  }
  if (t < 3 * RBM && m0 + m < M) dxyz[static_cast<size_t>(ch) * M + m0 + m] = dx_out;
  c.done();
}

int imax(int a, int b) { return a > b ? a : b; }

}  // namespace

// C entry point. Pointers are device pointers except `offsets`, a host
// array of N_W weight then N_B bias element offsets (-1 = absent operand),
// and `plan`, the host int array of kernels/f32_bwd.py::make_plan for these
// shapes; `frags` holds the dx fragments at the plan's offsets. gw and gb (float32, n_w and n_b entries, the packed buffers' sizes)
// are overwritten; `workspace` holds the plan's workspace bytes. Returns the
// CUDA error of the launches (0 = launched).
extern "C" int stnerf_field_bwd(const void* xyz, const void* ids, const void* dir,
                                const void* drgb, const void* dsig, const void* flags,
                                const void* weights, const void* frags, const void* biases,
                                const void* offsets, const void* plan, void* gw, void* gb,
                                void* dxyz, void* ddir,
                                void* workspace, int M, int dir_rows, int width, int head,
                                int motion_width, int freqs, int include_input, int use_time,
                                int n_rgb, int motion_mode, int n_w, int n_b, void* stream) {
  Plan P;
  if (M <= 0 || dir_rows <= 0 || !fwd_width(width) || !fwd_width(head) ||
      (motion_mode != 0 && !fwd_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2 || n_w <= 0 || n_b <= 0 ||
      !read_plan(static_cast<const int*>(plan), P)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  BwdParams p;
  set_plan(p, static_cast<const int*>(offsets), P);
  const int per = (include_input ? 1 : 0) + 2 * freqs;
  p.M = M;
  p.pos_rows = 3 * per;
  p.dir_rows = dir_rows;
  p.time_rows = use_time ? per : 0;
  p.width = width;
  p.head = head;
  p.n_rgb = n_rgb;
  p.motion_mode = motion_mode;
  p.motion_width = motion_mode ? motion_width : 0;
  p.menc_rows = motion_mode ? 4 * per : 0;
  p.freqs = freqs;
  p.inc = include_input ? 1 : 0;
  p.rows_a = imax(imax(width, head), imax(p.motion_width, p.menc_rows));
  const size_t smem = smem_bytes(p, P.rbm);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* fl = static_cast<const int*>(flags);
  return static_cast<int>(with_block(P, p, [&](auto block) {
    constexpr int RBM = decltype(block)::value;
    cudaError_t e = cudaFuncSetAttribute(field_bwd_kernel<RBM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const auto pass1 = [&](int b0, int nb, float* records) {
      field_bwd_kernel<RBM><<<nb, THREADS, smem, s>>>(
          static_cast<const float*>(xyz), static_cast<const float*>(ids),
          static_cast<const float*>(dir), static_cast<const float*>(drgb),
          static_cast<const float*>(dsig), fl, static_cast<const float*>(weights),
          static_cast<const float*>(frags), static_cast<const float*>(biases), records,
          static_cast<float*>(dxyz), static_cast<float*>(ddir), p, b0);
      return cudaGetLastError();
    };
    return run_f32_bwd<RBM>(P, M, fl, 1, static_cast<float*>(workspace), n_w, n_b,
                            static_cast<float*>(gw), static_cast<float*>(gb), s, pass1);
  }));
}
