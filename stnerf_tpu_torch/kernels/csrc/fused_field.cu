// Fused field evaluation on Hopper (sm_90a), float32 fields on CUDA cores.
//
// Replaces stnerf_tpu/kernels/fused_field.py::fused_field (the Pallas TPU
// kernel: _kernel, _kernel_body, _encode) for float32 fields; bf16 fields go
// to the tensor-core kernel of fused_field_tc.cu. Per block of BM samples,
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
// output (fused_field.py:184-188), so arithmetic bounds it: the CUDA cores'
// float32 FMA rate.
//
// The design. 8 consumer warps each keep a TO x BM/8 register tile of a
// layer's outputs (TO = width / 32) and walk the reduction axis: per k step
// a thread reads TO weights and BM/8 activations from shared memory and
// issues TO x BM/8 FMAs. The weights (~2.2 MB in float32 per field at the taekwondo
// widths, read by every block) reach shared memory through the weight ring
// of w_ring.cuh, read by ring_dense.cuh's layers (the SpaceNet's shared with
// K3's float32 forward, spacenet.cu): a ninth, producer warp streams every
// layer's weights, the 1- and 3-wide output layers' too, in slabs of up to
// 32 KB by bulk copies on mbarriers, running ahead across layer boundaries,
// so that the FMA loops read weights with broadcast shared-memory loads and
// never wait on L2. The activations are float32 in shared memory (two
// ping-pong tiles of width x BM, the encodings and the rgb/sigma rows:
// 161,536 bytes at the taekwondo widths 256/128/128 and BM = 64); the ring
// takes what is left of the block's 227 KB: 2 stages of 32 KB at those
// widths, 4-5 at 64/32/32. The block is chosen per launch: the largest of
// 64, 32 and 16 samples whose activations leave two stages, so 64 at every
// width up to 256, 32 at 512 (146,304 bytes at 512/256/256), 16 at 1024.
// A smaller block reads every weight once per fewer samples.
//
// Why the arithmetic keeps its order, and no tensor cores: K2's and K3's
// float32 backward recompute this forward with the same chain of FMAs
// (mlp_blocks.cuh fwd_seg, called from f32_bwd.cuh) and take its ReLU masks
// as bits, so each output (o, m) must stay acc = fmaf(W[k, o], x[k, m], acc)
// from 0 over k in order, segment by segment, then + bias, then ReLU. A
// reordered sum or a TF32 product would flip masks the backward recomputes
// in this order, and would change the output bits, which stay those of the
// first CUDA-core kernel.
//
// What it still gives up: the tensor cores (above); one block per SM (the
// activations), so 8 warps of FMA issue; every block still reads every
// weight from L2, 12.7 GB a call at M = 491,520 with 75% of tiles run, now
// off the FMA loops' path; a wait and a release per slab; the 1- and 3-wide
// output layers take one thread per output, with idle threads beside them.
// Numerics: products accumulate in float32, as the plain version's. The
// encodings use IEEE sinf/cosf and explicitly rounded products (no FMA
// contraction), matching the plain PyTorch version's elementwise ops.

#include "ring_dense.cuh"

namespace {

using wring::BLOCK;
constexpr int THREADS = wring::CONSUMERS;  // the consumers
constexpr int TILE = 64;                   // samples per skip flag (fused_field.py TILE)

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb,
      motion_mode;
  int rows_a, pos_rows, time_rows, menc_rows;
  int ring_off, stages;  // the ring's first float in dynamic shared memory
  int bm;                // samples per block
};

// The ring's segments in the order the layers below read them: the motion
// net's six layers (its 3-wide output one slab), then the SpaceNet's
// (ring_dense.cuh).
__device__ __forceinline__ void ring_segments(wring::Ctl& c, const float* wts, const Params& p) {
  c.n_seg = 0;
  if (p.motion_mode) {
    wring::add_seg(c, wts + p.w_off[W_M0], p.menc_rows, p.motion_width);
    for (int k = 1; k < 5; ++k) {
      wring::add_seg(c, wts + p.w_off[W_M0 + k], p.motion_width, p.motion_width);
    }
    wring::add_seg(c, wts + p.w_off[W_M0 + 5], p.motion_width, 3);
  }
  wring::spacenet_segments(c, wts, p);
}

// One block of BM samples (64, 32 or 16: Params.bm). The encodings take one
// consumer thread per (channel, sample) of the 4 x BM (xyz, id) values.
template <int BM>
__global__ void __launch_bounds__(BLOCK, 1)
fused_field_kernel(const float* __restrict__ xyz, const float* __restrict__ ids,
                   const float* __restrict__ dir, const int* __restrict__ flags,
                   const float* __restrict__ wts, const float* __restrict__ bias,
                   float* __restrict__ out, const Params p) {
  __shared__ wring::Ctl ring;
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (flags != nullptr && flags[m0 / TILE] == 0) {
    // a skipped tile must still be finite downstream (0 * NaN = NaN)
    for (int i = t; i < 4 * BM; i += BLOCK) {
      const int gm = m0 + i % BM;
      if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = 0.f;
    }
    return;
  }
  float* sm = wring::smem_floats();
  // activation tiles as float offsets into dynamic shared memory
  const int oX = 0;                         // 4 x BM: xyz rows, id row
  const int oA = oX + 4 * BM;               // rows_a x BM
  const int oB = oA + p.rows_a * BM;        // rows_a x BM
  const int oP = oB + p.rows_a * BM;        // pos_rows x BM
  const int oD = oP + p.pos_rows * BM;      // dir_rows x BM
  const int oT = oD + p.dir_rows * BM;      // time_rows x BM
  const int oR = oT + p.time_rows * BM;     // 4 x BM: flow or rgb, sigma
  float* X = sm + oX;
  float* A = sm + oA;
  float* P = sm + oP;
  float* D = sm + oD;
  float* T = sm + oT;
  float* R = sm + oR;

  if (t == 0) {
    ring_segments(ring, wts, p);
    wring::init(ring, p.stages, wring::CONSUMER_WARPS);
  }
  __syncthreads();
  if (t >= THREADS) {  // the producer warp
    if (t == THREADS) wring::produce(ring, sm + p.ring_off);
    return;
  }
  wring::RingPos pos{0, 0};

  for (int i = t; i < 4 * BM; i += THREADS) {
    const int r = i / BM, gm = m0 + i % BM;
    X[i] = gm < M ? (r < 3 ? xyz[static_cast<size_t>(r) * M + gm] : ids[gm]) : 0.f;
  }
  wring::sync_consumers();

  if (p.motion_mode) {
    for (int i = t; i < 4 * BM; i += THREADS) {
      const int ch = i / BM, m = i % BM;
      const float v = X[ch * BM + m];
      if (p.motion_mode == 2) {  // "lerp": blend the encodings of floor(id), floor(id)+1
        const float id = X[3 * BM + m];
        const float lo = floorf(id);
        const float wt = __fsub_rn(id, lo);
        encode<false>(ch == 3 ? lo : v, ch == 3 ? __fadd_rn(lo, 1.f) : v, wt, ch, 4, p.freqs,
                      p.inc, false, A, BM, m);
      } else {
        encode<false>(v, v, 0.f, ch, 4, p.freqs, p.inc, false, A, BM, m);
      }
    }
    wring::sync_consumers();
    const int mw = p.motion_width;
    const auto dense1 = [&](int in, int bslot, int dst) {
      wring::dense_call<BM>(ring, pos, p.ring_off, 1, in, 0, 0, bias + p.b_off[bslot], mw,
                            dst);
      wring::sync_consumers();
    };
    dense1(oA, B_M0, oB);
    dense1(oB, B_M0 + 1, oA);
    dense1(oA, B_M0 + 2, oB);
    dense1(oB, B_M0 + 3, oA);
    dense1(oA, B_M0 + 4, oB);
    wring::dense_small<BM>(ring, pos, p.ring_off, oB, bias + p.b_off[B_M0 + 5], oR);
    wring::sync_consumers();
    for (int i = t; i < 3 * BM; i += THREADS) X[i] = __fadd_rn(X[i], R[i]);  // displaced
    wring::sync_consumers();
  }

  // encodings: threads of channels 0-2 encode xyz, those of channel 3 the time
  for (int i = t; i < 4 * BM; i += THREADS) {
    const int ch = i / BM, m = i % BM;
    const float v = X[ch * BM + m];
    if (ch < 3) {
      encode<false>(v, v, 0.f, ch, 3, p.freqs, p.inc, false, P, BM, m);
    } else if (p.use_time) {
      encode<false>(v, v, 0.f, 0, 1, p.freqs, p.inc, true, T, BM, m);
    }
  }
  for (int i = t; i < p.dir_rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? dir[static_cast<size_t>(i / BM) * M + gm] : 0.f;
    D[i] = fmaxf(v, 0.f);
  }
  wring::sync_consumers();
  wring::spacenet_layers<BM, true>(ring, pos, bias, p, {oP, oD, oT, oA, oB, oR});
  for (int i = t; i < 4 * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < M) out[static_cast<size_t>(i / BM) * M + gm] = R[i];
  }
}

using Kernel = decltype(&fused_field_kernel<64>);

Kernel kernel_for(int bm) {
  return bm == 64 ? fused_field_kernel<64> : bm == 32 ? fused_field_kernel<32>
                                                      : fused_field_kernel<16>;
}

// The block, dynamic shared memory and ring stages of a launch with these
// ints (the entry point's): the largest block of 64, 32 or 16 samples whose
// activations leave room for two ring stages (64 at every width up to 256);
// 0 if the widths are refused or no block fits.
int configure(Params& p, int M, int dir_rows, int width, int head, int motion_width, int freqs,
              int include_input, int use_time, int n_rgb, int motion_mode, size_t* smem) {
  if (M <= 0 || dir_rows <= 0 || !fwd_width(width) || !fwd_width(head) ||
      (motion_mode != 0 && !fwd_width(motion_width)) || (n_rgb != 2 && n_rgb != 4) ||
      motion_mode < 0 || motion_mode > 2) {
    return 0;
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
  int wide = width > head ? width : head;
  if (motion_mode) wide = wide > motion_width ? wide : motion_width;
  p.rows_a = wide > p.menc_rows ? wide : p.menc_rows;
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return 0;
  }
  for (const int bm : {64, 32, 16}) {
    cudaFuncAttributes attr;
    if (wide > wring::max_width(bm) ||
        cudaFuncGetAttributes(&attr, kernel_for(bm)) != cudaSuccess) {
      continue;
    }
    // the activations, then the ring at a 128-byte boundary
    const int rows = 4 + 2 * p.rows_a + p.pos_rows + dir_rows + p.time_rows + 4;
    p.ring_off = (rows * bm + 31) / 32 * 32;
    const size_t act = static_cast<size_t>(p.ring_off) * sizeof(float);
    p.stages = wring::stages_for(act, static_cast<size_t>(optin) - attr.sharedSizeBytes);
    if (p.stages >= 2) {
      p.bm = bm;
      *smem = act + static_cast<size_t>(p.stages) * wring::STAGE_FLOATS * sizeof(float);
      return 1;
    }
  }
  return 0;
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
                                  int use_time, int n_rgb, int motion_mode, void* stream) {
  Params p;
  size_t smem = 0;
  if (!configure(p, M, dir_rows, width, head, motion_width, freqs, include_input, use_time,
                 n_rgb, motion_mode, &smem) ||
      reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* off = static_cast<const int*>(offsets);
  for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
  const Kernel kernel = kernel_for(p.bm);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + p.bm - 1) / p.bm);
  kernel<<<grid, BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xyz), static_cast<const float*>(ids),
      static_cast<const float*>(dir), static_cast<const int*>(flags),
      static_cast<const float*>(weights), static_cast<const float*>(biases),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// The launch of stnerf_fused_field with the same ints: out[0] the ring's
// stages, out[1] a stage's bytes, out[2] the block's dynamic shared memory,
// out[3] its samples. Returns a CUDA error (0 = the launch would be
// configured).
extern "C" int stnerf_fused_field_ring(int M, int dir_rows, int width, int head,
                                       int motion_width, int freqs, int include_input,
                                       int use_time, int n_rgb, int motion_mode, void* out) {
  Params p;
  size_t smem = 0;
  if (!configure(p, M, dir_rows, width, head, motion_width, freqs, include_input, use_time,
                 n_rgb, motion_mode, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = p.stages;
  o[1] = wring::STAGE_FLOATS * static_cast<int>(sizeof(float));
  o[2] = static_cast<int>(smem);
  o[3] = p.bm;
  return 0;
}
