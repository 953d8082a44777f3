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
// The forward: K1's float32 kernel (fused_field.cu) without the motion net
// and without the in-kernel encoding, on the same weight ring (w_ring.cuh)
// and the same SpaceNet layers (ring_dense.cuh): 64 samples a block (32 at
// widths up to 512, 16 up to 1024: the largest block whose activations
// leave two ring stages, chosen per launch), 8 consumer warps of CUDA-core
// FMA loops and a producer warp that bulk-copies every layer's weights in
// 32 KB slabs into the stages the activations leave (2 at the taekwondo
// widths 256/128 with time: 160,512 bytes of activations; up to MAX_STAGES
// at narrow widths), one block per SM. Each output keeps the chain acc =
// fmaf(W[k, o], x[k, m], acc) from 0 over k in order, segment by segment,
// + bias, ReLU on hidden layers (the 1- and 3-wide outputs one thread per
// (output, sample)), which the backward's recompute (f32_bwd.cuh, fwd_seg)
// repeats and whose ReLU masks it keeps as bits: no tensor cores, no
// reordering. The ragged tail of M reads zeros and is not written; a block
// whose `active` flag reads 0 writes zeros and exits before the ring is set
// up, so no bulk copy is in flight when it exits.
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
#include "ring_dense.cuh"

namespace {

static_assert(THREADS == wring::CONSUMERS, "the forward's consumers are the backward's block");

struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int M, pos_rows, dir_rows, time_rows, width, head, n_rgb;
  int rows_a;
  int ring_off, stages;  // the forward's ring: its first float in dynamic shared memory
  int bm;                // the forward's samples per block
};

// rows x BM values of a planar (rows, M) float32 input from sample m0 on
// (clipped at 0 with `relu`) by THREADS threads; zeros past M
template <int BM>
__device__ void load_rows(const float* __restrict__ src, int rows, int M, int m0, bool relu,
                          float* dst) {
  for (int i = threadIdx.x; i < rows * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    const float v = gm < M ? src[static_cast<size_t>(i / BM) * M + gm] : 0.f;
    dst[i] = relu ? fmaxf(v, 0.f) : v;
  }
}

// zeros into rows x BM values of a planar (rows, M) float32 output from
// sample m0 on (a skipped field's block), by `threads` threads
template <int BM>
__device__ void zero_rows(float* __restrict__ dst, int rows, int M, int m0, int threads) {
  for (int i = threadIdx.x; i < rows * BM; i += threads) {
    const int gm = m0 + i % BM;
    if (gm < M) dst[static_cast<size_t>(i / BM) * M + gm] = 0.f;
  }
}

// One block of BM samples (64, 32 or 16: Params.bm)
template <int BM>
__global__ void __launch_bounds__(wring::BLOCK, 1)
spacenet_fwd_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                    const float* __restrict__ time, const float* __restrict__ wts,
                    const float* __restrict__ bias, const int* __restrict__ active,
                    float* __restrict__ out, const Params p) {
  __shared__ wring::Ctl ring;
  const int t = threadIdx.x;
  const int m0 = blockIdx.x * BM;
  if (active != nullptr && *active == 0) {  // before the ring: no copy in flight
    zero_rows<BM>(out, 4, p.M, m0, wring::BLOCK);
    return;
  }
  float* sm = wring::smem_floats();
  // activation tiles as float offsets into dynamic shared memory
  wring::Tiles s;
  s.out = 0;                             // 4 x BM: rgb, sigma
  s.pos = s.out + 4 * BM;                // pos_rows x BM: position encoding
  s.dir = s.pos + p.pos_rows * BM;       // dir_rows x BM: relu(direction encoding)
  s.time = s.dir + p.dir_rows * BM;      // time_rows x BM: relu(time encoding)
  s.a = s.time + p.time_rows * BM;       // rows_a x BM: ping
  s.b = s.a + p.rows_a * BM;             // rows_a x BM: pong

  if (t == 0) {
    ring.n_seg = 0;
    wring::spacenet_segments(ring, wts, p);
    wring::init(ring, p.stages, wring::CONSUMER_WARPS);
  }
  __syncthreads();
  if (t >= THREADS) {  // the producer warp
    if (t == THREADS) wring::produce(ring, sm + p.ring_off);
    return;
  }
  wring::RingPos rp{0, 0};
  load_rows<BM>(pos, p.pos_rows, p.M, m0, false, sm + s.pos);
  load_rows<BM>(dir, p.dir_rows, p.M, m0, true, sm + s.dir);
  if (p.time_rows) load_rows<BM>(time, p.time_rows, p.M, m0, true, sm + s.time);
  wring::sync_consumers();
  wring::spacenet_layers<BM, false>(ring, rp, bias, p, s);
  for (int i = t; i < 4 * BM; i += THREADS) {
    const int gm = m0 + i % BM;
    if (gm < p.M) out[static_cast<size_t>(i / BM) * p.M + gm] = sm[s.out + i];
  }
}

using FwdKernel = decltype(&spacenet_fwd_kernel<64>);

FwdKernel fwd_kernel_for(int bm) {
  return bm == 64 ? spacenet_fwd_kernel<64> : bm == 32 ? spacenet_fwd_kernel<32>
                                                       : spacenet_fwd_kernel<16>;
}

// Pass 1 of the backward for the blocks b0 + blockIdx.x of RBM samples
// (f32_bwd.cuh)
template <int RBM>
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
    zero_rows<RBM>(dpos, kp, M, m0, THREADS);
    zero_rows<RBM>(ddir, p.dir_rows, M, m0, THREADS);
    return;
  }
  const Smem s = carve<RBM>(p, smem4);
  const Blk<RBM> c{p, wts, frags, bias, records + static_cast<size_t>(blockIdx.x) * p.rec_floats,
                   s.MK};
  load_rows<RBM>(pos, kp, M, m0, false, s.P);
  load_rows<RBM>(dir, p.dir_rows, M, m0, true, s.D);
  if (p.time_rows) load_rows<RBM>(time, p.time_rows, M, m0, true, s.T);
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

int imax(int a, int b) { return a > b ? a : b; }

// -> false for shapes the kernels do not take
bool fill_params(Params& p, const void* offsets, int M, int pos_rows, int dir_rows,
                 int time_rows, int width, int head, int n_rgb) {
  if (M <= 0 || pos_rows <= 0 || dir_rows <= 0 || time_rows < 0 || !fwd_width(width) ||
      !fwd_width(head) || (n_rgb != 2 && n_rgb != 4)) {
    return false;
  }
  if (offsets != nullptr) {
    const int* off = static_cast<const int*>(offsets);
    for (int i = 0; i < N_W; ++i) p.w_off[i] = off[i];
    for (int i = 0; i < N_B; ++i) p.b_off[i] = off[N_W + i];
  }
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

// The forward's block and ring for filled Params: the largest block of 64,
// 32 or 16 samples whose activations leave room for two ring stages (64 at
// every width up to 256), its stages and the block's dynamic shared
// memory; false if no block fits.
bool configure_fwd(Params& p, size_t* smem) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  for (const int bm : {64, 32, 16}) {
    cudaFuncAttributes attr;
    if (p.rows_a > wring::max_width(bm) ||
        cudaFuncGetAttributes(&attr, fwd_kernel_for(bm)) != cudaSuccess) {
      continue;
    }
    // the activations, then the ring at a 128-byte boundary
    const int rows = 4 + p.pos_rows + p.dir_rows + p.time_rows + 2 * p.rows_a;
    p.ring_off = (rows * bm + 31) / 32 * 32;
    const size_t act = static_cast<size_t>(p.ring_off) * sizeof(float);
    p.stages = wring::stages_for(act, static_cast<size_t>(optin) - attr.sharedSizeBytes);
    if (p.stages >= 2) {
      p.bm = bm;
      *smem = act + static_cast<size_t>(p.stages) * wring::STAGE_FLOATS * sizeof(float);
      return true;
    }
  }
  return false;
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
  size_t smem = 0;
  if (!fill_params(p, offsets, M, pos_rows, dir_rows, time_rows, width, head, n_rgb) ||
      !configure_fwd(p, &smem) || reinterpret_cast<uintptr_t>(weights) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdKernel kernel = fwd_kernel_for(p.bm);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + p.bm - 1) / p.bm);
  kernel<<<grid, wring::BLOCK, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const float*>(weights),
      static_cast<const float*>(biases), static_cast<const int*>(active),
      static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
}

// The forward's launch for the same ints as stnerf_spacenet_fwd: out[0] the
// ring's stages, out[1] a stage's bytes, out[2] the block's dynamic shared
// memory, out[3] its samples. Returns a CUDA error (0 = the launch would be
// configured).
extern "C" int stnerf_spacenet_ring(int M, int pos_rows, int dir_rows, int time_rows, int width,
                                    int head, int n_rgb, void* out) {
  Params p;
  size_t smem = 0;
  if (!fill_params(p, nullptr, M, pos_rows, dir_rows, time_rows, width, head, n_rgb) ||
      !configure_fwd(p, &smem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int* o = static_cast<int*>(out);
  o[0] = p.stages;
  o[1] = wring::STAGE_FLOATS * static_cast<int>(sizeof(float));
  o[2] = static_cast<int>(smem);
  o[3] = p.bm;
  return 0;
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
      n_w <= 0 || n_b <= 0 ||
      !read_plan(static_cast<const int*>(plan), P)) {
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
  const size_t smem = smem_bytes(p, P.rbm);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* act = static_cast<const int*>(active);
  return static_cast<int>(with_block(P, p, [&](auto block) {
    constexpr int RBM = decltype(block)::value;
    cudaError_t e = cudaFuncSetAttribute(spacenet_bwd_kernel<RBM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    const auto pass1 = [&](int b0, int nb, float* records) {
      spacenet_bwd_kernel<RBM><<<nb, THREADS, smem, s>>>(
          static_cast<const float*>(pos), static_cast<const float*>(dir),
          static_cast<const float*>(time), static_cast<const float*>(drgb),
          static_cast<const float*>(dsig), static_cast<const float*>(weights),
          static_cast<const float*>(frags), static_cast<const float*>(biases), act, records,
          static_cast<float*>(dpos), static_cast<float*>(ddir), p, b0);
      return cudaGetLastError();
    };
    // every record's flag is the field's `active` flag
    return run_f32_bwd<RBM>(P, M, act, 0, static_cast<float*>(workspace), n_w, n_b,
                            static_cast<float*>(gw), static_cast<float*>(gb), s, pass1);
  }));
}
