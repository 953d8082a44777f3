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
//   * forward, a block of two warpgroups per FWD_BM = 128 samples: every
//     layer of width >= 32 a wgmma product, the weights as register A
//     fragments from L2 (PackedField.tc), the activations the B operand in
//     shared memory, bias, ReLU and the rounding to bf16 in the epilogue;
//     the outputs whose sum lies near a bf16 rounding tie recomputed in
//     float32 on CUDA cores (dense_checked); the 1- and 3-wide layers on
//     CUDA cores. Shared memory at the taekwondo widths: two ping-pong tiles
//     of 256 x 128 (128 KB), the encodings (128 rows, 32 KB), 2 KB of float32
//     output rows and the recompute's 4 KB mask: 166 KB, one block an SM.
//   * backward, K2's two passes and fixed-order sum (no atomics, so the
//     weight gradients are the same bits on every run):
//     1. spacenet_bwd_tc_kernel, a block per BM = 64 samples: loads the
//        encodings, then tc_bwd.cuh's spacenet_bwd_block (the recompute and
//        dx = W dy on wgmma, every cotangent rounded to bf16 where the TPU
//        kernel casts it, ReLU masks on the stored bf16 activations, d_dir
//        masked where the rounded direction encoding is not positive) and
//        writes d_pos_enc = w1 dy1 + s2b dy4 from its float32 rows. Each
//        layer's x and dy go to the block's record (25 bf16 tiles: 4000 rows,
//        8000 bytes a sample at the taekwondo widths with the 2-layer rgb
//        head and a time input, 1.92 GB at M = 240,000).
//        Shared memory at those widths: the four trunk slots 128 KB, the rgb
//        head 16 KB (48 KB with the 4-layer head), the encodings 16 KB, the
//        float32 cotangent rows and d_pos_enc 18 KB: 178 KB (210 KB) of the
//        227 KB.
//     2. and 3. tc_bwd.cuh's field_dw_kernel and field_dw_reduce, with the
//        `active` flag as every record's flag.
// The ragged tail of M is guarded: samples past M read as zeros, get zero
// cotangents and are not written.

#include <cstdint>

#include "field_common.cuh"
#include "tc_blocks.cuh"
#include "tc_bwd.cuh"

namespace {

constexpr int FWD_BM = 128;  // samples per forward block

// ------------------------------------------------------------------ forward

// The forward's activations are rounded to bf16 as the plain version rounds
// them. A wgmma k-step aligns its products and accumulator to the largest
// exponent, keeps 25 bits and truncates toward zero, so a chained sum of
// K = 256 inputs lies a few float32 ulps from the plain version's float32
// product, which sums each output with FMAs in k order, and off it always
// toward zero. Rounded to bf16, the two differ only where they straddle a
// bf16 rounding tie, and the staged path's fine sampling turns such flips
// into a different training step (the pose gradients, PERF.md). So every
// output whose tensor-core sum lies within NEAR float32 ulps of a tie (NEAR /
// 2^15 of the positive ones) is recomputed as the plain version sums it:
// float32 FMAs in k order on CUDA cores, each K segment on its own, the
// segments then the bias added in order.
constexpr unsigned NEAR = 128;
constexpr int LIST = 1024;  // entries of a warp's list: one chunk of 32 mask words

// whether y (> 0) lies within NEAR float32 ulps of a bf16 rounding tie
__device__ __forceinline__ bool near_tie(float y) {
  const unsigned low = __float_as_uint(y) & 0xffffu;
  return y > 0.f && (low > 0x8000u ? low - 0x8000u : 0x8000u - low) < NEAR;
}

// acc + sum_k w_k x_k over one k-step (16 inputs) in k order: the four
// fragments of output row r (PackedField.tc, registers x and z, or y and w
// for rows 8-15 of a 16-row group, each the bf16 pair (k, k + 1)), x the
// input tile's (k-step, column) element, act layout of TB samples
template <int TB>
__device__ __forceinline__ float fma_kstep(const uint4 (&v)[4], bool hi,
                                           const unsigned short* x, float acc) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // inputs 0-7, then 8-15
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const unsigned wp = h ? (hi ? v[q].w : v[q].z) : (hi ? v[q].y : v[q].x);
      const unsigned short* xq = x + h * TB * 8 + 2 * q * 8;
      acc = fmaf(__uint_as_float(wp << 16), bf_f(xq[0]), acc);
      acc = fmaf(__uint_as_float(wp & 0xffff0000u), bf_f(xq[8]), acc);
    }
  }
  return acc;
}

// output i = r * TB + c recomputed as the plain version sums it: each
// segment's k-steps in order (KB of them loaded at a time), the segments,
// the bias; rounded to bf16 into out
template <int TB>
__device__ void recompute_one(const Seg* segs, int nseg, const float* __restrict__ bias, int i,
                              unsigned short* out) {
  constexpr int KB = 4;
  const int r = i / TB, c = i % TB;
  const bool hi = (r & 15) >= 8;
  // row r's fragments: m-tile r / 64, warp (r % 64) / 16, lanes 4 (r % 8) + 0..3
  const int t0 = ((r & 63) >> 4) * 32 + (r & 7) * 4;
  float sum = 0.f;
  for (int s = 0; s < nseg; ++s) {
    const int ks_n = segs[s].ks;
    const uint4* f = segs[s].frag + static_cast<size_t>(r >> 6) * ks_n * 128 + t0;
    const unsigned short* x = segs[s].b + (c >> 3) * 64 + (c & 7);
    float acc = 0.f;
    for (int k0 = 0; k0 < ks_n; k0 += KB) {
      uint4 v[KB][4];
#pragma unroll
      for (int j = 0; j < KB; ++j) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[j][q] = k0 + j < ks_n ? __ldg(f + (k0 + j) * 128 + q) : make_uint4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int j = 0; j < KB; ++j) {
        if (k0 + j < ks_n) acc = fma_kstep<TB>(v[j], hi, x + (k0 + j) * 2 * TB * 8, acc);
      }
    }
    sum = s ? __fadd_rn(sum, acc) : acc;
  }
  out[act_idx<TB>(r, c)] = f_bf(rnd<true>(fmaxf(__fadd_rn(sum, bias[r]), 0.f)));
}

// out = round_bf16(relu(sum_s W_s^T x_s + bias)), rows < O, into an act tile
// of TB samples: tc_dense's products, each output flagged in `mask` (O x TB
// bits, row-major; zero on entry and on exit) when it lies near a tie; then
// the flagged outputs recomputed (recompute_one), each by one lane from the
// segments' fragments. `lists` (LIST entries a warp) is shared-memory
// scratch.
template <int TB>
__device__ void dense_checked(const Seg* segs, int nseg, int O, const float* __restrict__ bias,
                              unsigned short* out, unsigned* mask, unsigned short* lists) {
  tc_product<TB>(segs, nseg, O, 0, TB, [=](int r, int c, float v0, float v1) {
    const float b = bias[r];
    const float y0 = v0 + b, y1 = v1 + b;
    *reinterpret_cast<unsigned*>(out + act_idx<TB>(r, c)) =
        static_cast<unsigned>(f_bf(rnd<true>(fmaxf(y0, 0.f)))) |
        (static_cast<unsigned>(f_bf(rnd<true>(fmaxf(y1, 0.f)))) << 16);
    const unsigned bits = (near_tie(y0) ? 1u : 0u) | (near_tie(y1) ? 2u : 0u);
    if (bits) {
      const int i = r * TB + c;
      atomicOr(mask + (i >> 5), bits << (i & 31));
    }
  });
  __syncthreads();
  // each warp lists the flagged outputs of its share of the mask in word
  // order, then its lanes recompute them (one output a lane); a list that
  // would overflow is recomputed and emptied first
  constexpr int WARPS = TC_THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = O * TB / 32, per = words / WARPS;
  unsigned short* list = lists + warp * LIST;
  const auto recompute = [&](int n) {
    for (int e = lane; e < n; e += 32) recompute_one<TB>(segs, nseg, bias, list[e], out);
    __syncwarp();
  };
  int n = 0;
  for (int w0 = warp * per; w0 < (warp + 1) * per; w0 += 32) {
    const int j = w0 + lane;
    unsigned word = 0;
    if (j < (warp + 1) * per) {
      word = mask[j];
      mask[j] = 0;
    }
    const int cnt = __popc(word);
    int incl = cnt;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += v;
    }
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    if (n + total > LIST) {
      recompute(n);
      n = 0;
    }
    for (int off = n + incl - cnt; word; word &= word - 1) {
      list[off++] = static_cast<unsigned short>((j << 5) | (__ffs(word) - 1));
    }
    n += total;
    __syncwarp();
  }
  recompute(n);
}

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

__global__ void __launch_bounds__(TC_THREADS, 1)
spacenet_fwd_tc_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                       const float* __restrict__ time, const unsigned short* __restrict__ wts,
                       const uint4* __restrict__ frags, const float* __restrict__ bias,
                       const int* __restrict__ active, float* __restrict__ out, const Params p) {
  constexpr int TB = FWD_BM;
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
  unsigned* mask = reinterpret_cast<unsigned*>(R + 4 * TB);      // rows_a x TB bits
  unsigned short* lists = reinterpret_cast<unsigned short*>(mask + rows_a * TB / 32);

  for (int i = threadIdx.x; i < rows_a * TB / 32; i += TC_THREADS) mask[i] = 0;
  load_tile<TB>(pos, p.pos_rows, p.pos_pad, M, m0, false, P);
  load_tile<TB>(dir, p.dir_rows, p.dir_pad, M, m0, true, D);
  if (p.use_time) load_tile<TB>(time, p.time_rows, p.time_pad, M, m0, true, T);
  layer_sync();

  const auto W = [&](int slot) { return wts + p.w_off[slot]; };
  const auto F = [&](int slot) { return frags + p.f_off[slot]; };
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const auto dense1 = [&](int slot, const unsigned short* in, int k_pad, int bslot, int O,
                          unsigned short* o) {
    const Seg s{F(slot), in, k_pad / 16};
    dense_checked<TB>(&s, 1, O, Bi(bslot), o, mask, lists);
    layer_sync();
  };
  const int wd = p.width, kp = p.pos_pad;
  dense1(W_1, P, kp, B_1, wd, A);
  dense1(W_1 + 1, A, wd, B_1 + 1, wd, B);
  dense1(W_1 + 2, B, wd, B_1 + 2, wd, A);
  dense1(W_1 + 3, A, wd, B_1 + 3, wd, B);
  {
    const Seg s[2] = {{F(W_S2A), B, wd / 16}, {F(W_S2B), P, kp / 16}};
    dense_checked<TB>(s, 2, wd, Bi(B_SB1), A, mask, lists);
    layer_sync();
  }
  dense1(W_S2W2, A, wd, B_SB2, wd, B);
  dense1(W_S2W3, B, wd, B_SB3, wd, A);
  small_fwd<TB>(W(W_DW), A, wd, Bi(B_DB), 1, R + 3 * TB);  // sigma
  {
    // rgb head: relu([x | dir | time]); x >= 0 already, D and T hold relu'd values
    const Seg s[3] = {{F(W_R1A), A, wd / 16}, {F(W_R1B), D, p.dir_pad / 16},
                      {F(W_R1C), T, p.time_pad / 16}};
    dense_checked<TB>(s, p.use_time ? 3 : 2, p.head, Bi(B_RB1), B, mask, lists);
    layer_sync();
  }
  if (p.n_rgb == 2) {
    small_fwd<TB>(W(W_RGB1), B, p.head, Bi(B_RGB1), 3, R);
  } else {
    dense1(W_RGB1, B, p.head, B_RGB1, p.head, A);
    dense1(W_RGB2, A, p.head, B_RGB2, p.head, B);
    small_fwd<TB>(W(W_RGB3), B, p.head, Bi(B_RGB3), 3, R);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 4 * TB; i += TC_THREADS) {
    const int gm = m0 + i % TB;
    if (gm < M) out[static_cast<size_t>(i / TB) * M + gm] = R[i];
  }
}

__global__ void __launch_bounds__(TC_THREADS, 1)
spacenet_bwd_tc_kernel(const float* __restrict__ pos, const float* __restrict__ dir,
                       const float* __restrict__ time, const float* __restrict__ drgb,
                       const float* __restrict__ dsig, const int* __restrict__ active,
                       const unsigned short* __restrict__ wts, const uint4* __restrict__ frags,
                       const float* __restrict__ bias, unsigned short* __restrict__ records,
                       float* __restrict__ dpos, float* __restrict__ ddir, const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int m0 = blockIdx.x * BM;
  const int M = p.M;
  if (active != nullptr && *active == 0) {
    zero_out<BM>(dpos, p.pos_rows, M, m0);
    zero_out<BM>(ddir, p.dir_rows, M, m0);
    return;
  }
  const Ctx c{p, wts, frags, bias,
              records + static_cast<size_t>(blockIdx.x) * p.rec_rows * BM};
  unsigned short* U = reinterpret_cast<unsigned short*>(smem);  // u_rows: trunk and head
  unsigned short* P = U + p.u_rows * BM;                        // pos_pad: position encoding
  unsigned short* D = P + p.pos_pad * BM;                       // dir_pad: relu(direction enc)
  unsigned short* T = D + p.dir_pad * BM;                       // time_pad: relu(time enc)
  float* R = reinterpret_cast<float*>(T + p.time_pad * BM);     // 4: the sigma cotangent
  float* G3 = R + 4 * BM;                                       // 4: the rgb cotangent
  float* DP = G3 + 4 * BM;                                      // pos_rows: d(position enc)

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

// The shapes into p (both kernels' parameters but the record layout);
// -> false for shapes the kernels do not take. `off` as the C entry points'
// (null: only the sizes are wanted).
bool fill_params(Params& p, const int* off, int M, int pos_rows, int dir_rows, int time_rows,
                 int width, int head, int n_rgb) {
  if (M <= 0 || pos_rows <= 0 || dir_rows <= 0 || time_rows < 0 || !kernel_width(width) ||
      !kernel_width(head) || (n_rgb != 2 && n_rgb != 4)) {
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
  return true;
}

// the backward's layout: fill_params, pass 1's shared memory, the records
// and pass 2's jobs
bool make_layout(Layout& L, const int* off, int M, int pos_rows, int dir_rows, int time_rows,
                 int width, int head, int n_rgb, int n_w, int n_b) {
  Params& p = L.p;
  if (n_w <= 0 || n_b <= 0 ||
      !fill_params(p, off, M, pos_rows, dir_rows, time_rows, width, head, n_rgb)) {
    return false;
  }
  L.smem = static_cast<size_t>(p.u_rows + p.pos_pad + p.dir_pad + p.time_pad) * BM * 2 +
           static_cast<size_t>(4 + 4 + pos_rows) * BM * sizeof(float);
  finish_layout(L, n_w, n_b, 0, sm_count());
  return true;
}

}  // namespace

// C entry points. Pointers are device pointers except `offsets`, a host
// array of N_W weight, N_B bias, N_W forward-fragment and N_W
// backward-fragment offsets (-1 = absent operand; PackedField.tc); `time`
// may be null when time_rows is 0, `active` (one int) null for a field that
// always runs. Each returns the CUDA error of its launches (0 = launched).
extern "C" int stnerf_spacenet_fwd_tc(const void* pos, const void* dir, const void* time,
                                      const void* weights, const void* frags,
                                      const void* biases, const void* offsets,
                                      const void* active, void* out, int M, int pos_rows,
                                      int dir_rows, int time_rows, int width, int head,
                                      int n_rgb, void* stream) {
  Params p{};
  if (!fill_params(p, static_cast<const int*>(offsets), M, pos_rows, dir_rows, time_rows, width,
                   head, n_rgb)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // two ping-pong tiles as wide as the wider of trunk and head, the
  // encodings, the float32 output rows, the recompute's mask and lists
  const int rows_a = imax(width, head);
  const size_t smem =
      static_cast<size_t>(2 * rows_a + p.pos_pad + p.dir_pad + p.time_pad) * FWD_BM * 2 +
      static_cast<size_t>(4) * FWD_BM * sizeof(float) + static_cast<size_t>(rows_a) * FWD_BM / 8 +
      static_cast<size_t>(TC_THREADS / 32) * LIST * 2;
  cudaError_t e = cudaFuncSetAttribute(spacenet_fwd_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  spacenet_fwd_tc_kernel<<<(M + FWD_BM - 1) / FWD_BM, TC_THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const unsigned short*>(weights),
      static_cast<const uint4*>(frags), static_cast<const float*>(biases),
      static_cast<const int*>(active), static_cast<float*>(out), p);
  return static_cast<int>(cudaGetLastError());
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
  *static_cast<long long*>(bytes) = static_cast<long long>(L.rec_bytes + L.part_bytes);
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
  const auto* act = static_cast<const int*>(active);
  cudaError_t e = cudaFuncSetAttribute(spacenet_bwd_tc_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(L.smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  spacenet_bwd_tc_kernel<<<L.dw.n_blocks, TC_THREADS, L.smem, s>>>(
      static_cast<const float*>(pos), static_cast<const float*>(dir),
      static_cast<const float*>(time), static_cast<const float*>(drgb),
      static_cast<const float*>(dsig), act, static_cast<const unsigned short*>(weights),
      static_cast<const uint4*>(frags), static_cast<const float*>(biases), records,
      static_cast<float*>(dpos), static_cast<float*>(ddir), L.p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(launch_dw(L, records, act, partial, n_w, n_b, static_cast<float*>(gw),
                                    static_cast<float*>(gb), s));
}
