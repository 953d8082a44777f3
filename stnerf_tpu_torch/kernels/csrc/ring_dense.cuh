// The consumers of the weight ring (w_ring.cuh): the float32 dense layers
// on CUDA cores that K1's float32 forward (fused_field.cu) and K3's
// (spacenet.cu) run, and the SpaceNet trunk and heads both kernels share,
// with the ring's segment list in the same order.
//
// A block is 8 consumer warps over BM samples whose activations sit in
// dynamic shared memory as float32 rows of BM, plus the ring's producer
// warp. BM is the launch's (block_samples): 64 while the activations of
// the field's widest layer fit beside two ring stages (every width up to
// 256), else 32 (up to 512) or 16 (up to 1024): max_width. Each consumer
// thread keeps a TO x BM/8 register tile of a layer's outputs (TO = O /
// 32; at most 64 accumulators) and walks the reduction axis slab by slab:
// per k step it reads TO weights of the slab (broadcast) and BM/8
// activations, and issues TO x BM/8 FMAs. Every output (o, m) is acc =
// fmaf(W[k, o], x[k, m], acc) from 0 over k in order, segment by segment,
// then + bias, then ReLU: the chain the float32 backward recomputes
// (mlp_blocks.cuh fwd_seg) and whose ReLU masks it takes as bits, so the
// order must not change, whatever the block.
#pragma once

#include "field_common.cuh"
#include "w_ring.cuh"

namespace {
namespace wring {

constexpr int CONSUMERS = 256;  // 8 warps: TO x BM/8 outputs a thread
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int BLOCK = CONSUMERS + 32;  // and the producer warp

// the widest layer a block of BM samples takes: TO x BM/8 <= 64 accumulators
__host__ __device__ constexpr int max_width(int BM) { return 16384 / BM; }

// the consumers' barrier (the producer warp never joins it)
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// the block's dynamic shared memory: activations, then the ring's stages
__device__ __forceinline__ float* smem_floats() {
  extern __shared__ __align__(128) float4 ring_smem4[];
  return reinterpret_cast<float*>(ring_smem4);
}

// A thread's BM/8 columns of a row of BM: at BM = 64, tm*4 + {0..3} and
// 32 + tm*4 + {0..3}, so that each quarter-warp's float4 loads cover 128
// contiguous bytes (no bank conflicts); at 32, tm*4 + {0..3}; at 16,
// tm*2 + {0, 1}. `p` points at the row's column col0<BM>(tm).
template <int BM>
__device__ __forceinline__ int col0(int tm) {
  return tm * (BM >= 32 ? 4 : 2);
}

template <int BM>
__device__ __forceinline__ void ld_cols(const float* p, float (&a)[BM / 8]) {
  if constexpr (BM == 16) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x, a[1] = v.y;
  } else {
#pragma unroll
    for (int h = 0; h < BM / 32; ++h) {
      const float4 v = *reinterpret_cast<const float4*>(p + 32 * h);
      a[4 * h] = v.x, a[4 * h + 1] = v.y, a[4 * h + 2] = v.z, a[4 * h + 3] = v.w;
    }
  }
}

template <int BM>
__device__ __forceinline__ void st_cols(float* p, const float (&v)[BM / 8]) {
  if constexpr (BM == 16) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int h = 0; h < BM / 32; ++h) {
      *reinterpret_cast<float4*>(p + 32 * h) =
          make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    }
  }
}

// A thread's TO outputs of a layer O = 32 * TO wide: runs of CH = min(TO,
// 8) consecutive outputs, 32 * CH apart, so that a warp's four weight
// vectors of a k step lie in distinct banks; output i is out_of(i, to).
template <int TO>
__device__ __forceinline__ int out_of(int i, int to) {
  constexpr int CH = TO < 8 ? TO : 8;
  return (i / CH) * 32 * CH + to * CH + i % CH;
}

// acc[i][j] += sum_k W[k, out_of(i)] * in[k, col(j)] over `rows` rows of a
// slab: W (rows, O) in a ring stage, in (rows, BM) in shared memory, `ip`
// at column col0<BM>(tm) of its first row. A warp reads 4 distinct weight
// vectors, each broadcast.
template <int TO, int BM>
__device__ __forceinline__ void mm_slab(float (&acc)[TO][BM / 8], const float* ws, int rows,
                                        const float* ip, int to) {
  constexpr int O = 32 * TO;
  constexpr int CH = TO < 8 ? TO : 8;
  const float* wp = ws + to * CH;
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float wv[TO];
#pragma unroll
    for (int c = 0; c < TO / CH; ++c) {
      float w[CH];
      load_w<float, CH>(wp + k * O + c * 32 * CH, w);
#pragma unroll
      for (int i = 0; i < CH; ++i) wv[c * CH + i] = w[i];
    }
    float a[BM / 8];
    ld_cols<BM>(ip + k * BM, a);
#pragma unroll
    for (int i = 0; i < TO; ++i) {
#pragma unroll
      for (int j = 0; j < BM / 8; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
    }
  }
}

// out = relu(W0 in0 + W1 in1 + W2 in2 + bias), O = 32 * TO rows, over the
// ring's next n_in segments (the split products of a concat input, in
// order); activations as float offsets into dynamic shared memory.
template <int TO, int BM>
__device__ void dense_t(Ctl& ring, RingPos& pos, int ring_off, int n_in, int in0, int in1,
                        int in2, const float* __restrict__ bias, int out) {
  constexpr int SLAB = slab_rows(32 * TO);
  constexpr int CPT = BM / 8;
  float* sm = smem_floats();
  const float* stages = sm + ring_off;
  const int to = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TO][CPT];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  const int ins[3] = {in0, in1, in2};
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    if (n == n_in) break;
    const int K = ring.seg[pos.seg++].K;
    const float* ip = sm + ins[n] + col0<BM>(tm);
    for (int k0 = 0; k0 < K; k0 += SLAB, ++pos.q) {
      const float* ws = stages + acquire(ring, pos.q) * STAGE_FLOATS;
      if (K - k0 >= SLAB) {
        mm_slab<TO, BM>(acc, ws, SLAB, ip + k0 * BM, to);
      } else {
        mm_slab<TO, BM>(acc, ws, K - k0, ip + k0 * BM, to);
      }
      release(ring, pos.q);
    }
  }
  float* o_sm = sm + out + col0<BM>(tm);
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = out_of<TO>(i, to);
    const float b = bias[o];
    float v[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) v[j] = fmaxf(acc[i][j] + b, 0.f);
    st_cols<BM>(o_sm + o * BM, v);
  }
}

// dense_t for a layer O wide; a width the block does not take (above
// max_width(BM)) or no kernel width traps: the launcher never picks one.
template <int BM>
__device__ void dense(Ctl& ring, RingPos& pos, int ring_off, int n_in, int in0, int in1,
                      int in2, const float* bias, int O, int out) {
  switch (O) {
    case 1024:
      if constexpr (max_width(BM) >= 1024) {
        dense_t<32, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out);
        return;
      }
      break;
    case 512:
      if constexpr (max_width(BM) >= 512) {
        dense_t<16, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out);
        return;
      }
      break;
    case 256: dense_t<8, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); return;
    case 128: dense_t<4, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); return;
    case 64: dense_t<2, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); return;
    case 32: dense_t<1, BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); return;
    default: break;
  }
  __trap();
}

// dense<BM> as a call: one copy of the layer loops in the kernel, called
// from every layer. K1, whose motion net adds five layers to the
// SpaceNet's, runs faster so (inlined at each of its layers it ran slower:
// tools/torch_k1_variants.py dense_inline); K3 keeps the compiler's
// inlining (OUTLINE false in spacenet_layers).
template <int BM>
__device__ __noinline__ void dense_call(Ctl& ring, RingPos& pos, int ring_off, int n_in,
                                        int in0, int in1, int in2, const float* bias, int O,
                                        int out) {
  dense<BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, O, out);
}

// dense<BM>, or dense_call<BM> with OUTLINE
template <int BM, bool OUTLINE>
__device__ __forceinline__ void layer(Ctl& ring, RingPos& pos, int ring_off, int n_in, int in0,
                                      int in1, int in2, const float* bias, int O, int out) {
  if constexpr (OUTLINE) {
    dense_call<BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, O, out);
  } else {
    dense<BM>(ring, pos, ring_off, n_in, in0, in1, in2, bias, O, out);
  }
}

// out = W in + bias for a 1- or 3-wide output layer (no activation), the
// ring's next segment, one slab: one thread per (output, sample), each a
// chain of FMAs over k in order, the weights broadcast from the stage.
template <int BM>
__device__ void dense_small(Ctl& ring, RingPos& pos, int ring_off, int in,
                            const float* __restrict__ bias, int out) {
  const int K = ring.seg[pos.seg].K, O = ring.seg[pos.seg++].O;
  float* sm = smem_floats();
  const float* w = sm + ring_off + acquire(ring, pos.q) * STAGE_FLOATS;
  const int t = threadIdx.x;
  if (t < O * BM) {
    const int o = t / BM, m = t % BM;
    const float* x = sm + in + m;
    float acc = 0.f;
#pragma unroll 8
    for (int k = 0; k < K; ++k) acc = fmaf(w[k * O + o], x[k * BM], acc);
    sm[out + o * BM + m] = acc + bias[o];
  }
  release(ring, pos.q++);
}

// Thread 0: append a (K, O) row-major weight operand to the segment list.
__device__ __forceinline__ void add_seg(Ctl& c, const float* w, int K, int O) {
  c.seg[c.n_seg++] = {w, K, O};
}

// Thread 0: the SpaceNet's segments in the order spacenet_layers reads
// them: the trunk (the skip layer as [trunk | pos_enc]), the density head,
// the rgb head's first layer over [features | dir_enc | time_enc] (no
// time segment when time_rows is 0), and the rest of the rgb head. A 1- or
// 3-wide layer is one slab (K * O * 4 bytes, a multiple of 16: K is a
// kernel width). P: a kernel's Params (w_off, pos_rows, dir_rows,
// time_rows, width, head, n_rgb).
template <class P>
__device__ __forceinline__ void spacenet_segments(Ctl& c, const float* wts, const P& p) {
  const auto add = [&](int slot, int K, int O) { add_seg(c, wts + p.w_off[slot], K, O); };
  add(W_1, p.pos_rows, p.width);
  for (int k = 1; k < 4; ++k) add(W_1 + k, p.width, p.width);
  add(W_S2A, p.width, p.width);
  add(W_S2B, p.pos_rows, p.width);
  add(W_S2W2, p.width, p.width);
  add(W_S2W3, p.width, p.width);
  add(W_DW, p.width, 1);
  add(W_R1A, p.width, p.head);
  add(W_R1B, p.dir_rows, p.head);
  if (p.time_rows > 0) add(W_R1C, p.time_rows, p.head);
  if (p.n_rgb == 4) {
    add(W_RGB1, p.head, p.head);
    add(W_RGB2, p.head, p.head);
    add(W_RGB3, p.head, 3);
  } else {
    add(W_RGB1, p.head, 3);
  }
}

// Where the SpaceNet's activations lie: float offsets into dynamic shared
// memory of rows of the block's BM samples. pos, dir and time are the
// encodings (dir and time clipped at 0: they feed the rgb head through its
// ReLU), a and b two ping-pong tiles of max(width, head) rows, out the 4
// rows rgb, sigma.
struct Tiles {
  int pos, dir, time, a, b, out;
};

// The consumers: the SpaceNet on the encodings in `s`, every layer through
// the ring (spacenet_segments' order) -> raw rgb and sigma in s.out; the
// consumers' barrier after every layer, the last one included. OUTLINE:
// each layer a call of dense_call.
template <int BM, bool OUTLINE, class P>
__device__ __forceinline__ void spacenet_layers(Ctl& ring, RingPos& pos, const float* bias,
                                                const P& p, const Tiles& s) {
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const auto dense1 = [&](int in, int bslot, int O, int dst) {
    layer<BM, OUTLINE>(ring, pos, p.ring_off, 1, in, 0, 0, Bi(bslot), O, dst);
    sync_consumers();
  };
  const int wd = p.width;
  dense1(s.pos, B_1, wd, s.a);
  dense1(s.a, B_1 + 1, wd, s.b);
  dense1(s.b, B_1 + 2, wd, s.a);
  dense1(s.a, B_1 + 3, wd, s.b);
  layer<BM, OUTLINE>(ring, pos, p.ring_off, 2, s.b, s.pos, 0, Bi(B_SB1), wd,
                     s.a);  // [trunk | pos_enc]
  sync_consumers();
  dense1(s.a, B_SB2, wd, s.b);
  dense1(s.b, B_SB3, wd, s.a);
  dense_small<BM>(ring, pos, p.ring_off, s.a, Bi(B_DB), s.out + 3 * BM);  // sigma
  // rgb head: relu([x | dir | time]); x >= 0 already, dir and time hold relu'd values
  layer<BM, OUTLINE>(ring, pos, p.ring_off, p.time_rows > 0 ? 3 : 2, s.a, s.dir, s.time,
                     Bi(B_RB1), p.head, s.b);
  sync_consumers();
  if (p.n_rgb == 2) {
    dense_small<BM>(ring, pos, p.ring_off, s.b, Bi(B_RGB1), s.out);
  } else {
    dense1(s.b, B_RGB1, p.head, s.a);
    dense1(s.a, B_RGB2, p.head, s.b);
    dense_small<BM>(ring, pos, p.ring_off, s.b, Bi(B_RGB3), s.out);
  }
  sync_consumers();
}

}  // namespace wring
}  // namespace
