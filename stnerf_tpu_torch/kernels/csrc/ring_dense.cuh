// The consumers of the weight ring (w_ring.cuh): the float32 dense layers
// on CUDA cores that K1's float32 forward (fused_field.cu) and K3's
// (spacenet.cu) run, and the SpaceNet trunk and heads both kernels share,
// with the ring's segment list in the same order.
//
// A block is 8 consumer warps over BM = 64 samples whose activations sit in
// dynamic shared memory as float32 rows of BM, plus the ring's producer
// warp. Each consumer thread keeps a TO x 8 register tile of a layer's
// outputs (TO = O / 32) and walks the reduction axis slab by slab: per k
// step it reads TO weights of the slab (broadcast) and 8 activations, and
// issues TO x 8 FMAs. Every output (o, m) is acc = fmaf(W[k, o], x[k, m],
// acc) from 0 over k in order, segment by segment, then + bias, then ReLU:
// the chain the float32 backward recomputes (mlp_blocks.cuh fwd_seg) and
// whose ReLU masks it takes as bits, so the order must not change.
#pragma once

#include "field_common.cuh"
#include "w_ring.cuh"

namespace {
namespace wring {

constexpr int BM = 64;          // samples per block: the tile of the skip flags
constexpr int CONSUMERS = 256;  // 8 warps: TO x 8 outputs a thread
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int BLOCK = CONSUMERS + 32;  // and the producer warp

// the consumers' barrier (the producer warp never joins it)
__device__ __forceinline__ void sync_consumers() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// the block's dynamic shared memory: activations, then the ring's stages
__device__ __forceinline__ float* smem_floats() {
  extern __shared__ __align__(128) float4 ring_smem4[];
  return reinterpret_cast<float*>(ring_smem4);
}

// acc[i][j] += sum_k W[k, to*TO + i] * in[k, col(j)] over `rows` rows of a
// slab: W (rows, O) in a ring stage, in (rows, BM) in shared memory. A
// thread's 8 columns are tm*4 + {0..3} and 32 + tm*4 + {0..3}: each
// quarter-warp's float4 loads then cover 128 contiguous bytes (no bank
// conflicts); a warp reads 4 distinct weight vectors, each broadcast.
template <int TO>
__device__ __forceinline__ void mm_slab(float (&acc)[TO][8], const float* ws, int rows,
                                        const float* ip, int to) {
  constexpr int O = 32 * TO;
  const float* wp = ws + to * TO;
#pragma unroll 4
  for (int k = 0; k < rows; ++k) {
    float wv[TO];
    load_w<float, TO>(wp + k * O, wv);
    const float4 a0 = *reinterpret_cast<const float4*>(ip + k * BM);
    const float4 a1 = *reinterpret_cast<const float4*>(ip + k * BM + 32);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int i = 0; i < TO; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], a[j], acc[i][j]);
    }
  }
}

// out = relu(W0 in0 + W1 in1 + W2 in2 + bias), O = 32 * TO rows, over the
// ring's next n_in segments (the split products of a concat input, in
// order); activations as float offsets into dynamic shared memory.
template <int TO>
__device__ void dense_t(Ctl& ring, RingPos& pos, int ring_off, int n_in, int in0, int in1,
                        int in2, const float* __restrict__ bias, int out) {
  constexpr int SLAB = slab_rows(32 * TO);
  float* sm = smem_floats();
  const float* stages = sm + ring_off;
  const int to = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TO][8];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const int ins[3] = {in0, in1, in2};
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    if (n == n_in) break;
    const int K = ring.seg[pos.seg++].K;
    const float* ip = sm + ins[n] + tm * 4;
    for (int k0 = 0; k0 < K; k0 += SLAB, ++pos.q) {
      const float* ws = stages + acquire(ring, pos.q) * STAGE_FLOATS;
      if (K - k0 >= SLAB) {
        mm_slab<TO>(acc, ws, SLAB, ip + k0 * BM, to);
      } else {
        mm_slab<TO>(acc, ws, K - k0, ip + k0 * BM, to);
      }
      release(ring, pos.q);
    }
  }
  float* o_sm = sm + out;
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const int o = to * TO + i;
    const float b = bias[o];
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = fmaxf(acc[i][j] + b, 0.f);
    *reinterpret_cast<float4*>(o_sm + o * BM + tm * 4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(o_sm + o * BM + 32 + tm * 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

__device__ void dense(Ctl& ring, RingPos& pos, int ring_off, int n_in, int in0, int in1,
                      int in2, const float* bias, int O, int out) {
  switch (O) {
    case 256: dense_t<8>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); break;
    case 128: dense_t<4>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); break;
    case 64: dense_t<2>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); break;
    case 32: dense_t<1>(ring, pos, ring_off, n_in, in0, in1, in2, bias, out); break;
  }
}

// out = W in + bias for a 1- or 3-wide output layer (no activation), the
// ring's next segment, one slab: one thread per (output, sample), each a
// chain of FMAs over k in order, the weights broadcast from the stage.
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
// memory of rows of BM. pos, dir and time are the encodings (dir and time
// clipped at 0: they feed the rgb head through its ReLU), a and b two
// ping-pong tiles of max(width, head) rows, out the 4 rows rgb, sigma.
struct Tiles {
  int pos, dir, time, a, b, out;
};

// The consumers: the SpaceNet on the encodings in `s`, every layer through
// the ring (spacenet_segments' order) -> raw rgb and sigma in s.out; the
// consumers' barrier after every layer, the last one included.
template <class P>
__device__ __forceinline__ void spacenet_layers(Ctl& ring, RingPos& pos, const float* bias,
                                                const P& p, const Tiles& s) {
  const auto Bi = [&](int slot) { return bias + p.b_off[slot]; };
  const auto dense1 = [&](int in, int bslot, int O, int dst) {
    dense(ring, pos, p.ring_off, 1, in, 0, 0, Bi(bslot), O, dst);
    sync_consumers();
  };
  const int wd = p.width;
  dense1(s.pos, B_1, wd, s.a);
  dense1(s.a, B_1 + 1, wd, s.b);
  dense1(s.b, B_1 + 2, wd, s.a);
  dense1(s.a, B_1 + 3, wd, s.b);
  dense(ring, pos, p.ring_off, 2, s.b, s.pos, 0, Bi(B_SB1), wd, s.a);  // [trunk | pos_enc]
  sync_consumers();
  dense1(s.a, B_SB2, wd, s.b);
  dense1(s.b, B_SB3, wd, s.a);
  dense_small(ring, pos, p.ring_off, s.a, Bi(B_DB), s.out + 3 * BM);  // sigma
  // rgb head: relu([x | dir | time]); x >= 0 already, dir and time hold relu'd values
  dense(ring, pos, p.ring_off, p.time_rows > 0 ? 3 : 2, s.a, s.dir, s.time, Bi(B_RB1), p.head,
        s.b);
  sync_consumers();
  if (p.n_rgb == 2) {
    dense_small(ring, pos, p.ring_off, s.b, Bi(B_RGB1), s.out);
  } else {
    dense1(s.b, B_RGB1, p.head, s.a);
    dense1(s.a, B_RGB2, p.head, s.b);
    dense_small(ring, pos, p.ring_off, s.b, Bi(B_RGB3), s.out);
  }
  sync_consumers();
}

}  // namespace wring
}  // namespace
