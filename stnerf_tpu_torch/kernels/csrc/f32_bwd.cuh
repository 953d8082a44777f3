// The float32 backward kernels of the field on Hopper (sm_90a), shared by K2
// (field_bwd.cu: the fused field with its motion net and encodings) and K3
// (spacenet.cu: the SpaceNet on encoded inputs). They run the bf16 route's
// three passes (tc_bwd.cuh) in float32:
//   1. pass 1, a block of THREADS threads per RBM samples (a record):
//      recompute the forward on CUDA cores
//      (mlp_blocks.cuh's fwd_seg: exact float32 FMA, as the forward kernels,
//      so that the ReLU masks are what they are there) and compute every
//      dx = W dy as 3xTF32 on the tensor cores (dx_tc_t), copying each
//      layer's float32 input x and output cotangent dy, as they stand in
//      shared memory, into the block's record in global memory (one bulk
//      copy a tile, issued by one thread, marked evict-first in L2 so that
//      the records do not push out of it the weights every block reads). The
//      backward reads no activation back: each ReLU's mask is kept in shared
//      memory as bits (RBM / 8 bytes a row), so nothing is recomputed and
//      the activations need two ping-pong tiles.
//   2. f32_dw_kernel: dW = x dy^T and db = sum dy for every layer from the
//      records (a job per layer), the sum over samples as 3xTF32 on the
//      tensor cores. A block takes one KT x KT tile of one layer's dW (NK x
//      NO on CUDA cores for the 1- and 3-wide layers) over one range of
//      records, which stream through a 3-stage cp.async ring, and writes its
//      float32 partials; a record whose flag is 0 was not written and is
//      skipped.
//   3. field_dw_reduce (field_common.cuh): each entry the sum of its
//      partials in (slice, range) order.
// Passes 1 and 2 run over slices of the blocks in order, so that the records
// of one slice are held at a time; each (slice, range) has its own partials.
// No atomics: every output is the same on every run.
//
// The block RBM is the plan's (f32_bwd.py make_plan: the largest of 64, 32
// and 16 samples whose pass-1 shared memory fits the card's, smem_bytes),
// so every kernel here is a template over it: 64 at every width up to 256
// (one skip-flag tile, fused_field.py TILE: those launches run the 64-sample
// code throughout), 32 at 512 and 16 at 1024, where a block is part of a
// tile and block b's flag is flags[b / (64 / RBM)] (block_flag). A thread
// keeps at most 64 accumulators of a layer's outputs (TO x RBM / 8), so a
// block takes layers up to 16384 / RBM wide (max_width).
//
// 3xTF32: each float32 operand v is split into hi, v rounded to TF32, and lo
// = v - hi, of which the tensor cores read the TF32 part (split), and a
// product is lo_a hi_b + hi_a lo_b + hi_a hi_b, three mma.sync.m16n8k8 tf32
// with float32 accumulation: about 21 bits of each operand, against
// float32's 24 (ops/rounding.py tf32x3_matmul is the plain version). Only
// the backward's products take it: their rounding moves no ReLU mask, since
// the masks come from the forward.
//
// The plan (the record's tiles, pass 2's jobs, the slices and ranges, and
// the offsets of the dx operands' fragments) comes from the wrapper
// (kernels/f32_bwd.py::make_plan) as one host int array; the tiles are in
// the order of f32_bwd.py's REC_TILES. A record tile is the shared tile's
// rows of RBM floats: plain for activations, encodings and the 1- and
// 3-wide cotangents, swizzled (swz) for the cotangents that dx makes; pass
// 2 undoes the swizzle as it loads. The dx operands are the weights in mma
// A-fragment order (f32_bwd.py dx_fragments), float32, split in the kernel.
//
// Numerics are otherwise the former one-pass kernel's and the plain
// version's: float32 throughout (the compute dtype rounds nothing), masks on
// the stored activation, d(pos enc), d_dir and d(motion enc) unmasked sums.
#pragma once

#include <cstdint>
#include <type_traits>

#include "field_common.cuh"
#include "mlp_blocks.cuh"

namespace {

constexpr int FLAG_TILE = 64;  // samples per skip flag (fused_field.py TILE)

// the widest layer a block of RBM samples takes: TO x RBM / 8 <= 64
// accumulators a thread
__host__ __device__ constexpr int max_width(int rbm) { return 16384 / rbm; }

// the skip flag of block b of RBM samples, `step` apart (0: one flag)
template <int RBM>
__device__ __forceinline__ int block_flag(const int* flags, int b, int step) {
  return flags[b / (FLAG_TILE / RBM) * step];
}

// The record's tiles, in the order of f32_bwd.py REC_TILES
enum Tile {
  T_HS0 = 0,     // rgb head activations (3)
  T_DHS0 = 3,    // their cotangents (3)
  T_G3RGB = 6,   // the rgb cotangent, 3 rows
  T_A0 = 7,      // trunk activations a0-a6 (7)
  T_D0 = 14,     // their cotangents (7)
  T_POS = 21,    // position encoding
  T_DIR = 22,    // relu(direction encoding)
  T_TIME = 23,   // relu(time encoding)
  T_SIG = 24,    // the sigma cotangent, 1 row
  T_U0 = 25,     // motion encoding and hidden layers u1-u5 (6)
  T_DU1 = 31,    // the hidden layers' cotangents du1-du5 (5)
  T_G3M = 36,    // the flow cotangent, 3 rows
  N_TILES = 37
};

// pass 2's job for one layer: dW[k, o] = sum_m x[k, m] dy[o, m] with x the
// record tile at float offset x (k_in rows, plain) and dy the one at y (o
// rows; swizzled when o > NO), into the partials at w_off and, when b_off
// >= 0, db[o] = sum_m dy[o, m] at b_off (the weights' count plus the bias's
// packed offset); mt x nt tiles of dW.
struct Job {
  int x, k_in, y, o, w_off, b_off, mt, nt;
};
constexpr int JOB_INTS = 8;
constexpr int MAX_JOBS = 24;
constexpr int PLAN_HEAD = 5;  // rec_floats, slice_blocks, ranges, n_jobs, block

// The plan array: PLAN_HEAD ints, N_TILES tile offsets (floats within a
// record, -1 absent), N_W offsets of the dx fragments (floats; -1: no dx on
// the tensor cores), then n_jobs x JOB_INTS.
struct Plan {
  int rec_floats, slice_blocks, ranges, n_jobs, rbm;
  const int* tile;
  const int* frag;
  const int* jobs;
};

bool read_plan(const int* a, Plan& P) {
  if (a == nullptr) return false;
  P.rec_floats = a[0];
  P.slice_blocks = a[1];
  P.ranges = a[2];
  P.n_jobs = a[3];
  P.rbm = a[4];
  P.tile = a + PLAN_HEAD;
  P.frag = P.tile + N_TILES;
  P.jobs = P.frag + N_W;
  return (P.rbm == 64 || P.rbm == 32 || P.rbm == 16) && P.rec_floats > 0 &&
         P.rec_floats % P.rbm == 0 && P.slice_blocks > 0 && P.ranges > 0 && P.n_jobs > 0 &&
         P.n_jobs <= MAX_JOBS;
}

// pass 1's parameters (both kernels; the motion entries are K2's)
struct BwdParams {
  int w_off[N_W];
  int b_off[N_B];
  int tile[N_TILES];  // a record tile's offset in floats; -1 = absent
  int frag[N_W];      // a weight's dx fragments, in floats; -1 = dx on CUDA cores
  int rec_floats;
  int M, pos_rows, dir_rows, time_rows, width, head, n_rgb;
  int motion_mode, motion_width, menc_rows, freqs, inc;
  int rows_a;  // rows of each ping-pong tile
};

void set_plan(BwdParams& p, const int* offsets, const Plan& P) {
  for (int i = 0; i < N_W; ++i) {
    p.w_off[i] = offsets[i];
    p.frag[i] = P.frag[i];
  }
  for (int i = 0; i < N_B; ++i) p.b_off[i] = offsets[N_W + i];
  for (int i = 0; i < N_TILES; ++i) p.tile[i] = P.tile[i];
  p.rec_floats = P.rec_floats;
}

// Pass 1's shared memory: float tiles of RBM samples (X: xyz and id, XD:
// displaced xyz, FL: the flow, R: the sigma cotangent, G3: the rgb or flow
// cotangent, P / D / T: the encodings, DP: d(pos enc), A and B: the
// ping-pong tiles), then the mask bytes (RBM / 8 a row: trunk a0-a6, head
// h0-h2, motion u1-u5). Rows of RBM floats; the cotangent tiles that dx
// makes are swizzled (swz), the rest plain. Every tile starts 16-byte
// aligned (rows of at least 64 bytes), as the bulk copies need.
struct Smem {
  float *X, *XD, *FL, *R, *G3, *P, *D, *T, *DP, *A, *B;
  unsigned char* MK;
};

inline int mask_rows(const BwdParams& p) {
  return 7 * p.width + 3 * p.head + 5 * p.motion_width;
}

// (f32_bwd.py pass1_smem_bytes)
size_t smem_bytes(const BwdParams& p, int rbm) {
  const int rows = 4 + 3 + 3 + 1 + 3 + 2 * p.pos_rows + p.dir_rows + p.time_rows + 2 * p.rows_a;
  return static_cast<size_t>(rows) * rbm * sizeof(float) +
         static_cast<size_t>(mask_rows(p)) * (rbm / 8);
}

// smem_bytes' layout, in the same order
template <int RBM>
__device__ Smem carve(const BwdParams& p, void* base) {
  Smem s;
  float* f = static_cast<float*>(base);
  const auto take = [&](int rows) {
    float* q = f;
    f += rows * RBM;
    return q;
  };
  s.X = take(4);
  s.XD = take(3);
  s.FL = take(3);
  s.R = take(1);
  s.G3 = take(3);
  s.P = take(p.pos_rows);
  s.D = take(p.dir_rows);
  s.T = take(p.time_rows);
  s.DP = take(p.pos_rows);
  s.A = take(p.rows_a);
  s.B = take(p.rows_a);
  s.MK = reinterpret_cast<unsigned char*>(f);
  return s;
}

// the ReLU mask of (row k, sample m): the stored activation is positive
template <int RBM>
__device__ __forceinline__ bool pos_bit(const unsigned char* mk, int k, int m) {
  return (mk[k * (RBM / 8) + m / 8] >> (m % 8)) & 1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// this thread's writes to shared memory, made visible to the bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the bulk copies issued so far (by thread 0) have read their tiles, which
// the epilogue about to run may overwrite; then the barrier
__device__ __forceinline__ void copies_read() {
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  __syncthreads();
}
// the barrier after shared-memory writes that a bulk copy may read
__device__ __forceinline__ void sync_async() {
  fence_async();
  __syncthreads();
}

// A thread's tile acc[i][j] (rows r = r0 + i, samples m = tm * CPT + j,
// CPT = RBM / 8) into a plain (rows, RBM) shared tile
template <int RBM, int TR>
__device__ __forceinline__ void store_tile(const float (&acc)[TR][RBM / 8], int r0, int tm,
                                           float* out) {
#pragma unroll
  for (int i = 0; i < TR; ++i) {
    float* o = out + (r0 + i) * RBM + tm * (RBM / 8);
    if constexpr (RBM == 16) {
      *reinterpret_cast<float2*>(o) = make_float2(acc[i][0], acc[i][1]);
    } else {
#pragma unroll
      for (int h = 0; h < RBM / 32; ++h) {
        reinterpret_cast<float4*>(o)[h] =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
    }
  }
}

// out = relu(W0^T in0 + W1^T in1 + W2^T in2 + bias), O = 32 * TO rows (a
// segment with K = 0 is absent), with its mask. Thread (to, tm) computes
// rows to * TO + i, samples tm * CPT + j; below 64 samples a mask byte's 8
// samples span 8 / CPT neighbouring lanes, which gather its bits.
template <int RBM, int TO>
__device__ __noinline__ void dense_t(const float* w0, const float* in0, int k0, const float* w1,
                        const float* in1, int k1, const float* w2, const float* in2, int k2,
                        const float* __restrict__ bias, float* out, unsigned char* mk) {
  constexpr int O = 32 * TO, CPT = RBM / 8;
  // eight k steps in flight, where the forward kernels have four (the
  // variant `unroll4`): the weights come from L2 for every block; fewer
  // for wider thread tiles
  constexpr int UNROLL = TO > 8 ? 64 / TO : 8;
  const int to = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TO][CPT];
#pragma unroll
  for (int i = 0; i < TO; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  fwd_seg<float, float, RBM, TO, UNROLL>(acc, w0, O, k0, in0, to, tm);
  if (k1) fwd_seg<float, float, RBM, TO, UNROLL>(acc, w1, O, k1, in1, to, tm);
  if (k2) fwd_seg<float, float, RBM, TO, UNROLL>(acc, w2, O, k2, in2, to, tm);
  copies_read();
  constexpr int PER = 8 / CPT;  // threads of one mask byte
#pragma unroll
  for (int i = 0; i < TO; ++i) {
    const float b = bias[to * TO + i];
    unsigned bits = 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      acc[i][j] = fmaxf(acc[i][j] + b, 0.f);
      bits |= (acc[i][j] > 0.f ? 1u : 0u) << j;
    }
    if constexpr (PER > 1) {
      bits <<= (tm % PER) * CPT;
#pragma unroll
      for (int d = 1; d < PER; d <<= 1) bits |= __shfl_xor_sync(0xffffffffu, bits, d);
    }
    if (tm % PER == 0) {
      mk[(to * TO + i) * (RBM / 8) + tm / PER] = static_cast<unsigned char>(bits);
    }
  }
  store_tile<RBM, TO>(acc, to * TO, tm, out);
}

// Where (row o, sample m) of a cotangent tile lies: rows of RBM floats,
// the samples of row o XOR-ed by swz_mask(o), so that the four rows an mma
// B fragment reads at one column fall in four bank groups: (o % 4) * 8 for
// rows of 64 or 32 floats (each row in the same banks), ((o / 2) % 2) * 8
// for rows of 16 (rows o and o + 1 already half a bank cycle apart).
template <int RBM>
__device__ __forceinline__ int swz_mask(int o) {
  return RBM >= 32 ? (o & 3) << 3 : (o & 2) << 2;
}
template <int RBM>
__device__ __forceinline__ int swz(int o, int m) { return o * RBM + (m ^ swz_mask<RBM>(o)); }

// v = hi + lo: hi is v rounded to TF32 (to nearest, ties away from zero, as
// cvt.rna: the carry of the 13th bit, then the low 13 bits cleared), lo the
// rest, as float32 bits of which an mma reads the TF32 part: |v - hi -
// tf32(lo)| <= 2^-21 |v|. An integer add, an and and a float subtract, where
// two cvt.rna cost more (the variant `cvt` of tools/torch_f32_bwd_variants.py).
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(__fsub_rn(v, __uint_as_float(hi)));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// d += a b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh[0], bh[1]);
  mma_tf32(d, ah, bl[0], bl[1]);
  mma_tf32(d, ah, bh[0], bh[1]);
}

// The products are not inlined: each gets the registers to itself (inlined
// into the pass-1 kernels, they spilled ~2 KB a thread: the variant
// `inline` of tools/torch_f32_bwd_variants.py).
//
// epi(k, m, sum_o W[k, o] dy[o, m]) for the rows k of W (K, O) from row
// tile r0 on, 16 * MT * (8 / WN) of them, those of row tiles past K left
// out, and the RBM samples, 3xTF32 on the tensor cores. frag: W in mma
// A-fragment order (f32_bwd.py dx_fragments: for each 16-row tile and each
// 8-column step, a float4 a lane), rows past K zero; dy: a swizzled tile of
// O rows (O a multiple of 8). Warp w takes MT row tiles and NT 8-sample
// column tiles (WN = RBM / (8 NT) warps share a row group).
template <int RBM, int MT, int NT, class Epi>
__device__ __noinline__ void dx_tc_t(const float4* __restrict__ frag, int K, int O,
                                     const float* dy, Epi epi, int r0 = 0) {
  constexpr int WN = RBM / (8 * NT);
  static_assert(WN >= 1 && 8 % WN == 0, "a warp's columns tile the block");
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31, g = l >> 2, q = l & 3;
  const int mt0 = r0 + (w / WN) * MT, n0 = (w % WN) * NT * 8;
  const bool live = mt0 * 16 < K;  // a warp whose row tiles all lie past K
  const int steps = live ? O / 8 : 0;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
    }
  }
  // the fragments of step kt, from L2; two steps ahead of their use
  const auto fetch = [&](float4 (&f)[MT], int kt) {
    if (kt < steps) {
#pragma unroll
      for (int i = 0; i < MT; ++i) f[i] = frag[static_cast<size_t>((mt0 + i) * steps + kt) * 32 + l];
    }
  };
  const auto step = [&](const float4 (&f)[MT], int kt) {
    uint32_t ah[MT][4], al[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      split(f[i].x, ah[i][0], al[i][0]);
      split(f[i].y, ah[i][1], al[i][1]);
      split(f[i].z, ah[i][2], al[i][2]);
      split(f[i].w, ah[i][3], al[i][3]);
    }
    // rows kt * 8 + q and + 4: the same swizzle
    const float* y0 = dy + (kt * 8 + q) * RBM;
    const float* y1 = y0 + 4 * RBM;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int c = (n0 + 8 * j + g) ^ swz_mask<RBM>(q);
      uint32_t bh[2], bl[2];
      split(y0[c], bh[0], bl[0]);
      split(y1[c], bh[1], bl[1]);
#pragma unroll
      for (int i = 0; i < MT; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);
    }
  };
  float4 f0[MT], f1[MT];
  fetch(f0, 0);
  fetch(f1, 1);
#pragma unroll 1
  for (int kt = 0; kt < steps; kt += 2) {
    step(f0, kt);
    fetch(f0, kt + 2);
    if (kt + 1 < steps) {
      step(f1, kt + 1);
      fetch(f1, kt + 3);
    }
  }
  copies_read();
  if (!live) return;
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        epi((mt0 + i) * 16 + g + (c >> 1) * 8, n0 + 8 * j + 2 * q + (c & 1), acc[i][j][c]);
      }
    }
  }
}

// The same on CUDA cores for a layer of O <= 4 outputs (dy a plain tile)
// and K = 32 * TK inputs; the sum runs over o in order.
template <int RBM, int TK, class Epi>
__device__ void dx_small_t(const float* __restrict__ w, int O, const float* dy, Epi epi) {
  constexpr int CPT = RBM / 8;
  const int tk = threadIdx.x / 8, tm = threadIdx.x % 8;
  float acc[TK][CPT];
#pragma unroll
  for (int i = 0; i < TK; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }
  for (int o = 0; o < O; ++o) {
    float y[CPT];
    ld_vec<CPT>(dy + o * RBM + tm * CPT, y);
#pragma unroll
    for (int i = 0; i < TK; ++i) {
      const float wv = w[(tk * TK + i) * O + o];
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(wv, y[j], acc[i][j]);
    }
  }
  copies_read();
#pragma unroll
  for (int i = 0; i < TK; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) epi(tk * TK + i, tm * CPT + j, acc[i][j]);
  }
}

// One pass-1 block: the packed operands, its record and its masks
template <int RBM>
struct Blk {
  const BwdParams& p;
  const float* wts;
  const float* frags;
  const float* bias;
  float* rec;
  unsigned char* mk;
  __device__ const float* W(int s) const { return wts + p.w_off[s]; }
  __device__ const float* Bi(int s) const { return bias + p.b_off[s]; }
  static constexpr int MB = RBM / 8;  // mask bytes a row
  __device__ unsigned char* trunk_mask(int l) const { return mk + l * p.width * MB; }
  __device__ unsigned char* head_mask(int i) const {
    return mk + (7 * p.width + i * p.head) * MB;
  }
  // the mask of the motion net's hidden layer u_{k+1}
  __device__ unsigned char* motion_mask(int k) const {
    return mk + (7 * p.width + 3 * p.head + k * p.motion_width) * MB;
  }
  // `rows` rows of a shared tile (written before the last sync) into record
  // tile r: one bulk copy from shared to global memory, issued by thread 0,
  // evict-first in L2; copies_read() before the tile is overwritten, done()
  // before the block exits
  __device__ void save(int r, const float* tile, int rows) const {
    if (threadIdx.x == 0) {
      asm volatile(
          "{\n.reg .b64 pol;\ncreatepolicy.fractional.L2::evict_first.b64 pol, 1.0;\n"
          "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, pol;\n}\n"
          ::"l"(rec + p.tile[r]), "r"(smem_u32(tile)), "r"(rows * RBM * 4)
          : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    }
  }
  __device__ void done() const {
    if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }

  // dense_t at O = 32 * TO, a width a block of RBM samples takes; the
  // launchers refuse the others (max_width), which trap
  template <int TO>
  __device__ void dense_as(int s0, const float* in0, int k0, int s1, const float* in1, int k1,
                           int s2, const float* in2, int k2, int bslot, float* out,
                           unsigned char* m) const {
    if constexpr (32 * TO <= max_width(RBM)) {
      dense_t<RBM, TO>(W(s0), in0, k0, W(s1), in1, k1, W(s2), in2, k2, Bi(bslot), out, m);
    } else {
      __trap();
    }
  }
  // out = relu(dense), O rows, with its mask m, saved as record tile r
  __device__ void dense(int s0, const float* in0, int k0, int s1, const float* in1, int k1,
                        int s2, const float* in2, int k2, int bslot, int O, float* out, int r,
                        unsigned char* m) const {
    switch (O) {
      case 1024: dense_as<32>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      case 512: dense_as<16>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      case 256: dense_as<8>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      case 128: dense_as<4>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      case 64: dense_as<2>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      case 32: dense_as<1>(s0, in0, k0, s1, in1, k1, s2, in2, k2, bslot, out, m); break;
      default: __trap();  // not a kernel width (fwd_width): the launchers refuse it
    }
    sync_async();
    save(r, out, O);
  }
  __device__ void dense1(int slot, const float* in, int k, int bslot, int O, float* out, int r,
                         unsigned char* m) const {
    dense(slot, in, k, slot, in, 0, slot, in, 0, bslot, O, out, r, m);
  }
  // epi(k, m, sum_o W[k, o] dy[o, m]) for the K rows of the layer's input
  // (dy: O rows): on the tensor cores where the plan gives the weight
  // fragments (dy swizzled; epi also sees the padding rows k >= K), else on
  // CUDA cores (O <= 4, dy plain); then the barrier (after a fence for the
  // bulk copies)
  //
  // The tensor-core split: the fragments' rows are K padded to a kernel
  // width (f32_bwd.py padded_rows), and each case's warps cover exactly
  // those rows (16 x MT x 8 / WN), but the narrowest: with 16 samples two
  // warps share a row group, and 32 rows take half of the warps.
  template <class Epi>
  __device__ void dx(int slot, int K, int O, const float* dy, Epi epi) const {
    if (p.frag[slot] >= 0) {
      const float4* f = reinterpret_cast<const float4*>(frags + p.frag[slot]);
      if constexpr (RBM == 64) {
        if (K > 128) {
          dx_tc_t<RBM, 2, 8>(f, K, O, dy, epi);
        } else if (K > 64) {
          dx_tc_t<RBM, 1, 8>(f, K, O, dy, epi);
        } else if (K > 32) {
          dx_tc_t<RBM, 1, 4>(f, K, O, dy, epi);
        } else {
          dx_tc_t<RBM, 1, 2>(f, K, O, dy, epi);
        }
      } else if constexpr (RBM == 32) {
        if (K > 256) {
          dx_tc_t<RBM, 4, 4>(f, K, O, dy, epi);
        } else if (K > 128) {
          dx_tc_t<RBM, 2, 4>(f, K, O, dy, epi);
        } else if (K > 64) {
          dx_tc_t<RBM, 1, 4>(f, K, O, dy, epi);
        } else if (K > 32) {
          dx_tc_t<RBM, 1, 2>(f, K, O, dy, epi);
        } else {
          dx_tc_t<RBM, 1, 1>(f, K, O, dy, epi);
        }
      } else {
        if (K > 512) {  // two halves of 512 rows
          dx_tc_t<RBM, 4, 2>(f, K, O, dy, epi);
          dx_tc_t<RBM, 4, 2>(f, K, O, dy, epi, 32);
        } else if (K > 256) {
          dx_tc_t<RBM, 4, 2>(f, K, O, dy, epi);
        } else if (K > 128) {
          dx_tc_t<RBM, 2, 2>(f, K, O, dy, epi);
        } else if (K > 64) {
          dx_tc_t<RBM, 1, 2>(f, K, O, dy, epi);
        } else {
          dx_tc_t<RBM, 1, 1>(f, K, O, dy, epi);
        }
      }
    } else {
      switch (K) {
        case 1024: dx_small_as<32>(slot, O, dy, epi); break;
        case 512: dx_small_as<16>(slot, O, dy, epi); break;
        case 256: dx_small_as<8>(slot, O, dy, epi); break;
        case 128: dx_small_as<4>(slot, O, dy, epi); break;
        case 64: dx_small_as<2>(slot, O, dy, epi); break;
        case 32: dx_small_as<1>(slot, O, dy, epi); break;
        default: __trap();  // not a kernel width (fwd_width): the launchers refuse it
      }
    }
    sync_async();
  }
  // dx_small_t at K = 32 * TK, a width a block of RBM samples takes (the
  // others trap: the launchers refuse them, max_width)
  template <int TK, class Epi>
  __device__ void dx_small_as(int slot, int O, const float* dy, Epi epi) const {
    if constexpr (32 * TK <= max_width(RBM)) {
      dx_small_t<RBM, TK>(W(slot), O, dy, epi);
    } else {
      __trap();
    }
  }
  // the backward of a hidden layer: its input's cotangent, f(k, m, W dy)
  // masked by the input's ReLU mask m, into the swizzled tile `out`, saved
  // as record tile r
  template <class F>
  __device__ void hidden_f(int slot, int K, int O, const float* dy, const unsigned char* m,
                           F f, float* out, int r) const {
    dx(slot, K, O, dy, [=](int k, int mm, float v) {
      out[swz<RBM>(k, mm)] = pos_bit<RBM>(m, k, mm) ? f(k, mm, v) : 0.f;
    });
    save(r, out, K);
  }
  __device__ void hidden(int slot, int K, int O, const float* dy, const unsigned char* m,
                         float* out, int r) const {
    hidden_f(slot, K, O, dy, m, [](int, int, float v) { return v; }, out, r);
  }
};

// Pass 1's SpaceNet part (spacenet_vjp._bwd_math) for the block of samples
// from m0 on, after a barrier behind the encodings in s.P, s.D (relu'd) and
// s.T (relu'd): the trunk and rgb head forward into the ping-pong tiles,
// then their backward from the cotangents drgb (3, M) and dsig (M,). Writes
// d_dir_enc (dir_rows, M), masked where D is not positive, leaves d(pos enc)
// = w1 dy0 + s2b dy4 in s.DP behind a barrier, and copies every layer's x
// and dy to the record (Blk::done() before the block exits).
template <int RBM>
__device__ void spacenet_block(const Blk<RBM>& c, int m0, const Smem& s,
                               const float* __restrict__ drgb, const float* __restrict__ dsig,
                               float* __restrict__ ddir) {
  const BwdParams& p = c.p;
  const int t = threadIdx.x;
  const int M = p.M, W = p.width, H = p.head, kp = p.pos_rows;
  float* x = s.A;
  float* y = s.B;
  const auto swap = [&]() {
    float* q = x;
    x = y;
    y = q;
  };
  // ---- forward: a_l alternates between the tiles; the newest is in x ----
  c.dense1(W_1, s.P, kp, B_1, W, x, T_A0, c.trunk_mask(0));
  for (int l = 1; l < 7; ++l) {
    swap();
    if (l == 4) {  // the stage-2 skip layer: [a3 | pos enc]
      c.dense(W_S2A, y, W, W_S2B, s.P, kp, W_S2B, s.P, 0, B_SB1, W, x, T_A0 + 4,
              c.trunk_mask(4));
    } else {
      const int slot = l < 4 ? W_1 + l : W_S2W2 + l - 5;
      const int bslot = l < 4 ? B_1 + l : B_SB2 + l - 5;
      c.dense1(slot, y, W, bslot, W, x, T_A0 + l, c.trunk_mask(l));
    }
  }
  // rgb head: relu([a6 | dir | time]); a6 >= 0, D and T hold relu'd values
  swap();
  c.dense(W_R1A, y, W, W_R1B, s.D, p.dir_rows, W_R1C, s.T, p.time_rows, B_RB1, H, x, T_HS0,
          c.head_mask(0));
  for (int i = 1; i < p.n_rgb - 1; ++i) {
    swap();
    c.dense1(W_RGB1 + i - 1, y, H, B_RGB1 + i - 1, H, x, T_HS0 + i, c.head_mask(i));
  }

  // ---- rgb head backward: x holds the last head activation, y is free ----
  for (int i = t; i < 3 * RBM; i += THREADS) {
    const int gm = m0 + i % RBM;
    s.G3[i] = gm < M ? drgb[static_cast<size_t>(i / RBM) * M + gm] : 0.f;
  }
  for (int i = t; i < RBM; i += THREADS) s.R[i] = m0 + i < M ? dsig[m0 + i] : 0.f;
  sync_async();
  c.save(T_G3RGB, s.G3, 3);
  c.save(T_SIG, s.R, 1);
  const int last = p.n_rgb - 2;
  c.hidden(W_RGB1 + last, H, 3, s.G3, c.head_mask(last), y, T_DHS0 + last);
  for (int i = last - 1; i >= 0; --i) {
    c.hidden(W_RGB1 + i, H, H, y, c.head_mask(i), x, T_DHS0 + i);
    swap();
  }
  // y: d(first head layer, pre-ReLU); its inputs are [a6 | dir | time]
  const float* D = s.D;
  const int dr = p.dir_rows;
  c.dx(W_R1B, dr, H, y, [=](int k, int m, float acc) {
    const int gm = m0 + m;
    if (k < dr && gm < M) {
      ddir[static_cast<size_t>(k) * M + gm] = D[k * RBM + m] > 0.f ? acc : 0.f;
    }
  });
  // d(a6) from the head, plus the density head's dw * d_sigma, masked by a6
  const float* dw = c.W(W_DW);
  const float* R = s.R;
  c.hidden_f(W_R1A, W, H, y, c.trunk_mask(6),
             [=](int k, int m, float acc) { return __fadd_rn(acc, __fmul_rn(dw[k], R[m])); }, x,
             T_D0 + 6);

  // ---- trunk backward: x holds d(a6) ----
  c.hidden(W_S2W3, W, W, x, c.trunk_mask(5), y, T_D0 + 5);  // a6 = relu(s2w3^T a5 + sb3)
  c.hidden(W_S2W2, W, W, y, c.trunk_mask(4), x, T_D0 + 4);  // a5 = relu(s2w2^T a4 + sb2)
  // a4 = relu(s2a^T a3 + s2b^T p + sb1): the skip input's part of d(pos enc)
  float* DP = s.DP;
  c.dx(W_S2B, kp, W, x, [=](int k, int m, float acc) {
    if (k < kp) DP[k * RBM + m] = acc;
  });
  c.hidden(W_S2A, W, W, x, c.trunk_mask(3), y, T_D0 + 3);
  c.hidden(W_1 + 3, W, W, y, c.trunk_mask(2), x, T_D0 + 2);  // a3 = relu(w4^T a2 + b4)
  c.hidden(W_1 + 2, W, W, x, c.trunk_mask(1), y, T_D0 + 1);
  c.hidden(W_1 + 1, W, W, y, c.trunk_mask(0), x, T_D0);
  // d(pos enc) = w1 dy0 + s2b dy4, float32
  c.dx(W_1, kp, W, x, [=](int k, int m, float acc) {
    if (k < kp) DP[k * RBM + m] = __fadd_rn(acc, DP[k * RBM + m]);
  });
}

// ------------------------------------------------------------------ pass 2

constexpr int KT = 128;           // a wide tile: KT x KT entries of dW
constexpr int NK = 256, NO = 4;   // a narrow tile (o <= NO): NK x NO
// a row's floats in a stage: conflict-free fragments
template <int RBM>
__host__ __device__ constexpr int xs_floats() { return RBM + 4; }
// floats of one stage: x rows, then dy rows
template <int RBM>
__host__ __device__ constexpr int dw_stage() { return (NK + NO) * xs_floats<RBM>(); }
static_assert(dw_stage<16>() >= 2 * KT * xs_floats<16>(), "a wide stage fits");
// records in flight: three of 64 samples; at smaller records as many as fit
// in about the same shared memory
template <int RBM>
__host__ __device__ constexpr int dw_stages() { return RBM == 64 ? 3 : RBM == 32 ? 6 : 10; }
template <int RBM>
__host__ __device__ constexpr int dw_smem() {
  return dw_stages<RBM>() * dw_stage<RBM>() * static_cast<int>(sizeof(float));
}

// records: this slice's; record b's flag is block_flag(flags, block0 + b,
// flag_step) (K2: one a tile; K3: flag_step 0, the field's `active` flag);
// no flags: every record counts
struct DwArgs {
  Job job[MAX_JOBS];
  int tile0[MAX_JOBS + 1];  // first tile of each job; the last entry is the total
  int n_jobs, rec_floats, n_records, block0, ranges, flag_step;
};

__device__ __forceinline__ void cp16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This block's tile (rows k0.., columns n0..) of job jb over the records
// [b_lo, b_hi), into `out` (this range's partials). A stage holds one
// record's rows of x, then of dy, XS floats a row (dy's swizzle undone).
//   wide (o > NO): KT x KT on the tensor cores, 3xTF32, each mma's k the
//     samples: warp w takes rows (w / 4) * 64 + 0..63 (four 16-row tiles)
//     and columns (w % 4) * 32 + 0..31 (four 8-column tiles); each record's
//     product goes to a fresh accumulator, then into the float32 total (an
//     mma's float32 sum is not rounded to nearest: a long chain would
//     drift); threads < KT sum db's columns;
//   narrow: NK x NO on CUDA cores, a row a thread; thread 0 sums db.
// Rows and columns past the layer's (rows not loaded, stale stages) fall in
// entries that are never written.
template <int RBM, bool NARROW>
__device__ void dw_tile(const float* __restrict__ records, const int* __restrict__ flags,
                        float* __restrict__ out, const DwArgs& a, const Job& jb, int k0, int n0,
                        int b_lo, int b_hi) {
  extern __shared__ __align__(16) float dsm[];
  constexpr int XS = xs_floats<RBM>(), DW_STAGE = dw_stage<RBM>(), DW_STAGES = dw_stages<RBM>();
  constexpr int XT = NARROW ? NK : KT;  // rows of x a stage holds
  constexpr int YOFF = XT * XS;         // dy's rows in a stage
  const int t = threadIdx.x;
  const int xr = min(XT, jb.k_in - k0);  // rows to load
  const int yr = NARROW ? jb.o : min(KT, jb.o - n0);
  const auto next = [&](int b) {  // the first record from b on that pass 1 wrote
    while (b < b_hi && flags != nullptr && block_flag<RBM>(flags, a.block0 + b, a.flag_step) == 0) {
      ++b;
    }
    return b;
  };
  const auto issue = [&](int st, int b) {  // record b into stage st (none past b_hi)
    if (b < b_hi) {
      const float* rec = records + static_cast<size_t>(b) * a.rec_floats;
      float* xs = dsm + st * DW_STAGE;
      const float* xg = rec + jb.x + k0 * RBM;
      for (int i = t; i < xr * (RBM / 4); i += THREADS) {
        const int r = i / (RBM / 4), c = (i % (RBM / 4)) * 4;
        cp16(xs + r * XS + c, xg + r * RBM + c);
      }
      const float* yg = rec + jb.y + n0 * RBM;
      for (int i = t; i < yr * (RBM / 4); i += THREADS) {
        const int r = i / (RBM / 4), c = (i % (RBM / 4)) * 4;
        // the chunk of samples c..c+3 of swizzled row o holds c ^ swz_mask(o)..
        cp16(xs + YOFF + r * XS + (NARROW ? c : c ^ swz_mask<RBM>(n0 + r)), yg + r * RBM + c);
      }
    }
    cp_commit();
  };
  const bool bias = jb.b_off >= 0 && k0 == 0 && (NARROW ? t == 0 : t < KT);
  const int w = t >> 5, l = t & 31, g = l >> 2, q = l & 3;
  const int wk = w >> 2, wo = w & 3;
  // wide: tot[i][j] the mma tile (row tile i, column tile j); narrow:
  // tot[0][0][j] the thread's row, column j
  constexpr int TI = NARROW ? 1 : 4, TJ = NARROW ? 1 : 4;
  float tot[TI][TJ][4], bs[NARROW ? NO : 1];
#pragma unroll
  for (int i = 0; i < TI; ++i) {
#pragma unroll
    for (int j = 0; j < TJ; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) tot[i][j][c] = 0.f;
    }
  }
#pragma unroll
  for (int c = 0; c < (NARROW ? NO : 1); ++c) bs[c] = 0.f;
  int ld = next(b_lo);
  for (int st = 0; st < DW_STAGES - 1; ++st) {
    issue(st, ld);
    if (ld < b_hi) ld = next(ld + 1);
  }
  int st = 0;
  for (int b = next(b_lo); b < b_hi; b = next(b + 1)) {
    cp_wait<DW_STAGES - 2>();
    __syncthreads();  // record b has landed; every thread is done with the stage refilled next
    issue((st + DW_STAGES - 1) % DW_STAGES, ld);
    if (ld < b_hi) ld = next(ld + 1);
    const float* xs = dsm + st * DW_STAGE;
    const float* ys = xs + YOFF;
    if constexpr (NARROW) {
      const float* xrow = xs + t * XS;
#pragma unroll 4
      for (int m = 0; m < RBM; m += 4) {
        const float4 x4 = *reinterpret_cast<const float4*>(xrow + m);
        const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
        for (int j = 0; j < NO; ++j) {
          const float4 y4 = *reinterpret_cast<const float4*>(ys + j * XS + m);
          const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
#pragma unroll
          for (int c = 0; c < 4; ++c) tot[0][0][j] = fmaf(xv[c], yv[c], tot[0][0][j]);
          if (bias) {
#pragma unroll
            for (int c = 0; c < 4; ++c) bs[j] += yv[c];
          }
        }
      }
    } else {
      float acc[4][4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
        }
      }
      const float* x0 = xs + (wk * 64 + g) * XS + q;
      const float* y0 = ys + (wo * 32 + g) * XS + q;
#pragma unroll 2
      for (int m0 = 0; m0 < RBM; m0 += 8) {
        // A = x (rows k, the samples as the mma's k), B = dy^T
        uint32_t ah[4][4], al[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(x0[16 * i * XS + m0], ah[i][0], al[i][0]);
          split(x0[(16 * i + 8) * XS + m0], ah[i][1], al[i][1]);
          split(x0[16 * i * XS + m0 + 4], ah[i][2], al[i][2]);
          split(x0[(16 * i + 8) * XS + m0 + 4], ah[i][3], al[i][3]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t bh[2], bl[2];
          split(y0[8 * j * XS + m0], bh[0], bl[0]);
          split(y0[8 * j * XS + m0 + 4], bh[1], bl[1]);
#pragma unroll
          for (int i = 0; i < 4; ++i) mma3(acc[i][j], ah[i], al[i], bh, bl);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int c = 0; c < 4; ++c) tot[i][j][c] += acc[i][j][c];
        }
      }
      if (bias) {
        const float* yrow = ys + t * XS;
        for (int m = 0; m < RBM; m += 4) {
          const float4 y4 = *reinterpret_cast<const float4*>(yrow + m);
          bs[0] += y4.x;
          bs[0] += y4.y;
          bs[0] += y4.z;
          bs[0] += y4.w;
        }
      }
    }
    st = (st + 1) % DW_STAGES;
  }
  if constexpr (NARROW) {
    const int k = k0 + t;
    if (k < jb.k_in) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (j < jb.o) out[jb.w_off + static_cast<size_t>(k) * jb.o + j] = tot[0][0][j];
      }
    }
    if (bias) {
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        if (j < jb.o) out[jb.b_off + j] = bs[j];
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = k0 + wk * 64 + 16 * i + g + (c >> 1) * 8;
          const int col = n0 + wo * 32 + 8 * j + 2 * q + (c & 1);
          if (k < jb.k_in && col < jb.o) {
            out[jb.w_off + static_cast<size_t>(k) * jb.o + col] = tot[i][j][c];
          }
        }
      }
    }
    if (bias && n0 + t < jb.o) out[jb.b_off + n0 + t] = bs[0];
  }
}

// grid: (tiles of all jobs, ranges of records); THREADS threads; `partial`
// this slice's first range's partials (n_params floats a range)
template <int RBM>
__global__ void __launch_bounds__(THREADS, 1)
f32_dw_kernel(const float* __restrict__ records, const int* __restrict__ flags,
              float* __restrict__ partial, int n_params, const __grid_constant__ DwArgs a) {
  int j = 0;
  while (static_cast<int>(blockIdx.x) >= a.tile0[j + 1]) ++j;
  const Job& jb = a.job[j];
  const int local = blockIdx.x - a.tile0[j];
  const bool narrow = jb.o <= NO;
  const int k0 = (local % jb.mt) * (narrow ? NK : KT), n0 = (local / jb.mt) * KT;
  const int r = blockIdx.y;
  const int b_lo = static_cast<int>(static_cast<long long>(r) * a.n_records / a.ranges);
  const int b_hi = static_cast<int>(static_cast<long long>(r + 1) * a.n_records / a.ranges);
  float* out = partial + static_cast<size_t>(r) * n_params;
  if (narrow) {
    dw_tile<RBM, true>(records, flags, out, a, jb, k0, 0, b_lo, b_hi);
  } else {
    dw_tile<RBM, false>(records, flags, out, a, jb, k0, n0, b_lo, b_hi);
  }
}

// Passes 1-3 for M samples in blocks of RBM (the plan's). pass1(b0, nb,
// records) launches pass 1 for the blocks [b0, b0 + nb) into records [0,
// nb). `work` holds the plan's workspace: one slice's records, then every
// (slice, range)'s partials. gw and gb (n_w and n_b floats) are
// overwritten.
template <int RBM, class Pass1>
cudaError_t run_f32_bwd(const Plan& P, int M, const int* flags, int flag_step, float* work,
                        int n_w, int n_b, float* gw, float* gb, cudaStream_t s, Pass1 pass1) {
  const int n_blocks = (M + RBM - 1) / RBM;
  const int n_slices = (n_blocks + P.slice_blocks - 1) / P.slice_blocks;
  const int n = n_w + n_b;
  float* records = work;
  float* partial = work + static_cast<size_t>(P.slice_blocks) * P.rec_floats;
  DwArgs a;
  a.n_jobs = P.n_jobs;
  a.tile0[0] = 0;
  for (int j = 0; j < P.n_jobs; ++j) {
    const int* q = P.jobs + j * JOB_INTS;
    a.job[j] = Job{q[0], q[1], q[2], q[3], q[4], q[5], q[6], q[7]};
    a.tile0[j + 1] = a.tile0[j] + q[6] * q[7];
  }
  a.rec_floats = P.rec_floats;
  a.ranges = P.ranges;
  a.flag_step = flag_step;
  // partials of entries no job writes (padding, absent layers) stay zero
  cudaError_t e = cudaMemsetAsync(
      partial, 0, static_cast<size_t>(n_slices) * P.ranges * n * sizeof(float), s);
  if (e != cudaSuccess) return e;
  constexpr int DW_SMEM = dw_smem<RBM>();
  e = cudaFuncSetAttribute(f32_dw_kernel<RBM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           DW_SMEM);
  if (e != cudaSuccess) return e;
  for (int sl = 0; sl < n_slices; ++sl) {
    const int b0 = sl * P.slice_blocks;
    const int nb = n_blocks - b0 < P.slice_blocks ? n_blocks - b0 : P.slice_blocks;
    e = pass1(b0, nb, records);
    if (e != cudaSuccess) return e;
    a.n_records = nb;
    a.block0 = b0;
    f32_dw_kernel<RBM><<<dim3(a.tile0[P.n_jobs], P.ranges), THREADS, DW_SMEM, s>>>(
        records, flags, partial + static_cast<size_t>(sl) * P.ranges * n, n, a);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  field_dw_reduce<<<(n + 255) / 256, 256, 0, s>>>(partial, n_slices * P.ranges, n_w, n_b, gw, gb);
  return cudaGetLastError();
}

// f(std::integral_constant<int, RBM>) for the plan's block, from a launcher
// whose kernels are templates over it; the shapes a block takes
// (max_width, with p.rows_a the widest layer) are checked first
template <class F>
cudaError_t with_block(const Plan& P, const BwdParams& p, F f) {
  if (p.rows_a > max_width(P.rbm)) return cudaErrorInvalidValue;
  switch (P.rbm) {
    case 64: return f(std::integral_constant<int, 64>{});
    case 32: return f(std::integral_constant<int, 32>{});
    default: return f(std::integral_constant<int, 16>{});
  }
}

}  // namespace
