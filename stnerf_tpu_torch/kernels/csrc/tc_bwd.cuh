// The shared parts of the bf16 field backward kernels on Hopper's tensor
// cores (sm_90a): K2 (field_bwd_tc.cu, the fused field with its motion net
// and encodings) and K3 (spacenet_tc.cu, the SpaceNet on encoded inputs).
// Both run the same three steps (tc_blocks.cuh has the products):
//   1. pass 1, a block per BM samples: recompute the forward and compute
//      dx = W dy on wgmma (spacenet_bwd_block for the SpaceNet part),
//      writing each layer's bf16 input x and output cotangent dy into the
//      block's record in global memory (Ctx::save). Every recomputed layer
//      is near-tie checked as the training forwards' are (Ctx::dense:
//      tc_blocks.cuh's dense_checked with its one rule, WideRule), so its
//      bf16 activations and ReLU masks are the plain version's k-order
//      rounding, the bits the checked forward computed;
//   2. field_dw_kernel: dW = x dy^T and db = sum dy for every layer from the
//      records, one float32 partial per range of records;
//   3. field_dw_reduce (field_common.cuh): each entry the sum of its ranges'
//      partials in range order, so the weight gradients are the same on
//      every run.
// The caller's pass 1 loads the encodings into act tiles and handles what
// lies outside the SpaceNet (K2: the motion net and the encoding's VJP);
// finish_layout and launch_dw set up and launch passes 2 and 3.
//
// The sample block BM is chosen per launch (choose_block): the largest of
// 64, 32 and 16 samples whose pass-1 tiles fit the card's shared memory,
// 64 at every width up to 256 (those launches are the 64-sample code
// throughout), 32 at 512 and 16 at 1024. A record is one block's: BM
// samples. A block of 64 covers one skip-flag tile (fused_field.py TILE),
// a smaller one part of one, so block b's flag is flags[b / (64 / BM)],
// in pass 1 as in pass 2.
#pragma once

#include <cstdint>

#include "field_common.cuh"
#include "tc_blocks.cuh"

namespace {

constexpr int FLAG_TILE = 64;  // samples per skip flag (fused_field.py TILE)
// entries of a warp's list in the recompute's check (dense_checked's LN): a
// chunk of 8 mask words, 4 KB in all, so that the 4-layer rgb head keeps
// 64-sample blocks at 256/128/128
constexpr int BWD_LIST = 256;

// the skip flag of block b of BM samples
template <int BM>
__device__ __forceinline__ int block_flag(const int* flags, int b, int step) {
  return flags[b / (FLAG_TILE / BM) * step];
}

// The record's tiles are tc_blocks.cuh's Rec; record_layout lays them out.
struct Params {
  int w_off[N_W];
  int b_off[N_B];
  int f_off[N_W];  // forward fragments (PackedField.tc), 16-byte units; -1 = absent
  int g_off[N_W];  // backward (dx) fragments
  int rec[N_REC];  // row offset of each record tile; -1 = absent
  int n_off[N_W];  // each checked slot's first row norm (row_norms_kernel); -1 = none
  int M, dir_rows, width, head, motion_width, freqs, inc, use_time, n_rgb, motion_mode;
  int pos_rows, time_rows, menc_rows, pos_pad, dir_pad, time_pad, menc_pad, u_rows, rec_rows;
};

// the widest checked layer's outputs: the mask's rows
__host__ __device__ inline int check_rows(const Params& p) {
  const int r = p.width > p.head ? p.width : p.head;
  return p.motion_mode && p.motion_width > r ? p.motion_width : r;
}
// pass 1's shared memory for the check at a block of bm samples: the mask
// (check_rows x bm bits), the lists, then float32 |w_r| (check_rows) and
// |x_c| (bm) of the layer being checked (WideRule)
inline size_t check_bytes(const Params& p, int bm) {
  return static_cast<size_t>(check_rows(p)) * bm / 8 + (TC_THREADS / 32) * BWD_LIST * 2 +
         static_cast<size_t>(check_rows(p) + bm) * sizeof(float);
}

template <int BM>
struct Ctx {
  const Params& p;
  const unsigned short* wts;
  const uint4* frags;
  const float* bias;
  unsigned short* rec;   // this block's record
  unsigned* mask;        // the check's mask (check_rows x BM bits, zero between layers)
  unsigned short* lists; // and its lists (BWD_LIST entries a warp)
  float* wn;             // |w_r| of the layer being checked (check_rows)
  float* xn;             // |x_c| of its inputs (BM)
  const float* norms;    // row_norms_kernel's squared row norms
  __device__ const unsigned short* W(int s) const { return wts + p.w_off[s]; }
  __device__ const uint4* F(int s) const { return frags + p.f_off[s]; }
  __device__ const uint4* G(int s) const { return frags + p.g_off[s]; }
  __device__ const float* Bi(int s) const { return bias + p.b_off[s]; }

  // zero the mask before the first layer (a barrier follows before any reads it)
  __device__ void clear_mask() const {
    for (int i = threadIdx.x; i < check_rows(p) * BM / 32; i += TC_THREADS) mask[i] = 0;
  }
  // out = relu(sum_s W_s^T x_s + bias) rounded to bf16 for the weight
  // slots `slots` of the segments, near-tie checked (dense_checked with the
  // segments' WideRule: first |w_r| and |x_c| over all the segments' inputs
  // into wn and xn), then the barrier before the next product
  __device__ void dense(const Seg* segs, const int* slots, int nseg, int bslot, int O,
                        unsigned short* out) const {
    int ks = 0;
    for (int i = 0; i < nseg; ++i) ks += segs[i].ks;
    for (int r = threadIdx.x; r < O; r += TC_THREADS) {
      float s = 0.f;
      for (int i = 0; i < nseg; ++i) s += norms[p.n_off[slots[i]] + r];
      wn[r] = sqrtf(s);
    }
    // TPC threads a sample, each a share of the inputs, summed by shuffles
    constexpr int TPC = TC_THREADS / BM;
    const int c = threadIdx.x / TPC, part = threadIdx.x % TPC;
    float s = 0.f;
    for (int i = 0; i < nseg; ++i) {
      for (int k = part; k < 16 * segs[i].ks; k += TPC) {
        const float v = bf_f(segs[i].b[act_idx<BM>(k, c)]);
        s = fmaf(v, v, s);
      }
    }
#pragma unroll
    for (int d = TPC / 2; d > 0; d >>= 1) s += __shfl_down_sync(0xffffffffu, s, d, TPC);
    if (part == 0) xn[c] = sqrtf(s);
    __syncthreads();
    dense_checked<BM, true, BWD_LIST>(segs, nseg, O, Bi(bslot), out, mask, lists,
                                      WideRule::make(ks, wn, xn));
    layer_sync();
  }
  __device__ void dense(int slot, const unsigned short* in, int k_rows, int bslot, int O,
                        unsigned short* out) const {
    const Seg s{F(slot), in, k_rows / 16};
    dense(&s, &slot, 1, bslot, O, out);
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

// A block's Ctx: its record, and the check's scratch from `mask` on (after
// pass 1's float32 rows: the mask, the lists, wn, xn; check_bytes)
template <int BM>
__device__ Ctx<BM> make_ctx(const Params& p, const unsigned short* wts, const uint4* frags,
                            const float* bias, const float* norms, unsigned short* records,
                            unsigned* mask) {
  auto* lists = reinterpret_cast<unsigned short*>(mask + check_rows(p) * BM / 32);
  float* wn = reinterpret_cast<float*>(lists + (TC_THREADS / 32) * BWD_LIST);
  return {p, wts, frags, bias, records + static_cast<size_t>(blockIdx.x) * p.rec_rows * BM,
          mask, lists, wn, wn + check_rows(p), norms};
}

// The SpaceNet's pass 1 on one block of BM samples from sample m0 on
// (spacenet_vjp._bwd_math): the encodings stand in P (position, pos_pad
// rows), D (relu(direction), dir_pad rows) and T (relu(time), time_pad
// rows), bf16, zero-padded, behind a layer_sync (and c's mask cleared
// before it). U holds u_rows bf16 rows
// for the trunk and head tiles; R (4 x BM), G3 (4 x BM) and DP (pos_rows x
// BM) are float32 scratch. Recomputes the trunk and the rgb head, reads the
// cotangents drgb (3, M) and dsig (M,) (rounded to bf16), writes d_dir_enc
// (dir_rows, M) float32, masked where D is 0, leaves d(position encoding) =
// w1 dy + s2b dy4 in DP (float32, behind a layer_sync) and saves every
// layer's x and dy to the record. The record copies may still be reading
// the tiles: Ctx::saved() before they are overwritten, Ctx::done() before
// the block exits.
template <int BM>
__device__ __forceinline__ void spacenet_bwd_block(const Ctx<BM>& c, int m0, unsigned short* U,
                                                   unsigned short* P, unsigned short* D,
                                                   unsigned short* T, float* R, float* G3,
                                                   float* DP, const float* __restrict__ drgb,
                                                   const float* __restrict__ dsig,
                                                   float* __restrict__ ddir) {
  const Params& p = c.p;
  const int t = threadIdx.x;
  const int M = p.M;
  const int W = p.width, H = p.head;
  unsigned short* S0 = U;  // four trunk slots of W rows
  unsigned short* S1 = U + W * BM;
  unsigned short* S2 = U + 2 * W * BM;
  unsigned short* S3 = U + 3 * W * BM;
  unsigned short* HS[3] = {U + 4 * W * BM, U + (4 * W + H) * BM, U + (4 * W + 2 * H) * BM};

  // ---- forward: trunk, rgb head ----
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
    const int slots[2] = {W_S2A, W_S2B};
    c.dense(s, slots, 2, B_SB1, W, S2);
  }
  c.dense(W_S2W2, S2, W, B_SB2, W, S3);
  c.dense(W_S2W3, S3, W, B_SB3, W, S0);
  {
    // rgb head: relu([a6 | dir | time]); a6 >= 0, D and T hold relu'd values
    const Seg s[3] = {{c.F(W_R1A), S0, W / 16}, {c.F(W_R1B), D, p.dir_pad / 16},
                      {c.F(W_R1C), T, p.time_pad / 16}};
    const int slots[3] = {W_R1A, W_R1B, W_R1C};
    c.dense(s, slots, p.use_time ? 3 : 2, B_RB1, H, HS[0]);
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
  c.dx(W_S2A, S2, W, W, Ctx<BM>::mask_round(S1));
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
// records of BM samples in flight: four of 64, as many bytes at smaller blocks
template <int BM>
__host__ __device__ constexpr int dw_stages() { return 4 * FLAG_TILE / BM; }
// elements of one stage: x, then dy
template <int BM>
__host__ __device__ constexpr int dw_stage() { return (DW_XR + 128) * BM; }

// flags: a record whose flag reads 0 was not written by pass 1 and is
// skipped; record b's flag is its tile's, block_flag(flags, b, flag_step)
// (K2: one per tile; K3: flag_step 0, the field's one `active` flag); no
// flags: every record counts
struct DwParams {
  Job job[MAX_JOBS];
  int tile0[MAX_JOBS + 1];  // first tile of each job; the last entry is the total
  int n_jobs, rec_rows, n_blocks, ranges, n_params, flag_step;
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
template <int BM, int NT>
__device__ void dw_tile(const unsigned short* __restrict__ records, const int* __restrict__ flags,
                        float* __restrict__ partial, const DwParams& p, const Job& jb, int k0,
                        int n0, int b_lo, int b_hi) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int DW_STAGES = dw_stages<BM>(), DW_STAGE = dw_stage<BM>();
  __shared__ uint64_t full[DW_STAGES];
  __shared__ int n_active;
  unsigned short* stages = reinterpret_cast<unsigned short*>(smem);
  const int t = threadIdx.x, wg = t >> 7;
  const int xr = jb.k_in - k0 > 64 ? DW_XR : 64;  // rows of x to load
  const int bytes = (xr + NT) * BM * 2;
  const size_t rec_elems = static_cast<size_t>(p.rec_rows) * BM;
  int next = b_lo;  // the next record to load (thread 0)
  const auto issue = [&](int s) {
    while (flags != nullptr && block_flag<BM>(flags, next, p.flag_step) == 0) ++next;
    const unsigned short* base = records + static_cast<size_t>(next++) * rec_elems;
    unsigned short* st = stages + s * DW_STAGE;
    mbar_expect_tx(&full[s], bytes);
    bulk_load(st, base + static_cast<size_t>(jb.x + k0) * BM, xr * BM * 2, &full[s]);
    bulk_load(st + DW_XR * BM, base + static_cast<size_t>(jb.y + n0) * BM, NT * BM * 2, &full[s]);
  };
  if (t == 0) {
    int n = 0;
    for (int b = b_lo; b < b_hi; ++b) {
      n += flags == nullptr || block_flag<BM>(flags, b, p.flag_step) != 0;
    }
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
template <int BM>
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
    case 16: dw_tile<BM, 16>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    case 32: dw_tile<BM, 32>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    case 64: dw_tile<BM, 64>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
    default: dw_tile<BM, 128>(records, flags, partial, p, jb, k0, n0, b_lo, b_hi); break;
  }
}

// ------------------------------------------------------------------ layout

int imax(int a, int b) { return a > b ? a : b; }
int round16(int v) { return (v + 15) / 16 * 16; }

// Everything the launches need, from the field's shape: the kernels'
// parameters, the sample block, pass 1's shared memory and the workspace
// (the records, the partials, then the weight-row norms of the check).
struct Layout {
  Params p;
  DwParams dw;
  int bm;
  NormJobs norm;
  size_t smem, rec_bytes, part_bytes, norm_bytes;
};

// L.bm and L.smem: the largest pass-1 block of 64, 32 or 16 samples whose
// dynamic shared memory, smem(bm), fits beside the static shared memory of
// the kernels kernel(bm) on this card; false if none fits
template <class Smem, class Kernel>
bool choose_block(Layout& L, Smem smem, Kernel kernel) {
  int dev = 0, optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) !=
          cudaSuccess) {
    return false;
  }
  for (const int bm : {64, 32, 16}) {
    cudaFuncAttributes attr;
    const size_t bytes = smem(bm);
    if (cudaFuncGetAttributes(&attr, kernel(bm)) == cudaSuccess &&
        bytes + attr.sharedSizeBytes <= static_cast<size_t>(optin)) {
      L.bm = bm;
      L.smem = bytes;
      return true;
    }
  }
  return false;
}

// The packed offsets (the C entry points' `offsets`, PackedField.tc: N_W
// weight, N_B bias, N_W forward-fragment, N_W backward-fragment and N_W
// row-norm offsets, the last into PackedField.tc_norms, which K3's forward
// reads; the backward lays out its own, finish_layout) into p; all -1 when
// `off` is null (only the sizes are wanted).
void set_offsets(Params& p, const int* off) {
  for (int i = 0; i < N_W; ++i) {
    p.w_off[i] = off ? off[i] : -1;
    p.f_off[i] = off ? off[N_W + N_B + i] : -1;
    p.g_off[i] = off ? off[2 * N_W + N_B + i] : -1;
    p.n_off[i] = off ? off[3 * N_W + N_B + i] : -1;
  }
  for (int i = 0; i < N_B; ++i) p.b_off[i] = off ? off[N_W + i] : -1;
}

// The record's tiles and the jobs of pass 2, from L.p's shapes (the
// SpaceNet's, and the motion net's when p.motion_mode is set), for M
// samples in blocks of L.bm and the packed weights' and biases' element
// counts n_w and n_b.
void finish_layout(Layout& L, int n_w, int n_b, int flag_step, int sms) {
  Params& p = L.p;
  record_layout(p);

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
  const int W = p.width, H = p.head, last = p.n_rgb - 2;
  add(W_RGB1 + last, B_RGB1 + last, R_HS0 + last, H, R_G3RGB, 3);
  for (int i = last - 1; i >= 0; --i) add(W_RGB1 + i, B_RGB1 + i, R_HS0 + i, H, R_DHS0 + i + 1, H);
  add(W_R1A, B_RB1, R_A0 + 6, W, R_DHS0, H);
  add(W_R1B, -1, R_DIR, p.dir_rows, R_DHS0, H);
  if (p.use_time) add(W_R1C, -1, R_TIME, p.time_rows, R_DHS0, H);
  add(W_DW, B_DB, R_A0 + 6, W, R_SIG, 1);
  add(W_S2W3, B_SB3, R_A0 + 5, W, R_D0 + 6, W);
  add(W_S2W2, B_SB2, R_A0 + 4, W, R_D0 + 5, W);
  add(W_S2A, B_SB1, R_A0 + 3, W, R_D0 + 4, W);
  add(W_S2B, -1, R_POS, p.pos_rows, R_D0 + 4, W);
  for (int k = 3; k >= 1; --k) add(W_1 + k, B_1 + k, R_A0 + k - 1, W, R_D0 + k, W);
  add(W_1, B_1, R_POS, p.pos_rows, R_D0, W);
  if (p.motion_mode) {
    const int mw = p.motion_width;
    add(W_M0 + 5, B_M0 + 5, R_U0 + 5, mw, R_G3M, 3);
    for (int k = 4; k >= 1; --k) add(W_M0 + k, B_M0 + k, R_U0 + k, mw, R_DU1 + k, mw);
    add(W_M0, B_M0, R_U0, p.menc_rows, R_DU1, mw);
  }
  const int tiles = d.tile0[d.n_jobs];
  d.rec_rows = p.rec_rows;
  d.n_blocks = (p.M + L.bm - 1) / L.bm;
  d.n_params = n_w + n_b;
  d.flag_step = flag_step;
  // ranges of records: about four blocks per SM in all
  d.ranges = (4 * sms + tiles - 1) / tiles;
  if (d.ranges > d.n_blocks) d.ranges = d.n_blocks;
  // the records, plus the rows a DW_XR-row load may read past the last one
  L.rec_bytes = (static_cast<size_t>(d.n_blocks) * p.rec_rows + DW_XR) * L.bm * 2;
  L.part_bytes = static_cast<size_t>(d.ranges) * d.n_params * sizeof(float);

  // the checked layers' weight slots (k inputs, o outputs) for row_norms_kernel
  NormJobs& nj = L.norm;
  nj.n = 0;
  nj.at[0] = 0;
  for (int i = 0; i < N_W; ++i) p.n_off[i] = -1;
  const auto job = [&](int slot, int k, int o) {
    p.n_off[slot] = nj.at[nj.n];
    nj.w_off[nj.n] = p.w_off[slot];
    nj.k[nj.n] = k;
    nj.o[nj.n] = o;
    nj.at[nj.n + 1] = nj.at[nj.n] + o;
    ++nj.n;
  };
  if (p.motion_mode) {
    job(W_M0, p.menc_rows, p.motion_width);
    for (int k = 1; k < 5; ++k) job(W_M0 + k, p.motion_width, p.motion_width);
  }
  job(W_1, p.pos_rows, W);
  for (int k = 1; k < 4; ++k) job(W_1 + k, W, W);
  job(W_S2A, W, W);
  job(W_S2B, p.pos_rows, W);
  job(W_S2W2, W, W);
  job(W_S2W3, W, W);
  job(W_R1A, W, H);
  job(W_R1B, p.dir_rows, H);
  if (p.use_time) job(W_R1C, p.time_rows, H);
  for (int i = 0; i < p.n_rgb - 2; ++i) job(W_RGB1 + i, H, H);
  L.norm_bytes = static_cast<size_t>(nj.at[nj.n]) * sizeof(float);
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    return 132;
  }
  return sms;
}

// The weight-row norms into `norms` (L.norm_bytes of the workspace, after
// the partials), on the stream before pass 1
cudaError_t launch_norms(const Layout& L, const unsigned short* wts, float* norms,
                         cudaStream_t s) {
  const int n = L.norm.at[L.norm.n];
  row_norms_kernel<<<(n + 255) / 256, 256, 0, s>>>(wts, L.norm, norms);
  return cudaGetLastError();
}

// Passes 2 and 3 on the stream after pass 1: dW and db from the records
// into gw and gb (n_w and n_b float32 entries, overwritten); `partial` is
// the workspace after the records.
cudaError_t launch_dw(const Layout& L, const unsigned short* records, const int* flags,
                      float* partial, int n_w, int n_b, float* gw, float* gb, cudaStream_t s) {
  // partials of weights no job writes (padding, absent layers) stay zero
  cudaError_t e = cudaMemsetAsync(partial, 0, L.part_bytes, s);
  if (e != cudaSuccess) return e;
  const auto kernel = L.bm == 64 ? field_dw_kernel<64>
                      : L.bm == 32 ? field_dw_kernel<32> : field_dw_kernel<16>;
  const int dw_smem = dw_stages<64>() * dw_stage<64>() * 2;  // the same at every block
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(L.dw.tile0[L.dw.n_jobs], L.dw.ranges), TC_THREADS, dw_smem, s>>>(
      records, flags, partial, L.dw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int n = n_w + n_b;
  field_dw_reduce<<<(n + 255) / 256, 256, 0, s>>>(partial, L.dw.ranges, n_w, n_b, gw, gb);
  return cudaGetLastError();
}

}  // namespace
