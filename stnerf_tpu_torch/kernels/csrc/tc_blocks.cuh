// Tensor-core building blocks of the bf16 field kernels (fused_field_tc.cu,
// field_bwd_tc.cu, spacenet_tc.cu) on Hopper (sm_90a): dense layers over a
// tile of BM samples as warpgroup matrix products (wgmma), bf16 operands and
// float32 accumulation, exactly the TPU kernels' products; dense_checked
// recomputes in float32 the outputs that lie near a bf16 rounding tie or the
// ReLU's 0, by one rule (WideRule) for the training forwards and the
// backward's recompute alike.
//
// Operand roles. For y = W^T x a layer's outputs are the MMA's M, the
// samples its N and the inputs its K; for dx = W dy the inputs are M and the
// outputs K; for dW = x dy^T the inputs are M, the outputs N and the samples
// K.
//   * A from registers (forward and dx): the weights, packed on the host
//     (fused_field.py PackedField.tc) in the per-thread fragment order of a
//     64 x 16 tile, so that each thread loads its 8 values of a (m-tile,
//     k-step) with one 16-byte load from L2 and no shared memory is spent
//     on weights. Rows and columns past the layer's shape are zero.
//   * B, and A of dW, from shared memory: activations and cotangents, bf16,
//     in one layout (act_idx) of 8 x 8 core matrices (8 feature rows of 8
//     consecutive samples, 128 contiguous bytes), no swizzle. A feature row
//     is contiguous in samples, so y = W^T x and dx read B "MN-major"
//     (transposed), while dW reads both x and dy "K-major" over the samples.
//
// The accumulator fragment of wgmma m64nN: warp w of the warpgroup holds
// rows 16w + lane/4 (+8), columns 8j + 2(lane%4) (+1), registers
// d[4j + {0,1}] (row) and d[4j + {2,3}] (row + 8).
#pragma once

#include <cstdint>

#include "field_common.cuh"

namespace {

constexpr int TC_WG = 2;                  // warpgroups per block
constexpr int TC_THREADS = 128 * TC_WG;

// element index of (feature row k, sample n) in a tile of BM samples
template <int BM>
__device__ __forceinline__ int act_idx(int k, int n) {
  return ((k >> 3) * (BM >> 3) + (n >> 3)) * 64 + (k & 7) * 8 + (n & 7);
}

__device__ __forceinline__ float bf_f(unsigned short v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);
}
__device__ __forceinline__ unsigned short f_bf(float v) {  // v already rounded
  return static_cast<unsigned short>(__float_as_uint(v) >> 16);
}

// The shared-memory matrix descriptor without swizzle: start address, the
// byte offset between core matrices adjacent in K ("leading") and in M or N
// ("stride"), each in 16-byte units.
__device__ __forceinline__ uint64_t desc_raw(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ uint64_t make_desc(const void* smem, uint32_t k_stride,
                                              uint32_t mn_stride) {
  return desc_raw(smem, k_stride, mn_stride);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// generic-proxy shared-memory writes before the async proxy (wgmma) reads them
__device__ __forceinline__ void fence_smem_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across wgmma
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 16, f32) += A (64 x 16, bf16 fragment in 4 registers) * B (16 x 16, smem)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint4& a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 16, f32) += A (64 x 16, smem) * B (16 x 16, smem)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[8], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D (64 x 32, f32) += A (64 x 16, bf16 fragment in 4 registers) * B (16 x 32, smem)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint4& a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 32, f32) += A (64 x 16, smem) * B (16 x 32, smem)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, bf16 fragment in 4 registers) * B (16 x 64, smem)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint4& a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 64, f32) += A (64 x 16, smem) * B (16 x 64, smem)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, bf16 fragment in 4 registers) * B (16 x 128, smem)
template <int TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint4& a, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "l"(db), "r"(acc), "n"(TB));
}

// D (64 x 128, f32) += A (64 x 16, smem) * B (16 x 128, smem)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
}

// ------------------------------------------------------------ block products

// Keep a register live up to here: a wgmma reads its A registers
// asynchronously, so they must not be reused before the wait.
__device__ __forceinline__ void keep(const uint4& a) {
  asm volatile("" ::"r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w));
}

// One K segment of a product with A from registers: `frag` the packed
// fragments (PackedField.tc: m-tile major, then k-step, then thread, 16 bytes a
// thread), `b` the B tile in shared memory (act layout, its first feature
// row is the segment's first k), `ks` the k-steps of 16; `rn`, for a
// checked product (dense_checked), the squared L2 norm of each output row
// of the segment's weights (PackedField.tc_norms).
struct Seg {
  const uint4* frag;
  const unsigned short* b;
  int ks;
  const float* rn = nullptr;
};

constexpr int KC = 4;  // k-steps whose fragments are loaded together

// d = sum over segments of A[mt] B[:, n0:n0 + N] for this warpgroup. The
// k-steps go in chunks of KC whose fragments are loaded while the previous
// chunk's products run, then one at a time; no wgmma sits under a branch
// (ptxas serialises those).
template <int BM, int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const Seg* segs, int nseg, int mt,
                                       int n0) {
  const int t = threadIdx.x & 127;
#pragma unroll
  for (int i = 0; i < N / 2; ++i) d[i] = 0.f;
  fence_acc(d);
  for (int s = 0; s < nseg; ++s) {
    const int ks = segs[s].ks, full = ks / KC * KC;
    const uint4* f = segs[s].frag + static_cast<size_t>(mt) * ks * 128 + t;
    const unsigned short* b = segs[s].b + (n0 >> 3) * 64;
    const auto desc = [&](int k) { return make_desc(b + k * 16 * BM, 16 * BM, 128); };
    uint4 a[KC];
    if (full) {
#pragma unroll
      for (int i = 0; i < KC; ++i) a[i] = __ldg(f + i * 128);
    }
    for (int k0 = 0; k0 < full; k0 += KC) {
      wg_fence();
#pragma unroll
      for (int i = 0; i < KC; ++i) wgmma_rs<1>(d, a[i], desc(k0 + i), 1);
      wg_commit();
      uint4 nx[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        nx[i] = k0 + KC + i < full ? __ldg(f + (k0 + KC + i) * 128) : make_uint4(0, 0, 0, 0);
      }
      wg_wait0();
      fence_acc(d);
#pragma unroll
      for (int i = 0; i < KC; ++i) {
        keep(a[i]);
        a[i] = nx[i];
      }
    }
    for (int k = full; k < ks; ++k) {
      const uint4 a1 = __ldg(f + k * 128);
      wg_fence();
      wgmma_rs<1>(d, a1, desc(k), 1);
      wg_commit();
      wg_wait0();
      fence_acc(d);
      keep(a1);
    }
  }
}

// epi(row, col, v0, v1) for the accumulator pairs of rows < rows
template <int N, class Epi>
__device__ __forceinline__ void acc_epilogue(const float (&d)[N / 2], int r0, int n0, int rows,
                                             Epi& epi) {
  const int w = (threadIdx.x & 127) >> 5, l = threadIdx.x & 31;
  const int ra = r0 + 16 * w + (l >> 2);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = n0 + 8 * j + 2 * (l & 3);
    if (ra < rows) epi(ra, c, d[4 * j], d[4 * j + 1]);
    if (ra + 8 < rows) epi(ra + 8, c, d[4 * j + 2], d[4 * j + 3]);
  }
}

// rows x [n_lo, n_lo + n_cnt) of sum_s A_s B_s, A from registers, handed to
// epi. Each warpgroup takes every other 64-row m-tile at the full width, or,
// with one m-tile, half of the columns; 16 columns (the backward's 16-sample
// block) have no half: both warpgroups compute them and the first hands
// them on, so that no wgmma sits under a branch.
template <int BM, int NF, class Epi>
__device__ void tc_product_n(const Seg* segs, int nseg, int rows, int n_lo, Epi& epi) {
  const int wg = threadIdx.x >> 7;
  const int mt_n = (rows + 63) >> 6;
  if (mt_n >= TC_WG) {
    for (int mt = wg; mt < mt_n; mt += TC_WG) {
      float d[NF / 2];
      mma_rs<BM, NF>(d, segs, nseg, mt, n_lo);
      acc_epilogue<NF>(d, mt * 64, n_lo, rows, epi);
    }
  } else if constexpr (NF == 16) {
    float d[NF / 2];
    mma_rs<BM, NF>(d, segs, nseg, 0, n_lo);
    if (wg == 0) acc_epilogue<NF>(d, 0, n_lo, rows, epi);
  } else {
    constexpr int NH = NF / 2;
    float d[NH / 2];
    mma_rs<BM, NH>(d, segs, nseg, 0, n_lo + wg * NH);
    acc_epilogue<NH>(d, 0, n_lo + wg * NH, rows, epi);
  }
}

// n_cnt is BM or, in a block of two skip-flag tiles (BM >= 64), half of it
template <int BM, class Epi>
__device__ void tc_product(const Seg* segs, int nseg, int rows, int n_lo, int n_cnt, Epi epi) {
  if constexpr (BM >= 64) {
    if (n_cnt != BM) {
      tc_product_n<BM, BM / 2>(segs, nseg, rows, n_lo, epi);
      return;
    }
  }
  tc_product_n<BM, BM>(segs, nseg, rows, n_lo, epi);
}

// out = round_bf16(relu(sum_s W_s^T x_s + bias)), rows < O, into an act tile
template <int BM>
__device__ void tc_dense(const Seg* segs, int nseg, int O, const float* __restrict__ bias,
                         unsigned short* out, int n_lo, int n_cnt) {
  tc_product<BM>(segs, nseg, O, n_lo, n_cnt, [=](int r, int c, float v0, float v1) {
    const float b = bias[r];
    const float y0 = rnd<true>(fmaxf(v0 + b, 0.f)), y1 = rnd<true>(fmaxf(v1 + b, 0.f));
    *reinterpret_cast<unsigned*>(out + act_idx<BM>(r, c)) =
        static_cast<unsigned>(f_bf(y0)) | (static_cast<unsigned>(f_bf(y1)) << 16);
  });
}

// ------------------------------ products checked against the plain rounding

// The training forwards' activations are rounded to bf16 as the plain
// version rounds them, and the backward's recompute rounds to the same bits,
// so that the backward differentiates the activations the forward computed.
// A wgmma k-step aligns its products and accumulator to the largest
// exponent, keeps 25 bits and truncates toward zero, so a chained sum of K
// inputs lies off the plain version's float32 sum (FMAs in k order) by a few
// units of 2^-24 of its partial sums a k-step, always toward zero. Rounded
// to bf16 and through the ReLU, the two differ only where they straddle a
// bf16 rounding tie or 0, and a training step's fine sampling turns such
// flips into a different step (the pose gradients, PERF.md). So every
// output that WideRule flags is recomputed as the plain version sums it:
// float32 FMAs in k order on CUDA cores, each K segment on its own, the
// segments then the bias added in order. One rule serves K1's checked
// forward, K3's forward (and K6's) and pass 1 of K2's and K3's backward, on
// the same weight-row norms (the forwards' PackedField.tc_norms, the
// backward's own pre-pass: one kernel, the same bits) and input norms
// (input_norms, the backward's sum), so both directions flag the same
// outputs.
constexpr unsigned NEAR = 128;  // the smallest ulp window
constexpr int LIST = 1024;  // entries of a warp's list: one chunk of 32 mask words

// The error is absolute, so a window of ulps of y alone misses the outputs
// whose sum cancels (a small y has small ulps, and straddles a tie, or the
// ReLU's 0, from farther than NEAR of them), and more so where the inputs
// are large (a position encoding's raw coordinates reach 10^3 on a parked
// sample). The partial sums' scale is estimated per output as S = |w_r|
// |x_c| / sqrt(K) (the L2 norms of the weight row and of the sample's
// inputs over the layer's K inputs, all segments), and y is flagged within
// ABS_KS x 2^-24 x S a k-step of a tie or of 0; the ulp window grows with
// the k-steps, NEAR_KS ulps a k-step (at least NEAR). An exact 0 sum with a
// 0 bias (a unit that pack_field pads, all of whose weights are 0) is no
// flip: the k order sums the same zeros. tests/test_torch_near_tie.py holds
// the rule against a model of the truncation at the K of every checked
// layer, at two input scales.
constexpr unsigned NEAR_KS = 8;
constexpr unsigned ABS_KS = 8;
struct WideRule {
  unsigned near;
  float scale;       // ABS_KS x ks x 2^-24 / sqrt(K)
  const float* wn;   // |w_r| for each output row (shared memory)
  const float* xn;   // |x_c| for each sample of the block (shared memory)
  __device__ static WideRule make(int ks, const float* wn, const float* xn) {
    return {NEAR_KS * ks > NEAR ? NEAR_KS * ks : NEAR,
            static_cast<float>(ABS_KS * ks) / 16777216.f * rsqrtf(16.f * ks), wn, xn};
  }
  // whether output (r, c), y = v + b (v the tensor-core sum, b the bias),
  // is recomputed
  __device__ __forceinline__ bool operator()(int r, int c, float y, float v, float b) const {
    if (v == 0.f && b == 0.f) return false;
    const float win = scale * wn[r] * xn[c];
    if (fabsf(y) < win) return true;
    if (!(y > 0.f)) return false;
    const unsigned u = __float_as_uint(y), low = u & 0xffffu;
    const unsigned d = low > 0x8000u ? low - 0x8000u : 0x8000u - low;  // ulps to the tie
    // d ulps of y's binade: d x 2^(e - 23)
    return d < near ||
           static_cast<float>(d) * __uint_as_float(u & 0x7f800000u) / 8388608.f < win;
  }
};

// The check's shared-memory scratch: the mask (rows x TB bits, zero between
// layers), the lists (LN entries a warp), then WideRule's |w_r| (rows) and
// |x_c| (TB), each a float
struct Check {
  unsigned* mask;
  unsigned short* lists;
  float* wn;
  float* xn;
};
// its bytes for layers of at most `rows` outputs, TB samples, LN entries a warp
__host__ __device__ constexpr size_t check_bytes(int rows, int tb, int ln) {
  return static_cast<size_t>(rows) * tb / 8 + static_cast<size_t>(TC_THREADS / 32) * ln * 2 +
         static_cast<size_t>(rows + tb) * sizeof(float);
}
// the scratch laid out from `at` (check_bytes of it)
__device__ inline Check make_check(void* at, int rows, int tb, int ln) {
  auto* mask = static_cast<unsigned*>(at);
  auto* lists = reinterpret_cast<unsigned short*>(mask + rows * tb / 32);
  auto* wn = reinterpret_cast<float*>(lists + (TC_THREADS / 32) * ln);
  return {mask, lists, wn, wn + rows};
}

// The pre-pass of every checked product: the squared L2 norm of each
// output row of the checked layers' weight slots over the slot's inputs, a
// float each, in job order (WideRule's |w_r|): once a packed field for the
// forwards (PackedField.tc_norms, stnerf_tc_row_norms), once a launch for
// the backward (tc_bwd.cuh launch_norms), by this one kernel.
struct NormJobs {
  int n;
  int w_off[N_W], k[N_W], o[N_W];  // each job's weights: (k, o) row-major bf16
  int at[N_W + 1];                  // first float of each job; at[n] floats in all
};

// grid: at[n] threads, one a row, its squares summed in k order
__global__ void row_norms_kernel(const unsigned short* __restrict__ wts, const NormJobs jobs,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= jobs.at[jobs.n]) return;
  int j = 0;
  while (i >= jobs.at[j + 1]) ++j;
  const int o = i - jobs.at[j], O = jobs.o[j];
  const unsigned short* w = wts + jobs.w_off[j];
  float acc = 0.f;
  for (int k = 0; k < jobs.k[j]; ++k) {
    const float v = bf_f(w[k * O + o]);
    acc = fmaf(v, v, acc);
  }
  out[i] = acc;
}

// |x_c|, the L2 norm of each sample's inputs over every segment, for the
// samples [n_lo, n_lo + n_cnt) of an act tile of TB, into xn. The squares
// are summed in 4 chains (chain q the inputs k = q mod 4 of each segment in
// order, carried from segment to segment), then as (q0 + q2) + (q1 + q3):
// the bf16 backward's sum at its 64-sample block (tc_bwd.cuh Ctx::dense,
// 4 threads a sample), so that at every width up to 256 both directions
// see the same |x_c|, bit for bit (a wider layer's smaller backward block
// sums in 8 or 16 chains).
template <int TB>
__device__ void input_norms(const Seg* segs, int nseg, int n_lo, int n_cnt, float* xn) {
  constexpr int TPC = TC_THREADS / TB;      // threads a sample: 2 at TB = 128, 4 at 64, 8 at 32
  constexpr int J = TPC < 4 ? 4 / TPC : 1;  // chains a thread: q = part + TPC j
  const int c = threadIdx.x / TPC, part = threadIdx.x % TPC;
  float s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = 0.f;
  if (c >= n_lo && c < n_lo + n_cnt && part < 4) {
    for (int i = 0; i < nseg; ++i) {
      const unsigned short* b = segs[i].b;
      for (int k0 = 0; k0 < 16 * segs[i].ks; k0 += 4) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float v = bf_f(b[act_idx<TB>(k0 + part + TPC * j, c)]);
          s[j] = fmaf(v, v, s[j]);
        }
      }
    }
  }
  if constexpr (J == 2) s[0] += s[1];  // q + (q + 2)
#pragma unroll
  for (int d = TPC / 2; d > 0; d >>= 1) s[0] += __shfl_down_sync(0xffffffffu, s[0], d, TPC);
  if (c >= n_lo && c < n_lo + n_cnt && part == 0) xn[c] = sqrtf(s[0]);
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

// WideRule for one checked layer over these segments: |w_r| (the root of
// the segments' squared row norms rn, summed in order) for its O rows into
// wn, and |x_c| (input_norms) for the samples [n_lo, n_lo + n_cnt) into xn,
// then a barrier before the product that reads them
template <int TB>
__device__ WideRule wide_rule(const Seg* segs, int nseg, int O, int n_lo, int n_cnt, float* wn,
                              float* xn) {
  int ks = 0;
  for (int i = 0; i < nseg; ++i) ks += segs[i].ks;
  for (int r = threadIdx.x; r < O; r += TC_THREADS) {
    float s = 0.f;
    for (int i = 0; i < nseg; ++i) s += segs[i].rn[r];
    wn[r] = sqrtf(s);
  }
  input_norms<TB>(segs, nseg, n_lo, n_cnt, xn);
  __syncthreads();
  return WideRule::make(ks, wn, xn);
}

// out = round_bf16(relu(sum_s W_s^T x_s + bias)), rows < O, into an act
// tile of TB samples: tc_dense's products, each output flagged in `mask`
// (O x TB bits, row-major; zero on entry and on exit) when `rule` (the
// layer's wide_rule) says so; then the flagged outputs recomputed
// (recompute_one), each by one lane from the segments' fragments. `lists`
// (LN entries a warp, a multiple of 32: a chunk of LN / 32 mask words) is
// shared-memory scratch. FULL: every column (K3's forward, the backward);
// otherwise the columns [n_lo, n_lo + n_cnt) (K1's blocks with one skip
// flag off), the only ones normed and flagged.
template <int TB, bool FULL, int LN>
__device__ void dense_checked(const Seg* segs, int nseg, int O, const float* __restrict__ bias,
                              unsigned short* out, unsigned* mask, unsigned short* lists,
                              const WideRule rule, int n_lo = 0, int n_cnt = TB) {
  if (FULL) {
    n_lo = 0;
    n_cnt = TB;
  }
  tc_product<TB>(segs, nseg, O, n_lo, n_cnt, [=](int r, int c, float v0, float v1) {
    const float b = bias[r];
    const float y0 = v0 + b, y1 = v1 + b;
    *reinterpret_cast<unsigned*>(out + act_idx<TB>(r, c)) =
        static_cast<unsigned>(f_bf(rnd<true>(fmaxf(y0, 0.f)))) |
        (static_cast<unsigned>(f_bf(rnd<true>(fmaxf(y1, 0.f)))) << 16);
    const unsigned bits =
        (rule(r, c, y0, v0, b) ? 1u : 0u) | (rule(r, c + 1, y1, v1, b) ? 2u : 0u);
    if (bits) {
      const int i = r * TB + c;
      atomicOr(mask + (i >> 5), bits << (i & 31));
    }
  });
  __syncthreads();
  // each warp lists the flagged outputs of its share of the mask in word
  // order, then its lanes recompute them (one output a lane); a list that
  // would overflow is recomputed and emptied first
  constexpr int WARPS = TC_THREADS / 32, CH = LN / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int words = O * TB / 32, per = words / WARPS;
  unsigned short* list = lists + warp * LN;
  const auto recompute = [&](int n) {
    for (int e = lane; e < n; e += 32) recompute_one<TB>(segs, nseg, bias, list[e], out);
    __syncwarp();
  };
  int n = 0;
  for (int w0 = warp * per; w0 < (warp + 1) * per; w0 += CH) {
    const int j = w0 + lane;
    unsigned word = 0;
    if (lane < CH && j < (warp + 1) * per) {
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
    if (n + total > LN) {
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

// ---------------------------------------- the thin layers, on CUDA cores

// out[o, m] = sum_k W[k, o] x[k, m] + bias[o] for O <= 4 outputs (no
// activation), float32 rows of BM; W (K, O) bf16 in global memory
template <int BM>
__device__ void small_fwd(const unsigned short* __restrict__ w, const unsigned short* x, int K,
                          const float* __restrict__ bias, int O, float* out) {
  for (int i = threadIdx.x; i < O * BM; i += TC_THREADS) {
    const int o = i / BM, m = i % BM;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc = fmaf(bf_f(w[k * O + o]), bf_f(x[act_idx<BM>(k, m)]), acc);
    out[i] = acc + bias[o];
  }
}

// epi(k, m, sum_o W[k, o] dy[o, m]) for O <= 4; dy float32 rows of BM
template <int BM, class Epi>
__device__ void small_dx(const unsigned short* __restrict__ w, int K, int O, const float* dy,
                         Epi epi) {
  for (int i = threadIdx.x; i < K * BM; i += TC_THREADS) {
    const int k = i / BM, m = i % BM;
    float acc = 0.f;
    for (int o = 0; o < O; ++o) acc = fmaf(bf_f(w[k * O + o]), dy[o * BM + m], acc);
    epi(k, m, acc);
  }
}

// zero the rows [from, to) of an act tile
template <int BM>
__device__ void zero_rows(unsigned short* t, int from, int to) {
  for (int i = threadIdx.x; i < (to - from) * BM; i += TC_THREADS) {
    t[act_idx<BM>(from + i / BM, i % BM)] = 0;
  }
}

// shared-memory writes of this block before the next product reads them
__device__ __forceinline__ void layer_sync() {
  fence_smem_async();
  __syncthreads();
}

// ------------------------------------- the record layout, and the taps

// The tiles of a block's record of the bf16 backward's pass 1 (tc_bwd.cuh),
// in rows of BM bf16 samples (act layout). The checked forwards' taps (a
// read-back for checks: chip_smoke.py) write the forward's tiles of it in
// the same layout at the forward's block.
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

// p.rec (each tile's first row; -1 = absent) and p.rec_rows from p's
// shapes: the SpaceNet's, and the motion net's when p.motion_mode is set
template <class P>
void record_layout(P& p) {
  int rows[N_REC];
  for (int r = 0; r < N_REC; ++r) rows[r] = 0;
  for (int i = 0; i < p.n_rgb - 1; ++i) rows[R_HS0 + i] = rows[R_DHS0 + i] = p.head;
  rows[R_G3RGB] = rows[R_SIG] = 16;
  for (int k = 0; k < 7; ++k) rows[R_A0 + k] = rows[R_D0 + k] = p.width;
  rows[R_POS] = p.pos_pad;
  rows[R_DIR] = p.dir_pad;
  rows[R_TIME] = p.time_pad;
  if (p.motion_mode) {
    rows[R_U0] = p.menc_pad;
    for (int k = 1; k < 6; ++k) rows[R_U0 + k] = rows[R_DU1 + k - 1] = p.motion_width;
    rows[R_G3M] = 16;
  }
  p.rec_rows = 0;
  for (int r = 0; r < N_REC; ++r) {
    p.rec[r] = rows[r] ? p.rec_rows : -1;
    p.rec_rows += rows[r];
  }
}

// With taps (not null): the `rows` rows of an act tile of TB samples, as
// they stand in shared memory behind the last layer_sync, into the record
// tile at row `at` of this block's record in taps (rec_rows x TB bf16 a
// block). Each thread copies its share before it reaches the next barrier,
// so the tile may be overwritten after the layer that follows.
template <int TB>
__device__ void tap(unsigned short* taps, int rec_rows, int at, const unsigned short* tile,
                    int rows) {
  if (taps == nullptr || at < 0) return;
  auto* dst = reinterpret_cast<uint4*>(
      taps + (static_cast<size_t>(blockIdx.x) * rec_rows + at) * TB);
  const auto* src = reinterpret_cast<const uint4*>(tile);
  for (int i = threadIdx.x; i < rows * TB / 8; i += TC_THREADS) dst[i] = src[i];
}

}  // namespace
