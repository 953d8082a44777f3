// Tensor-core building blocks of the bf16 field kernels (fused_field_tc.cu,
// field_bwd_tc.cu) on Hopper (sm_90a): dense layers over a tile of BM
// samples as warpgroup matrix products (wgmma), bf16 operands and float32
// accumulation, exactly the TPU kernels' products.
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
// row is the segment's first k), `ks` the k-steps of 16.
struct Seg {
  const uint4* frag;
  const unsigned short* b;
  int ks;
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
// with one m-tile, half of the columns.
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
  } else {
    constexpr int NH = NF / 2;
    float d[NH / 2];
    mma_rs<BM, NH>(d, segs, nseg, 0, n_lo + wg * NH);
    acc_epilogue<NH>(d, 0, n_lo + wg * NH, rows, epi);
  }
}

template <int BM, class Epi>
__device__ void tc_product(const Seg* segs, int nseg, int rows, int n_lo, int n_cnt, Epi epi) {
  if (n_cnt == BM) {
    tc_product_n<BM, BM>(segs, nseg, rows, n_lo, epi);
  } else {
    tc_product_n<BM, BM / 2>(segs, nseg, rows, n_lo, epi);
  }
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

}  // namespace
