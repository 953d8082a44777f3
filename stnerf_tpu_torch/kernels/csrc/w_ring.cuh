// A ring of weight slabs in shared memory for the float32 MLP kernels on
// CUDA cores: K1's float32 forward (fused_field.cu) and K3's (spacenet.cu),
// whose consumers are ring_dense.cuh's layers. The float32 backward's
// recompute (f32_bwd.cuh) still reads its weights from L2.
//
// A kernel's products read a fixed sequence of weight segments: one per
// split product of a layer (W, or the parts of a concatenated input), each
// (K, O) row-major in the packed weights. pack_field aligns every operand
// to 16 elements and O is a kernel width, so a segment's rows are
// contiguous runs of O * 4 bytes, a multiple of 128. The ring streams the
// segments in that order through `stages` stages of STAGE_FLOATS floats: a
// slab is slab_rows(O) consecutive rows (32 at O = 256, 64 at 128, 128 at
// 64, 256 at 32) or the rest of its segment. A 1- or 3-wide output layer
// is one slab: its K * O * 4 bytes are a multiple of 16 when K is a kernel
// width. Every slab costs each consumer warp a wait and a release, so the
// stages are large: two of 32 KB ran K1's float32 forward faster on the
// H100 than four of 16 KB, three of 22 KB or eight of 8 KB
// (tools/torch_k1_variants.py).
//
// One producer thread (lane 0 of a warp beside the consumers) issues one
// bulk copy (cp.async.bulk, global to shared) per slab, completing on the
// stage's `full` mbarrier with the slab's bytes as the expected
// transaction. The copies take L2's normal priority: every block re-reads
// the same weights, so they stay resident without a hint, and an
// evict-last hint outlives the kernel, keeping its lines in L2 against the
// kernels that run after it. Before it refills a stage it waits on the stage's `empty`
// mbarrier, on which each consumer warp arrives once it has read the slab.
// The producer runs ahead across layer boundaries: the next layer's first
// slabs land while the consumers finish a layer's epilogue and barrier.
// Consumers count slabs in the same order (RingPos), so slab q sits in
// stage q % stages at phase q / stages.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {
namespace wring {

constexpr int STAGE_FLOATS = 8192;  // 32 KB a stage
constexpr int MAX_STAGES = 8;
constexpr int MAX_SEGS = 24;

struct Seg {
  const float* w;  // (K, O) row-major in global memory, 16-byte aligned
  int K, O;
};

// The ring's barriers and segment list, in the kernel's static shared
// memory; the stages are in its dynamic shared memory.
struct Ctl {
  uint64_t full[MAX_STAGES];
  uint64_t empty[MAX_STAGES];
  Seg seg[MAX_SEGS];
  int n_seg, stages;
};

// The consumers' position: the next segment and the next slab
struct RingPos {
  int seg, q;
};

__host__ __device__ constexpr int slab_rows(int O) { return STAGE_FLOATS / O; }

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\nwait_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra wait_%=;\n}\n" ::"r"(saddr(bar)),
      "r"(parity)
      : "memory");
}

// Thread 0, before the block's first barrier: `stages` stages, each
// released by `consumer_warps` warps.
__device__ __forceinline__ void init(Ctl& c, int stages, int consumer_warps) {
  c.stages = stages;
  for (int s = 0; s < stages; ++s) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(saddr(&c.full[s])) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(&c.empty[s])),
                 "r"(consumer_warps)
                 : "memory");
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The producer thread: every slab of the segments, in order, into `stage`
// (stages of STAGE_FLOATS floats, 128-byte aligned shared memory).
__device__ __forceinline__ void produce(Ctl& c, float* stage) {
  const int S = c.stages;
  int q = 0;
  for (int i = 0; i < c.n_seg; ++i) {
    const Seg sg = c.seg[i];
    const int rows = slab_rows(sg.O);
    for (int k0 = 0; k0 < sg.K; k0 += rows, ++q) {
      const int s = q % S;
      if (q >= S) bar_wait(&c.empty[s], (q / S - 1) & 1);
      const int bytes = min(rows, sg.K - k0) * sg.O * static_cast<int>(sizeof(float));
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                       saddr(&c.full[s])),
                   "r"(bytes)
                   : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(saddr(stage + s * STAGE_FLOATS)),
          "l"(sg.w + static_cast<size_t>(k0) * sg.O), "r"(bytes), "r"(saddr(&c.full[s]))
          : "memory");
    }
  }
}

// A consumer: wait until slab q has landed -> its stage's index
__device__ __forceinline__ int acquire(Ctl& c, int q) {
  const int s = q % c.stages;
  bar_wait(&c.full[s], (q / c.stages) & 1);
  return s;
}

// A consumer warp is done reading slab q (every lane calls it)
__device__ __forceinline__ void release(Ctl& c, int q) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(&c.empty[q % c.stages]))
                 : "memory");
  }
}

// Host: the stages that fit beside `other` bytes of dynamic shared memory
// under `limit` bytes a block (the card's opt-in maximum less the
// kernel's static shared memory), at most MAX_STAGES.
inline int stages_for(size_t other, size_t limit) {
  const size_t stage = STAGE_FLOATS * sizeof(float);
  const size_t n = limit > other ? (limit - other) / stage : 0;
  return static_cast<int>(n < MAX_STAGES ? n : MAX_STAGES);
}

}  // namespace wring
}  // namespace
