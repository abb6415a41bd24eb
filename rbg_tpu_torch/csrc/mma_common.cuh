// Thin wrappers of the Ampere/Hopper warp-level instructions that the
// block-ragged kernels B and D (ragged_paged.cuh) are built from:
//   cp.async     16-byte (and 4-byte) global -> shared copies that do not
//                hold registers, grouped with commit/wait so that the next
//                KV blocks load while this one is computed;
//   ldmatrix     four 8x8 b16 matrices from shared memory into the
//                fragment layout of mma.sync (.trans for row-major V);
//   mma.sync     m16n8k16, bf16 x bf16 -> f32 accumulators.
// Fragment layouts (PTX ISA, "Matrix fragments for mma.m16n8k16"), with
// lane = 4 * gid + tig:
//   A 16x16 row-major: reg0 = (row gid, cols 2tig, 2tig+1), reg1 = row
//     gid+8, reg2 = row gid cols +8, reg3 = row gid+8 cols +8;
//   B 16x8 "col": reg0 = (k 2tig, 2tig+1; n gid), reg1 = k +8;
//   C 16x8: c0, c1 = (row gid, cols 2tig, 2tig+1), c2, c3 = row gid+8.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace rbg {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a · b on one m16n8k16 tile (bf16 inputs, f32 accumulators). Not
// volatile: register operands only, so the compiler may interleave
// independent products to hide each one's latency.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// threadIdx.x through a volatile read: what a loop derives from it (lane
// offsets of shared-memory addresses) is made where it is used, not hoisted
// out of the loop and held in registers across it.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
  return t;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (a, b) as the bf16 pair hi (a in the low half) plus the bf16 pair lo of
// what hi rounded away: hi + lo carries a and b to about 16 bits.
__device__ __forceinline__ void split_bf16x2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(a - hf.x, b - hf.y));
}

}  // namespace rbg
