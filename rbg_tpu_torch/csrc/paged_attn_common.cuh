// Shared device code of the paged-attention kernels: the float and
// bfloat16 conversions, and where a walk's slots live in the pool
// (PageMap, every kernel).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rbg {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Four f32 values at d (16-byte aligned) in T.
__device__ __forceinline__ void store4(float* d, float4 v) {
  *reinterpret_cast<float4*>(d) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* d, float4 v) {
  reinterpret_cast<__nv_bfloat162*>(d)[0] = __floats2bfloat162_rn(v.x, v.y);
  reinterpret_cast<__nv_bfloat162*>(d)[1] = __floats2bfloat162_rn(v.z, v.w);
}

// The shift of a page size that is a power of two, else -1 (PageMap's
// pshift).
__host__ __device__ inline int page_shift(int page) {
  if (page < 1 || (page & (page - 1))) return -1;
  int s = 0;
  while ((1 << s) < page) ++s;
  return s;
}

// Where walk slot s of one table row lives in a pool [NP, page, ...]: the
// id of its page, table row entry s / page, times the page size plus its
// offset s % page in the page (a shift when the page size is a power of
// two, pshift >= 0; a division otherwise). So a kernel's KV block may span
// parts of pages of any size, or lie inside one page. The page index is
// clamped to the walk's last page: slots past the walk are masked, but
// read finite values.
struct PageMap {
  const int* trow;
  int last, page, pshift;

  __device__ __forceinline__ int index(int s, int* off) const {
    if (pshift >= 0) {
      *off = s & (page - 1);
      return s >> pshift;
    }
    const int i = s / page;
    *off = s - i * page;
    return i;
  }
  // The page index of the walk's slot `slots - 1`, the last a walk of
  // `slots` slots reads (PageMap::last).
  __device__ __forceinline__ int last_of(int slots) const {
    int off;
    return index(slots - 1, &off);
  }
  // slot(s) on the path of a page size that is (kPow2) or is not a power
  // of two; a loop of lookups branches once, outside, so its table loads
  // issue back to back.
  template <bool kPow2>
  __device__ __forceinline__ long slot_in(int s) const {
    if constexpr (kPow2) {
      return ((long)__ldg(trow + min(s >> pshift, last)) << pshift) + (s & (page - 1));
    } else {
      const int i = s / page;
      return (long)__ldg(trow + min(i, last)) * page + (s - i * page);
    }
  }
  __device__ __forceinline__ long slot(int s) const {
    return pshift >= 0 ? slot_in<true>(s) : slot_in<false>(s);
  }
};

}  // namespace rbg
