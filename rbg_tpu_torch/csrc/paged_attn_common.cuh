// Shared device code of the paged-attention kernels: where a walk's slots
// live in the pool (PageMap, every kernel), and the page walk with an
// online softmax in float32 of the token-grid kernel I.
//
// The walk (rbg::attend_row): a thread block owns the G query heads of one
// GQA kv head for one token. Their q, running max m, running denominator l
// and numerator acc live in shared memory for the whole walk. For each page
// of the row the block
//   1. copies the page's K and V slices from device memory into shared
//      memory (16-byte loads, converted to f32),
//   2. scores every (query row, slot) pair from shared memory,
//   3. updates m and l per query row (a slot at or past the row's causal
//      limit gets probability 0),
//   4. rescales acc and adds probs · V, one thread per (row, column).
// Plain f32 FMA on CUDA cores, one page at a time: kernel I is the
// block_ragged probe's baseline, and its re-reading of a row's pages per
// token is what the probe measures kernel B against.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rbg {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

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

// Shared-memory plan for nq query rows of head dim hd: a K page and a V
// page of `page` rows, each with stride hd + 1 (padded: conflict-free).
struct Plan {
  int nq, hd, page, ld;
};

__host__ __device__ inline Plan gqa_plan(int nq, int hd, int page) {
  return Plan{nq, hd, page, hd + 1};
}

struct Smem {
  float* q;      // [nq, hd]
  float* acc;    // [nq, hd]
  float* k;      // [page, ld]
  float* v;      // [page, ld]
  float* s;      // [nq, page] scores, then probabilities
  float* m;      // [nq]
  float* l;      // [nq]
  float* alpha;  // [nq] rescale factor of the current page
  int* act;      // [nq] query rows taking part in the current row walk
  int* lim;      // [nq] their causal limits (slots < lim are visible)
};

__host__ __device__ inline size_t smem_bytes(const Plan& p) {
  return sizeof(float) * (2 * (size_t)p.nq * p.hd + 2 * (size_t)p.page * p.ld
                          + (size_t)p.nq * p.page + 3 * (size_t)p.nq)
         + sizeof(int) * 2 * (size_t)p.nq;
}

__device__ inline Smem carve(float* base, const Plan& p) {
  Smem sm;
  sm.q = base;
  sm.acc = sm.q + p.nq * p.hd;
  sm.k = sm.acc + p.nq * p.hd;
  sm.v = sm.k + p.page * p.ld;
  sm.s = sm.v + p.page * p.ld;
  sm.m = sm.s + p.nq * p.page;
  sm.l = sm.m + p.nq;
  sm.alpha = sm.l + p.nq;
  sm.act = reinterpret_cast<int*>(sm.alpha + p.nq);
  sm.lim = sm.act + p.nq;
  return sm;
}

// Copy the [page, width] slice of kv head `kv` in pool page `phys` into dst
// (row stride ld). Pool layout [NP, page, KV, width]: consecutive slots are
// KV*width apart. width must be a multiple of 16 bytes of P.
template <typename P>
__device__ void load_page(float* dst, int ld, const P* pages, long phys, int kv,
                          int KV, int width, int page) {
  constexpr int VEC = 16 / sizeof(P);
  const int chunks = width / VEC;
  for (int i = threadIdx.x; i < page * chunks; i += blockDim.x) {
    const int t = i / chunks, c = i % chunks;
    const long slot = (phys * page + t) * KV + kv;
    const uint4 raw = *reinterpret_cast<const uint4*>(pages + slot * width + c * VEC);
    const P* vals = reinterpret_cast<const P*>(&raw);
    float* d = dst + t * ld + c * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = to_f32(vals[j]);
  }
}

// Steps 2-4 for page p, staged in sm.k / sm.v: score the nact active rows,
// update their softmax state, accumulate probs · V. Ends synchronised.
__device__ inline void attend_page(const Smem& sm, const Plan& pl, int nact, int p,
                                   float scale) {
  const int page = pl.page;
  for (int i = threadIdx.x; i < nact * page; i += blockDim.x) {
    const int a = i / page, t = i % page;
    const float* qr = sm.q + sm.act[a] * pl.hd;
    const float* kr = sm.k + t * pl.ld;
    float dot = 0.f;
    for (int d = 0; d < pl.hd; ++d) dot = fmaf(qr[d], kr[d], dot);
    sm.s[i] = (p * page + t < sm.lim[a]) ? dot * scale : kNegInf;
  }
  __syncthreads();
  for (int a = threadIdx.x; a < nact; a += blockDim.x) {
    const int r = sm.act[a];
    float* sr = sm.s + a * page;
    float mx = kNegInf;
    for (int t = 0; t < page; ++t) mx = fmaxf(mx, sr[t]);
    const float m_old = sm.m[r];
    const float m_new = fmaxf(m_old, mx);
    const float alpha = expf(m_old - m_new);
    float sum = 0.f;
    for (int t = 0; t < page; ++t) {
      const float pr = (p * page + t < sm.lim[a]) ? expf(sr[t] - m_new) : 0.f;
      sum += pr;
      sr[t] = pr;
    }
    sm.m[r] = m_new;
    sm.l[r] = sm.l[r] * alpha + sum;
    sm.alpha[a] = alpha;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nact * pl.hd; i += blockDim.x) {
    const int a = i / pl.hd, d = i % pl.hd;
    const int r = sm.act[a];
    const float* pr = sm.s + a * page;
    float o = sm.acc[r * pl.hd + d] * sm.alpha[a];
    for (int t = 0; t < page; ++t) o = fmaf(pr[t], sm.v[t * pl.ld + d], o);
    sm.acc[r * pl.hd + d] = o;
  }
  __syncthreads();
}

// Walk one table row's pages of GQA kv head `kv` for the nact active query
// rows listed in sm.act / sm.lim, up to row_limit slots (the largest of
// their limits). Every thread of the block calls this with the same
// arguments.
template <typename P>
__device__ void attend_row(const Smem& sm, const Plan& pl, int nact, int row_limit,
                           const int* table_row, int max_pages, const P* k_pages,
                           const P* v_pages, int kv, int KV, float scale) {
  const int page = pl.page;
  const int n_pages = min((row_limit + page - 1) / page, max_pages);
  for (int p = 0; p < n_pages; ++p) {
    const long phys = table_row[p];
    load_page(sm.k, pl.ld, k_pages, phys, kv, KV, pl.hd, page);
    load_page(sm.v, pl.ld, v_pages, phys, kv, KV, pl.hd, page);
    __syncthreads();
    attend_page(sm, pl, nact, p, scale);
  }
}

// Initialise the softmax state and accumulators of all nq rows.
__device__ inline void init_state(const Smem& sm, const Plan& pl) {
  for (int i = threadIdx.x; i < pl.nq * pl.hd; i += blockDim.x) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < pl.nq; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rbg
