// Shared device code of the two paged-attention kernels (paged_decode.cu,
// ragged_paged.cu): the page walk with an online softmax in float32.
//
// A thread block owns a set of query rows of ONE kv head (the G query
// heads of a GQA group, for one or more tokens). Their q, running max m,
// running denominator l and numerator acc live in shared memory for the
// whole walk. For each page of the row the block
//   1. copies the page's [page, hd] K and V slices of this kv head from
//      device memory into shared memory (16-byte loads, converted to f32),
//   2. scores every (query row, slot) pair from shared memory,
//   3. updates m and l per query row (a slot at or past the row's causal
//      limit gets probability 0),
//   4. rescales acc and adds probs · V, one thread per head-dim column.
// Each K/V page is read from device memory once per (block, row walk);
// that traffic, not arithmetic, bounds a decode step on Hopper. Plain f32
// FMA on CUDA cores is this first version's arithmetic; tensor cores
// (wgmma) and TMA page loads come later.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rbg {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared-memory layout for nq query rows (all float, then the int lists).
struct Smem {
  float* q;      // [nq, hd]
  float* acc;    // [nq, hd]
  float* k;      // [page, hd + 1] (padded row: conflict-free column reads)
  float* v;      // [page, hd + 1]
  float* s;      // [nq, page] scores, then probabilities
  float* m;      // [nq]
  float* l;      // [nq]
  float* alpha;  // [nq] rescale factor of the current page
  int* act;      // [nq] query rows taking part in the current row walk
  int* lim;      // [nq] their causal limits (slots < lim are visible)
};

__host__ __device__ inline size_t smem_bytes(int nq, int hd, int page) {
  return sizeof(float) * (2 * (size_t)nq * hd + 2 * (size_t)page * (hd + 1)
                          + (size_t)nq * page + 3 * (size_t)nq)
         + sizeof(int) * 2 * (size_t)nq;
}

__device__ inline Smem carve(float* base, int nq, int hd, int page) {
  Smem sm;
  sm.q = base;
  sm.acc = sm.q + nq * hd;
  sm.k = sm.acc + nq * hd;
  sm.v = sm.k + page * (hd + 1);
  sm.s = sm.v + page * (hd + 1);
  sm.m = sm.s + nq * page;
  sm.l = sm.m + nq;
  sm.alpha = sm.l + nq;
  sm.act = reinterpret_cast<int*>(sm.alpha + nq);
  sm.lim = sm.act + nq;
  return sm;
}

// Copy the [page, hd] slice of kv head `kv` in pool page `phys` into dst.
// Pool layout [NP, page, KV, hd]: consecutive slots are KV*hd apart.
template <typename T>
__device__ void load_page(float* dst, const T* pages, long phys, int kv,
                          int KV, int hd, int page) {
  constexpr int VEC = 16 / sizeof(T);
  const int chunks = hd / VEC;
  for (int i = threadIdx.x; i < page * chunks; i += blockDim.x) {
    const int t = i / chunks, c = i % chunks;
    const T* src = pages + ((phys * page + t) * KV + kv) * (long)hd + c * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const T* vals = reinterpret_cast<const T*>(&raw);
    float* d = dst + t * (hd + 1) + c * VEC;
#pragma unroll
    for (int j = 0; j < VEC; ++j) d[j] = to_f32(vals[j]);
  }
}

// Walk one table row's pages for the nact active query rows listed in
// sm.act / sm.lim, up to row_limit slots (the largest of their limits).
// Every thread of the block calls this with the same arguments.
template <typename T>
__device__ void attend_row(const Smem& sm, int nact, int row_limit,
                           const int* table_row, int max_pages,
                           const T* k_pages, const T* v_pages, int kv, int KV,
                           int hd, int page, float scale) {
  const int n_pages = min((row_limit + page - 1) / page, max_pages);
  for (int p = 0; p < n_pages; ++p) {
    const long phys = table_row[p];
    load_page(sm.k, k_pages, phys, kv, KV, hd, page);
    load_page(sm.v, v_pages, phys, kv, KV, hd, page);
    __syncthreads();
    for (int i = threadIdx.x; i < nact * page; i += blockDim.x) {
      const int a = i / page, t = i % page;
      const float* qr = sm.q + sm.act[a] * hd;
      const float* kr = sm.k + t * (hd + 1);
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot = fmaf(qr[d], kr[d], dot);
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
        sr[t] = pr;
        sum += pr;
      }
      sm.m[r] = m_new;
      sm.l[r] = sm.l[r] * alpha + sum;
      sm.alpha[a] = alpha;
    }
    __syncthreads();
    for (int a = 0; a < nact; ++a) {
      const int r = sm.act[a];
      const float* pr = sm.s + a * page;
      const float al = sm.alpha[a];
      for (int d = threadIdx.x; d < hd; d += blockDim.x) {
        float o = sm.acc[r * hd + d] * al;
        for (int t = 0; t < page; ++t) o = fmaf(pr[t], sm.v[t * (hd + 1) + d], o);
        sm.acc[r * hd + d] = o;
      }
    }
    __syncthreads();
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
