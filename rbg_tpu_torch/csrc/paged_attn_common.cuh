// Shared device code of the paged-attention kernels: the page walk with an
// online softmax in float32.
//
// A thread block owns a set of query rows that read the same pages (the G
// query heads of one GQA kv head, or a group of MLA heads, for one or more
// tokens). Their q, running max m, running denominator l and numerator acc
// live in shared memory for the whole walk. For each page of the row the
// block
//   1. copies the page's K (and V) slices from device memory into shared
//      memory (16-byte loads, converted to f32), with the page's per-slot
//      scales when the pool is int8,
//   2. scores every (query row, slot) pair from shared memory,
//   3. updates m and l per query row (a slot at or past the row's causal
//      limit gets probability 0),
//   4. rescales acc and adds probs · V, one thread per (row, column).
// Each page is read from device memory once per (block, row walk); that
// traffic, not arithmetic, bounds a decode step on Hopper. Plain f32 FMA on
// CUDA cores is this first version's arithmetic; tensor cores (wgmma) and
// TMA page loads come later.
//
// int8 pools (per-(slot, kv head) absmax scales, f32 [NP, page, KV, 1]) are
// never dequantized into memory: the k scale folds into the score,
// s = (q·k_i8)·scale·ks[slot], and the v scale into the probability before
// the PV sum, p' = p·vs[slot] (the denominator keeps p).
//
// MLA (latent) pools are MQA-shaped: one latent c [dc] and one RoPE key
// pe [dr] per slot. The walk stages [c | pe] as one K row of width dc+dr,
// and the values are the first dc columns of that same row. int8 latent
// pools carry two scales per slot (f32 [NP, page, 1, 1] each): the c
// scale multiplies the latent score term and the values, the pe scale the
// RoPE term. One score scale per slot cannot express that, so the MLA
// walk folds them while staging: the c part of slot i's row is converted
// to f32 times cs[i] and the pe part times ps[i], and attend_page runs
// unchanged. That is the reference's algebra up to f32 rounding order.

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

// Shared-memory plan for nq query rows of score width dq and value width
// dv: a K page of `page` rows with stride ldk, and a V page with stride ldv
// (ldv == 0: the values live in the K page's first dv columns).
struct Plan {
  int nq, dq, dv, page, ldk, ldv;
};

__host__ __device__ inline Plan gqa_plan(int nq, int hd, int page) {
  return Plan{nq, hd, hd, page, hd + 1, hd + 1};  // padded rows: conflict-free
}

__host__ __device__ inline Plan mla_plan(int nq, int dc, int dr, int page) {
  return Plan{nq, dc + dr, dc, page, dc + dr + 1, 0};
}

struct Smem {
  float* q;      // [nq, dq]
  float* acc;    // [nq, dv]
  float* k;      // [page, ldk]
  float* v;      // [page, ldv], or k when ldv == 0
  float* s;      // [nq, page] scores, then probabilities
  float* m;      // [nq]
  float* l;      // [nq]
  float* alpha;  // [nq] rescale factor of the current page
  float* ks;     // [page] k scales of the current page (int8 pools)
  float* vs;     // [page] v scales of the current page (int8 pools)
  int* act;      // [nq] query rows taking part in the current row walk
  int* lim;      // [nq] their causal limits (slots < lim are visible)
};

__host__ __device__ inline size_t smem_bytes(const Plan& p) {
  return sizeof(float) * ((size_t)p.nq * (p.dq + p.dv) + (size_t)p.page * (p.ldk + p.ldv)
                          + (size_t)p.nq * p.page + 3 * (size_t)p.nq + 2 * (size_t)p.page)
         + sizeof(int) * 2 * (size_t)p.nq;
}

__device__ inline Smem carve(float* base, const Plan& p) {
  Smem sm;
  sm.q = base;
  sm.acc = sm.q + p.nq * p.dq;
  sm.k = sm.acc + p.nq * p.dv;
  sm.v = p.ldv ? sm.k + p.page * p.ldk : sm.k;
  sm.s = sm.k + p.page * (p.ldk + p.ldv);
  sm.m = sm.s + p.nq * p.page;
  sm.l = sm.m + p.nq;
  sm.alpha = sm.l + p.nq;
  sm.ks = sm.alpha + p.nq;
  sm.vs = sm.ks + p.page;
  sm.act = reinterpret_cast<int*>(sm.vs + p.page);
  sm.lim = sm.act + p.nq;
  return sm;
}

// Copy the [page, width] slice of kv head `kv` in pool page `phys` into dst
// (row stride ld). Pool layout [NP, page, KV, width]: consecutive slots are
// KV*width apart. width must be a multiple of 16 bytes of P. With
// `scales` (f32 [NP, page, KV, 1]) each slot's row is staged times its
// scale.
template <typename P>
__device__ void load_page(float* dst, int ld, const P* pages, long phys, int kv,
                          int KV, int width, int page,
                          const float* scales = nullptr) {
  constexpr int VEC = 16 / sizeof(P);
  const int chunks = width / VEC;
  for (int i = threadIdx.x; i < page * chunks; i += blockDim.x) {
    const int t = i / chunks, c = i % chunks;
    const long slot = (phys * page + t) * KV + kv;
    const P* src = pages + slot * width + c * VEC;
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const P* vals = reinterpret_cast<const P*>(&raw);
    float* d = dst + t * ld + c * VEC;
    if (scales) {
      const float s = scales[slot];
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f32(vals[j]) * s;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) d[j] = to_f32(vals[j]);
    }
  }
}

// The page's per-slot scales of kv head `kv`: scales [NP, page, KV, 1].
__device__ inline void load_scales(float* dst, const float* scales, long phys,
                                   int kv, int KV, int page) {
  for (int t = threadIdx.x; t < page; t += blockDim.x)
    dst[t] = scales[(phys * page + t) * KV + kv];
}

// Steps 2-4 for page p, staged in sm.k / sm.v: score the nact active rows,
// update their softmax state, accumulate probs · V. ks / vs (shared-memory
// scales of the page, or nullptr) fold the int8 scales. Ends synchronised.
__device__ inline void attend_page(const Smem& sm, const Plan& pl, int nact, int p,
                                   float scale, const float* ks, const float* vs) {
  const int page = pl.page;
  for (int i = threadIdx.x; i < nact * page; i += blockDim.x) {
    const int a = i / page, t = i % page;
    const float* qr = sm.q + sm.act[a] * pl.dq;
    const float* kr = sm.k + t * pl.ldk;
    float dot = 0.f;
    for (int d = 0; d < pl.dq; ++d) dot = fmaf(qr[d], kr[d], dot);
    float s = dot * scale;
    if (ks) s *= ks[t];
    sm.s[i] = (p * page + t < sm.lim[a]) ? s : kNegInf;
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
      sr[t] = vs ? pr * vs[t] : pr;
    }
    sm.m[r] = m_new;
    sm.l[r] = sm.l[r] * alpha + sum;
    sm.alpha[a] = alpha;
  }
  __syncthreads();
  const int ldv = pl.ldv ? pl.ldv : pl.ldk;
  for (int i = threadIdx.x; i < nact * pl.dv; i += blockDim.x) {
    const int a = i / pl.dv, d = i % pl.dv;
    const int r = sm.act[a];
    const float* pr = sm.s + a * page;
    float o = sm.acc[r * pl.dv + d] * sm.alpha[a];
    for (int t = 0; t < page; ++t) o = fmaf(pr[t], sm.v[t * ldv + d], o);
    sm.acc[r * pl.dv + d] = o;
  }
  __syncthreads();
}

// Walk one table row's pages of GQA kv head `kv` for the nact active query
// rows listed in sm.act / sm.lim, up to row_limit slots (the largest of
// their limits). k_scales / v_scales are nullptr for model-dtype pools.
// Every thread of the block calls this with the same arguments.
template <typename P>
__device__ void attend_row(const Smem& sm, const Plan& pl, int nact, int row_limit,
                           const int* table_row, int max_pages, const P* k_pages,
                           const P* v_pages, const float* k_scales,
                           const float* v_scales, int kv, int KV, float scale) {
  const int page = pl.page, hd = pl.dq;
  const int n_pages = min((row_limit + page - 1) / page, max_pages);
  for (int p = 0; p < n_pages; ++p) {
    const long phys = table_row[p];
    load_page(sm.k, pl.ldk, k_pages, phys, kv, KV, hd, page);
    load_page(sm.v, pl.ldv, v_pages, phys, kv, KV, hd, page);
    if (k_scales) {
      load_scales(sm.ks, k_scales, phys, kv, KV, page);
      load_scales(sm.vs, v_scales, phys, kv, KV, page);
    }
    __syncthreads();
    attend_page(sm, pl, nact, p, scale, k_scales ? sm.ks : nullptr,
                v_scales ? sm.vs : nullptr);
  }
}

// The MLA walk: pages of the latent pool c [NP, page, 1, dc] and the RoPE
// key pool pe [NP, page, 1, dr] staged as one [page, dc + dr] K page whose
// first dc columns are the values. c_scales / pe_scales (f32
// [NP, page, 1, 1], int8 pools) scale the staged parts; nullptr for
// model-dtype pools.
template <typename P>
__device__ void mla_attend_row(const Smem& sm, const Plan& pl, int nact, int row_limit,
                               const int* table_row, int max_pages, const P* c_pages,
                               const P* pe_pages, const float* c_scales,
                               const float* pe_scales, float scale) {
  const int page = pl.page, dc = pl.dv, dr = pl.dq - pl.dv;
  const int n_pages = min((row_limit + page - 1) / page, max_pages);
  for (int p = 0; p < n_pages; ++p) {
    const long phys = table_row[p];
    load_page(sm.k, pl.ldk, c_pages, phys, 0, 1, dc, page, c_scales);
    load_page(sm.k + dc, pl.ldk, pe_pages, phys, 0, 1, dr, page, pe_scales);
    __syncthreads();
    attend_page(sm, pl, nact, p, scale, nullptr, nullptr);
  }
}

// Initialise the softmax state and accumulators of all nq rows.
__device__ inline void init_state(const Smem& sm, const Plan& pl) {
  for (int i = threadIdx.x; i < pl.nq * pl.dv; i += blockDim.x) sm.acc[i] = 0.f;
  for (int r = threadIdx.x; r < pl.nq; r += blockDim.x) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.f;
  }
}

// ---- the ragged kernels' tiles of packed tokens ----
constexpr int kTile = 8;

// Per tile token: its row (-1 when it attends nothing) and causal limit.
__device__ inline void tile_rows(int* tok_row, int* tok_lim, int t0, int n_tokens,
                                 const int* row_ids, const int* q_pos,
                                 const int* kv_lens, int R) {
  if (threadIdx.x < kTile) {
    const int t = t0 + threadIdx.x;
    int row = -1, lim = 0;
    if (t < n_tokens) {
      const int r = row_ids[t], pos = q_pos[t];
      if (r >= 0 && r < R && pos >= 0) {
        row = r;
        lim = min(kv_lens[r], pos + 1);
      }
    }
    tok_row[threadIdx.x] = lim > 0 ? row : -1;
    tok_lim[threadIdx.x] = lim;
  }
}

// If tile token k leads its row (the row's first token in the tile), list
// the query rows riding the walk in sm.act / sm.lim (nh rows per token,
// query row j * nh + h) and return the walk's slot limit; else return 0.
// Every thread calls this; thread 0 writes the lists. Ends synchronised
// when it returns non-zero.
__device__ inline int lead_row(const Smem& sm, const int* tok_row, const int* tok_lim,
                               int k, int nh, int* nact) {
  const int row = tok_row[k];
  if (row < 0) return 0;
  for (int j = 0; j < k; ++j)
    if (tok_row[j] == row) return 0;  // an earlier token already led this row
  int n = 0, row_limit = 0;
  for (int j = k; j < kTile; ++j) {
    if (tok_row[j] != row) continue;
    row_limit = max(row_limit, tok_lim[j]);
    for (int h = 0; h < nh; ++h, ++n) {
      if (threadIdx.x == 0) {
        sm.act[n] = j * nh + h;
        sm.lim[n] = tok_lim[j];
      }
    }
  }
  *nact = n;
  __syncthreads();
  return row_limit;
}


// Opt a kernel into more than the default 48 KB of dynamic shared memory.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace rbg
