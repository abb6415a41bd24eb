// Paged decode attention (T == 1) for Hopper: the kernel body shared by
// paged_decode.cu (kernel A, model-dtype pools) and paged_decode_q.cu
// (kernel C, int8 pools). They replace the TPU kernels
// rbg_tpu/ops/pallas/paged_attention_kernel.py `paged_attention_pallas`
// and `paged_attention_pallas_q`.
//
// Query head h = kv·G + g of row b attends slots < len(b) = min(kv_lens[b],
// P·page) through page_table[b]; a row with len <= 0 gives 0 (the
// engine's bucket pad rows). Online softmax in f32; the output is
// acc / max(l, 1e-30).
//
// Bound: bytes. A decode step reads each live K/V slot once for all G
// heads of its kv head and does 4·G·hd flops per slot, far below the
// card's ~295 flop/byte. What holds a decode kernel back is the serial
// path: a block that walks a 2k-token row alone, one page at a time, on a
// card where B·KV blocks (64 at B = 8 on llama3-8b) leave half the SMs
// idle. The design cuts that path three ways.
//
// 1. Work items (row b, kv head, split s). A row's walk of
//    nkb = ceil(len / 64) KV blocks splits into
//      ns(b) = min(cap, ceil(nkb / kMinSplitBlocks))
//    contiguous ranges, split s taking blocks [s·nkb/ns, (s+1)·nkb/ns)
//    (never empty, sizes differing by at most one block), where
//      cap = min(kMaxSplits, max(1, ceil(512 / (B·KV))))
//    comes from the launch's sizes alone (the wrapper's split_cap passes
//    it). So ns follows each row's own length, never the table's width,
//    and once B·KV blocks reach 512 nothing splits. The grid is (B·KV,
//    min(cap, ceil(ceil(P·page / 64) / kMinSplitBlocks))); a block whose
//    s >= ns(b) returns at once. Block (0, 0) writes the launch's items,
//    KV · (sum of ns(b) over rows with len > 0), and its grid size into the
//    counts (kItemsSlot, kGridSlot), where the wrapper's launch_report
//    reads them.
// 2. The merge, on the card, in a fixed order. A split of a row with
//    ns > 1 writes its partial (o unnormalised, m in log2 units, l) per
//    query head to part[(b·KV + kv)·cap + s], fences, and counts itself
//    with atomicInc on counts[kDoneSlot0 + b·KV + kv], which wraps back to
//    0 at the row's last split: so the counts are zeroed once, when made.
//    The split that sees the count reach ns - 1 merges all ns partials in
//    split order, so the output bits do not depend on which split finished
//    first (nor on P). ns == 1 writes the output directly.
// 3. A pipeline of 64-slot KV blocks. A stage holds one block's K and V
//    rows of the kv head, copied with 16-byte cp.async (int8 pools: their
//    per-slot scales with 4-byte copies); each thread reads the page ids
//    its copies need from the table row as the walk goes (rbg::PageMap:
//    table[slot / page] at offset slot % page, a shift for a power-of-two
//    page size, a division otherwise), so a block may span parts of pages
//    of any size or lie inside one page, and a row of any length the table
//    holds works. kStages blocks are in flight (3 for
//    bf16 pools, 4 for int8 pools' half-size stages, 2 for f32 queries).
//    Slots past the row's last page repeat it: masked, but finite. Only a
//    split's last block can reach past len, and only it masks.
//
// bf16 queries (the served dtype): four warps; warp w takes slots
// 16w .. 16w + 15 of every KV block. Q's G rows, padded to 16 with zeros,
// are read once from device memory into mma A fragments. Each block is
// kernel B's per-block step rk::mma_block (ragged_paged.cuh) on one 16-row
// group: S = Q·Kᵀ on mma.sync m16n8k16 with K through ldmatrix, the online
// softmax on the S fragments in registers (quad shuffles), O += P·V with P
// as bf16 hi + lo parts and V through ldmatrix.trans, f32 accumulators.
// The four warps' states merge in shared memory after the walk; the
// padded rows are never written. int8 pools: each stage is converted to
// bf16 in shared memory (exact for int8) before ldmatrix; the k scale
// multiplies score column j and the v scale p_j before P·V while the
// denominator keeps p. No page is dequantized into device memory.
//
// float32 queries (tests, `tiny`): the same items, splits, merge and
// staging, with f32 FMAs on CUDA cores and no TF32: each thread scores one
// slot against eight query rows (eight independent accumulators, q read as
// float4 broadcasts from shared memory) and accumulates hd / 8 (row,
// column) outputs in registers.

#pragma once

#include <type_traits>

#include "mma_common.cuh"
#include "paged_attn_common.cuh"
#include "ragged_paged.cuh"

namespace {

namespace pd {

constexpr int kBN = rk::kBN;          // KV slots per pipeline step
constexpr int kThreads = 128;         // four warps
constexpr int kRows = 16;             // query rows of an item: G <= 16, padded
constexpr int kMinSplitBlocks = 2;    // a split per two KV blocks of a row, at most
constexpr int kMaxSplits = 16;        // the largest cap the wrapper passes
// The int32 counts: slots 1, 2 the last launch's work items and grid, then
// one finished-split count per (row, kv head). Slot 0 is kernel B's.
constexpr int kItemsSlot = 1, kGridSlot = 2, kDoneSlot0 = 3;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ int splits_of(int nkb, int cap) {
  return max(1, min(cap, (nkb + kMinSplitBlocks - 1) / kMinSplitBlocks));
}

// Dynamic shared memory of one block, in bytes from its start: the staged
// K, V tiles (of every stage for model-dtype pools; the converted pair for
// int8 pools, whose raw stages and scales follow), then, for f32 queries,
// Q, the scores and the softmax state. After the walk the stages hold the
// warps' merge.
template <typename T, typename KVT, int HD>
struct Layout {
  static constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStages = kMma ? (kQuant ? 4 : 3) : 2;
  static constexpr int LD = HD + 16 / (int)sizeof(T);      // staged row, elements
  static constexpr int kTile = kBN * LD * (int)sizeof(T);  // one staged K or V block
  static constexpr int kRaw = kBN * HD;                    // one int8 K or V block
  static constexpr int kRawOff = (kQuant ? 2 : 2 * kStages) * kTile;
  // int8 pools: K, V of every stage, then the scales: k, v of every stage,
  // then the current block's k, v.
  static constexpr int kScaleOff = kRawOff + (kQuant ? 2 * kStages * kRaw : 0);
  static constexpr int kQOff = kScaleOff + (kQuant ? (2 * kStages + 2) * kBN * 4 : 0);
  // f32 queries: Q [kRows, HD], S / P [kRows, kSLd], m, l, alpha [kRows].
  static constexpr int kSLd = kBN + 1;
  static constexpr int kBytes = kQOff + (kMma ? 0 : (kRows * (HD + kSLd) + 3 * kRows) * 4);
  static constexpr int kCLd = HD + 4;  // a partial row: o, then m, l
  static_assert(!kMma || 4 * kRows * kCLd * 4 <= kQOff, "the warps' merge fits the stages");
  static_assert(!kMma || LD == rk::Layout<T, KVT, HD>::LD, "rk::mma_block's row stride");
};

// Copy KV block nb (walk slots nb·kBN ..) of kv head kv into stage st.
template <typename T, typename KVT, int HD>
__device__ __forceinline__ void issue_block(unsigned char* sm, int st, int nb,
                                            const KVT* k_pages, const KVT* v_pages,
                                            const float* k_scales, const float* v_scales,
                                            const rbg::PageMap& pmap, int kv, int KV) {
  using L = Layout<T, KVT, HD>;
  constexpr int CPR = HD * (int)sizeof(KVT) / 16;  // 16-byte chunks per row
  constexpr int N = kBN * CPR / kThreads;          // chunks of K (and of V) per thread
  static_assert(N * kThreads == kBN * CPR, "whole chunks per thread");
  constexpr int ld = L::kQuant ? HD : L::LD * (int)sizeof(T);
  unsigned char* kd = L::kQuant ? sm + L::kRawOff + 2 * st * L::kRaw : sm + 2 * st * L::kTile;
  unsigned char* vd = kd + (L::kQuant ? L::kRaw : L::kTile);
  long src[N];
  auto sources = [&](auto pow2) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = threadIdx.x + i * kThreads;
      src[i] = (pmap.template slot_in<decltype(pow2)::value>(nb * kBN + c / CPR) * KV + kv) * HD
                   * (long)sizeof(KVT)
               + (c % CPR) * 16;
    }
  };
  if (pmap.pshift >= 0)
    sources(std::true_type{});
  else
    sources(std::false_type{});
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = threadIdx.x + i * kThreads, off = (c / CPR) * ld + (c % CPR) * 16;
    rbg::cp_async16(kd + off, reinterpret_cast<const unsigned char*>(k_pages) + src[i]);
    rbg::cp_async16(vd + off, reinterpret_cast<const unsigned char*>(v_pages) + src[i]);
  }
  if constexpr (L::kQuant) {
    float* ks = reinterpret_cast<float*>(sm + L::kScaleOff) + 2 * st * kBN;
    const int r = threadIdx.x;
    if (r < kBN) {
      const long i = pmap.slot(nb * kBN + r) * KV + kv;
      rbg::cp_async4(ks + r, k_scales + i);
      rbg::cp_async4(ks + kBN + r, v_scales + i);
    }
  }
}

// int8 pools: stage st's K and V as T in the converted tiles, its scales
// as the current block's.
template <typename T, int HD>
__device__ __forceinline__ void convert_block(unsigned char* sm, int st) {
  using L = Layout<T, int8_t, HD>;
  constexpr int CPR = HD / 16;
  for (int c = threadIdx.x; c < 2 * kBN * CPR; c += kThreads) {
    const int m = c / (kBN * CPR), rc = c % (kBN * CPR);  // m: 0 = K, 1 = V
    const int r = rc / CPR, ch = rc % CPR;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        sm + L::kRawOff + (2 * st + m) * L::kRaw + r * HD + ch * 16);
    rk::store_i8x16(reinterpret_cast<T*>(sm + m * L::kTile) + r * L::LD + ch * 16, raw);
  }
  const float* raw_s = reinterpret_cast<const float*>(sm + L::kScaleOff) + 2 * st * kBN;
  float* cur = reinterpret_cast<float*>(sm + L::kScaleOff) + 2 * L::kStages * kBN;
  for (int i = threadIdx.x; i < 2 * kBN; i += kThreads) cur[i] = raw_s[i];
}

// ---- float32 queries: one KV block on CUDA cores ----
// o: this thread's outputs, column tid % HD of rows tid / HD + i·(128 / HD).
template <typename KVT, int HD>
__device__ __forceinline__ void fma_block(unsigned char* sm, float (&o)[HD / 8], int nb,
                                          bool masked, int len, const float* sk,
                                          const float* sv, const float* ks, const float* vs,
                                          float scale) {
  using L = Layout<float, KVT, HD>;
  constexpr int LD = L::LD, SLD = L::kSLd, RS = kThreads / HD;
  const int tid = threadIdx.x;
  const float* sq = reinterpret_cast<const float*>(sm + L::kQOff);
  float* ss = reinterpret_cast<float*>(sm + L::kQOff) + kRows * HD;
  float* sm_ = ss + kRows * SLD;
  float* sl = sm_ + kRows;
  float* sa = sl + kRows;
  // S: thread (rh, j) scores slot j against rows rh, rh + 2, .., rh + 14.
  {
    const int j = tid % kBN, rh = tid / kBN;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(sk + j * LD + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(sq + (rh + 2 * i) * HD + d);
        acc[i] = fmaf(q4.x, k4.x, acc[i]);
        acc[i] = fmaf(q4.y, k4.y, acc[i]);
        acc[i] = fmaf(q4.z, k4.z, acc[i]);
        acc[i] = fmaf(q4.w, k4.w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float x = acc[i] * scale;
      if constexpr (L::kQuant) x *= ks[j];
      if (masked && nb * kBN + j >= len) x = rbg::kNegInf;
      ss[(rh + 2 * i) * SLD + j] = x;
    }
  }
  __syncthreads();
  // Softmax step: eight threads (one warp's eight lanes) per query row.
  {
    const int r = tid >> 3, part = tid & 7;
    float* sr = ss + r * SLD;
    float mx = rbg::kNegInf;
    for (int c = part; c < kBN; c += 8) mx = fmaxf(mx, sr[c]);
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float m_old = sm_[r], m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = part; c < kBN; c += 8) {
      const float p = sr[c] > rbg::kNegInf ? expf(sr[c] - m_new) : 0.f;
      sum += p;
      sr[c] = L::kQuant ? p * vs[c] : p;
    }
#pragma unroll
    for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (part == 0) {
      const float alpha = expf(m_old - m_new);
      sm_[r] = m_new;
      sl[r] = sl[r] * alpha + sum;
      sa[r] = alpha;
    }
  }
  __syncthreads();
  // O += P · V.
  const int c = tid % HD, r0 = tid / HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i] *= sa[r0 + i * RS];
#pragma unroll 4
  for (int j = 0; j < kBN; ++j) {
    const float v = sv[j * LD + c];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) o[i] = fmaf(ss[(r0 + i * RS) * SLD + j], v, o[i]);
  }
}

// T: q and output element type; KVT: pool element type (T, or int8_t with
// f32 scales [NP, page, KV, 1]); HD: head dim (32, 64 or 128). Two blocks
// per SM is the register target (the bf16 hd-128 stages fit two per SM):
// without it ptxas spills to fit three.
template <typename T, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const T* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ table,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counts, int B, int KV, int G,
                    int page, int pshift, int P, int cap, float scale) {
  using L = Layout<T, KVT, HD>;
  constexpr int S = L::kStages, CLD = L::kCLd;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_last;
  const int tid = threadIdx.x, bkv = blockIdx.x, split = blockIdx.y;
  const int b = bkv / KV, kv = bkv % KV, cap_slots = P * page;

  if (bkv == 0 && split == 0 && tid < 32) {  // the launch's report
    int n = 0;
    for (int r = tid; r < B; r += 32) {
      const int len = min(kv_lens[r], cap_slots);
      if (len > 0) n += splits_of((len + kBN - 1) / kBN, cap);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (tid == 0) {
      counts[kItemsSlot] = n * KV;
      counts[kGridSlot] = (int)(gridDim.x * gridDim.y);
    }
  }

  // Head h = kv * G + g of row b: q and out [B, 1, H, hd] read as [B·KV, G, hd].
  T* dst = out + (long)bkv * G * HD;
  const int len = min(kv_lens[b], cap_slots);
  if (len <= 0) {
    if (split == 0)
      for (int c = tid; c < G * HD * (int)sizeof(T) / 16; c += kThreads)
        reinterpret_cast<uint4*>(dst)[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int nkb = (len + kBN - 1) / kBN, ns = splits_of(nkb, cap);
  if (split >= ns) return;
  const int kb0 = split * nkb / ns, nblk = (split + 1) * nkb / ns - kb0;
  rbg::PageMap pmap{table + (long)b * P, 0, page, pshift};
  pmap.last = pmap.last_of(len);
  auto issue = [&](int st, int i) {
    issue_block<T, KVT, HD>(sm, st, kb0 + i, k_pages, v_pages, k_scales, v_scales, pmap, kv,
                            KV);
  };
#pragma unroll
  for (int st = 0; st < S; ++st) {
    if (st < nblk) issue(st, st);
    rbg::cp_async_commit();
  }

  const float* ks = reinterpret_cast<const float*>(sm + L::kScaleOff) + 2 * S * kBN;
  const float* vs = ks + kBN;
  // Wait for step i's stage; int8 pools convert it into the shared tiles
  // and refill it at once. Returns K's tile; V's follows it.
  auto take = [&](int i) -> const T* {
    const int stg = i % S;
    rbg::cp_async_wait<S - 1>();
    __syncthreads();
    if constexpr (L::kQuant) {
      convert_block<T, HD>(sm, stg);
      __syncthreads();
      if (i + S < nblk) issue(stg, i + S);
      rbg::cp_async_commit();
      return reinterpret_cast<const T*>(sm);
    } else {
      return reinterpret_cast<const T*>(sm + 2 * stg * L::kTile);
    }
  };
  // After step i: model-dtype pools refill the stage just read.
  auto refill = [&](int i) {
    __syncthreads();
    if constexpr (!L::kQuant) {
      if (i + S < nblk) issue(i % S, i + S);
      rbg::cp_async_commit();
    }
  };
  // The split's result for query row r < G, column c: out when the row's
  // walk is one split, else a partial of the merge.
  auto finish = [&](int r, int c, float o, float m, float l) {
    if (ns == 1) {
      dst[r * HD + c] = rbg::from_f32<T>(o / fmaxf(l, 1e-30f));
    } else {
      float* mine = part + (((long)bkv * cap + split) * G + r) * CLD;
      mine[c] = o;
      if (c == 0) *reinterpret_cast<float2*>(mine + HD) = make_float2(m, l);
    }
  };
  const T* qb = q + (long)bkv * G * HD;

  if constexpr (L::kMma) {
    rk::MmaState<HD> st;
    const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    // A fragments of Q rows gid and gid + 8 (zero past G), from device memory.
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = gid + 8 * (j & 1), c = kk * 16 + 2 * tig + 8 * (j >> 1);
        st.qa[kk][j] = r < G ? *reinterpret_cast<const uint32_t*>(qb + r * HD + c) : 0u;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      st.m[h] = rbg::kNegInf;
      st.l[h] = 0.f;
      st.lim[h] = len;
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
    const float sl2 = scale * rk::kLog2e;
    for (int i = 0; i < nblk; ++i) {
      const __nv_bfloat16* sk = take(i);
      const int nb = kb0 + i;
      rk::mma_block<KVT, HD, kBN / 4>(st, nb, warp * (kBN / 4), (nb + 1) * kBN > len, sk,
                                      sk + L::kTile / (int)sizeof(T), ks, vs, sl2);
      refill(i);
    }
    rbg::cp_async_wait<0>();
    __syncthreads();
    // Merge the four warps through shared memory (the stages are free
    // now): per warp and row, o then m and l (quad sums of l).
    float* cb = reinterpret_cast<float*>(sm);
    float* wb = cb + warp * kRows * CLD;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float l = st.l[h];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      float* rb = wb + (gid + 8 * h) * CLD;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        *reinterpret_cast<float2*>(rb + dt * 8 + tig * 2) =
            make_float2(st.o[dt][2 * h], st.o[dt][2 * h + 1]);
      if (tig == 0) {
        rb[HD] = st.m[h];
        rb[HD + 1] = l;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      const int r = i / HD, c = i % HD;
      const float* rb = cb + r * CLD;
      float m = rbg::kNegInf;
#pragma unroll
      for (int w = 0; w < 4; ++w) m = fmaxf(m, rb[w * kRows * CLD + HD]);
      float l = 0.f, o = 0.f;
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const float* wr = rb + w * kRows * CLD;
        const float x = exp2f(wr[HD] - m);  // 0 for a warp that saw no slot
        l = fmaf(x, wr[HD + 1], l);
        o = fmaf(x, wr[c], o);
      }
      finish(r, c, o, m, l);
    }
  } else {
    float* sq = reinterpret_cast<float*>(sm + L::kQOff);
    float* sm_ = sq + kRows * (HD + L::kSLd);
    float* sl = sm_ + kRows;
    for (int i = tid; i < kRows * HD; i += kThreads) sq[i] = i < G * HD ? rbg::to_f32(qb[i]) : 0.f;
    for (int r = tid; r < kRows; r += kThreads) {
      sm_[r] = rbg::kNegInf;
      sl[r] = 0.f;
    }
    float o[HD / 8];
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) o[i] = 0.f;
    for (int i = 0; i < nblk; ++i) {
      const float* sk = take(i);
      const int nb = kb0 + i;
      fma_block<KVT, HD>(sm, o, nb, (nb + 1) * kBN > len, len, sk, sk + L::kTile / 4, ks, vs,
                         scale);
      refill(i);
    }
    rbg::cp_async_wait<0>();
    const int c = tid % HD, r0 = tid / HD;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      const int r = r0 + i * (kThreads / HD);
      if (r < G) finish(r, c, o[i], sm_[r] * rk::kLog2e, sl[r]);
    }
  }

  // Several splits: the last to finish merges every split's partial, in
  // split order (its atomicInc wraps the count back to 0).
  if (ns > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicInc(reinterpret_cast<unsigned*>(counts) + kDoneSlot0 + bkv,
                         (unsigned)(ns - 1)) == (unsigned)(ns - 1);
    __syncthreads();
    if (s_last) {
      __threadfence();
      const float* all = part + (long)bkv * cap * G * CLD;
      for (int i = tid; i < G * (HD / 4); i += kThreads) {
        const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
        float m = rbg::kNegInf;
        for (int s = 0; s < ns; ++s) m = fmaxf(m, __ldcg(all + (s * G + r) * CLD + HD));
        float l = 0.f;
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int s = 0; s < ns; ++s) {
          const float* p = all + (s * G + r) * CLD;
          const float2 ml = __ldcg(reinterpret_cast<const float2*>(p + HD));
          const float4 v = __ldcg(reinterpret_cast<const float4*>(p + c));
          const float w = exp2f(ml.x - m);
          l = fmaf(w, ml.y, l);
          a.x = fmaf(w, v.x, a.x);
          a.y = fmaf(w, v.y, a.y);
          a.z = fmaf(w, v.z, a.z);
          a.w = fmaf(w, v.w, a.w);
        }
        const float inv = 1.f / fmaxf(l, 1e-30f);
        rbg::store4(dst + r * HD + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
      }
    }
  }
}

template <typename T, typename KVT, int HD>
int launch_hd(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
              const void* v_scales, const void* table, const void* kv_lens, void* out,
              void* part, void* counts, int B, int KV, int G, int page, int P, int cap,
              float scale, int dev, cudaStream_t stream) {
  using L = Layout<T, KVT, HD>;
  // The shared-memory attribute, once per device (set even under 48 KB:
  // the static flag adds to the dynamic plan).
  static bool ready[kMaxDevices];
  if (!ready[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, KVT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const long nkb = ((long)P * page + kBN - 1) / kBN;
  const int gy = (int)max(1L, min((long)cap, (nkb + kMinSplitBlocks - 1) / kMinSplitBlocks));
  paged_decode_kernel<T, KVT, HD><<<dim3(B * KV, gy), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(counts), B, KV, G, page, rbg::page_shift(page), P, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace pd

// The shapes the kernel takes (the wrapper refuses others first, with a
// ValueError): hd 32, 64 or 128, 1 <= G <= 16, any page size,
// 1 <= cap <= pd::kMaxSplits. part: float32 scratch of B * KV * cap * G *
// (hd + 4); counts: int32 of pd::kDoneSlot0 + B * KV, zero when first used.
// The launch goes to device `dev` (q's, whose stream `stream` is); the
// calling thread's current device is left as it was.
template <typename T, typename KVT>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales, const void* table,
                  const void* kv_lens, void* out, void* part, void* counts, int B, int KV,
                  int G, int hd, int page, int P, int cap, float scale, int dev,
                  cudaStream_t stream) {
  if (B == 0) return 0;
  if (G < 1 || G > pd::kRows || page < 1 || cap < 1 ||
      cap > pd::kMaxSplits || dev < 0 || dev >= pd::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  int rc = (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      rc = pd::launch_hd<T, KVT, 32>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                     out, part, counts, B, KV, G, page, P, cap, scale, dev,
                                     stream);
      break;
    case 64:
      rc = pd::launch_hd<T, KVT, 64>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                     out, part, counts, B, KV, G, page, P, cap, scale, dev,
                                     stream);
      break;
    case 128:
      rc = pd::launch_hd<T, KVT, 128>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                      out, part, counts, B, KV, G, page, P, cap, scale, dev,
                                      stream);
      break;
  }
  if (cur != dev) cudaSetDevice(cur);
  return rc;
}

}  // namespace
