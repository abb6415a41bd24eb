// MLA latent decode attention (T == 1) for Hopper: the kernel body shared
// by paged_mla_decode.cu (model-dtype latent pools, kernel E) and
// paged_mla_decode_q.cu (int8 latent pools, kernel G). They replace the TPU
// kernels rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas` and `paged_mla_attention_pallas_q`
// (`_mla_decode_kernel`).
//
// Absorbed-form multi-head latent attention over the paged latent pools c
// [NP, page, 1, dc] and pe [NP, page, 1, dr]. Head h of row b scores slot i
// as (q_lat[h]·c[i]·cs[i] + q_pe[h]·pe[i]·ps[i])·scale, where the f32
// scales cs, ps [NP, page, 1, 1] exist for int8 pools only; the values are
// the latents c, for int8 pools with the probabilities times cs while the
// denominator keeps p. Online softmax in f32; the output is
// acc / max(l, 1e-30) in latent space [B, 1, H, dc]; a row with kv_len 0
// gives 0. Any page size and any table width P.
//
// Bound: bytes. The latent cache is MQA-shaped (one [c | pe] row per slot
// for every head), so a decode step reads each live slot's (dc + dr)·2 B
// (int8: (dc + dr) B and 8 B of scales) once for ~4·H·dc flops, under the
// card's ~295 flop/byte for H <= 64. What holds a decode kernel back is
// its serial path: one block per row (8 at B = 8 on deepseek-v2-lite)
// walking the whole row one page at a time, with CUDA-core dot products,
// leaves most SMs idle. This design cuts it as kernels A and C do
// (paged_decode.cuh):
//
// 1. Work items (row b, group of kRows = 16 heads, split s). 16 heads fill
//    one m16 tile; a group of fewer (H < 16, or the last group) has zero
//    query rows that are never written. A row's walk of nkb = ceil(len /
//    kBN) latent blocks splits into
//      ns(b) = min(cap, ceil(nkb / kMinSplitBlocks))
//    contiguous ranges, split s taking blocks [s·nkb/ns, (s+1)·nkb/ns),
//    where the wrapper's cap = min(kMaxSplits, SMs / (B·groups)) comes
//    from the launch's sizes and the blocks the card holds at once (one per
//    SM), never from P. The grid is (B·groups, min(cap, ceil(ceil(P·page /
//    kBN) / kMinSplitBlocks))); a block whose s >= ns(b) returns at once.
//    Block (0, 0) writes the launch's items and grid size into the counts
//    (kItemsSlot, kGridSlot), where launch_report reads them.
// 2. The merge, on the card, in split order. A split of a row with ns > 1
//    writes its partial (o unnormalised, m in log2 units, l) per head to
//    part[((b·groups + g)·cap + s)·16 + r], fences, and counts itself with
//    atomicInc on counts[kDoneSlot0 + b·groups + g], which wraps back to 0
//    at the last split (no memset). The split that sees the count reach
//    ns - 1 merges all ns partials in split order, so the output bits
//    depend neither on which split finished first nor on P.
// 3. Staging. A stage is one block of kBN = 32 slots: its c rows and pe
//    rows, copied with 16-byte cp.async: four stages (three blocks in
//    flight during a step) for bf16 queries and for int8 pools' raw
//    stages, two for f32 queries over f32 pools. Each slot's page id comes
//    from the table row (rbg::PageMap: a shift when the page size is a
//    power of two, a division otherwise), so blocks span pages of any size.
//    int8 pools stage the raw bytes (and the two scales per slot) and
//    convert each block into one tile of the query's type in shared memory,
//    which is exact (issue_block and convert_block also stage kernels F
//    and H, ragged_paged_mla.cuh). One 32-slot bf16 [c | pe] block at deepseek widths is 37 KB;
//    E's bf16 plan holds 162 KB, G's 134 KB, the f32 plans 185 KB: one
//    block per SM (__launch_bounds__(128, 1)).
// 4. bf16 queries (the served dtype): four warps, products on the tensor
//    cores (mma.sync m16n8k16, f32 accumulators). O is [16, dc] in f32, 256
//    registers a thread for one warp, so the warps split the columns:
//    warp w scores its quarter of the dc columns (and every fourth 16-wide
//    slice of dr) for all 32 slots, S_c = q_lat·cᵀ and S_pe = q_pe·peᵀ
//    (two fragment sets for int8 pools, one for model-dtype pools), its Q
//    slices held as A fragments for the whole walk; the four partial score
//    tiles are summed in shared memory in warp order, where one pass takes
//    s = (S_c·cs + S_pe·ps)·scale (the reference's algebra), the mask and
//    the online softmax, and writes P as bf16 hi + lo parts (kernel B's
//    rounding fix); then warp w adds P·c for its quarter of the dc columns
//    (64 accumulators a thread at dc = 512), reading the same staged c
//    rows through ldmatrix.trans. Scoring the whole block in every warp
//    would take four times the S products and 144 Q registers. ptxas
//    (sm_90a) at (512, 64): 202 registers with bf16 pools, 182 with int8
//    pools, 0 spills.
// 5. f32 queries (tests, tiny-mla): the same items, splits, merge and
//    staging with f32 FMAs on CUDA cores and no TF32: each thread scores
//    one slot against four heads with independent accumulators (q read as
//    float4 broadcasts from shared memory), eight threads per head take
//    the softmax, and each thread accumulates 64 (head, column) outputs.

#pragma once

#include <type_traits>

#include "mma_common.cuh"
#include "paged_attn_common.cuh"
#include "ragged_paged.cuh"

namespace {

namespace pm {

constexpr int kBN = 32;               // latent slots per pipeline step
constexpr int kThreads = 128;         // four warps
constexpr int kRows = 16;             // heads of an item: one m16 tile, padded
constexpr int kMinSplitBlocks = 2;    // a split per two latent blocks of a row, at most
constexpr int kMaxSplits = 16;        // the largest cap the wrapper passes
// The int32 counts (shared with kernels A-D): slots 1, 2 the last launch's
// work items and grid, then one finished-split count per (row, head group).
constexpr int kItemsSlot = 1, kGridSlot = 2, kDoneSlot0 = 3;
constexpr int kMaxDevices = 16;

__device__ __forceinline__ int splits_of(int nkb, int cap) {
  return max(1, min(cap, (nkb + kMinSplitBlocks - 1) / kMinSplitBlocks));
}

// Dynamic shared memory of one block, in bytes from its start: the staged
// [c | pe] tiles (every stage for model-dtype pools; the converted one for
// int8 pools, whose raw stages and scales follow), then the work area (bf16:
// the warps' partial scores and P's hi and lo parts; f32: Q and the
// scores), then per head the softmax's alpha, m and l and the merge's
// weights.
template <typename T, typename KVT, int DC, int DR>
struct Layout {
  static constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kStages = (kMma || kQuant) ? 4 : 2;
  static constexpr int E = (int)sizeof(T);
  static constexpr int LDC = DC + 16 / E, LDP = DR + 16 / E;  // staged rows, elements
  static constexpr int kCTile = kBN * LDC * E, kTile = kCTile + kBN * LDP * E;
  static constexpr int kRawC = kBN * DC, kRaw = kRawC + kBN * DR;  // one int8 block
  static constexpr int kRawOff = (kQuant ? 1 : kStages) * kTile;
  static constexpr int kScaleOff = kRawOff + (kQuant ? kStages * kRaw : 0);
  static constexpr int kWorkOff = kScaleOff + (kQuant ? kStages * 2 * kBN * 4 : 0);
  static constexpr int kSets = kQuant ? 2 : 1;            // S_c, S_pe apart for int8 pools
  static constexpr int kRLd = kBN + 8, kPLd = kBN + 8;    // partial-score, P rows
  static constexpr int kRedBytes = 4 * kSets * kRows * kRLd * 4;
  static constexpr int kDQ = DC + DR, kSLd = kBN + 1;     // f32: Q rows, score rows
  static constexpr int kStateOff =
      kWorkOff + (kMma ? kRedBytes + 2 * kRows * kPLd * 2 : kRows * (kDQ + kSLd) * 4);
  static constexpr int kBytes = kStateOff + (4 * kRows + kRows * kMaxSplits) * 4;
  static constexpr int kThreads = pm::kThreads;
  static_assert(DC % 64 == 0 && DR % 16 == 0, "dc splits over four warps in 16-wide k steps");
  static_assert(kThreads == 4 * kBN, "four threads stage each slot");
};

// Copy latent block nb (walk slots nb·kBN ..) into stage st of layout L
// (E and G's, or F and H's in ragged_paged_mla.cuh): each slot row is
// L::kThreads / kBN threads' share of 16-byte chunks of c and of pe (int8
// pools: and the slot's two scales).
template <typename L, typename KVT, int DC, int DR>
__device__ __forceinline__ void issue_block(unsigned char* sm, int st, int nb, const KVT* c_pages,
                                            const KVT* pe_pages, const float* c_scales,
                                            const float* pe_scales, const rbg::PageMap& pmap) {
  constexpr int TPR = L::kThreads / kBN;
  constexpr int CC = DC * (int)sizeof(KVT) / 16, CP = DR * (int)sizeof(KVT) / 16;
  const int r = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const long slot = pmap.slot(nb * kBN + r);
  unsigned char* cd;
  unsigned char* pd;
  int ldc, ldp;  // bytes
  if constexpr (L::kQuant) {
    cd = sm + L::kRawOff + st * L::kRaw;
    pd = cd + L::kRawC;
    ldc = DC;
    ldp = DR;
  } else {
    cd = sm + st * L::kTile;
    pd = cd + L::kCTile;
    ldc = L::LDC * L::E;
    ldp = L::LDP * L::E;
  }
  const unsigned char* cs =
      reinterpret_cast<const unsigned char*>(c_pages) + slot * DC * (long)sizeof(KVT);
  const unsigned char* ps =
      reinterpret_cast<const unsigned char*>(pe_pages) + slot * DR * (long)sizeof(KVT);
#pragma unroll
  for (int j = 0; j < (CC + TPR - 1) / TPR; ++j) {
    const int ch = part + j * TPR;
    if (CC % TPR == 0 || ch < CC) rbg::cp_async16(cd + r * ldc + ch * 16, cs + ch * 16);
  }
#pragma unroll
  for (int j = 0; j < (CP + TPR - 1) / TPR; ++j) {
    const int ch = part + j * TPR;
    if (CP % TPR == 0 || ch < CP) rbg::cp_async16(pd + r * ldp + ch * 16, ps + ch * 16);
  }
  if constexpr (L::kQuant) {
    float* sc = reinterpret_cast<float*>(sm + L::kScaleOff) + st * 2 * kBN;
    if (part == 0) rbg::cp_async4(sc + r, c_scales + slot);
    if (part == 1) rbg::cp_async4(sc + kBN + r, pe_scales + slot);
  }
}

// int8 pools: raw stage st of layout L's c and pe rows as T in the
// converted tile.
template <typename L, typename T, int DC, int DR>
__device__ __forceinline__ void convert_block(unsigned char* sm, int st) {
  constexpr int CC = DC / 16, CP = DR / 16;
  const unsigned char* raw = sm + L::kRawOff + st * L::kRaw;
  T* tc = reinterpret_cast<T*>(sm);
  T* tp = reinterpret_cast<T*>(sm + L::kCTile);
  for (int c = threadIdx.x; c < kBN * (CC + CP); c += L::kThreads) {
    if (c < kBN * CC) {
      const int r = c / CC, ch = c % CC;
      rk::store_i8x16(tc + r * L::LDC + ch * 16,
                      *reinterpret_cast<const uint4*>(raw + r * DC + ch * 16));
    } else {
      const int i = c - kBN * CC, r = i / CP, ch = i % CP;
      rk::store_i8x16(tp + r * L::LDP + ch * 16,
                      *reinterpret_cast<const uint4*>(raw + L::kRawC + r * DR + ch * 16));
    }
  }
}

// One softmax step of row r = threadIdx.x / 8 over slots q4 .. q4 + 3 of
// latent block nb from its scores s (log2 units); slots at or past the
// row's limit lim get p = 0 when the block is masked. The row's running
// max and sum (m_run, l_run) are kept alike by its eight threads; alpha, m
// and l go to s_alpha, s_m, s_l[r]. Returns p in s (times cs for int8
// pools, whose denominator keeps p).
template <bool kQuant>
__device__ __forceinline__ void softmax4(float (&s)[4], int nb, bool masked, int q4, int lim,
                                         const float* cs, float& m_run, float& l_run,
                                         float* s_alpha, float* s_m, float* s_l) {
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (masked && nb * kBN + q4 + e >= lim) s[e] = rbg::kNegInf;
  float mx = fmaxf(fmaxf(s[0], s[1]), fmaxf(s[2], s[3]));
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_new = fmaxf(m_run, mx), alpha = exp2f(m_run - m_new);
  float sum = 0.f;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float p = (!masked || s[e] > rbg::kNegInf) ? exp2f(s[e] - m_new) : 0.f;
    sum += p;
    s[e] = kQuant ? p * cs[q4 + e] : p;
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  m_run = m_new;
  l_run = l_run * alpha + sum;
  if ((threadIdx.x & 7) == 0) {
    const int r = threadIdx.x >> 3;
    s_alpha[r] = alpha;
    s_m[r] = m_run;
    s_l[r] = l_run;
  }
}

// f32 queries (kernels E and F): one latent block staged by layout L on
// CUDA cores for kRows query rows whose [q_lat | q_pe] rows (stride LDQ)
// are f32 in shared memory at sq. S: thread (warp w, lane j) scores slot j
// against rows 4w .. 4w + 3 (two accumulators per row for c, one for pe)
// into ss [kRows][L::kSLd], scaled (int8 pools: s = (S_c·cs + S_pe·ps)·
// scale); the softmax step of row threadIdx.x / 8 (limit lim) turns the
// scores into P; O += P · c, thread (r0, cq) owning rows r0 + RS·i and
// columns 4cq .. 4cq + 3. Synchronises the block between the steps.
template <typename L, int DC, int DR, int LDQ>
__device__ __forceinline__ void fma_block(float (&o)[kRows * DC / 4 / kThreads][4],
                                          const float* tc, const float* tp, const float* sq,
                                          float* ss, const float* cs, float sl2, int nb,
                                          bool masked, int lim, float& m_run, float& l_run,
                                          float* s_alpha, float* s_m, float* s_l) {
  constexpr int SLD = L::kSLd, CQ = DC / 4, RS = kThreads / CQ;
  const int tid = threadIdx.x;
  {
    const int j = tid & 31, rg = (tid >> 5) * 4;
    float ac[4][2], ap[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) ac[r][0] = ac[r][1] = ap[r] = 0.f;
#pragma unroll 2
    for (int d = 0; d < DC; d += 8) {
      const float4 k0 = *reinterpret_cast<const float4*>(tc + j * L::LDC + d);
      const float4 k1 = *reinterpret_cast<const float4*>(tc + j * L::LDC + d + 4);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sq + (rg + r) * LDQ + d);
        const float4 y = *reinterpret_cast<const float4*>(sq + (rg + r) * LDQ + d + 4);
        ac[r][0] = fmaf(x.x, k0.x, ac[r][0]);
        ac[r][0] = fmaf(x.y, k0.y, ac[r][0]);
        ac[r][0] = fmaf(x.z, k0.z, ac[r][0]);
        ac[r][0] = fmaf(x.w, k0.w, ac[r][0]);
        ac[r][1] = fmaf(y.x, k1.x, ac[r][1]);
        ac[r][1] = fmaf(y.y, k1.y, ac[r][1]);
        ac[r][1] = fmaf(y.z, k1.z, ac[r][1]);
        ac[r][1] = fmaf(y.w, k1.w, ac[r][1]);
      }
    }
#pragma unroll
    for (int d = 0; d < DR; d += 4) {
      const float4 k = *reinterpret_cast<const float4*>(tp + j * L::LDP + d);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(sq + (rg + r) * LDQ + DC + d);
        ap[r] = fmaf(x.x, k.x, ap[r]);
        ap[r] = fmaf(x.y, k.y, ap[r]);
        ap[r] = fmaf(x.z, k.z, ap[r]);
        ap[r] = fmaf(x.w, k.w, ap[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float c = ac[r][0] + ac[r][1];
      ss[(rg + r) * SLD + j] = (L::kQuant ? c * cs[j] + ap[r] * cs[kBN + j] : c + ap[r]) * sl2;
    }
  }
  __syncthreads();
  {
    const int r = tid >> 3, q4 = (tid & 7) * 4;
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) s[e] = ss[r * SLD + q4 + e];
    softmax4<L::kQuant>(s, nb, masked, q4, lim, cs, m_run, l_run, s_alpha, s_m, s_l);
#pragma unroll
    for (int e = 0; e < 4; ++e) ss[r * SLD + q4 + e] = s[e];
  }
  __syncthreads();
  const int cq = tid % CQ, r0 = tid / CQ;
#pragma unroll
  for (int i = 0; i < kRows / RS; ++i) {
    const float a = s_alpha[r0 + RS * i];
    o[i][0] *= a;
    o[i][1] *= a;
    o[i][2] *= a;
    o[i][3] *= a;
  }
#pragma unroll 4
  for (int j = 0; j < kBN; ++j) {
    const float4 v = *reinterpret_cast<const float4*>(tc + j * L::LDC + 4 * cq);
#pragma unroll
    for (int i = 0; i < kRows / RS; ++i) {
      const float p = ss[(r0 + RS * i) * SLD + j];
      o[i][0] = fmaf(p, v.x, o[i][0]);
      o[i][1] = fmaf(p, v.y, o[i][1]);
      o[i][2] = fmaf(p, v.z, o[i][2]);
      o[i][3] = fmaf(p, v.w, o[i][3]);
    }
  }
}

// T: q and output element type; KVT: latent pool element type (T, or int8_t
// with f32 scales [NP, page, 1, 1] for c and for pe). One block per SM.
template <typename T, typename KVT, int DC, int DR>
__global__ void __launch_bounds__(kThreads, 1)
paged_mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                        const KVT* __restrict__ c_pages, const KVT* __restrict__ pe_pages,
                        const float* __restrict__ c_scales, const float* __restrict__ pe_scales,
                        const int* __restrict__ table, const int* __restrict__ kv_lens,
                        T* __restrict__ out, float* __restrict__ part, int* __restrict__ counts,
                        int B, int H, int NG, int page, int pshift, int P, int cap,
                        float scale) {
  using L = Layout<T, KVT, DC, DR>;
  constexpr int S = L::kStages, CLD = DC + 4;  // a partial row: o, then m, l
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_last;
  const int tid = threadIdx.x, item = blockIdx.x, split = blockIdx.y;
  const int b = item / NG, h0 = (item % NG) * kRows, nh = min(kRows, H - h0);
  const int cap_slots = P * page;

  if (item == 0 && split == 0 && tid < 32) {  // the launch's report
    int n = 0;
    for (int r = tid; r < B; r += 32) {
      const int len = min(kv_lens[r], cap_slots);
      if (len > 0) n += splits_of((len + kBN - 1) / kBN, cap);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
    if (tid == 0) {
      counts[kItemsSlot] = n * NG;
      counts[kGridSlot] = (int)(gridDim.x * gridDim.y);
    }
  }

  // Heads h0 + r, r < nh, of row b: q and out rows [b·H + h0 + r].
  T* dst = out + ((long)b * H + h0) * DC;
  const int len = min(kv_lens[b], cap_slots);
  if (len <= 0) {
    if (split == 0)
      for (int c = tid; c < nh * DC * (int)sizeof(T) / 16; c += kThreads)
        reinterpret_cast<uint4*>(dst)[c] = make_uint4(0u, 0u, 0u, 0u);
    return;
  }
  const int nkb = (len + kBN - 1) / kBN, ns = splits_of(nkb, cap);
  if (split >= ns) return;
  const int kb0 = split * nkb / ns, nblk = (split + 1) * nkb / ns - kb0;
  rbg::PageMap pmap{table + (long)b * P, 0, page, pshift};
  pmap.last = pmap.last_of(len);
  auto issue = [&](int i) {  // step i's block into its stage (an empty group past the split)
    if (i < nblk)
      issue_block<L, KVT, DC, DR>(sm, i % S, kb0 + i, c_pages, pe_pages, c_scales, pe_scales,
                                  pmap);
    rbg::cp_async_commit();
  };
#pragma unroll
  for (int i = 0; i < S - 1; ++i) issue(i);
  // Wait for step i's block, then refill the stage step i - 1 used (every
  // thread is past step i - 1 here); int8 pools convert the block into the
  // shared tile. Returns the staged c tile; pe's follows it.
  auto take = [&](int i) -> const T* {
    rbg::cp_async_wait<S - 2>();
    __syncthreads();
    issue(i + S - 1);
    if constexpr (L::kQuant) {
      convert_block<L, T, DC, DR>(sm, i % S);
      __syncthreads();
      return reinterpret_cast<const T*>(sm);
    } else {
      return reinterpret_cast<const T*>(sm + (i % S) * L::kTile);
    }
  };
  // Block i's scales (int8 pools): cs[kBN], then ps[kBN].
  auto scales_of = [&](int i) {
    return reinterpret_cast<const float*>(sm + L::kScaleOff) + (i % S) * 2 * kBN;
  };
  float* s_alpha = reinterpret_cast<float*>(sm + L::kStateOff);
  float* s_m = s_alpha + kRows;
  float* s_l = s_m + kRows;
  float* s_inv = s_l + kRows;
  float* s_w = s_inv + kRows;  // [kRows][kMaxSplits]
  const float sl2 = scale * rk::kLog2e;
  const int qrow0 = b * H + h0;
  // The running max (log2 units) and sum of softmax row r, kept alike by
  // the eight threads that take its softmax.
  float m_run = rbg::kNegInf, l_run = 0.f;
  // The split's result for head r < nh, columns c, c + 1: out when the row's
  // walk is one split, else a partial of the merge (m and l once per row).
  auto finish2 = [&](int r, int c, float o0, float o1, bool ml) {
    if (ns == 1) {
      const float inv = 1.f / fmaxf(s_l[r], 1e-30f);
      if constexpr (L::kMma)
        *reinterpret_cast<__nv_bfloat162*>(dst + r * DC + c) =
            __floats2bfloat162_rn(o0 * inv, o1 * inv);
      else
        *reinterpret_cast<float2*>(dst + r * DC + c) = make_float2(o0 * inv, o1 * inv);
    } else {
      float* mine = part + (((long)item * cap + split) * kRows + r) * CLD;
      *reinterpret_cast<float2*>(mine + c) = make_float2(o0, o1);
      if (ml) *reinterpret_cast<float2*>(mine + DC) = make_float2(s_m[r], s_l[r]);
    }
  };

  if constexpr (L::kMma) {
    constexpr int KC = DC / 64, KP = DR / 16, KPW = (KP + 3) / 4;  // k steps per warp
    constexpr int DCW = DC / 4;                                    // O columns per warp
    const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
    // A fragments of this warp's Q slices: q_lat k steps warp·KC .., q_pe k
    // steps warp, warp + 4, ..; rows gid and gid + 8, zero past nh.
    uint32_t qc[KC][4], qp[KPW][4];
    auto frag = [&](const T* q, int ld, int kk, int j) -> uint32_t {
      const int r = gid + 8 * (j & 1), c = kk * 16 + 2 * tig + 8 * (j >> 1);
      return r < nh ? *reinterpret_cast<const uint32_t*>(q + (long)(qrow0 + r) * ld + c) : 0u;
    };
#pragma unroll
    for (int i = 0; i < KC; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qc[i][j] = frag(q_lat, DC, warp * KC + i, j);
#pragma unroll
    for (int i = 0; i < KPW; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) qp[i][j] = warp + 4 * i < KP ? frag(q_pe, DR, warp + 4 * i, j) : 0u;
    float o[DCW / 8][4];
#pragma unroll
    for (int dt = 0; dt < DCW / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
    float* red = reinterpret_cast<float*>(sm + L::kWorkOff);  // [4][kSets][kRows][kRLd]
    __nv_bfloat16* phi = reinterpret_cast<__nv_bfloat16*>(sm + L::kWorkOff + L::kRedBytes);
    __nv_bfloat16* plo = phi + kRows * L::kPLd;

    for (int i = 0; i < nblk; ++i) {
      const __nv_bfloat16* tc = take(i);
      const __nv_bfloat16* tp = tc + L::kCTile / 2;
      const int nb = kb0 + i;
      const bool masked = (nb + 1) * kBN > len;
      // This warp's partial scores: x4 ldmatrix of c (pe) rows gives the B
      // fragments of slot tiles 2np and 2np + 1 for one k step.
      float sc[kBN / 8][4], sp[kBN / 8][4];
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = sp[nt][e] = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int kk = warp * KC + k;
#pragma unroll
        for (int np = 0; np < kBN / 16; ++np) {
          uint32_t bb[4];
          rbg::ldmatrix_x4(bb, tc + (np * 16 + (lane & 7) + (lane >> 4) * 8) * L::LDC
                                   + kk * 16 + ((lane >> 3) & 1) * 8);
          rbg::mma_bf16(sc[2 * np], qc[k], bb[0], bb[1]);
          rbg::mma_bf16(sc[2 * np + 1], qc[k], bb[2], bb[3]);
        }
      }
#pragma unroll
      for (int k = 0; k < KPW; ++k) {
        const int kk = warp + 4 * k;
        if (kk < KP) {
#pragma unroll
          for (int np = 0; np < kBN / 16; ++np) {
            uint32_t bb[4];
            rbg::ldmatrix_x4(bb, tp + (np * 16 + (lane & 7) + (lane >> 4) * 8) * L::LDP
                                     + kk * 16 + ((lane >> 3) & 1) * 8);
            float(*acc)[4] = L::kQuant ? sp : sc;
            rbg::mma_bf16(acc[2 * np], qp[k], bb[0], bb[1]);
            rbg::mma_bf16(acc[2 * np + 1], qp[k], bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int set = 0; set < L::kSets; ++set) {
        float* rw = red + ((warp * L::kSets + set) * kRows + gid) * L::kRLd;
#pragma unroll
        for (int nt = 0; nt < kBN / 8; ++nt) {
          const float* x = set ? sp[nt] : sc[nt];
          *reinterpret_cast<float2*>(rw + nt * 8 + 2 * tig) = make_float2(x[0], x[1]);
          *reinterpret_cast<float2*>(rw + 8 * L::kRLd + nt * 8 + 2 * tig) =
              make_float2(x[2], x[3]);
        }
      }
      __syncthreads();
      // Scores of row tid / 8, slots q4 .. q4 + 3: the warps' partials summed
      // in warp order, then scaled; the softmax; P as bf16 hi + lo.
      {
        const int r = tid >> 3, q4 = (tid & 7) * 4;
        float s[4] = {0.f, 0.f, 0.f, 0.f}, t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float4 x = *reinterpret_cast<const float4*>(
              red + ((w * L::kSets) * kRows + r) * L::kRLd + q4);
          s[0] += x.x, s[1] += x.y, s[2] += x.z, s[3] += x.w;
          if constexpr (L::kQuant) {
            const float4 y = *reinterpret_cast<const float4*>(
                red + ((w * L::kSets + 1) * kRows + r) * L::kRLd + q4);
            t[0] += y.x, t[1] += y.y, t[2] += y.z, t[3] += y.w;
          }
        }
        const float* cs = scales_of(i);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[e] = (L::kQuant ? s[e] * cs[q4 + e] + t[e] * cs[kBN + q4 + e] : s[e]) * sl2;
        softmax4<L::kQuant>(s, nb, masked, q4, len, cs, m_run, l_run, s_alpha, s_m, s_l);
        uint32_t hi[2], lo[2];
        rbg::split_bf16x2(s[0], s[1], hi[0], lo[0]);
        rbg::split_bf16x2(s[2], s[3], hi[1], lo[1]);
        *reinterpret_cast<uint2*>(phi + r * L::kPLd + q4) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(plo + r * L::kPLd + q4) = make_uint2(lo[0], lo[1]);
      }
      __syncthreads();
      // O[:, warp's columns] = alpha·O + P·c: P's hi and lo parts as A
      // fragments, c through ldmatrix.trans.
      {
        const float a0 = s_alpha[gid], a1 = s_alpha[gid + 8];
#pragma unroll
        for (int dt = 0; dt < DCW / 8; ++dt) {
          o[dt][0] *= a0;
          o[dt][1] *= a0;
          o[dt][2] *= a1;
          o[dt][3] *= a1;
        }
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk) {
          uint32_t ah[4], al[4];
          rbg::ldmatrix_x4(ah, phi + (lane & 15) * L::kPLd + kk * 16 + (lane >> 4) * 8);
          rbg::ldmatrix_x4(al, plo + (lane & 15) * L::kPLd + kk * 16 + (lane >> 4) * 8);
          const __nv_bfloat16* vrow = tc + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L::LDC
                                      + (lane >> 4) * 8 + warp * DCW;
#pragma unroll
          for (int dp = 0; dp < DCW / 16; ++dp) {
            uint32_t v[4];
            rbg::ldmatrix_x4_trans(v, vrow + dp * 16);
            rbg::mma_bf16(o[2 * dp], ah, v[0], v[1]);
            rbg::mma_bf16(o[2 * dp + 1], ah, v[2], v[3]);
            rbg::mma_bf16(o[2 * dp], al, v[0], v[1]);
            rbg::mma_bf16(o[2 * dp + 1], al, v[2], v[3]);
          }
        }
      }
    }
    rbg::cp_async_wait<0>();
    // s_m and s_l hold the last step's values (written before its P·V).
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = gid + 8 * h;
      if (r < nh)
#pragma unroll
        for (int dt = 0; dt < DCW / 8; ++dt)
          finish2(r, warp * DCW + dt * 8 + 2 * tig, o[dt][2 * h], o[dt][2 * h + 1],
                  warp == 0 && dt == 0 && tig == 0);
    }
  } else {
    constexpr int DQ = L::kDQ;
    constexpr int CQ = DC / 4, RS = kThreads / CQ;  // P·V: column quads, row stride
    float* sq = reinterpret_cast<float*>(sm + L::kWorkOff);  // Q [kRows][DQ]
    float* ss = sq + kRows * DQ;                              // S, then P [kRows][SLD]
    for (int i = tid; i < kRows * DQ; i += kThreads) {
      const int r = i / DQ, d = i % DQ;
      sq[i] = r >= nh ? 0.f
              : d < DC ? rbg::to_f32(q_lat[(long)(qrow0 + r) * DC + d])
                       : rbg::to_f32(q_pe[(long)(qrow0 + r) * DR + d - DC]);
    }
    const int cq = tid % CQ, r0 = tid / CQ;
    float o[kRows / RS][4];
#pragma unroll
    for (int i = 0; i < kRows / RS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    for (int i = 0; i < nblk; ++i) {
      const float* tc = take(i);
      const float* tp = tc + L::kCTile / 4;
      const int nb = kb0 + i;
      const bool masked = (nb + 1) * kBN > len;
      fma_block<L, DC, DR, DQ>(o, tc, tp, sq, ss, scales_of(i), sl2, nb, masked, len, m_run,
                               l_run, s_alpha, s_m, s_l);
    }
    rbg::cp_async_wait<0>();
#pragma unroll
    for (int i = 0; i < kRows / RS; ++i) {
      const int r = r0 + RS * i;
      if (r < nh) {
        finish2(r, 4 * cq, o[i][0], o[i][1], cq == 0);
        finish2(r, 4 * cq + 2, o[i][2], o[i][3], false);
      }
    }
  }

  // Several splits: the last to finish merges every split's partial, in
  // split order (its atomicInc wraps the count back to 0).
  if (ns > 1) {
    __threadfence();
    __syncthreads();
    if (tid == 0)
      s_last = atomicInc(reinterpret_cast<unsigned*>(counts) + kDoneSlot0 + item,
                         (unsigned)(ns - 1)) == (unsigned)(ns - 1);
    __syncthreads();
    if (s_last) {
      __threadfence();
      // Every load of a thread is issued before any is used, past L1 (other
      // blocks wrote them); the sums still run in split order.
      const float* all = part + (long)item * cap * kRows * CLD;
      if (tid < nh) {  // each split's weight for head tid, and 1 / l
        float2 ml[kMaxSplits];
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s)
          ml[s] = s < ns ? __ldcg(reinterpret_cast<const float2*>(all + (s * kRows + tid) * CLD + DC))
                         : make_float2(rbg::kNegInf, 0.f);
        float m = rbg::kNegInf, l = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s) m = fmaxf(m, ml[s].x);
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s) {
          const float w = s < ns ? exp2f(ml[s].x - m) : 0.f;  // 0 past the row's splits
          s_w[tid * kMaxSplits + s] = w;
          l = fmaf(w, ml[s].y, l);
        }
        s_inv[tid] = 1.f / fmaxf(l, 1e-30f);
      }
      __syncthreads();
      for (int i = tid; i < nh * (DC / 4); i += kThreads) {
        const int r = i / (DC / 4), c = (i % (DC / 4)) * 4;
        float4 v[kMaxSplits];
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s)
          if (s < ns) v[s] = __ldcg(reinterpret_cast<const float4*>(all + (s * kRows + r) * CLD + c));
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int s = 0; s < kMaxSplits; ++s) {
          if (s < ns) {
            const float w = s_w[r * kMaxSplits + s];
            a.x = fmaf(w, v[s].x, a.x);
            a.y = fmaf(w, v[s].y, a.y);
            a.z = fmaf(w, v[s].z, a.z);
            a.w = fmaf(w, v[s].w, a.w);
          }
        }
        const float inv = s_inv[r];
        rbg::store4(dst + r * DC + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
      }
    }
  }
}

template <typename T, typename KVT, int DC, int DR>
int launch_dims(const void* q_lat, const void* q_pe, const void* c_pages, const void* pe_pages,
                const void* c_scales, const void* pe_scales, const void* table,
                const void* kv_lens, void* out, void* part, void* counts, int B, int H,
                int page, int P, int cap, float scale, int dev, cudaStream_t stream) {
  using L = Layout<T, KVT, DC, DR>;
  // The shared-memory attribute, once per device.
  static bool ready[kMaxDevices];
  if (!ready[dev]) {
    const cudaError_t err =
        cudaFuncSetAttribute(paged_mla_decode_kernel<T, KVT, DC, DR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const int NG = (H + kRows - 1) / kRows;
  const long nkb = ((long)P * page + kBN - 1) / kBN;
  const int gy = (int)max(1L, min((long)cap, (nkb + kMinSplitBlocks - 1) / kMinSplitBlocks));
  paged_mla_decode_kernel<T, KVT, DC, DR><<<dim3(B * NG, gy), kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe),
      static_cast<const KVT*>(c_pages), static_cast<const KVT*>(pe_pages),
      static_cast<const float*>(c_scales), static_cast<const float*>(pe_scales),
      static_cast<const int*>(table), static_cast<const int*>(kv_lens), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(counts), B, H, NG, page,
      rbg::page_shift(page), P, cap, scale);
  return (int)cudaGetLastError();
}

}  // namespace pm

// The shapes the kernel takes (the wrapper refuses others first, with a
// ValueError): (dc, dr) = (512, 64) or (64, 16), any H >= 1, any page size,
// 1 <= cap <= pm::kMaxSplits. part: float32 scratch of B * ceil(H / 16) *
// cap * 16 * (dc + 4); counts: int32 of pm::kDoneSlot0 + B * ceil(H / 16),
// zero when first used. The launch goes to device `dev` (q's, whose stream
// `stream` is); the calling thread's current device is left as it was.
template <typename T, typename KVT>
int launch_mla_decode(const void* q_lat, const void* q_pe, const void* c_pages,
                      const void* pe_pages, const void* c_scales, const void* pe_scales,
                      const void* table, const void* kv_lens, void* out, void* part,
                      void* counts, int B, int H, int dc, int dr, int page, int P, int cap,
                      float scale, int dev, cudaStream_t stream) {
  if (B == 0) return 0;
  if (H < 1 || page < 1 || P < 0 || cap < 1 || cap > pm::kMaxSplits || dev < 0 ||
      dev >= pm::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  int rc = (int)cudaErrorInvalidValue;
  if (dc == 512 && dr == 64)
    rc = pm::launch_dims<T, KVT, 512, 64>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales,
                                          table, kv_lens, out, part, counts, B, H, page, P, cap,
                                          scale, dev, stream);
  else if (dc == 64 && dr == 16)
    rc = pm::launch_dims<T, KVT, 64, 16>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales,
                                         table, kv_lens, out, part, counts, B, H, page, P, cap,
                                         scale, dev, stream);
  if (cur != dev) cudaSetDevice(cur);
  return rc;
}

}  // namespace
