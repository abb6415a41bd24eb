// Paged decode attention for Hopper, and its per-token form: the kernel
// body shared by paged_decode.cu (kernel A, model-dtype pools),
// paged_decode_q.cu (kernel C, int8 pools) and ragged_paged_tokengrid.cu
// (kernel I, model-dtype pools). They replace the TPU kernels
// rbg_tpu/ops/pallas/paged_attention_kernel.py `paged_attention_pallas`
// and `paged_attention_pallas_q`, and ragged_attention_kernel.py
// `ragged_paged_attention_pallas_tokengrid`.
//
// A, C: query head h = kv·G + g of row b attends slots < len(b) =
// min(kv_lens[b], P·page) through page_table[b]; a row with len <= 0
// gives 0 (the engine's bucket pad rows). Online softmax in f32; the
// output is acc / max(l, 1e-30).
//
// I (token mode, kTok): kernel B's function on a per-token grid. Item b
// is packed token t of a ragged pack: its table row is row_ids[t] and it
// attends slots < len(t) = min(kv_lens[row], q_pos[t] + 1, P·page), 0 for
// a pad (q_pos < 0) and for a row outside [0, R). q and out [1, T, H, hd]
// are read as [T·KV, G, hd], as A reads [B, 1, H, hd]: every token is a
// decode-shaped walk of its own row, and all that follows holds with
// B = T (items, splits with the cap from T·KV, merges, the report).
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
// Kernel I's bound is B's (each row's live slots read once: the work is
// the same function), and I stays far from it by design: a token grid
// re-reads a row's pages once per token of the row, where B's tiles read
// them once per tile. That re-reading is what the block_ragged probe
// measures B against, so I keeps it and makes it cheap instead. Block x
// of the grid's first dimension is x = t·KV + kv, so the blocks the card
// runs together are consecutive tokens of one row (a prefill chunk's
// tokens are packed in order) and all its kv heads: the first of them
// brings a page from device memory and the others find it in the 50 MB
// L2, which holds every row of a pack at the sizes served (the kernels
// phase's llama3-8b pack: 33 MB of distinct K and V). The walks then run
// at L2's rate, not device memory's. Two other designs were rejected:
// kernel A on a per-token table gathered by torch (a second launch and a
// [T, P] copy per call), and tiles of several tokens of one row (that is kernel B,
// and the probe would compare B with itself).
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
// float32 queries (tests, `tiny`, the probe): the same items, splits,
// merge and staging, with f32 FMAs on CUDA cores and no TF32: each thread
// scores one slot against eight query rows (eight independent
// accumulators, q read as float4 broadcasts from shared memory) and
// accumulates hd / 8 (row, column) outputs in registers.

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

// Kernel I's packed token t: its walk length, the slots it attends in its
// row, or 0 for a pad (q_pos < 0) or a row outside [0, R).
__device__ __forceinline__ int token_len(const int* row_ids, const int* q_pos,
                                         const int* kv_lens, int R, int t, int cap_slots) {
  const int r = row_ids[t], p = q_pos[t];
  return r >= 0 && r < R && p >= 0 ? min(min(kv_lens[r], p + 1), cap_slots) : 0;
}

// The kernels. T: q and output element type; KVT: pool element type (T,
// or int8_t with f32 scales [NP, page, KV, 1]); HD: head dim (32, 64 or
// 128). Each has the body (paged_decode_body.cuh) included as its own
// statements, not called: so A's and C's code is the body's as a kernel
// of its own (an inlined call in its place changes the loop code that
// ptxas is given, and one instance's register count). Two blocks per SM
// is the register target (the bf16 hd-128 stages fit two per SM): without
// it ptxas spills to fit three.

// Kernels A and C: item b is decode row b.
template <typename T, typename KVT, int HD>
__global__ void __launch_bounds__(kThreads, 2)
paged_decode_kernel(const T* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ table,
                    const int* __restrict__ kv_lens, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ counts, int B, int KV, int G,
                    int page, int pshift, int P, int cap, float scale) {
  constexpr bool kTok = false;
  const int* row_ids = nullptr;
  const int* q_pos = nullptr;
  const int R = B;
#include "paged_decode_body.cuh"
}

// Kernel I: item b is packed token b of n_tokens = B, over R table rows.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
ragged_paged_tokengrid_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages, const int* __restrict__ table,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ row_ids,
                              const int* __restrict__ q_pos, T* __restrict__ out,
                              float* __restrict__ part, int* __restrict__ counts, int B, int R,
                              int KV, int G, int page, int pshift, int P, int cap,
                              float scale) {
  using KVT = T;
  constexpr bool kTok = true;
  const float* k_scales = nullptr;
  const float* v_scales = nullptr;
#include "paged_decode_body.cuh"
}

template <typename T, typename KVT, int HD, bool kTok>
int launch_hd(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
              const void* v_scales, const void* table, const void* kv_lens,
              const void* row_ids, const void* q_pos, void* out, void* part, void* counts,
              int B, int R, int KV, int G, int page, int P, int cap, float scale, int dev,
              cudaStream_t stream) {
  using L = Layout<T, KVT, HD>;
  // The shared-memory attribute, once per device (set even under 48 KB:
  // the static flag adds to the dynamic plan).
  static bool ready[kMaxDevices];
  if (!ready[dev]) {
    cudaError_t err;
    if constexpr (kTok)
      err = cudaFuncSetAttribute(ragged_paged_tokengrid_kernel<T, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    else
      err = cudaFuncSetAttribute(paged_decode_kernel<T, KVT, HD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  const long nkb = ((long)P * page + kBN - 1) / kBN;
  const int gy = (int)max(1L, min((long)cap, (nkb + kMinSplitBlocks - 1) / kMinSplitBlocks));
  const dim3 grid(B * KV, gy);
  if constexpr (kTok)
    ragged_paged_tokengrid_kernel<T, HD><<<grid, kThreads, L::kBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pages),
        static_cast<const T*>(v_pages), static_cast<const int*>(table),
        static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
        static_cast<const int*>(q_pos), static_cast<T*>(out), static_cast<float*>(part),
        static_cast<int*>(counts), B, R, KV, G, page, rbg::page_shift(page), P, cap, scale);
  else
    paged_decode_kernel<T, KVT, HD><<<grid, kThreads, L::kBytes, stream>>>(
        static_cast<const T*>(q), static_cast<const KVT*>(k_pages),
        static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales), static_cast<const int*>(table),
        static_cast<const int*>(kv_lens), static_cast<T*>(out), static_cast<float*>(part),
        static_cast<int*>(counts), B, KV, G, page, rbg::page_shift(page), P, cap, scale);
  return (int)cudaGetLastError();
}

// Checks the sizes, switches to device `dev` and launches the instance of
// head dim hd; the calling thread's current device is left as it was.
template <typename T, typename KVT, bool kTok>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
           const void* v_scales, const void* table, const void* kv_lens, const void* row_ids,
           const void* q_pos, void* out, void* part, void* counts, int B, int R, int KV,
           int G, int hd, int page, int P, int cap, float scale, int dev,
           cudaStream_t stream) {
  if (B == 0) return 0;
  if (G < 1 || G > kRows || page < 1 || cap < 1 || cap > kMaxSplits || dev < 0 ||
      dev >= kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  int rc = (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      rc = launch_hd<T, KVT, 32, kTok>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                       row_ids, q_pos, out, part, counts, B, R, KV, G, page,
                                       P, cap, scale, dev, stream);
      break;
    case 64:
      rc = launch_hd<T, KVT, 64, kTok>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                       row_ids, q_pos, out, part, counts, B, R, KV, G, page,
                                       P, cap, scale, dev, stream);
      break;
    case 128:
      rc = launch_hd<T, KVT, 128, kTok>(q, k_pages, v_pages, k_scales, v_scales, table,
                                        kv_lens, row_ids, q_pos, out, part, counts, B, R, KV,
                                        G, page, P, cap, scale, dev, stream);
      break;
  }
  if (cur != dev) cudaSetDevice(cur);
  return rc;
}

}  // namespace pd

// The shapes the kernels take (the wrappers refuse others first, with a
// ValueError): hd 32, 64 or 128, 1 <= G <= 16, any page size,
// 1 <= cap <= pd::kMaxSplits. part: float32 scratch of B * KV * cap * G *
// (hd + 4); counts: int32 of pd::kDoneSlot0 + B * KV, zero when first used.
// The launch goes to device `dev` (q's, whose stream `stream` is); the
// calling thread's current device is left as it was.

// Kernels A and C: B decode rows, table [B, P], kv_lens [B].
template <typename T, typename KVT>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales, const void* table,
                  const void* kv_lens, void* out, void* part, void* counts, int B, int KV,
                  int G, int hd, int page, int P, int cap, float scale, int dev,
                  cudaStream_t stream) {
  return pd::launch<T, KVT, false>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens,
                                   nullptr, nullptr, out, part, counts, B, B, KV, G, hd, page,
                                   P, cap, scale, dev, stream);
}

// Kernel I: a pack of n_tokens tokens over R table rows, table [R, P],
// kv_lens [R], row_ids and q_pos [n_tokens]; B = n_tokens above.
template <typename T>
int launch_tokengrid(const void* q, const void* k_pages, const void* v_pages,
                     const void* table, const void* kv_lens, const void* row_ids,
                     const void* q_pos, void* out, void* part, void* counts, int n_tokens,
                     int R, int KV, int G, int hd, int page, int P, int cap, float scale,
                     int dev, cudaStream_t stream) {
  return pd::launch<T, T, true>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, row_ids,
                                q_pos, out, part, counts, n_tokens, R, KV, G, hd, page, P, cap,
                                scale, dev, stream);
}

}  // namespace
