// Block-ragged paged attention for Hopper: the kernel body shared by
// ragged_paged.cu (kernel B, model-dtype pools) and ragged_paged_q.cu
// (kernel D, int8 pools). They replace the TPU kernels
// rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas` and `ragged_paged_attention_pallas_q`.
// One launch serves a packed mix of prefill chunks and decode steps of
// many rows.
//
// Token t of the pack attends slots < min(kv_lens[row_ids[t]], q_pos[t] + 1);
// a pad token (q_pos < 0) and a token of a row with kv_len == 0 give 0.
// Rows need not be contiguous runs of the pack.
//
// Bound: bytes. Each row's live K/V slots are read once per (tile, kv
// head), and a 64-token prefill chunk over a 2k-token cache does ~64·G
// flops per K/V byte, under the card's bf16 ridge (~295 flop/byte). What
// holds a walk back is its length: one block walks a long row's pages one
// 64-slot block after another.
//
// Work items. A tile is (row, up to TM of that row's live tokens, kv
// head): kRows = 64 query rows, TM = 64 / G tokens x G heads (query row
// r = token k * G + g). A row's walk of nkb KV blocks (its own kv_len)
// is split into ns = min(kMaxSplits, ceil(nkb / kMinSplitBlocks)) items
// of ceil(nkb / ns) blocks, for each of its tiles; the item that finishes
// last merges the others' partial softmax states (m, l, o) from a scratch
// buffer. The launch is persistent: as many blocks as fit on the card,
// each deriving the items in shared memory from row_ids / q_pos / kv_lens
// (live tokens per row with shared atomics, tiles and splits per row,
// block-wide prefixes) and then taking items from a queue in global
// memory, highest split level first, so the long rows' walks start
// first. For its item a block collects the row's live tokens of rank
// [j·TM, j·TM + TM) in packed order with an ordered ballot/popc scan. So
// pads never enter a tile, a decode token is a one-token tile, and a long
// walk runs on several SMs at once. The derivation and the scan (Items,
// gather_tokens) also serve the MLA kernels F and H (ragged_paged_mla.cuh).
// Every block also writes the zeros of the dead
// (token, kv head) pairs (pads, kv_len-0 rows) in its grid-stride share.
// Block 0 records the launch's work items and grid size in the counts
// buffer (kItemsSlot, kGridSlot), where the wrapper reads them back.
//
// The walk goes in KV blocks of kBN = 64 slots up to the tile's largest
// limit, its page ids staged once in shared memory. Each slot's page is
// table[slot / page] at offset slot % page (rbg::PageMap: a shift for a
// power-of-two page size, a division otherwise), so a block may span parts
// of pages of any size or lie inside one page. Each block's
// K and V slices of the kv head are copied into shared memory with
// cp.async, several blocks in flight, so block n+1 loads while block n is
// computed. Only blocks reaching past the tile's smallest limit apply the
// per-row causal mask. Every live token sees slot 0, so a row's running
// max is finite after the first KV block of the first split and the
// -1e30 sentinel (kNegInf) is safe there; a later split, or a warp's part
// of a block, may see no slot of a row, so masked slots get p = 0
// explicitly and such a partial state (m = -1e30, l = 0) weighs 0 in
// every merge.
//
// bf16 queries (the served dtype): eight warps, three KV blocks in flight.
// Q is staged once in shared memory (rows padded by 16 bytes, so ldmatrix
// is free of bank conflicts; with model-dtype pools in the last stage's
// room, which loads once Q is in registers) and held as mma A fragments.
// The tile's rows form groups of 16; each group's KV block is split among
// four or two warps (the in-block merge follows the walk; always two with
// `invariant`, so a token's bits never depend on the tokens beside it, for
// batch-invariant serving). S = Q·Kᵀ is
// mma.sync m16n8k16 (bf16 -> f32); the online softmax runs on the S
// fragments in registers (quad shuffles for row max and sum); P is split
// into bf16 hi + lo parts reused in registers as the A operand of P·V
// (V through ldmatrix.trans), so rounding P costs about 2^-16 rather than
// 2^-8 relative: that keeps short rows, whose few probabilities each
// weigh a lot, within one bf16 rounding of the f32 reference. The output
// accumulates in f32 registers and is written once as acc / max(l, 1e-30).
// int8 pools: each staged block is converted to bf16 in shared memory
// (exact for int8); the k scale multiplies score column j, the v scale
// multiplies p_j before P·V, while the denominator keeps p. No page is
// dequantized into device memory.
//
// float32 queries (tests, the float32 witness, the probe): the same items,
// splits and cp.async pipeline with four warps and two blocks in flight;
// S and P·V are f32 FMAs on CUDA cores, 32 independent accumulators per
// thread for S, P staged in shared memory.

#pragma once

#include <climits>
#include <type_traits>

#include "mma_common.cuh"
#include "paged_attn_common.cuh"

namespace {

namespace rk {

constexpr int kRows = 64;                 // query rows per block (TM tokens x G heads)
constexpr int kBN = 64;                   // KV slots per pipeline step
constexpr int kMaxRows = 1024;            // table rows the shared counts hold
constexpr int kPidCap = 512;              // page ids of a walk kept in shared memory
constexpr int kMaxWarps = 8;
constexpr int kMaxSplits = 4;             // items of one tile's walk at most
constexpr int kMinSplitBlocks = 8;        // a split for every 8 KV blocks of a row
// The int32 counts buffer: the queue head, the last launch's work items
// and grid blocks, then the finished splits of each (tile, kv head).
constexpr int kHeadSlot = 0, kItemsSlot = 1, kGridSlot = 2, kTileSlot0 = 3;
constexpr float kLog2e = 1.4426950408889634f;

// Dynamic shared memory of one block, in bytes from its start. The bf16
// path keeps three KV blocks in flight; with model-dtype pools its Q tile
// is the third stage's K tile, which loads once Q is held in registers.
// The f32 path reads Q from shared memory at every step and keeps two in
// flight. After the walk the stages hold the in-block merge.
template <typename T, typename KVT, int HD>
struct Layout {
  static constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kThreads = kMma ? 256 : 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kStages = kMma ? 3 : 2;
  static constexpr bool kAliasQ = kMma && !kQuant;
  static constexpr int LD = HD + 16 / (int)sizeof(T);      // staged row, elements
  static constexpr int kTile = kBN * LD * (int)sizeof(T);  // one staged K or V block
  static constexpr int kRaw = kBN * HD;                    // one int8 K or V block
  // K, V tiles: of every stage for model-dtype pools, the converted pair for
  // int8 pools. Q [kRows, LD] is one tile's size (kRows == kBN).
  static constexpr int kKV = kAliasQ ? 0 : kTile;
  static constexpr int kQ = kAliasQ ? kKV + 2 * (kStages - 1) * kTile : 0;
  static constexpr int kRawOff = kKV + (kQuant ? 2 : 2 * kStages) * kTile;
  // int8 pools: K, V of every stage, then the scales: k, v of every stage,
  // then the current block's k, v.
  static constexpr int kScaleOff = kRawOff + (kQuant ? 2 * kStages * kRaw : 0);
  static constexpr int kSOff = kScaleOff + (kQuant ? (2 * kStages + 2) * kBN * 4 : 0);
  static constexpr int kSLd = kBN + 1;
  // f32 path: S / P [kRows, kSLd], then m, l, alpha [kRows].
  static constexpr int kBytes = kSOff + (kMma ? 0 : (kRows * kSLd + 3 * kRows) * 4);
  static_assert(kRows == kBN, "Q takes one K tile's room");
  // After the walk the bf16 path merges its warps' (16 rows, HD + 4)
  // partials from the start of shared memory, over the free stages.
  static_assert(!kMma || kWarps * 16 * (HD + 4) * 4 <= kSOff, "the warps' merge fits");
};

// Causal limit of packed token t (0: the token attends nothing), clamped to
// the table's P·page slots; *row gets its row.
__device__ __forceinline__ int live_limit(int t, const int* row_ids, const int* q_pos,
                                          const int* kv_lens, int R, int cap, int* row) {
  const int r = row_ids[t], pos = q_pos[t];
  *row = r;
  if (r < 0 || r >= R || pos < 0) return 0;
  return max(0, min(min(kv_lens[r], pos + 1), cap));
}

// Block-wide exclusive prefix sum of one value per thread (NW warps);
// *total = the sum.
template <int NW>
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  if (lane == 31) s_warp[w] = incl;
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    off += i < w ? s_warp[i] : 0;
    tot += s_warp[i];
  }
  __syncthreads();
  *total = tot;
  return off + incl - v;
}

// Rank of a set flag among the block's set flags in thread order (ballot +
// popc per warp, NW warps); *total = the number set.
template <int NW>
__device__ __forceinline__ int block_rank(bool flag, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) s_warp[w] = __popc(b);
  __syncthreads();
  int off = 0, tot = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    off += i < w ? s_warp[i] : 0;
    tot += s_warp[i];
  }
  __syncthreads();
  *total = tot;
  return off + __popc(b & ((1u << lane) - 1u));
}

// ---- The work items of the block-ragged kernels (B and D here, F and H
// in ragged_paged_mla.cuh), derived alike by every block of a launch ----
// A tile is (row, up to tm of the row's live tokens, head slice), tm from
// the kernel's query rows. Row r's walk of nkb = ceil(len / BN) blocks (its
// own kv_len, clamped to the table's cap slots) splits into
//   ns(r) = min(cap, MaxSplits, ceil(nkb / MinSplitBlocks))
// items per tile, split s taking blocks [s·ceil(nkb / ns), ..). A launch's
// items form a queue by split level, the highest first: only long rows
// have the high levels, so the longest walks start first. Thread t owns a
// run of rows [r0, r1). Shared memory holds each row's live tokens (s_cnt)
// and splits (s_ns) and the plan's header s (the items of each level, the
// split cap). A thread's bases (its rows' first tile, first
// live token of a splitting row, and first item in every level) live
// where kShared says:
// - registers (kernels B and D): found once per launch, so drawing an item
//   costs no block scan;
// - shared memory (kernels F and H, whose walk needs every register): the
//   tile and live bases in s, the level base rescanned (one block scan)
//   when an item is drawn.
template <int NT, int BN, int MaxSplits, int MinSplitBlocks, bool kShared>
struct Items {
  static constexpr int NW = NT / 32;
  static constexpr int kCap = MaxSplits, kTileBase = MaxSplits + 1, kLiveBase = kTileBase + NT,
                       kInts = kShared ? kLiveBase + NT : kTileBase;
  int* s;                // the plan, [kInts] in shared memory
  unsigned char* s_ns;   // each row's splits (0: no live token), [R] in shared memory
  int R;
  // Registers (!kShared): this thread's bases.
  int tile_base = 0, live_base = 0, lvl[kShared ? 1 : MaxSplits] = {};

  __device__ __forceinline__ int r0() const {
    return min(R, (int)threadIdx.x * ((R + NT - 1) / NT));
  }
  __device__ __forceinline__ int r1() const { return min(R, r0() + (R + NT - 1) / NT); }
  // The launch's split cap (derive's; readable by every thread after the
  // barrier that follows derive).
  __device__ __forceinline__ int cap() const { return s[kCap]; }
  __device__ __forceinline__ static int kv_blocks(const int* kv_lens, int r, int cap_slots) {
    return (min(kv_lens[r], cap_slots) + BN - 1) / BN;
  }
  // This thread's items at split level l (its rows' tiles that split more
  // than l ways).
  __device__ __forceinline__ int at_level(int l, const int* s_cnt, int tm) const {
    int n = 0;
#pragma unroll 1
    for (int r = r0(), e = r1(); r < e; ++r)
      if (l < s_ns[r]) n += (s_cnt[r] + tm - 1) / tm;
    return n;
  }

  // Live tokens per row into s_cnt (loads of 4 tokens per thread in flight
  // at once), then tiles, the split cap, each row's splits, the bases and
  // the levels' items. Each tile and split is `slices` items (kv heads,
  // head slices). `target`: the items a launch aims at, the split cap
  // ceil(target / (tiles · slices)) (0: MaxSplits). Returns the item count
  // to every thread.
  __device__ int derive(int* s_cnt, int* s_warp, int n_tokens, int tm, const int* row_ids,
                        const int* q_pos, const int* kv_lens, int cap_slots, int slices,
                        int target) {
    const int tid = threadIdx.x;
    for (int r = tid; r < R; r += NT) s_cnt[r] = 0;
    __syncthreads();
    for (int t0 = 0; t0 < n_tokens; t0 += 4 * NT) {
      int r[4], lim[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int t = t0 + k * NT + tid;
        r[k] = -1;
        lim[k] = t < n_tokens ? live_limit(t, row_ids, q_pos, kv_lens, R, cap_slots, &r[k]) : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (lim[k] > 0) atomicAdd(&s_cnt[r[k]], 1);
    }
    __syncthreads();
    int my_tiles = 0;
#pragma unroll 1
    for (int r = r0(), e = r1(); r < e; ++r) my_tiles += (s_cnt[r] + tm - 1) / tm;
    int n_tiles, total;
    const int tb = block_scan<NW>(my_tiles, s_warp, &n_tiles);
    const int all = n_tiles * slices;
    const int cap = target > 0 && all > 0 ? min(MaxSplits, max(1, (target + all - 1) / all))
                                          : MaxSplits;
    // Each row's splits (read only by this thread until find's scan), the
    // live tokens of this thread's splitting rows and, in registers, its
    // items at every level.
    int my_live = 0;
#pragma unroll 1
    for (int r = r0(), e = r1(); r < e; ++r) {
      const int nkb = kv_blocks(kv_lens, r, cap_slots);
      const int ns = s_cnt[r] ? max(1, min(cap, (nkb + MinSplitBlocks - 1) / MinSplitBlocks)) : 0;
      s_ns[r] = ns;
      my_live += ns > 1 ? s_cnt[r] : 0;
      if constexpr (!kShared) {
        const int nt = (s_cnt[r] + tm - 1) / tm;
#pragma unroll
        for (int l = 0; l < MaxSplits; ++l) lvl[l] += l < ns ? nt : 0;
      }
    }
    const int lb = block_scan<NW>(my_live, s_warp, &total);
    if constexpr (kShared) {
      s[kTileBase + tid] = tb;
      s[kLiveBase + tid] = lb;
    } else {
      tile_base = tb;
      live_base = lb;
    }
    int n = 0;
    if constexpr (kShared) {
      for (int l = 0; l < MaxSplits; ++l) {
        block_scan<NW>(at_level(l, s_cnt, tm), s_warp, &total);
        if (tid == 0) s[l] = total;
        n += total;
      }
    } else {
#pragma unroll
      for (int l = 0; l < MaxSplits; ++l) {
        lvl[l] = block_scan<NW>(lvl[l], s_warp, &total);  // now this thread's base in level l
        if (tid == 0) s[l] = total;
        n += total;
      }
    }
    if (tid == 0) s[kCap] = cap;
    return n;
  }

  // Item k of the queue (0 <= k < the item count): its split level,
  // returned to every thread; the thread owning its row writes s_item[0..3]
  // = row, the tile's index in the row, ns, the tile's id, s_item[6] = the
  // tile's first live token among the live tokens of the rows that split
  // (its partials' first row, when ns > 1), s_item[7] = blocks per split.
  // Every thread of the block calls it; the caller synchronises before
  // reading s_item.
  __device__ int find(int k, const int* s_cnt, int* s_warp, int tm, const int* kv_lens,
                      int cap_slots, int* s_item) const {
    int split = -1;
    for (int l = MaxSplits - 1; l >= 0 && split < 0; --l) {
      if (k < s[l])
        split = l;
      else
        k -= s[l];
    }
    const int tid = threadIdx.x;
    int base, bt, bl;
    if constexpr (kShared) {
      int total;
      base = block_scan<NW>(at_level(split, s_cnt, tm), s_warp, &total);
      // The slots' address from a fresh read of the thread index, so that
      // none is held in a register across the caller's walk.
      const int t = rbg::thread_index();
      bt = s[kTileBase + t];
      bl = s[kLiveBase + t];
    } else {
      base = 0;
#pragma unroll
      for (int l = 0; l < MaxSplits; ++l) base = l == split ? lvl[l] : base;
      bt = tile_base;
      bl = live_base;
    }
#pragma unroll 1
    for (int r = r0(), e = r1(); r < e; ++r) {
      const int nt = (s_cnt[r] + tm - 1) / tm, ns = s_ns[r];
      if (split < ns) {
        if (k >= base && k < base + nt) {
          s_item[0] = r;
          s_item[1] = k - base;
          s_item[2] = ns;
          s_item[3] = bt + k - base;
          s_item[6] = bl + (k - base) * tm;
          s_item[7] = (kv_blocks(kv_lens, r, cap_slots) + ns - 1) / ns;
        }
        base += nt;
      }
      bt += nt;
      bl += ns > 1 ? s_cnt[r] : 0;
    }
    return split;
  }
};

// The live tokens of `row` of rank [lo, lo + ntok) in packed order, into
// s_tok (their indices) and s_lim (their limits), by an ordered
// ballot/popc scan over the pack; the next NT tokens load while these are
// ranked. The caller synchronises before reading them.
template <int NT>
__device__ void gather_tokens(int row, int lo, int ntok, int n_tokens, const int* row_ids,
                              const int* q_pos, const int* kv_lens, int R, int cap_slots,
                              int* s_tok, int* s_lim, int* s_warp) {
  const int tid = threadIdx.x;
  int nr = -1;
  int nl = tid < n_tokens ? live_limit(tid, row_ids, q_pos, kv_lens, R, cap_slots, &nr) : 0;
#pragma unroll 1
  for (int t0 = 0, seen = 0; t0 < n_tokens && seen < lo + ntok; t0 += NT) {
    const int t = t0 + tid, r = nr, lim = nl;
    nr = -1;
    nl = t + NT < n_tokens ? live_limit(t + NT, row_ids, q_pos, kv_lens, R, cap_slots, &nr) : 0;
    const bool hit = lim > 0 && r == row;
    int n;
    const int rank = seen + block_rank<NT / 32>(hit, s_warp, &n);
    if (hit && rank >= lo && rank < lo + ntok) {
      s_tok[rank - lo] = t;
      s_lim[rank - lo] = lim;
    }
    seen += n;
  }
}

// Where the walk's page ids come from: shared memory for the first
// kPidCap pages (loaded once per block), the table row past them; each
// slot's page index and offset from rbg::PageMap (any page size).
struct Pages {
  const int* s_pid;
  rbg::PageMap map;

  // On the path of a page size that is (kPow2) or is not a power of two,
  // as rbg::PageMap::slot_in.
  template <bool kPow2>
  __device__ __forceinline__ long slot_in(int slot) const {
    int i, off;
    if constexpr (kPow2) {
      i = slot >> map.pshift;
      off = slot & (map.page - 1);
    } else {
      i = slot / map.page;
      off = slot - i * map.page;
    }
    i = min(i, map.last);
    const long phys = i < kPidCap ? s_pid[i] : map.trow[i];
    return kPow2 ? (phys << map.pshift) + off : phys * map.page + off;
  }
  __device__ __forceinline__ long slot_of(int slot) const {
    return map.pshift >= 0 ? slot_in<true>(slot) : slot_in<false>(slot);
  }
};

// Copy KV block nb (slots nb·kBN ..) of kv head kv into stage st: K and V
// rows (and the int8 pools' scales) with cp.async, each thread's page ids
// read first so the copies issue back to back. Slots past the walk's last
// page repeat it: they are masked, but stay finite.
template <typename T, typename KVT, int HD>
__device__ __forceinline__ void issue_block(unsigned char* sm, int st, int nb,
                                            const KVT* k_pages, const KVT* v_pages,
                                            const float* k_scales, const float* v_scales,
                                            const Pages& pg, int kv, int KV) {
  using L = Layout<T, KVT, HD>;
  constexpr int CPR = HD * (int)sizeof(KVT) / 16;  // 16-byte chunks per row
  constexpr int NC = kBN * CPR;                    // chunks of K (and of V) per block
  // Chunks per thread: whole, or one for the first NC threads (int8 pools
  // at hd 32 have 128 chunks for the bf16 path's 256 threads).
  constexpr int N = (NC + L::kThreads - 1) / L::kThreads;
  static_assert(NC % L::kThreads == 0 || N == 1, "whole chunks per thread, or at most one");
  constexpr int ld = L::kQuant ? HD : L::LD * (int)sizeof(T);
  unsigned char* kd = L::kQuant ? sm + L::kRawOff + 2 * st * L::kRaw
                                : sm + L::kKV + 2 * st * L::kTile;
  unsigned char* vd = kd + (L::kQuant ? L::kRaw : L::kTile);
  long src[N];
  auto sources = [&](auto pow2) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int c = min((int)threadIdx.x + i * L::kThreads, NC - 1);
      src[i] = (pg.template slot_in<decltype(pow2)::value>(nb * kBN + c / CPR) * KV + kv) * HD
                   * (long)sizeof(KVT)
               + (c % CPR) * 16;
    }
  };
  if (pg.map.pshift >= 0)
    sources(std::true_type{});
  else
    sources(std::false_type{});
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int c = threadIdx.x + i * L::kThreads, off = (c / CPR) * ld + (c % CPR) * 16;
    if (NC % L::kThreads == 0 || c < NC) {
      rbg::cp_async16(kd + off, reinterpret_cast<const unsigned char*>(k_pages) + src[i]);
      rbg::cp_async16(vd + off, reinterpret_cast<const unsigned char*>(v_pages) + src[i]);
    }
  }
  if constexpr (L::kQuant) {
    float* ks = reinterpret_cast<float*>(sm + L::kScaleOff) + 2 * st * kBN;
    const int r = threadIdx.x;
    if (r < kBN) {
      const long i = pg.slot_of(nb * kBN + r) * KV + kv;
      rbg::cp_async4(ks + r, k_scales + i);
      rbg::cp_async4(ks + kBN + r, v_scales + i);
    }
  }
}

// The four signed bytes of w as exact floats, without a conversion
// instruction: byte x ^ 0x80 = x + 128 becomes the low mantissa byte of
// 2^23, and 2^23 + 128 is taken off.
__device__ __forceinline__ float4 i8x4_f32(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float b = 8388736.f;  // 2^23 + 128
  return make_float4(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - b,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - b,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - b,
                     __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - b);
}

// 16 int8 values (raw) as 16 T at d (16-byte aligned).
__device__ __forceinline__ void store_i8x16(float* d, uint4 raw) {
  reinterpret_cast<float4*>(d)[0] = i8x4_f32(raw.x);
  reinterpret_cast<float4*>(d)[1] = i8x4_f32(raw.y);
  reinterpret_cast<float4*>(d)[2] = i8x4_f32(raw.z);
  reinterpret_cast<float4*>(d)[3] = i8x4_f32(raw.w);
}

// An integer of at most 8 significant bits is a bf16 exactly, so its bf16
// is the upper half of its f32: one byte permute packs two.
__device__ __forceinline__ void store_i8x16(__nv_bfloat16* d, uint4 raw) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t b[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 f = i8x4_f32(w[k]);
    b[2 * k] = __byte_perm(__float_as_uint(f.x), __float_as_uint(f.y), 0x7632);
    b[2 * k + 1] = __byte_perm(__float_as_uint(f.z), __float_as_uint(f.w), 0x7632);
  }
  reinterpret_cast<uint4*>(d)[0] = make_uint4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<uint4*>(d)[1] = make_uint4(b[4], b[5], b[6], b[7]);
}

// int8 pools: stage st's K and V as T in the converted tiles, its scales
// as the current block's.
template <typename T, int HD>
__device__ __forceinline__ void convert_block(unsigned char* sm, int st) {
  using L = Layout<T, int8_t, HD>;
  constexpr int CPR = HD / 16;
  for (int c = threadIdx.x; c < 2 * kBN * CPR; c += L::kThreads) {
    const int m = c / (kBN * CPR), rc = c % (kBN * CPR);  // m: 0 = K, 1 = V
    const int r = rc / CPR, ch = rc % CPR;
    const uint4 raw = *reinterpret_cast<const uint4*>(
        sm + L::kRawOff + (2 * st + m) * L::kRaw + r * HD + ch * 16);
    store_i8x16(reinterpret_cast<T*>(sm + L::kKV + m * L::kTile) + r * L::LD + ch * 16, raw);
  }
  const float* raw_s = reinterpret_cast<const float*>(sm + L::kScaleOff) + 2 * st * kBN;
  float* cur = reinterpret_cast<float*>(sm + L::kScaleOff) + 2 * L::kStages * kBN;
  for (int i = threadIdx.x; i < 2 * kBN; i += L::kThreads) cur[i] = raw_s[i];
}

// ---- bf16 queries: tensor-core products, softmax in registers ----
// Eight warps. The tile's query rows form ng = ceil(rows / 16) groups of
// 16; each group's KV block is split among wpg = 4 (ng <= 2) or 2 warps,
// SW = 64 / wpg slots each, so that every SM sub-partition runs two warps
// and a decode tile (one group) still spreads its block over four. Each
// warp keeps its own online softmax over its slots; the warps of a group
// are merged once at the end. With `invariant` every group takes two warps
// whatever ng (a tile of ng <= 2 groups leaves warps idle), so a query
// row's arithmetic is the same in a full tile and in a short one: a
// prefill chunk cut at another token, or a row packed beside others, gives
// the same bits.
template <int HD>
struct MmaState {
  uint32_t qa[HD / 16][4];  // the group's 16 Q rows as A fragments
  float o[HD / 8][4];       // output accumulators, 16 rows x HD
  float m[2], l[2];         // rows gid and gid + 8: running max (log2 units), partial sum
  int lim[2];               // their causal limits
};

// One KV block (staged in sk / sv) for this warp's SW slots from slot0.
template <typename KVT, int HD, int SW>
__device__ __forceinline__ void mma_block(MmaState<HD>& st, int nb, int slot0, bool masked,
                                          const __nv_bfloat16* sk, const __nv_bfloat16* sv,
                                          const float* ks, const float* vs, float sl2) {
  constexpr int LD = Layout<__nv_bfloat16, KVT, HD>::LD;
  constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  const int lane = threadIdx.x & 31, tig = lane & 3;
  float s[SW / 8][4];
#pragma unroll
  for (int nt = 0; nt < SW / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
  // S = Q · Kᵀ: an x4 ldmatrix of K gives the B fragments of n-tiles 2np
  // and 2np + 1 for k-step kk.
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < SW / 16; ++np) {
      uint32_t b[4];
      rbg::ldmatrix_x4(b, sk + (slot0 + np * 16 + (lane & 7) + (lane >> 4) * 8) * LD
                              + kk * 16 + ((lane >> 3) & 1) * 8);
      rbg::mma_bf16(s[2 * np], st.qa[kk], b[0], b[1]);
      rbg::mma_bf16(s[2 * np + 1], st.qa[kk], b[2], b[3]);
    }
  }
  // Scale (log2 units), k scales, causal mask; new row max.
  float mx[2] = {rbg::kNegInf, rbg::kNegInf};
#pragma unroll
  for (int nt = 0; nt < SW / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = slot0 + nt * 8 + tig * 2 + (e & 1), h = e >> 1;
      float x = s[nt][e] * sl2;
      if constexpr (kQuant) x *= ks[col];
      if (masked && nb * kBN + col >= st.lim[h]) x = rbg::kNegInf;
      s[nt][e] = x;
      mx[h] = fmaxf(mx[h], x);
    }
  }
  float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(st.m[h], mx[h]);
    alpha[h] = exp2f(st.m[h] - m_new);
    st.m[h] = m_new;
  }
  // A warp's slots may all be masked for a row (a short row, a later
  // split), so a masked block gives masked slots p = 0 explicitly.
#pragma unroll
  for (int nt = 0; nt < SW / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[nt][e];
      const float p = (!masked || x > rbg::kNegInf) ? exp2f(x - st.m[e >> 1]) : 0.f;
      rs[e >> 1] += p;
      s[nt][e] = kQuant ? p * vs[slot0 + nt * 8 + tig * 2 + (e & 1)] : p;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) st.l[h] = st.l[h] * alpha[h] + rs[h];
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt) {
    st.o[dt][0] *= alpha[0];
    st.o[dt][1] *= alpha[0];
    st.o[dt][2] *= alpha[1];
    st.o[dt][3] *= alpha[1];
  }
  // O += P · V: the S fragments of n-tiles 2kk, 2kk + 1 are the A fragment
  // of k-step kk; an x4 ldmatrix.trans of V gives the B fragments of
  // output n-tiles 2dp and 2dp + 1. Two such loads per step, so that the
  // hi and lo products into one accumulator stand four products apart.
#pragma unroll
  for (int kk = 0; kk < SW / 16; ++kk) {
    uint32_t hi[4], lo[4];
    rbg::split_bf16x2(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
    rbg::split_bf16x2(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
    rbg::split_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
    rbg::split_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
    const __nv_bfloat16* vrow =
        sv + (slot0 + kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int dp = 0; dp < HD / 16; dp += 2) {
      uint32_t b[4], c[4];
      rbg::ldmatrix_x4_trans(b, vrow + dp * 16);
      rbg::ldmatrix_x4_trans(c, vrow + dp * 16 + 16);
      rbg::mma_bf16(st.o[2 * dp], hi, b[0], b[1]);
      rbg::mma_bf16(st.o[2 * dp + 1], hi, b[2], b[3]);
      rbg::mma_bf16(st.o[2 * dp + 2], hi, c[0], c[1]);
      rbg::mma_bf16(st.o[2 * dp + 3], hi, c[2], c[3]);
      rbg::mma_bf16(st.o[2 * dp], lo, b[0], b[1]);
      rbg::mma_bf16(st.o[2 * dp + 1], lo, b[2], b[3]);
      rbg::mma_bf16(st.o[2 * dp + 2], lo, c[0], c[1]);
      rbg::mma_bf16(st.o[2 * dp + 3], lo, c[2], c[3]);
    }
  }
}

// ---- float32 queries: CUDA-core FMAs ----
// The P·V columns of thread cx (of 16 per row group): in each of kGroups
// groups of 16·kVW columns, kVW adjacent ones (float4 at hd 64 and 128,
// float2 at hd 32), HD / 16 in all.
template <int HD>
struct FmaCols {
  static constexpr int kVW = HD >= 64 ? 4 : 2;
  static constexpr int kGroups = HD / (16 * kVW);
  __device__ static int col(int gi, int cx) { return gi * 16 * kVW + cx * kVW; }
};

template <typename KVT, int HD>
__device__ __forceinline__ void fma_block(unsigned char* sm, float (&o)[8][HD / 16], int nb,
                                          bool masked, const int (&lim)[4], const float* sk,
                                          const float* sv, const float* ks, const float* vs,
                                          float scale) {
  using L = Layout<float, KVT, HD>;
  constexpr int LD = L::LD, SLD = L::kSLd;
  constexpr bool kQuant = L::kQuant;
  const int tid = threadIdx.x;
  const float* sq = reinterpret_cast<const float*>(sm + L::kQ);
  float* ss = reinterpret_cast<float*>(sm + L::kSOff);
  float* sm_ = ss + kRows * SLD;
  float* sl = sm_ + kRows;
  float* sa = sl + kRows;
  // S: thread (ty, tx) scores rows 4ty .. 4ty+3 against slots tx + 8j.
  {
    const int ty = tid >> 3, tx = tid & 7;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv4[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(sq + (ty * 4 + i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv4[j] = *reinterpret_cast<const float4*>(sk + (tx + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          acc[i][j] = fmaf(qv[i].x, kv4[j].x, acc[i][j]);
          acc[i][j] = fmaf(qv[i].y, kv4[j].y, acc[i][j]);
          acc[i][j] = fmaf(qv[i].z, kv4[j].z, acc[i][j]);
          acc[i][j] = fmaf(qv[i].w, kv4[j].w, acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        float x = acc[i][j] * scale;
        if constexpr (kQuant) x *= ks[col];
        if (masked && nb * kBN + col >= lim[i]) x = rbg::kNegInf;
        ss[(ty * 4 + i) * SLD + col] = x;
      }
  }
  __syncthreads();
  // Softmax step: two threads per query row.
  {
    const int r = tid >> 1, half = tid & 1;
    float* sr = ss + r * SLD;
    float mx = rbg::kNegInf;
    for (int c = half; c < kBN; c += 2) mx = fmaxf(mx, sr[c]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sm_[r], m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = half; c < kBN; c += 2) {
      const float p = sr[c] > rbg::kNegInf ? expf(sr[c] - m_new) : 0.f;  // a row may see
                                                                        // no slot of a split
      sum += p;
      sr[c] = kQuant ? p * vs[c] : p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if (half == 0) {
      const float alpha = expf(m_old - m_new);
      sm_[r] = m_new;
      sl[r] = sl[r] * alpha + sum;
      sa[r] = alpha;
    }
  }
  __syncthreads();
  // O += P · V: thread (ry, cx) owns rows 8ry .. 8ry+7 and columns
  // col_of<HD>(gi, cx) .. + kVW - 1 of each column group gi.
  constexpr int VW = FmaCols<HD>::kVW;
  const int ry = tid >> 4, cx = tid & 15;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float a = sa[ry * 8 + i];
#pragma unroll
    for (int c = 0; c < HD / 16; ++c) o[i][c] *= a;
  }
#pragma unroll 4
  for (int j = 0; j < kBN; ++j) {
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = ss[(ry * 8 + i) * SLD + j];
#pragma unroll
    for (int gi = 0; gi < FmaCols<HD>::kGroups; ++gi) {
      float v[VW];
      const float* vp = sv + j * LD + FmaCols<HD>::col(gi, cx);
      if constexpr (VW == 4) {
        const float4 t = *reinterpret_cast<const float4*>(vp);
        v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
      } else {
        const float2 t = *reinterpret_cast<const float2*>(vp);
        v[0] = t.x, v[1] = t.y;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < VW; ++e) o[i][gi * VW + e] = fmaf(p[i], v[e], o[i][gi * VW + e]);
    }
  }
}

// Cross-block merge of a tile's splits: a split block's partial results
// (per query row: o unnormalised, then m in log2 units and l; HD + 4
// floats) go to part[live row, kv, split], where the live row of query row
// r of a tile is (its first live token's index among the live tokens of
// the rows that split) * G + r, so the scratch holds T * G * KV *
// kMaxSplits such rows at most; the split that finishes last merges them
// all.

// T: q and output element type; KVT: pool element type (T, or int8_t with
// f32 scales [NP, page, KV, 1]); HD: head dim (32, 64 or 128).
template <typename T, typename KVT, int HD>
__global__ void __launch_bounds__(Layout<T, KVT, HD>::kThreads, 1)
ragged_paged_kernel(const T* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ table,
                    const int* __restrict__ kv_lens, const int* __restrict__ row_ids,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ done, int n_tokens, int R,
                    int KV, int G, int page, int pshift, int P, float scale,
                    int invariant) {
  using L = Layout<T, KVT, HD>;
  constexpr int S = L::kStages, NT = L::kThreads, CLD = HD + 4;  // o, then m, l
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_cnt[kMaxRows];
  __shared__ int s_pid[kPidCap];
  __shared__ int s_tok[kRows];
  __shared__ int s_lim[kRows];
  __shared__ int s_warp[kMaxWarps];
  __shared__ int s_item[8];
  using Plan = Items<NT, kBN, kMaxSplits, kMinSplitBlocks, false>;
  __shared__ int s_plan[Plan::kInts];
  __shared__ unsigned char s_ns[kMaxRows];
  const int tid = threadIdx.x;
  const int tm = kRows / G, cap = P * page;

  // Dead (token, kv head) pairs of this block's grid-stride share get
  // zeros, one pair per thread.
  for (long i = blockIdx.x + (long)tid * gridDim.x; i < (long)n_tokens * KV;
       i += (long)NT * gridDim.x) {
    int r;
    if (live_limit((int)(i / KV), row_ids, q_pos, kv_lens, R, cap, &r) > 0) continue;
    uint4* o = reinterpret_cast<uint4*>(out + i * G * HD);
    for (int c = 0; c < G * HD * (int)sizeof(T) / 16; ++c) o[c] = make_uint4(0u, 0u, 0u, 0u);
  }

  // The work items (Items): per row ceil(live tokens / TM) tiles, each
  // split by the row's own KV blocks, every kv head alike.
  Plan it{s_plan, s_ns, R};
  const int n_items = it.derive(s_cnt, s_warp, n_tokens, tm, row_ids, q_pos, kv_lens, cap, KV, 0);
  if (blockIdx.x == 0 && tid == 0) {
    done[kItemsSlot] = n_items * KV;
    done[kGridSlot] = (int)gridDim.x;
  }

  // Every block takes items until it draws one past the last, so a launch
  // draws n_items * KV + gridDim.x times in all: atomicInc wraps the head
  // back to 0 at the last draw, ready for the next launch.
  const unsigned last_draw = (unsigned)(n_items * KV) + gridDim.x - 1u;
  for (;;) {
    if (tid == 0)
      s_item[5] = (int)atomicInc(reinterpret_cast<unsigned*>(done) + kHeadSlot, last_draw);
    __syncthreads();
    const int qi = s_item[5];
    if (qi >= n_items * KV) break;  // the same for every thread of the block
    const int kv = qi % KV;
    const int split = it.find(qi / KV, s_cnt, s_warp, tm, kv_lens, cap, s_item);
    __syncthreads();
    const int row = s_item[0], lo = s_item[1] * tm, ns = s_item[2], tile_id = s_item[3];
    const int live0 = s_item[6], split_kb = s_item[7];
    const int ntok = min(tm, s_cnt[row] - lo), nrows = ntok * G;
    gather_tokens<NT>(row, lo, ntok, n_tokens, row_ids, q_pos, kv_lens, R, cap, s_tok, s_lim,
                      s_warp);
    __syncthreads();
    // The tile's smallest and largest limits (every warp alike).
    int lmin = INT_MAX, lmax = 0;
    {
      const int lane = tid & 31;
      for (int i = lane; i < ntok; i += 32) {
        lmin = min(lmin, s_lim[i]);
        lmax = max(lmax, s_lim[i]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
        lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
      }
    }
    // This split's KV blocks [kb0, kb1) of the tile's walk (empty when the
    // tile ends before the row does); their page ids; the first blocks in
    // flight (all but the last stage when Q shares that stage's room)
    // before Q is staged.
    const int kb0 = split * split_kb, kb1 = min((lmax + kBN - 1) / kBN, kb0 + split_kb);
    const int nblk = max(0, kb1 - kb0);
    const int* trow = table + (long)row * P;
    Pages pg{s_pid, rbg::PageMap{trow, 0, page, pshift}};
    pg.map.last = pg.map.last_of(lmax);
    for (int i = tid; i <= min(pg.map.last, kPidCap - 1); i += NT) s_pid[i] = trow[i];
    __syncthreads();
    auto issue = [&](int st, int b) {
      issue_block<T, KVT, HD>(sm, st, kb0 + b, k_pages, v_pages, k_scales, v_scales, pg, kv,
                              KV);
    };
#pragma unroll
    for (int st = 0; st < S - (L::kAliasQ ? 1 : 0); ++st) {
      if (st < nblk) issue(st, st);
      rbg::cp_async_commit();
    }

    // Q rows r = k * G + g of the tile's tokens; rows past nrows are zero.
    T* sq = reinterpret_cast<T*>(sm + L::kQ);
    constexpr int QC = HD * (int)sizeof(T) / 16;
    for (int c = tid; c < kRows * QC; c += NT) {
      const int r = c / QC, ch = c % QC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nrows) {
        const long src = ((long)s_tok[r / G] * KV + kv) * G + r % G;
        v = reinterpret_cast<const uint4*>(q + src * HD)[ch];
      }
      *reinterpret_cast<uint4*>(sq + r * L::LD + ch * (16 / (int)sizeof(T))) = v;
    }

    const float* ks = reinterpret_cast<const float*>(sm + L::kScaleOff) + 2 * S * kBN;
    const float* vs = ks + kBN;
    // Wait for step b's stage; int8 pools convert it into the shared tiles
    // and refill it at once. Returns K's tile; V's follows it.
    auto take = [&](int b) -> const T* {
      const int stg = b % S;
      rbg::cp_async_wait<S - 1>();
      __syncthreads();
      if constexpr (L::kQuant) {
        convert_block<T, HD>(sm, stg);
        __syncthreads();
        if (b + S < nblk) issue(stg, b + S);
        rbg::cp_async_commit();
        return reinterpret_cast<const T*>(sm + L::kKV);
      } else {
        return reinterpret_cast<const T*>(sm + L::kKV + 2 * stg * L::kTile);
      }
    };
    // After step b: model-dtype pools refill the stage just read.
    auto refill = [&](int b) {
      __syncthreads();
      if constexpr (!L::kQuant) {
        if (b + S < nblk) issue(b % S, b + S);
        rbg::cp_async_commit();
      }
    };
    // The partials of the tile's query row r, [kMaxSplits][CLD].
    auto partials = [&](int r) {
      return part + ((long)(live0 * G + r) * KV + kv) * kMaxSplits * CLD;
    };
    // The tile's result for rows r < nrows, column pair c: this split's
    // (o, m, l); with one split written out, else kept as a partial.
    auto finish = [&](int r, int c, float o0, float o1, float m, float l) {
      if (ns == 1) {
        const float inv = 1.f / fmaxf(l, 1e-30f);
        T* dst = out + (((long)s_tok[r / G] * KV + kv) * G + r % G) * HD + c;
        if constexpr (L::kMma) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o0 * inv, o1 * inv);
        } else {
          dst[0] = o0 * inv;
          dst[1] = o1 * inv;
        }
      } else {
        float* mine = partials(r) + split * CLD;
        *reinterpret_cast<float2*>(mine + c) = make_float2(o0, o1);
        if (c == 0) *reinterpret_cast<float2*>(mine + HD) = make_float2(m, l);
      }
    };

    if constexpr (L::kMma) {
      MmaState<HD> st;
      const int warp = tid >> 5, lane = tid & 31;
      const int ng = (nrows + 15) / 16, wpg = ng <= 2 && !invariant ? 4 : 2;
      const int grp = warp / wpg, slot0 = (warp % wpg) * (kBN / wpg);
      const bool active = grp < ng;  // a warp past the tile's groups idles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = grp * 16 + (lane >> 2) + 8 * h;
        st.lim[h] = r < nrows ? s_lim[r / G] : lmax;
        st.m[h] = rbg::kNegInf;
        st.l[h] = 0.f;
      }
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt)
        st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
      __syncthreads();  // Q staged
      if (active) {
#pragma unroll
        for (int kk = 0; kk < HD / 16; ++kk)
          rbg::ldmatrix_x4(st.qa[kk], sq + (grp * 16 + (lane & 15)) * L::LD + kk * 16
                                          + (lane >> 4) * 8);
      }
      if constexpr (L::kAliasQ) {
        __syncthreads();  // every warp holds its Q fragments: the last stage loads
        if (S - 1 < nblk) issue(S - 1, S - 1);
        rbg::cp_async_commit();
      }
      const float sl2 = scale * kLog2e;
      for (int b = 0; b < nblk; ++b) {
        const __nv_bfloat16* sk = take(b);
        const __nv_bfloat16* sv = sk + L::kTile / (int)sizeof(T);
        const int nb = kb0 + b;
        const bool masked = (nb + 1) * kBN > lmin;
        if (active) {
          if (wpg == 4)
            mma_block<KVT, HD, kBN / 4>(st, nb, slot0, masked, sk, sv, ks, vs, sl2);
          else
            mma_block<KVT, HD, kBN / 2>(st, nb, slot0, masked, sk, sv, ks, vs, sl2);
        }
        refill(b);
      }
      rbg::cp_async_wait<0>();
      __syncthreads();
      // Merge the warps of each group through shared memory (the stages
      // are free now): per warp and row, o then m and l (quad sums of l).
      float* cb = reinterpret_cast<float*>(sm);
      if (active) {
        const int tig = lane & 3;
        float* wb = cb + warp * 16 * CLD;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float l = st.l[h];
          l += __shfl_xor_sync(0xffffffffu, l, 1);
          l += __shfl_xor_sync(0xffffffffu, l, 2);
          float* rb = wb + ((lane >> 2) + 8 * h) * CLD;
#pragma unroll
          for (int dt = 0; dt < HD / 8; ++dt)
            *reinterpret_cast<float2*>(rb + dt * 8 + tig * 2) =
                make_float2(st.o[dt][2 * h], st.o[dt][2 * h + 1]);
          if (tig == 0) {
            rb[HD] = st.m[h];
            rb[HD + 1] = l;
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < nrows * (HD / 2); i += NT) {
        const int r = i / (HD / 2), c = (i % (HD / 2)) * 2;
        const float* rb = cb + ((r >> 4) * wpg * 16 + (r & 15)) * CLD;
        float m = rbg::kNegInf;
        for (int sp = 0; sp < wpg; ++sp) m = fmaxf(m, rb[sp * 16 * CLD + HD]);
        float l = 0.f, o0 = 0.f, o1 = 0.f;
        for (int sp = 0; sp < wpg; ++sp) {
          const float* b = rb + sp * 16 * CLD;
          const float w = exp2f(b[HD] - m);  // 0 for a warp that saw no slot
          l = fmaf(w, b[HD + 1], l);
          o0 = fmaf(w, b[c], o0);
          o1 = fmaf(w, b[c + 1], o1);
        }
        finish(r, c, o0, o1, m, l);
      }
    } else {
      float* sm_ = reinterpret_cast<float*>(sm + L::kSOff) + kRows * L::kSLd;
      float* sl = sm_ + kRows;
      for (int r = tid; r < kRows; r += NT) {
        sm_[r] = rbg::kNegInf;
        sl[r] = 0.f;
      }
      int lim[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = (tid >> 3) * 4 + i;
        lim[i] = r < nrows ? s_lim[r / G] : lmax;
      }
      float o[8][HD / 16];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < HD / 16; ++c) o[i][c] = 0.f;
      for (int b = 0; b < nblk; ++b) {
        const float* sk = take(b);
        const float* sv = sk + L::kTile / (int)sizeof(float);
        const int nb = kb0 + b;
        fma_block<KVT, HD>(sm, o, nb, (nb + 1) * kBN > lmin, lim, sk, sv, ks, vs, scale);
        refill(b);
      }
      rbg::cp_async_wait<0>();
      __syncthreads();
      const int ry = tid >> 4, cx = tid & 15;
      constexpr int VW = FmaCols<HD>::kVW;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int r = ry * 8 + i;
        if (r >= nrows) continue;
#pragma unroll
        for (int gi = 0; gi < FmaCols<HD>::kGroups; ++gi) {
          const int c = FmaCols<HD>::col(gi, cx);
          const float m = sm_[r] * kLog2e, l = sl[r];
#pragma unroll
          for (int e = 0; e < VW; e += 2)
            finish(r, c + e, o[i][gi * VW + e], o[i][gi * VW + e + 1], m, l);
        }
      }
    }

    // Several splits: the last to finish merges every split's partial (its
    // atomicInc wraps the count back to 0).
    if (ns > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0)
        s_item[4] = atomicInc(reinterpret_cast<unsigned*>(done) + kTileSlot0 + tile_id * KV + kv,
                              (unsigned)(ns - 1)) == (unsigned)(ns - 1);
      __syncthreads();
      if (s_item[4]) {
        __threadfence();
        // NT / kRows threads per query row, each over CPT columns; every
        // load of a thread is issued before any is used, past L1 (other
        // blocks wrote them).
        constexpr int TPR = NT / kRows, CPT = HD / TPR;
        const int r = tid / TPR, c0 = (tid % TPR) * CPT;
        if (r < nrows) {
          const float* all = partials(r);
          float2 ml[kMaxSplits];
          float w[kMaxSplits], m = rbg::kNegInf, l = 0.f;
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp)
            ml[sp] = sp < ns ? __ldcg(reinterpret_cast<const float2*>(all + sp * CLD + HD))
                             : make_float2(rbg::kNegInf, 0.f);
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) m = fmaxf(m, ml[sp].x);
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) {
            w[sp] = sp < ns ? exp2f(ml[sp].x - m) : 0.f;  // 0 for a split the row saw nothing of
            l = fmaf(w[sp], ml[sp].y, l);
          }
          const float inv = 1.f / fmaxf(l, 1e-30f);
          T* dst = out + (((long)s_tok[r / G] * KV + kv) * G + r % G) * HD + c0;
#pragma unroll
          for (int c = 0; c < CPT; c += 4) {
            float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
            for (int sp = 0; sp < kMaxSplits; ++sp) {
              if (sp < ns) {
                const float4 v =
                    __ldcg(reinterpret_cast<const float4*>(all + sp * CLD + c0 + c));
                a.x = fmaf(w[sp], v.x, a.x);
                a.y = fmaf(w[sp], v.y, a.y);
                a.z = fmaf(w[sp], v.z, a.z);
                a.w = fmaf(w[sp], v.w, a.w);
              }
            }
            if constexpr (L::kMma) {
              reinterpret_cast<__nv_bfloat162*>(dst + c)[0] =
                  __floats2bfloat162_rn(a.x * inv, a.y * inv);
              reinterpret_cast<__nv_bfloat162*>(dst + c)[1] =
                  __floats2bfloat162_rn(a.z * inv, a.w * inv);
            } else {
              *reinterpret_cast<float4*>(dst + c) =
                  make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv);
            }
          }
        }
      }
    }
    __syncthreads();  // shared memory is the next item's
  }
}

template <typename T, typename KVT, int HD>
int launch_hd(const void* q, const void* k_pages, const void* v_pages, const void* k_scales,
              const void* v_scales, const void* table, const void* kv_lens,
              const void* row_ids, const void* q_pos, void* out, void* part, void* done,
              int n_tokens, int R, int KV, int G, int page, int P, float scale,
              int invariant, cudaStream_t stream) {
  constexpr size_t smem = Layout<T, KVT, HD>::kBytes;
  // As many blocks as fit on the card at once (they take items from the
  // queue), or as many as there can be items. Found at a device's first
  // launch, with the shared-memory attribute (set even under 48 KB: the
  // static row counts add to the dynamic plan).
  constexpr int kMaxDevices = 16;
  static int resident[kMaxDevices];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(ragged_paged_kernel<T, KVT, HD>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ragged_paged_kernel<T, KVT, HD>,
                                                  Layout<T, KVT, HD>::kThreads, smem);
    resident[dev] = max(1, sms * per_sm);
  }
  const int tm = kRows / G;
  const long bound = (long)((n_tokens + tm - 1) / tm + R) * kMaxSplits * KV;
  const dim3 grid((unsigned)min((long)resident[dev], bound));
  ragged_paged_kernel<T, KVT, HD><<<grid, Layout<T, KVT, HD>::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
      static_cast<const int*>(q_pos), static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int*>(done), n_tokens, R, KV, G, page, rbg::page_shift(page), P, scale,
      invariant);
  return (int)cudaGetLastError();
}

}  // namespace rk

// The shapes the kernel takes (the wrapper refuses others first, with a
// ValueError): hd 32, 64 or 128, 1 <= G <= 16, any page size, at most
// rk::kMaxRows table rows. part: float32 scratch of n_tokens * G * KV *
// rk::kMaxSplits * (hd + 4); done: int32 counts of rk::kTileSlot0 +
// (ceil(n_tokens / (64 / G)) + R) * KV, zero when first used.
template <typename T, typename KVT>
int launch_ragged(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales, const void* table,
                  const void* kv_lens, const void* row_ids, const void* q_pos,
                  void* out, void* part, void* done, int n_tokens, int R, int KV, int G,
                  int hd, int page, int P, float scale, int invariant,
                  cudaStream_t stream) {
  if (n_tokens == 0) return 0;
  if (G < 1 || G > 16 || page < 1 || R < 0 || R > rk::kMaxRows)
    return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 32:
      return rk::launch_hd<T, KVT, 32>(q, k_pages, v_pages, k_scales, v_scales, table,
                                       kv_lens, row_ids, q_pos, out, part, done, n_tokens, R,
                                       KV, G, page, P, scale, invariant, stream);
    case 64:
      return rk::launch_hd<T, KVT, 64>(q, k_pages, v_pages, k_scales, v_scales, table,
                                       kv_lens, row_ids, q_pos, out, part, done, n_tokens, R,
                                       KV, G, page, P, scale, invariant, stream);
    case 128:
      return rk::launch_hd<T, KVT, 128>(q, k_pages, v_pages, k_scales, v_scales, table,
                                        kv_lens, row_ids, q_pos, out, part, done, n_tokens,
                                        R, KV, G, page, P, scale, invariant, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
