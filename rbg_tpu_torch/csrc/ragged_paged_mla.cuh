// Block-ragged MLA latent attention for Hopper: the kernel body shared by
// ragged_paged_mla.cu (model-dtype latent pools, kernel F) and
// ragged_paged_mla_q.cu (int8 latent pools, kernel H). They replace the TPU
// kernels rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_mla_attention_pallas` and
// `ragged_paged_mla_attention_pallas_q` (`_block_ragged_mla_kernel[_q]`).
// One launch serves a packed mix of prefill chunks and decode steps of
// many rows over the paged latent pools c [NP, page, 1, dc] and
// pe [NP, page, 1, dr].
//
// Token t of the pack attends slots < min(kv_lens[row_ids[t]], q_pos[t] + 1).
// Head h scores slot i as (q_lat[h]·c[i]·cs[i] + q_pe[h]·pe[i]·ps[i])·scale,
// where the f32 scales cs, ps [NP, page, 1, 1] exist for int8 pools only;
// the values are c, for int8 pools with the probabilities times cs while
// the denominator keeps p. Online softmax in f32; the output is
// acc / max(l, 1e-30) in latent space [1, T, H, dc]. A pad token
// (q_pos < 0) and a token of a row with kv_len == 0 give 0. Rows need not
// be contiguous runs of the pack.
//
// Bound: the latent cache is MQA-shaped (one [c | pe] row per slot serves
// every head), so a pack reads each row's live slots once, (dc + dr)·2 B a
// slot (int8: (dc + dr) B and 8 B of scales), for ~4·H·dc flops per slot
// and query token. Decode-heavy packs are bound by those bytes; as prefill
// chunks grow (64 tokens x 16 heads over a 2k-token row is ~1k query rows
// per slot) the products pass the card's bf16 ridge (~295 flop/byte) and
// operations bound it. So the design puts every head of several tokens on
// one staged block and runs both products on the tensor cores.
//
// 1. Work items (rk::Items, shared with kernels B and D): an item is (row,
//    a tile of the row's live tokens x a slice of the heads, split). The
//    tile is kRows query rows filled token-major: HG = min(H, kRows) heads
//    of TM = kRows / HG tokens (query row r = token k·HG + head h), in NHG
//    = ceil(H / HG) head slices: at H = 16 (deepseek-v2-lite) four tokens
//    x 16 heads, at H = 128 (deepseek-v3) one token in two 64-row slices.
//    A row's walk of 32-slot latent blocks (its own kv_len) splits into
//    ns = min(cap, kMaxSplits, ceil(blocks / kMinSplitBlocks)) items, where
//    cap = ceil(kItemsPerBlock · resident blocks / tiles) comes from the
//    pack and the card, never from the table width P: few tiles (a
//    decode-heavy pack) split as far as kMaxSplits, many (deepseek-v3's
//    prefill chunks) do not split: there the partials' traffic cost more
//    than the balance gained (on the H100, aiming at two items per block
//    took deepseek-v3's pack from 0.72 to 0.55 ms and deepseek-v2-lite's
//    from 0.21 to 0.17 ms against four). The split that finishes last
//    merges the partials (o, m, l) on the card in split order, so the
//    output bits depend neither on finishing order nor on P. Partials are
//    numbered by the live tokens of the rows that split, cap of them each:
//    a launch writes fewer than 2 · kItemsPerBlock · resident blocks · kRows
//    of them (launch_ragged_mla), however long the pack. The launch is persistent
//    (as many blocks as the card holds); items come from a queue, highest
//    split level first. Live tokens are gathered by the ordered ballot/popc
//    scan (rk::gather_tokens): pads and kv_len-0 rows never enter a tile,
//    and every block writes the zeros of the dead tokens in warp-stride.
//    Block 0 records the launch's items and grid in the counts buffer,
//    where launch_report reads them.
// 2. Staging (as kernels E and G): a stage is one block of kBN = 32 slots,
//    its c and pe rows copied with 16-byte cp.async, several stages in
//    flight. Each slot's page id comes from the table row (rbg::PageMap: a
//    shift for a power-of-two page size, a division otherwise), so a block
//    spans pages of any size. int8 pools stage the raw bytes and the two
//    scales per slot and convert each block into one tile of the query's
//    type in shared memory, which is exact. Only blocks reaching past the
//    tile's smallest limit apply the per-token causal mask; masked slots
//    get p = 0 explicitly (a later split may see no slot of a row: such a
//    partial, m = -1e30 and l = 0, weighs 0 in the merge).
// 3. bf16 queries (the served dtype): eight warps, 64 query rows
//    (kMmaRows, kMmaThreads). Q [64, dc + dr] (75 KB at deepseek widths,
//    too large for registers) is staged once per item and read per block
//    through ldmatrix. Each 16-row group has kWpg = 2 warps: warp w takes
//    group w / kWpg and part w % kWpg of the k steps of
//    S = [q_lat | q_pe]·[c | pe]ᵀ (mma.sync m16n8k16, bf16 -> f32; int8
//    pools keep S_c and S_pe apart and fold s = S_c·cs + S_pe·ps per slot);
//    the parts are summed in shared memory in warp order, where four
//    threads per row take the online softmax and write P as bf16 hi + lo
//    parts (kernel B's rounding fix). Then warp w adds P·c for part
//    w % kWpg of the dc columns of its group (256 columns, 128 f32
//    accumulators a thread at dc = 512), c through ldmatrix.trans. A warp whose group has
//    no query row (a decode token at H = 16 fills one group) skips its
//    products. Shared memory at (512, 64): three 37 KB stages (int8: one
//    converted tile and four raw stages), Q, the partial scores and P:
//    about 220 KB, one block per SM (__launch_bounds__(256, 1)). ptxas
//    (sm_90a): 255 registers and 0 spills with bf16 and int8 pools. The
//    128 accumulators leave little room, and ptxas spilled a few bytes
//    whenever values lived across the whole walk, so the walk holds the
//    item plan (rk::Items), the rows' softmax state and the table row in
//    shared memory, derives its lane offsets inside each step
//    (rbg::thread_index), unrolls the k steps by two and leaves the item
//    setup's small loops rolled. Two smaller tiles were measured against it
//    (H100 80GB HBM3, 700 W; scripts/torch_ab.py --kernels against a copy
//    of the tree with kMmaRows and kMmaThreads changed, device time over
//    the 64-row tile's on the kernels phase's pack): 32 rows with eight
//    warps (four a group, 64 accumulators, 175 / 191 registers) took F / H
//    1.05 / 1.08x at deepseek-v2-lite and 1.23 / 1.29x at deepseek-v3; 32
//    rows with four warps (two a group, 128 accumulators) 1.37 / 1.37x and
//    1.55 / 1.55x, and spilled 8 bytes. The 64-row tile stays: each staged
//    block serves twice the query rows, for the same barriers per step.
// 4. f32 queries (tests, tiny-mla, the f32 witness): the same items,
//    splits, merge and staging with 16-row tiles, four warps and f32 FMAs
//    on CUDA cores, no TF32: each thread scores one slot against four rows
//    (q read as float4 broadcasts from shared memory), eight threads per
//    row take the softmax, and each thread accumulates 64 (row, column)
//    outputs (kernel E's f32 step with a causal limit per row).

#pragma once

#include <climits>
#include <type_traits>

#include "mma_common.cuh"
#include "paged_attn_common.cuh"
#include "paged_mla_decode.cuh"
#include "ragged_paged.cuh"

namespace {

namespace rm {

constexpr int kBN = pm::kBN;           // latent slots per pipeline step (E and G's staging)
constexpr int kMinSplitBlocks = 8;     // a split per 8 latent blocks (256 slots) of a row
constexpr int kMaxSplits = 8;          // items of one tile's walk at most
constexpr int kItemsPerBlock = 2;      // the split cap aims at this many items per block
constexpr int kMaxDevices = 16;
// bf16 queries: query rows of a tile and threads of a block. Each 16-row
// group of the tile has kWpg = threads / 32 / (rows / 16) warps, which
// split S's k steps and P·c's dc columns: 128 accumulators a thread at dc =
// 512 with two warps a group, 64 with four.
constexpr int kMmaRows = 64, kMmaThreads = 256;
using rk::kGridSlot;
using rk::kHeadSlot;
using rk::kItemsSlot;
using rk::kLog2e;
using rk::kTileSlot0;

// Dynamic shared memory of one block, in bytes from its start: the staged
// [c | pe] tiles (every stage for model-dtype pools; the converted one for
// int8 pools, whose raw stages and scales follow), Q, the work area (bf16:
// the two k halves' partial scores and P's hi and lo parts; f32: the
// scores), then per query row the softmax's alpha, m, l and causal limit.
template <typename T, typename KVT, int DC, int DR>
struct Layout {
  static constexpr bool kQuant = std::is_same<KVT, int8_t>::value;
  static constexpr bool kMma = std::is_same<T, __nv_bfloat16>::value;
  static constexpr int kThreads = kMma ? kMmaThreads : 128;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kRows = kMma ? kMmaRows : 16;     // query rows of a tile
  static constexpr int kWpg = kWarps / (kRows / 16);     // warps of a 16-row group (bf16)
  static constexpr int kStages = kQuant ? 4 : (kMma ? 3 : 2);
  static constexpr int E = (int)sizeof(T);
  static constexpr int LDC = DC + 16 / E, LDP = DR + 16 / E;  // staged rows, elements
  static constexpr int LDQ = DC + DR + 16 / E;                // Q rows [q_lat | q_pe]
  static constexpr int kCTile = kBN * LDC * E, kTile = kCTile + kBN * LDP * E;
  static constexpr int kRawC = kBN * DC, kRaw = kRawC + kBN * DR;  // one int8 block
  static constexpr int kRawOff = (kQuant ? 1 : kStages) * kTile;
  static constexpr int kScaleOff = kRawOff + (kQuant ? kStages * kRaw : 0);
  static constexpr int kQOff = kScaleOff + (kQuant ? kStages * 2 * kBN * 4 : 0);
  static constexpr int kWorkOff = kQOff + kRows * LDQ * E;
  static constexpr int kRLd = kBN + 8, kPLd = kBN + 8, kSLd = kBN + 1;
  static constexpr int kRedBytes = kWpg * kRows * kRLd * 4;
  static constexpr int kStateOff =
      kWorkOff + (kMma ? kRedBytes + 2 * kRows * kPLd * 2 : kRows * kSLd * 4);
  static constexpr int kBytes = kStateOff + 4 * kRows * 4;
  // The last split's merge weights, [kRows][kMaxSplits] and 1 / l, reuse
  // the stages.
  static_assert(kRows * (kMaxSplits + 1) * 4 <= kRawOff, "the merge's weights fit");
  static_assert(DC % (16 * kWpg) == 0 && DR % 16 == 0, "k steps of 16, dc in kWpg parts of 16");
  static_assert(!kMma || (kWpg >= 1 && kWarps == kWpg * kRows / 16 && kThreads / 4 >= kRows),
                "whole warps per group; four softmax threads per row");
  static_assert(kThreads % kBN == 0, "whole threads per staged slot");
  static_assert(kMma || (kRows == pm::kRows && kThreads == pm::kThreads),
                "f32 queries take kernel E's block step (pm::fma_block)");
};

// bf16 queries: one warp's partial scores of a latent block over k steps
// [K0, K1) of [q_lat | q_pe] (c's steps first, then pe's): 16 query rows
// of group grp against the block's 32 slots. int8 pools keep the c and pe
// parts apart and fold each slot's two scales here; sc then holds the
// partial s before the softmax scale.
template <typename KVT, int DC, int DR, int K0, int K1>
__device__ __forceinline__ void score_steps(float (&sc)[kBN / 8][4], const __nv_bfloat16* sq,
                                            const __nv_bfloat16* tc, const __nv_bfloat16* tp,
                                            const float* scl, int grp, int lane) {
  using L = Layout<__nv_bfloat16, KVT, DC, DR>;
  constexpr int KC = DC / 16;
  constexpr bool kSplitPe = L::kQuant && K1 > KC;
  float sp[kBN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[nt][e] = sp[nt][e] = 0.f;
  const __nv_bfloat16* qrow = sq + (grp * 16 + (lane & 15)) * L::LDQ + (lane >> 4) * 8;
  // One k step: Q's A fragment, then an x4 ldmatrix of c (pe) rows gives
  // the B fragments of slot tiles 2np and 2np + 1.
  auto step = [&](float (&acc)[kBN / 8][4], int kk, const __nv_bfloat16* brow, int ld) {
    uint32_t a[4];
    rbg::ldmatrix_x4(a, qrow + kk * 16);
#pragma unroll
    for (int np = 0; np < kBN / 16; ++np) {
      uint32_t b[4];
      rbg::ldmatrix_x4(b, brow + (np * 16 + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8);
      rbg::mma_bf16(acc[2 * np], a, b[0], b[1]);
      rbg::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  };
  const __nv_bfloat16* crow = tc + (lane & 7) * L::LDC;
  const __nv_bfloat16* prow = tp + (lane & 7) * L::LDP;
#pragma unroll 2
  for (int kk = K0; kk < (K1 < KC ? K1 : KC); ++kk) step(sc, kk, crow + kk * 16, L::LDC);
#pragma unroll 2
  for (int kk = (K0 > KC ? K0 : KC); kk < K1; ++kk)
    step(kSplitPe ? sp : sc, kk, prow + (kk - KC) * 16, L::LDP);
  if constexpr (L::kQuant) {
    const int tig = lane & 3;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + 2 * tig + (e & 1);
        sc[nt][e] = kSplitPe ? sc[nt][e] * scl[col] + sp[nt][e] * scl[kBN + col]
                             : sc[nt][e] * scl[col];
      }
  }
}

// Part `part` of kWpg of the k steps of [q_lat | q_pe] (score_steps).
template <typename KVT, int DC, int DR, int WPG, int P = 0>
__device__ __forceinline__ void score_part(float (&sc)[kBN / 8][4], int part,
                                           const __nv_bfloat16* sq, const __nv_bfloat16* tc,
                                           const __nv_bfloat16* tp, const float* scl, int grp,
                                           int lane) {
  constexpr int KT = (DC + DR) / 16;
  if constexpr (P < WPG) {
    if (part == P)
      score_steps<KVT, DC, DR, (P * KT + WPG - 1) / WPG, ((P + 1) * KT + WPG - 1) / WPG>(
          sc, sq, tc, tp, scl, grp, lane);
    else
      score_part<KVT, DC, DR, WPG, P + 1>(sc, part, sq, tc, tp, scl, grp, lane);
  }
}

// T: q and output element type; KVT: latent pool element type (T, or int8_t
// with f32 scales [NP, page, 1, 1] for c and for pe). A partial's row (one
// query row of one split) is o unnormalised [DC], then m (log2 units) and l.
template <typename T, typename KVT, int DC, int DR>
__global__ void __launch_bounds__(Layout<T, KVT, DC, DR>::kThreads, 1)
ragged_paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                        const KVT* __restrict__ c_pages, const KVT* __restrict__ pe_pages,
                        const float* __restrict__ c_scales, const float* __restrict__ pe_scales,
                        const int* __restrict__ table, const int* __restrict__ kv_lens,
                        const int* __restrict__ row_ids, const int* __restrict__ q_pos,
                        T* __restrict__ out, float* __restrict__ part, int* __restrict__ done,
                        int n_tokens, int R, int H, int HG, int NHG, int page, int pshift, int P,
                        int target, float scale) {
  using L = Layout<T, KVT, DC, DR>;
  constexpr int S = L::kStages, NT = L::kThreads, NW = L::kWarps, KR = L::kRows;
  constexpr int CLD = DC + 4;
  extern __shared__ __align__(16) unsigned char sm[];
  __shared__ int s_cnt[rk::kMaxRows];
  __shared__ int s_tok[KR];
  __shared__ int s_lim[KR];
  __shared__ int s_warp[NW];
  __shared__ int s_item[11];
  using Plan = rk::Items<NT, kBN, kMaxSplits, kMinSplitBlocks, true>;
  __shared__ int s_plan[Plan::kInts];
  __shared__ unsigned char s_ns[rk::kMaxRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tm = KR / HG, cap = P * page;

  // Dead tokens (pads, kv_len-0 rows) of this block's warp-stride share get
  // zeros, one token [H, DC] per warp.
#pragma unroll 1
  for (long t = (long)blockIdx.x * NW + warp; t < n_tokens; t += (long)gridDim.x * NW) {
    int r;
    if (rk::live_limit((int)t, row_ids, q_pos, kv_lens, R, cap, &r) > 0) continue;
    uint4* o = reinterpret_cast<uint4*>(out + t * H * DC);
#pragma unroll 1
    for (int c = lane; c < H * DC * (int)sizeof(T) / 16; c += 32)
      o[c] = make_uint4(0u, 0u, 0u, 0u);
  }

  Plan it{s_plan, s_ns, R};
  const int n_items = it.derive(s_cnt, s_warp, n_tokens, tm, row_ids, q_pos, kv_lens, cap,
                                NHG, target);
  if (blockIdx.x == 0 && tid == 0) {
    done[kItemsSlot] = n_items * NHG;
    done[kGridSlot] = (int)gridDim.x;
  }

  const float sl2 = scale * kLog2e;
  float* s_alpha = reinterpret_cast<float*>(sm + L::kStateOff);
  float* s_m = s_alpha + KR;
  float* s_l = s_m + KR;
  int* s_rlim = reinterpret_cast<int*>(s_l + KR);
  T* sq = reinterpret_cast<T*>(sm + L::kQOff);
  // Every block draws items until it draws one past the last: a launch
  // draws n_items * NHG + gridDim.x times, and atomicInc wraps the head
  // back to 0 at the last draw.
  const unsigned last_draw = (unsigned)(n_items * NHG) + gridDim.x - 1u;
  for (;;) {
    if (tid == 0)
      s_item[5] = (int)atomicInc(reinterpret_cast<unsigned*>(done) + kHeadSlot, last_draw);
    __syncthreads();
    const int qi = s_item[5];
    if (qi >= n_items * NHG) break;  // the same for every thread of the block
    {
      const int split = it.find(qi / NHG, s_cnt, s_warp, tm, kv_lens, cap, s_item);
      if (tid == 0) s_item[8] = split;
    }
    __syncthreads();
    // The item (s_item, read where it is used, so that a walk holds little
    // of it in registers): row s_item[0], tile s_item[1] of the row, ns =
    // s_item[2] splits, tile id s_item[3], blocks per split s_item[7],
    // split s_item[8]; head slice hs of NHG. Query row r's partial is row
    // s_item[10] + r * s_item[9] of part (with ns > 1): ((first partial
    // row s_item[6]) * HG + r) * NHG + hs, then the launch's cap of splits.
    const int hs = qi % NHG, h0 = hs * HG;
    if (tid == 0) {
      s_item[9] = NHG * it.cap();
      s_item[10] = (s_item[6] * HG * NHG + hs) * it.cap() + s_item[8];
    }
    const int row = s_item[0], lo = s_item[1] * tm;
    const int ntok = min(tm, s_cnt[row] - lo), nrows = ntok * HG;
    rk::gather_tokens<NT>(row, lo, ntok, n_tokens, row_ids, q_pos, kv_lens, R, cap, s_tok,
                          s_lim, s_warp);
    __syncthreads();
    int lmin = INT_MAX, lmax = 0;  // the tile's smallest and largest limits (every warp alike)
#pragma unroll 1
    for (int i = lane; i < ntok; i += 32) {
      lmin = min(lmin, s_lim[i]);
      lmax = max(lmax, s_lim[i]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      lmin = min(lmin, __shfl_xor_sync(0xffffffffu, lmin, o));
      lmax = max(lmax, __shfl_xor_sync(0xffffffffu, lmax, o));
    }
    // This split's latent blocks [kb0, kb0 + nblk) of the tile's walk
    // (none when the tile ends before the row does).
    const int kb0 = s_item[8] * s_item[7];
    const int nblk = max(0, min((lmax + kBN - 1) / kBN, kb0 + s_item[7]) - kb0);
    const int last = rbg::PageMap{nullptr, 0, page, pshift}.last_of(lmax);
    // Step i's block into its stage (an empty group past the split); the
    // table row's address is made per call, not held through the walk.
    auto issue = [&](int i) {
      if (i < nblk)
        pm::issue_block<L, KVT, DC, DR>(
            sm, i % S, kb0 + i, c_pages, pe_pages, c_scales, pe_scales,
            rbg::PageMap{table + (long)s_item[0] * P, last, page, pshift});
      rbg::cp_async_commit();
    };
    // Q rows r = k·HG + h: [q_lat | q_pe] of token s_tok[k], head h0 + h,
    // copied with cp.async in the first block's group; rows past the
    // tile's (or past H) are zero.
    {
      constexpr int VC = DC * L::E / 16, VP = DR * L::E / 16, VQ = VC + VP;
      const int nh = min(HG, H - h0);
      for (int c = tid; c < KR * VQ; c += NT) {
        const int r = c / VQ, ch = c % VQ, h = r % HG;
        uint4* dst = reinterpret_cast<uint4*>(sq + r * L::LDQ) + ch;
        if (r < nrows && h < nh) {
          const long qr = (long)s_tok[r / HG] * H + h0 + h;
          rbg::cp_async16(dst, ch < VC ? reinterpret_cast<const uint4*>(q_lat + qr * DC) + ch
                                       : reinterpret_cast<const uint4*>(q_pe + qr * DR) + ch - VC);
        } else {
          *dst = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < S - 1; ++i) issue(i);
    // Wait for step i's block, then refill the stage step i - 1 used (every
    // thread is past step i - 1 here); int8 pools convert the block into
    // the shared tile. Returns the staged c tile; pe's follows it.
    auto take = [&](int i) -> const T* {
      rbg::cp_async_wait<S - 2>();
      __syncthreads();
      issue(i + S - 1);
      if constexpr (L::kQuant) {
        pm::convert_block<L, T, DC, DR>(sm, i % S);
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
    // Query row r < nrows of the tile holds a head (h0 + r % HG < H).
    auto row_ok = [&](int r) { return r < nrows && h0 + r % HG < H; };
    // The split's result for query row r, columns c, c + 1: out when the
    // tile's walk is one split, else a partial of the merge (m and l once
    // per row, with ml).
    auto finish2 = [&](int r, int c, float o0, float o1, bool ml) {
      if (s_item[2] == 1) {
        const float inv = 1.f / fmaxf(s_l[r], 1e-30f);
        T* dst = out + ((long)s_tok[r / HG] * H + h0 + r % HG) * DC + c;
        if constexpr (L::kMma)
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o0 * inv, o1 * inv);
        else
          *reinterpret_cast<float2*>(dst) = make_float2(o0 * inv, o1 * inv);
      } else {
        float* mine = part + ((long)s_item[10] + (long)r * s_item[9]) * CLD;
        *reinterpret_cast<float2*>(mine + c) = make_float2(o0, o1);
        if (ml) *reinterpret_cast<float2*>(mine + DC) = make_float2(s_m[r], s_l[r]);
      }
    };

    if constexpr (L::kMma) {
      constexpr int WPG = L::kWpg, DCW = DC / WPG;  // warps of a group, O columns per warp
      const int ng = (nrows + 15) / 16;
      // A warp past the tile's groups skips its products.
      const bool active = (int)((unsigned)warp / WPG) < ng;
      float* red = reinterpret_cast<float*>(sm + L::kWorkOff);  // [WPG][KR][kRLd]
      __nv_bfloat16* phi = reinterpret_cast<__nv_bfloat16*>(sm + L::kWorkOff + L::kRedBytes);
      __nv_bfloat16* plo = phi + KR * L::kPLd;
      // Softmax rows: four threads per row r = tid / 4, slots q8 .. q8 + 7.
      // The row's causal limit and running max (log2 units) and sum are in
      // shared memory (s_rlim, s_m, s_l), not held through the walk.
      if ((tid & 3) == 0 && (tid >> 2) < KR) {
        s_rlim[tid >> 2] = (tid >> 2) < nrows ? s_lim[(tid >> 2) / HG] : lmax;
        s_m[tid >> 2] = rbg::kNegInf;
        s_l[tid >> 2] = 0.f;
      }
      float o[DCW / 8][4];
#pragma unroll
      for (int dt = 0; dt < DCW / 8; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;

      for (int i = 0; i < nblk; ++i) {
        const __nv_bfloat16* tc = take(i);
        const __nv_bfloat16* tp = tc + L::kCTile / 2;
        const int nb = kb0 + i;
        const bool masked = (nb + 1) * kBN > lmin;
        const float* scl = L::kQuant ? scales_of(i) : nullptr;
        // The thread's group, part, lanes and softmax row from a read of
        // threadIdx.x made here: the addresses built from them live within
        // the step, not across the walk (the accumulators fill the registers).
        const int t = rbg::thread_index(), ln = t & 31;
        const int grp = (unsigned)t / (32u * WPG), part = ((unsigned)t >> 5) % WPG;
        const int gid = ln >> 2, tig = ln & 3;
        const int sr = t >> 2, q8 = (t & 3) * 8;
        if (active) {
          float s[kBN / 8][4];
          score_part<KVT, DC, DR, WPG>(s, part, sq, tc, tp, scl, grp, ln);
          float* rw = red + (part * KR + grp * 16 + gid) * L::kRLd;
#pragma unroll
          for (int nt = 0; nt < kBN / 8; ++nt) {
            *reinterpret_cast<float2*>(rw + nt * 8 + 2 * tig) = make_float2(s[nt][0], s[nt][1]);
            *reinterpret_cast<float2*>(rw + 8 * L::kRLd + nt * 8 + 2 * tig) =
                make_float2(s[nt][2], s[nt][3]);
          }
        }
        __syncthreads();
        // Scores of row sr, slots q8 ..: the parts summed in warp order,
        // scaled; the softmax; P as bf16 hi + lo (times cs for int8 pools,
        // whose denominator keeps p).
        if (sr < ng * 16) {  // whole warps: warp w holds rows 8w .. 8w + 7
          float x[8];
          const float* r0 = red + sr * L::kRLd + q8;
#pragma unroll
          for (int e = 0; e < 8; e += 4) {
            float4 a = *reinterpret_cast<const float4*>(r0 + e);
#pragma unroll
            for (int p = 1; p < WPG; ++p) {
              const float4 b = *reinterpret_cast<const float4*>(r0 + p * KR * L::kRLd + e);
              a.x += b.x;
              a.y += b.y;
              a.z += b.z;
              a.w += b.w;
            }
            x[e] = a.x * sl2;
            x[e + 1] = a.y * sl2;
            x[e + 2] = a.z * sl2;
            x[e + 3] = a.w * sl2;
          }
          const int lim = s_rlim[sr];
          const float m_run = s_m[sr];
          float mx = rbg::kNegInf;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            if (masked && nb * kBN + q8 + e >= lim) x[e] = rbg::kNegInf;
            mx = fmaxf(mx, x[e]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_run, mx), alpha = exp2f(m_run - m_new);
          float sum = 0.f;
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float p = (!masked || x[e] > rbg::kNegInf) ? exp2f(x[e] - m_new) : 0.f;
            sum += p;
            x[e] = L::kQuant ? p * scl[q8 + e] : p;
          }
          sum += __shfl_xor_sync(0xffffffffu, sum, 1);
          sum += __shfl_xor_sync(0xffffffffu, sum, 2);
          __syncwarp();  // the row's four threads have read s_m[sr]
          if ((t & 3) == 0) {
            s_alpha[sr] = alpha;
            s_m[sr] = m_new;
            s_l[sr] = s_l[sr] * alpha + sum;
          }
          uint32_t hi[4], lo[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) rbg::split_bf16x2(x[2 * e], x[2 * e + 1], hi[e], lo[e]);
          *reinterpret_cast<uint4*>(phi + sr * L::kPLd + q8) =
              make_uint4(hi[0], hi[1], hi[2], hi[3]);
          *reinterpret_cast<uint4*>(plo + sr * L::kPLd + q8) =
              make_uint4(lo[0], lo[1], lo[2], lo[3]);
        }
        __syncthreads();
        // O[group rows, part's columns] = alpha·O + P·c.
        if (active) {
          const float a0 = s_alpha[grp * 16 + gid], a1 = s_alpha[grp * 16 + gid + 8];
#pragma unroll
          for (int dt = 0; dt < DCW / 8; ++dt) {
            o[dt][0] *= a0;
            o[dt][1] *= a0;
            o[dt][2] *= a1;
            o[dt][3] *= a1;
          }
#pragma unroll 1
          for (int kk = 0; kk < kBN / 16; ++kk) {
            uint32_t ah[4], al[4];
            const int pr = (grp * 16 + (ln & 15)) * L::kPLd + kk * 16 + (ln >> 4) * 8;
            rbg::ldmatrix_x4(ah, phi + pr);
            rbg::ldmatrix_x4(al, plo + pr);
            const __nv_bfloat16* vrow = tc + (kk * 16 + (ln & 7) + ((ln >> 3) & 1) * 8) * L::LDC
                                        + (ln >> 4) * 8 + part * DCW;
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
      __syncthreads();
      if (active) {
        const int grp = (unsigned)warp / WPG, part = (unsigned)warp % WPG;
        const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = grp * 16 + gid + 8 * h;
          if (row_ok(r))
#pragma unroll
            for (int dt = 0; dt < DCW / 8; ++dt)
              finish2(r, part * DCW + dt * 8 + 2 * tig, o[dt][2 * h], o[dt][2 * h + 1],
                      part == 0 && dt == 0 && tig == 0);
        }
      }
    } else {
      constexpr int CQ = DC / 4, RS = NT / CQ;  // P·c: column quads, row stride
      float* ss = reinterpret_cast<float*>(sm + L::kWorkOff);  // S, then P [KR][kSLd]
      // Softmax rows: eight threads per row tid / 8, each keeping its
      // running max and sum.
      const int sr = tid >> 3;
      const int lim = sr < nrows ? s_lim[sr / HG] : lmax;
      float m_run = rbg::kNegInf, l_run = 0.f;
      if ((tid & 7) == 0) {
        s_m[sr] = m_run;
        s_l[sr] = l_run;
      }
      const int cq = tid % CQ, r0 = tid / CQ;
      float o[KR / RS][4];
#pragma unroll
      for (int i = 0; i < KR / RS; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
      for (int i = 0; i < nblk; ++i) {
        const float* tc = take(i);
        const int nb = kb0 + i;
        pm::fma_block<L, DC, DR, L::LDQ>(o, tc, tc + L::kCTile / 4,
                                         reinterpret_cast<const float*>(sq), ss, scales_of(i),
                                         sl2, nb, (nb + 1) * kBN > lmin, lim, m_run, l_run,
                                         s_alpha, s_m, s_l);
      }
      rbg::cp_async_wait<0>();
      __syncthreads();  // s_m, s_l of an empty split are its initial state
#pragma unroll
      for (int k = 0; k < KR / RS; ++k) {
        const int r = r0 + RS * k;
        if (row_ok(r)) {
          finish2(r, 4 * cq, o[k][0], o[k][1], cq == 0);
          finish2(r, 4 * cq + 2, o[k][2], o[k][3], false);
        }
      }
    }

    // Several splits: the last to finish merges every split's partial, in
    // split order (its atomicInc wraps the count back to 0).
    const int ns = s_item[2];
    if (ns > 1) {
      __threadfence();
      __syncthreads();
      if (tid == 0)
        s_item[4] = atomicInc(reinterpret_cast<unsigned*>(done) + kTileSlot0 + s_item[3] * NHG + hs,
                              (unsigned)(ns - 1)) == (unsigned)(ns - 1);
      __syncthreads();
      if (s_item[4]) {
        __threadfence();
        // Each row's weight per split and 1 / l (in the free stages); then
        // every load of a thread is issued before any is used, past L1
        // (other blocks wrote them), and the sums run in split order.
        float* s_w = reinterpret_cast<float*>(sm);  // [KR][kMaxSplits]
        float* s_inv = s_w + KR * kMaxSplits;
        auto partial = [&](int r) {  // split 0's
          return part + ((long)(s_item[10] - s_item[8]) + (long)r * s_item[9]) * CLD;
        };
#pragma unroll 1
        for (int r = tid; r < nrows; r += NT) {
          if (!row_ok(r)) continue;
          const float* all = partial(r);
          float2 ml[kMaxSplits];
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp)
            ml[sp] = sp < ns ? __ldcg(reinterpret_cast<const float2*>(all + sp * CLD + DC))
                             : make_float2(rbg::kNegInf, 0.f);
          float m = rbg::kNegInf, l = 0.f;
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) m = fmaxf(m, ml[sp].x);
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) {
            const float w = sp < ns ? exp2f(ml[sp].x - m) : 0.f;  // 0 for a split that saw nothing
            s_w[r * kMaxSplits + sp] = w;
            l = fmaf(w, ml[sp].y, l);
          }
          s_inv[r] = 1.f / fmaxf(l, 1e-30f);
        }
        __syncthreads();
        for (int i = tid; i < nrows * (DC / 4); i += NT) {
          const int r = i / (DC / 4), c = (i % (DC / 4)) * 4;
          if (!row_ok(r)) continue;
          const float* all = partial(r);
          float4 v[kMaxSplits];
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp)
            if (sp < ns) v[sp] = __ldcg(reinterpret_cast<const float4*>(all + sp * CLD + c));
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) {
            if (sp < ns) {
              const float w = s_w[r * kMaxSplits + sp];
              a.x = fmaf(w, v[sp].x, a.x);
              a.y = fmaf(w, v[sp].y, a.y);
              a.z = fmaf(w, v[sp].z, a.z);
              a.w = fmaf(w, v[sp].w, a.w);
            }
          }
          const float inv = s_inv[r];
          rbg::store4(out + ((long)s_tok[r / HG] * H + h0 + r % HG) * DC + c,
                 make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
        }
      }
    }
    __syncthreads();  // shared memory is the next item's
  }
}

template <typename T, typename KVT, int DC, int DR>
int launch_dims(const void* q_lat, const void* q_pe, const void* c_pages, const void* pe_pages,
                const void* c_scales, const void* pe_scales, const void* table,
                const void* kv_lens, const void* row_ids, const void* q_pos, void* out,
                void* part, long part_rows, void* done, int n_tokens, int R, int H, int page,
                int P, float scale, int dev, cudaStream_t stream) {
  using L = Layout<T, KVT, DC, DR>;
  // As many blocks as fit on the card at once (they draw items from the
  // queue), or as many as there can be items. Found at a device's first
  // launch, with the shared-memory attribute.
  static int resident[kMaxDevices];
  if (resident[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(ragged_paged_mla_kernel<T, KVT, DC, DR>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::kBytes);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, ragged_paged_mla_kernel<T, KVT, DC, DR>, L::kThreads, L::kBytes);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = max(1, sms * per_sm);
  }
  const int HG = min(H, L::kRows), NHG = (H + HG - 1) / HG, tm = L::kRows / HG;
  const int target = kItemsPerBlock * resident[dev];
  // Partial rows the launch may write (launch_ragged_mla's contract).
  const long need = min((long)n_tokens * HG * NHG * kMaxSplits, 2L * target * L::kRows);
  if (need > part_rows) return (int)-need;
  const long bound = (long)((n_tokens + tm - 1) / tm + R) * kMaxSplits * NHG;
  const dim3 grid((unsigned)min((long)resident[dev], bound));
  ragged_paged_mla_kernel<T, KVT, DC, DR><<<grid, L::kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe),
      static_cast<const KVT*>(c_pages), static_cast<const KVT*>(pe_pages),
      static_cast<const float*>(c_scales), static_cast<const float*>(pe_scales),
      static_cast<const int*>(table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(row_ids), static_cast<const int*>(q_pos), static_cast<T*>(out),
      static_cast<float*>(part), static_cast<int*>(done), n_tokens, R, H, HG, NHG, page,
      rbg::page_shift(page), P, target, scale);
  return (int)cudaGetLastError();
}

}  // namespace rm

// The shapes the kernel takes (the wrapper refuses others first, with a
// ValueError): (dc, dr) = (512, 64) or (64, 16), any H >= 1, any page size,
// at most rk::kMaxRows table rows. With HG = min(H, rows) heads of a tile's
// rows (64 for bf16 queries, 16 for f32), TM = rows / HG tokens and NHG =
// ceil(H / HG): done is int32 counts of rk::kTileSlot0 + (ceil(n_tokens /
// TM) + R) * NHG, zero when first used; part is float32 scratch of
// part_rows partial rows of dc + 4. A launch writes at most
//   need = min(n_tokens * HG * NHG * rm::kMaxSplits, 2 * target * rows)
// rows, target = rm::kItemsPerBlock x the blocks the card holds at once:
// only the live tokens of splitting rows have partials, a row splits only
// when the launch has fewer (tile, head slice) pairs than target, and the
// split cap keeps their splits under 2 * target in all. With part_rows <
// need nothing is launched and -need is returned, so that the caller can
// grow the scratch and launch again. The launch goes to device `dev` (q's,
// whose stream `stream` is); the calling thread's current device is left
// as it was.
template <typename T, typename KVT>
int launch_ragged_mla(const void* q_lat, const void* q_pe, const void* c_pages,
                      const void* pe_pages, const void* c_scales, const void* pe_scales,
                      const void* table, const void* kv_lens, const void* row_ids,
                      const void* q_pos, void* out, void* part, long part_rows, void* done,
                      int n_tokens, int R, int H, int dc, int dr, int page, int P, float scale,
                      int dev, cudaStream_t stream) {
  if (n_tokens == 0) return 0;
  if (H < 1 || page < 1 || P < 0 || R < 0 || R > rk::kMaxRows || dev < 0 ||
      dev >= rm::kMaxDevices)
    return (int)cudaErrorInvalidValue;
  int cur = 0;
  cudaError_t err = cudaGetDevice(&cur);
  if (err == cudaSuccess && cur != dev) err = cudaSetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  int rc = (int)cudaErrorInvalidValue;
  if (dc == 512 && dr == 64)
    rc = rm::launch_dims<T, KVT, 512, 64>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales,
                                          table, kv_lens, row_ids, q_pos, out, part, part_rows,
                                          done, n_tokens, R, H, page, P, scale, dev, stream);
  else if (dc == 64 && dr == 16)
    rc = rm::launch_dims<T, KVT, 64, 16>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales,
                                         table, kv_lens, row_ids, q_pos, out, part, part_rows,
                                         done, n_tokens, R, H, page, P, scale, dev, stream);
  if (cur != dev) cudaSetDevice(cur);
  return rc;
}

}  // namespace
