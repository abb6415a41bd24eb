// Block-ragged MLA latent attention for Hopper: the kernel body shared by
// ragged_paged_mla.cu (model-dtype latent pools, kernel F) and
// ragged_paged_mla_q.cu (int8 latent pools, kernel H). One launch serves a
// packed mix of prefill chunks and decode steps of many rows over the
// latent pools.
//
// Token t attends slots < min(kv_lens[row_ids[t]], q_pos[t] + 1) with
// scores (q_lat·c + q_pe·pe)·scale and values c; the output is latent
// [1, T, H, dc]. A pad token (q_pos < 0) and a row with kv_len == 0 give 0.
//
// Bound: bytes for decode-heavy packs; prefill chunks raise the flops per
// page byte toward the ridge, where the f32 CUDA-core arithmetic of this
// first version is far from the card's bound. Design: tile leadership
// (paged_attn_common.cuh `tile_rows` / `lead_row`: the first token of each
// distinct row in a tile of kTile packed tokens walks that row's pages once
// for all of the row's tokens in the tile; rows need not be contiguous
// runs). A block holding all heads of its kTile tokens would hold
// kTile·H rows of width dc + dr plus dc of
// accumulator, 8·16·1088·4 B = 557 KB at deepseek-v2-lite, far over the
// 227 KB a block may use. The heads are therefore split across blocks:
// a block owns (tile, group of hg heads), kTile·hg query rows. Splitting
// heads, not the tile's tokens, keeps the leader walk whole (one walk per
// distinct row and block) and gives T/kTile·H/hg blocks, which fills the
// card at prefill sizes; each c/pe page is then staged once per head group
// (from L2 after the first). The head group is a launch parameter; the
// wrapper picks kTile·hg <= 16 rows, about 108 KB at dc = 512, dr = 64.
// Staging is in f32 whatever the pool type, so int8 pools take the same
// shared memory.

#pragma once

#include "paged_attn_common.cuh"

namespace {

constexpr int kMlaThreads = 256;

// T: q and output element type; KVT: latent pool element type (T, or
// int8_t with f32 scales [NP, page, 1, 1] for c and for pe).
template <typename T, typename KVT>
__global__ void __launch_bounds__(kMlaThreads)
ragged_paged_mla_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                        const KVT* __restrict__ c_pages, const KVT* __restrict__ pe_pages,
                        const float* __restrict__ c_scales,
                        const float* __restrict__ pe_scales,
                        const int* __restrict__ table, const int* __restrict__ kv_lens,
                        const int* __restrict__ row_ids, const int* __restrict__ q_pos,
                        T* __restrict__ out, int n_tokens, int R, int H, int hg, int dc,
                        int dr, int page, int P, float scale) {
  extern __shared__ float smem[];
  __shared__ int tok_row[rbg::kTile];
  __shared__ int tok_lim[rbg::kTile];
  const int t0 = blockIdx.x * rbg::kTile, h0 = blockIdx.y * hg;
  const int nq = rbg::kTile * hg;  // query row r = (tile token k) * hg + g
  const int dq = dc + dr;
  const rbg::Plan pl = rbg::mla_plan(nq, dc, dr, page);
  const rbg::Smem sm = rbg::carve(smem, pl);

  rbg::tile_rows(tok_row, tok_lim, t0, n_tokens, row_ids, q_pos, kv_lens, R);
  // q row r = [q_lat | q_pe] of token t0 + r / hg, head h0 + r % hg.
  for (int i = threadIdx.x; i < nq * dq; i += blockDim.x) {
    const int r = i / dq, d = i % dq;
    const int t = t0 + r / hg;
    const long h = (long)t * H + h0 + r % hg;
    sm.q[i] = t < n_tokens
                  ? rbg::to_f32(d < dc ? q_lat[h * dc + d] : q_pe[h * dr + d - dc])
                  : 0.f;
  }
  rbg::init_state(sm, pl);
  __syncthreads();

  for (int k = 0; k < rbg::kTile; ++k) {
    int nact = 0;
    const int row_limit = rbg::lead_row(sm, tok_row, tok_lim, k, hg, &nact);
    if (row_limit == 0) continue;
    rbg::mla_attend_row(sm, pl, nact, row_limit, table + (long)tok_row[k] * P, P,
                        c_pages, pe_pages, c_scales, pe_scales, scale);
  }

  for (int i = threadIdx.x; i < nq * dc; i += blockDim.x) {
    const int r = i / dc, d = i % dc;
    const int t = t0 + r / hg;
    if (t < n_tokens) {
      out[((long)t * H + h0 + r % hg) * dc + d] =
          rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
    }
  }
}

template <typename T, typename KVT>
int launch_ragged_mla(const void* q_lat, const void* q_pe, const void* c_pages,
                      const void* pe_pages, const void* c_scales, const void* pe_scales,
                      const void* table, const void* kv_lens, const void* row_ids,
                      const void* q_pos, void* out, int n_tokens, int R, int H, int hg,
                      int dc, int dr, int page, int P, float scale, cudaStream_t stream) {
  if (hg <= 0 || H % hg) return (int)cudaErrorInvalidValue;
  if (n_tokens == 0) return 0;
  const size_t smem = rbg::smem_bytes(rbg::mla_plan(rbg::kTile * hg, dc, dr, page));
  cudaError_t err = rbg::allow_smem(ragged_paged_mla_kernel<T, KVT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tokens + rbg::kTile - 1) / rbg::kTile, H / hg);
  ragged_paged_mla_kernel<T, KVT><<<grid, kMlaThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe),
      static_cast<const KVT*>(c_pages), static_cast<const KVT*>(pe_pages),
      static_cast<const float*>(c_scales), static_cast<const float*>(pe_scales),
      static_cast<const int*>(table), static_cast<const int*>(kv_lens),
      static_cast<const int*>(row_ids), static_cast<const int*>(q_pos),
      static_cast<T*>(out), n_tokens, R, H, hg, dc, dr, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace
