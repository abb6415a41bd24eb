// Block-ragged paged attention for Hopper: the kernel body shared by
// ragged_paged.cu (model-dtype pools) and ragged_paged_q.cu (int8 pools).
// One launch serves a packed mix of prefill chunks and decode steps of
// many rows.
//
// Token t of the pack attends slots < min(kv_lens[row_ids[t]], q_pos[t] + 1);
// a pad token (q_pos < 0) and a row with kv_len == 0 give 0.
//
// Bound: bytes for decode-heavy packs; a prefill chunk of 64 tokens over a
// ~1k-token cache sits near the bf16 ridge (~270 flop/byte), so there the
// f32 CUDA-core arithmetic of this first version is far from the card's
// bound. Design: one block per (query tile of kTile packed tokens, kv
// head). The tile may span rows and need not hold a row as one contiguous
// run: the first token of each distinct row in the tile (first-occurrence
// leadership, as `_tile_leadership` does) walks that row's pages ONCE, up
// to the largest causal limit among the row's tokens in the tile, and all
// of the row's tokens in the tile (x G heads) ride that walk. So a prefill
// row's page is read once per tile, not once per token. Pad tokens never
// take part in a walk. The kernel takes any T; the last tile is masked.

#pragma once

#include "paged_attn_common.cuh"

namespace {

// T: q and output element type; KVT: pool element type (T, or int8_t with
// f32 scales [NP, page, KV, 1]).
template <typename T, typename KVT>
__global__ void __launch_bounds__(rbg::kThreads)
ragged_paged_kernel(const T* __restrict__ q, const KVT* __restrict__ k_pages,
                    const KVT* __restrict__ v_pages, const float* __restrict__ k_scales,
                    const float* __restrict__ v_scales, const int* __restrict__ table,
                    const int* __restrict__ kv_lens, const int* __restrict__ row_ids,
                    const int* __restrict__ q_pos, T* __restrict__ out, int n_tokens,
                    int R, int KV, int G, int hd, int page, int P, float scale) {
  extern __shared__ float smem[];
  __shared__ int tok_row[rbg::kTile];
  __shared__ int tok_lim[rbg::kTile];
  const int t0 = blockIdx.x * rbg::kTile, kv = blockIdx.y;
  const int nq = rbg::kTile * G;  // query row r = (tile token k) * G + g
  const rbg::Plan pl = rbg::gqa_plan(nq, hd, page);
  const rbg::Smem sm = rbg::carve(smem, pl);

  rbg::tile_rows(tok_row, tok_lim, t0, n_tokens, row_ids, q_pos, kv_lens, R);
  // q [1, T, H, hd] read as [T, KV, G, hd].
  for (int i = threadIdx.x; i < nq * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int t = t0 + r / G, g = r % G;
    sm.q[i] = t < n_tokens ? rbg::to_f32(q[(((long)t * KV + kv) * G + g) * hd + d])
                           : 0.f;
  }
  rbg::init_state(sm, pl);
  __syncthreads();

  for (int k = 0; k < rbg::kTile; ++k) {
    int nact = 0;
    const int row_limit = rbg::lead_row(sm, tok_row, tok_lim, k, G, &nact);
    if (row_limit == 0) continue;
    rbg::attend_row(sm, pl, nact, row_limit, table + (long)tok_row[k] * P, P,
                    k_pages, v_pages, k_scales, v_scales, kv, KV, scale);
  }

  for (int i = threadIdx.x; i < nq * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int t = t0 + r / G, g = r % G;
    if (t < n_tokens) {
      out[(((long)t * KV + kv) * G + g) * hd + d] =
          rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[r], 1e-30f));
    }
  }
}

template <typename T, typename KVT>
int launch_ragged(const void* q, const void* k_pages, const void* v_pages,
                  const void* k_scales, const void* v_scales, const void* table,
                  const void* kv_lens, const void* row_ids, const void* q_pos,
                  void* out, int n_tokens, int R, int KV, int G, int hd, int page,
                  int P, float scale, cudaStream_t stream) {
  if (n_tokens == 0) return 0;
  const size_t smem = rbg::smem_bytes(rbg::gqa_plan(rbg::kTile * G, hd, page));
  cudaError_t err = rbg::allow_smem(ragged_paged_kernel<T, KVT>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tokens + rbg::kTile - 1) / rbg::kTile, KV);
  ragged_paged_kernel<T, KVT><<<grid, rbg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KVT*>(k_pages),
      static_cast<const KVT*>(v_pages), static_cast<const float*>(k_scales),
      static_cast<const float*>(v_scales), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
      static_cast<const int*>(q_pos), static_cast<T*>(out), n_tokens, R, KV, G,
      hd, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace
