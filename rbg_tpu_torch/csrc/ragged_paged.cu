// Block-ragged paged attention for Hopper: one launch serves a packed
// mix of prefill chunks and decode steps of many rows.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas` (`_block_ragged_kernel`). Token t of
// the pack attends slots < min(kv_lens[row_ids[t]], q_pos[t] + 1); a pad
// token (q_pos < 0) and a row with kv_len == 0 give 0.
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
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_attn_common.cuh"

namespace {

constexpr int kTile = 8;

template <typename T>
__global__ void __launch_bounds__(rbg::kThreads)
ragged_paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ table,
                    const int* __restrict__ kv_lens,
                    const int* __restrict__ row_ids,
                    const int* __restrict__ q_pos, T* __restrict__ out,
                    int n_tokens, int R, int KV, int G, int hd, int page, int P,
                    float scale) {
  extern __shared__ float smem[];
  __shared__ int tok_row[kTile];
  __shared__ int tok_lim[kTile];
  const int t0 = blockIdx.x * kTile, kv = blockIdx.y;
  const int nq = kTile * G;  // query row r = (tile token k) * G + g
  const rbg::Smem sm = rbg::carve(smem, nq, hd, page);

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
  // q [1, T, H, hd] read as [T, KV, G, hd].
  for (int i = threadIdx.x; i < nq * hd; i += blockDim.x) {
    const int r = i / hd, d = i % hd;
    const int t = t0 + r / G, g = r % G;
    sm.q[i] = t < n_tokens ? rbg::to_f32(q[(((long)t * KV + kv) * G + g) * hd + d])
                           : 0.f;
    sm.acc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < nq; r += blockDim.x) {
    sm.m[r] = rbg::kNegInf;
    sm.l[r] = 0.f;
  }
  __syncthreads();

  for (int k = 0; k < kTile; ++k) {
    const int row = tok_row[k];
    if (row < 0) continue;
    bool dup = false;
    for (int j = 0; j < k; ++j) dup |= tok_row[j] == row;
    if (dup) continue;  // an earlier token of the tile already led this row
    int nact = 0, row_limit = 0;
    for (int j = k; j < kTile; ++j) {
      if (tok_row[j] != row) continue;
      row_limit = max(row_limit, tok_lim[j]);
      for (int g = 0; g < G; ++g, ++nact) {
        if (threadIdx.x == 0) {
          sm.act[nact] = j * G + g;
          sm.lim[nact] = tok_lim[j];
        }
      }
    }
    __syncthreads();
    rbg::attend_row(sm, nact, row_limit, table + (long)row * P, P, k_pages,
                    v_pages, kv, KV, hd, page, scale);
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

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* kv_lens, const void* row_ids,
           const void* q_pos, void* out, int n_tokens, int R, int KV, int G,
           int hd, int page, int P, float scale, cudaStream_t stream) {
  const size_t smem = rbg::smem_bytes(kTile * G, hd, page);
  cudaError_t err = rbg::allow_smem(ragged_paged_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_tokens + kTile - 1) / kTile, KV);
  ragged_paged_kernel<T><<<grid, rbg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
      static_cast<const int*>(q_pos), static_cast<T*>(out), n_tokens, R, KV, G,
      hd, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int ragged_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* kv_lens, const void* row_ids,
                 const void* q_pos, void* out, int n_tokens, int R, int KV, int G,
                 int hd, int page, int P, float scale, int dtype, void* stream) {
  if (n_tokens == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, n_tokens, R, KV, G, hd, page, P, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, n_tokens, R, KV, G, hd, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
