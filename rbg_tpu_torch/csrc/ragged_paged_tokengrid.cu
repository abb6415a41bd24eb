// Token-grid ragged paged attention for Hopper: the baseline that the
// block-ragged kernel B is measured against.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas_tokengrid` (`_ragged_kernel`). It computes
// B's function: packed token t (row row_ids[t], position q_pos[t]) attends
// slots < min(kv_lens[row], q_pos[t] + 1) of its row's pages with scale
// hd^-0.5; a pad token (q_pos < 0) and a row with kv_len == 0 give 0.
// Model-dtype pools (f32 or bf16), as the original.
//
// Bound: bytes. The work is B's, so the bound is B's: each row's live
// slots read once. This kernel does not reach it by design: one block per
// (packed token, kv head) holds that token's G query heads and walks its
// row's pages alone (kernel A's body with a per-token row and causal
// limit, rbg::attend_row), so a prefill row's pages are read once per
// token of the row, not once per tile of tokens as in B. That re-reading
// is what the block_ragged probe measures B against.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_attn_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rbg::kThreads)
ragged_paged_tokengrid_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                              const T* __restrict__ v_pages, const int* __restrict__ table,
                              const int* __restrict__ kv_lens,
                              const int* __restrict__ row_ids,
                              const int* __restrict__ q_pos, T* __restrict__ out, int R,
                              int KV, int G, int hd, int page, int P, float scale) {
  extern __shared__ float smem[];
  const int t = blockIdx.x, kv = blockIdx.y;
  const rbg::Plan pl = rbg::gqa_plan(G, hd, page);
  const rbg::Smem sm = rbg::carve(smem, pl);
  const int row = row_ids[t], pos = q_pos[t];
  const int limit = (row >= 0 && row < R && pos >= 0) ? min(kv_lens[row], pos + 1) : 0;
  // q [1, T, H, hd] read as [T, KV, G, hd].
  const long base = ((long)t * KV + kv) * G * hd;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) sm.q[i] = rbg::to_f32(q[base + i]);
  rbg::init_state(sm, pl);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm.act[g] = g;
    sm.lim[g] = limit;
  }
  __syncthreads();
  if (limit > 0) {
    rbg::attend_row(sm, pl, G, limit, table + (long)row * P, P, k_pages, v_pages, kv, KV,
                    scale);
  }
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    out[base + i] = rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[i / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages, const void* table,
           const void* kv_lens, const void* row_ids, const void* q_pos, void* out,
           int n_tokens, int R, int KV, int G, int hd, int page, int P, float scale,
           cudaStream_t stream) {
  if (n_tokens == 0) return 0;
  const size_t smem = rbg::smem_bytes(rbg::gqa_plan(G, hd, page));
  cudaError_t err = rbg::allow_smem(ragged_paged_tokengrid_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  ragged_paged_tokengrid_kernel<T><<<dim3(n_tokens, KV), rbg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<const int*>(row_ids),
      static_cast<const int*>(q_pos), static_cast<T*>(out), R, KV, G, hd, page, P,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output alike).
int ragged_paged_tokengrid(const void* q, const void* k_pages, const void* v_pages,
                           const void* table, const void* kv_lens, const void* row_ids,
                           const void* q_pos, void* out, int n_tokens, int R, int KV,
                           int G, int hd, int page, int P, float scale, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, n_tokens, R, KV, G, hd, page, P, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, n_tokens, R, KV, G, hd, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_tokengrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
