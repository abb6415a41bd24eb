// Block-ragged paged attention for Hopper over int8 pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas_q` (`_block_ragged_kernel_q`): kernel B on
// int8 K/V pages with per-(slot, kv head) absmax scales f32
// [NP, page, KV, 1].
//
// Bound: as B, on half the page bytes plus 8 B of scales per (slot, kv
// head). Design: B's per-row tiles and cp.async pipeline (ragged_paged.cuh)
// with int8 stages converted to the query's dtype in shared memory (exact);
// the k scale folds into the score columns and the v scale into the
// probabilities before P·V, so no page is ever dequantized into memory.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "ragged_paged.cuh"

extern "C" {

// dtype: q and output, 0 = float32, 1 = bfloat16; pools int8, scales f32.
// part / done: the split partials and the counts
// (ops/kernels/ragged_paged.py::scratch).
int ragged_paged_q(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* table,
                   const void* kv_lens, const void* row_ids, const void* q_pos,
                   void* out, void* part, void* done, int n_tokens, int R, int KV, int G,
                   int hd, int page, int P, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged<float, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens, row_ids, q_pos, out, part, done, n_tokens, R, KV, G, hd, page, P, scale, s);
    case 1: return launch_ragged<__nv_bfloat16, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens, row_ids, q_pos, out, part, done, n_tokens, R, KV, G, hd, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
