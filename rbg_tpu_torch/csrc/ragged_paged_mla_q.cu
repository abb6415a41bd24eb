// Block-ragged MLA latent attention for Hopper over int8 latent pools:
// kernel H.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_mla_attention_pallas_q` (`_block_ragged_mla_kernel_q`):
// kernel F on int8 latent pools c and pe with per-slot absmax scales, f32
// [NP, page, 1, 1] each (the c scale on the latent score term and on the
// values, the pe scale on the RoPE term).
//
// Bound: as F, on half the latent bytes plus 8 B of scales per slot.
// Design: F's body (ragged_paged_mla.cuh). Each block stages the raw int8
// bytes and the two scales per slot and converts the block into one tile
// of the query's type in shared memory (exact); the scales fold as the
// reference folds them, s = (S_c·cs + S_pe·ps)·scale, P·cs feeds P·c and
// the denominator keeps p. No page is dequantized into device memory.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int
// (part_rows as long).
// Returns cudaGetLastError() after the launch.

#include "ragged_paged_mla.cuh"

extern "C" {

// dtype: queries and output, 0 = float32, 1 = bfloat16; pools int8,
// scales f32. part, part_rows, counts, device: as ragged_paged_mla.
int ragged_paged_mla_q(const void* q_lat, const void* q_pe, const void* c_pages,
                       const void* pe_pages, const void* c_scales, const void* pe_scales,
                       const void* table, const void* kv_lens, const void* row_ids,
                       const void* q_pos, void* out, void* part, long part_rows, void* counts,
                       int n_tokens, int R, int H, int dc, int dr, int page, int P,
                       float scale, int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged_mla<float, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, row_ids, q_pos, out, part, part_rows, counts, n_tokens, R, H, dc, dr, page, P, scale, device, s);
    case 1: return launch_ragged_mla<__nv_bfloat16, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, row_ids, q_pos, out, part, part_rows, counts, n_tokens, R, H, dc, dr, page, P, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_mla_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
