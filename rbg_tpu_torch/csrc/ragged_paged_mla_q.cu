// Block-ragged MLA latent attention for Hopper over int8 latent pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_mla_attention_pallas_q` (`_block_ragged_mla_kernel_q`):
// kernel F on int8 latent pools c and pe with per-slot absmax scales, f32
// [NP, page, 1, 1] each (the c scale on the latent score term and on the
// values, the pe scale on the RoPE term).
//
// Bound: as F, on half the page bytes plus 8 B of scales per slot. Design:
// F's tile-leader plan with heads split across blocks
// (ragged_paged_mla.cuh), the page load templated on the pool's element
// type. As in kernel G, a slot's two scales are applied while its page is
// staged to f32 in shared memory (c part times cs[i], pe part times
// ps[i]), so the score, softmax and value steps run exactly as in F and no
// page is dequantized into device memory.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "ragged_paged_mla.cuh"

extern "C" {

// dtype: queries and output, 0 = float32, 1 = bfloat16; pools int8,
// scales f32. hg: heads per block, a divisor of H.
int ragged_paged_mla_q(const void* q_lat, const void* q_pe, const void* c_pages,
                       const void* pe_pages, const void* c_scales, const void* pe_scales,
                       const void* table, const void* kv_lens, const void* row_ids,
                       const void* q_pos, void* out, int n_tokens, int R, int H, int hg,
                       int dc, int dr, int page, int P, float scale, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged_mla<float, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, row_ids, q_pos, out, n_tokens, R, H, hg, dc, dr, page, P, scale, s);
    case 1: return launch_ragged_mla<__nv_bfloat16, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, row_ids, q_pos, out, n_tokens, R, H, hg, dc, dr, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_mla_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
