// Block-ragged MLA latent attention for Hopper over model-dtype latent
// pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_mla_attention_pallas` (`_block_ragged_mla_kernel`). Kernel
// body, bound and design: ragged_paged_mla.cuh.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "ragged_paged_mla.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output alike).
// hg: heads per block, a divisor of H.
int ragged_paged_mla(const void* q_lat, const void* q_pe, const void* c_pages,
                     const void* pe_pages, const void* table, const void* kv_lens,
                     const void* row_ids, const void* q_pos, void* out, int n_tokens,
                     int R, int H, int hg, int dc, int dr, int page, int P, float scale,
                     int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged_mla<float, float>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, n_tokens, R, H, hg, dc, dr, page, P, scale, s);
    case 1: return launch_ragged_mla<__nv_bfloat16, __nv_bfloat16>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, n_tokens, R, H, hg, dc, dr, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
