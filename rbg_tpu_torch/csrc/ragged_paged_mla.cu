// Block-ragged MLA latent attention for Hopper over model-dtype latent
// pools: kernel F.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_mla_attention_pallas` (`_block_ragged_mla_kernel`). Kernel
// body, bound and design (kernel B's work items and splits merged on the
// card, cp.async latent blocks of any page size, mma.sync products for
// bf16): ragged_paged_mla.cuh. Instances: (dc, dr) = (512, 64) and
// (64, 16), f32 and bf16.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int
// (part_rows as long).
// Returns cudaGetLastError() after the launch.

#include "ragged_paged_mla.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output alike). part
// (part_rows rows), counts: the merge's scratch and the work queue; device:
// q's (launch_ragged_mla in ragged_paged_mla.cuh: a negative result is the
// partial rows the launch needs, nothing having been launched).
int ragged_paged_mla(const void* q_lat, const void* q_pe, const void* c_pages,
                     const void* pe_pages, const void* table, const void* kv_lens,
                     const void* row_ids, const void* q_pos, void* out, void* part,
                     long part_rows, void* counts, int n_tokens, int R, int H, int dc, int dr,
                     int page, int P, float scale, int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged_mla<float, float>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, part, part_rows, counts, n_tokens, R, H, dc, dr, page, P, scale, device, s);
    case 1: return launch_ragged_mla<__nv_bfloat16, __nv_bfloat16>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, part, part_rows, counts, n_tokens, R, H, dc, dr, page, P, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_mla_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
