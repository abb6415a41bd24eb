// MLA latent decode attention (T == 1) for Hopper over model-dtype latent
// pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas` (`_mla_decode_kernel`). Kernel body, bound
// and design: paged_mla_decode.cuh.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_mla_decode.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output alike).
// hg: heads per block, a divisor of H.
int paged_mla_decode(const void* q_lat, const void* q_pe, const void* c_pages,
                     const void* pe_pages, const void* table, const void* kv_lens,
                     void* out, int B, int H, int hg, int dc, int dr, int page, int P,
                     float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mla_decode<float, float>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    case 1: return launch_mla_decode<__nv_bfloat16, __nv_bfloat16>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
