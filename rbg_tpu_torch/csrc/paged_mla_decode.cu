// MLA latent decode attention (T == 1) for Hopper over model-dtype latent
// pools: kernel E.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas` (`_mla_decode_kernel`). Kernel body, bound
// and design (split walks merged on the card, cp.async latent blocks,
// mma.sync products for bf16): paged_mla_decode.cuh. Instances: (dc, dr) =
// (512, 64) and (64, 16), f32 and bf16.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_mla_decode.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output alike). part,
// counts: the merge's scratch; device: q's (launch_mla_decode in
// paged_mla_decode.cuh).
int paged_mla_decode(const void* q_lat, const void* q_pe, const void* c_pages,
                     const void* pe_pages, const void* table, const void* kv_lens,
                     void* out, void* part, void* counts, int B, int H, int dc, int dr,
                     int page, int P, int cap, float scale, int dtype, int device,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mla_decode<float, float>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, out, part, counts, B, H, dc, dr, page, P, cap, scale, device, s);
    case 1: return launch_mla_decode<__nv_bfloat16, __nv_bfloat16>(q_lat, q_pe, c_pages, pe_pages, nullptr, nullptr, table, kv_lens, out, part, counts, B, H, dc, dr, page, P, cap, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
