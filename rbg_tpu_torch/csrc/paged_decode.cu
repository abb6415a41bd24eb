// Paged decode attention (T == 1) for Hopper over model-dtype pools:
// kernel A.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_attention_pallas` (`_decode_kernel`). Kernel body, bound and
// design (split walks merged on the card, cp.async KV blocks, mma.sync
// products for bf16): paged_decode.cuh.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_decode.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output alike). part,
// counts: the merge's scratch; device: q's (launch_decode in
// paged_decode.cuh).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* kv_lens, void* out, void* part,
                 void* counts, int B, int KV, int G, int hd, int page, int P, int cap,
                 float scale, int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_decode<float, float>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, out, part, counts, B, KV, G, hd, page, P, cap, scale, device, s);
    case 1: return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, out, part, counts, B, KV, G, hd, page, P, cap, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
