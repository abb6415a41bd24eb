// Paged decode attention (T == 1) for Hopper over model-dtype pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_attention_pallas` (`_decode_kernel`). Kernel body, bound and
// design: paged_decode.cuh.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_decode.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output alike).
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* kv_lens, void* out, int B, int KV,
                 int G, int hd, int page, int P, float scale, int dtype,
                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_decode<float, float>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, out, B, KV, G, hd, page, P, scale, s);
    case 1: return launch_decode<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, out, B, KV, G, hd, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
