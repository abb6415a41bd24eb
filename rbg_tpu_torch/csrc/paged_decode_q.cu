// Paged decode attention (T == 1) for Hopper over int8 pools: kernel C.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_attention_pallas_q` (`_decode_kernel_q`): kernel A on int8 K/V
// pages with per-(slot, kv head) absmax scales f32 [NP, page, KV, 1].
//
// Bound: bytes, as A, on half the page bytes (1 B per element) plus 8 B of
// scales per (slot, kv head). Design: A's body (paged_decode.cuh) with
// int8 stages, converted to the query's type in shared memory (exact) after
// they land. The pages are never dequantized into device memory: the k
// scale folds into the score, s = (q·k_i8)·scale·ks[slot], and the v scale
// into the probability before the PV sum, p' = p·vs[slot] (the
// denominator keeps p).
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_decode.cuh"

extern "C" {

// dtype: q and output, 0 = float32, 1 = bfloat16; pools int8, scales f32.
// part, counts: the merge's scratch; device: q's (launch_decode in
// paged_decode.cuh).
int paged_decode_q(const void* q, const void* k_pages, const void* v_pages,
                   const void* k_scales, const void* v_scales, const void* table,
                   const void* kv_lens, void* out, void* part, void* counts, int B, int KV,
                   int G, int hd, int page, int P, int cap, float scale, int dtype,
                   int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_decode<float, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens, out, part, counts, B, KV, G, hd, page, P, cap, scale, device, s);
    case 1: return launch_decode<__nv_bfloat16, int8_t>(q, k_pages, v_pages, k_scales, v_scales, table, kv_lens, out, part, counts, B, KV, G, hd, page, P, cap, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
