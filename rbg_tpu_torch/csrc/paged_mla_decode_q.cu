// MLA latent decode attention (T == 1) for Hopper over int8 latent pools:
// kernel G.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas_q` (`_mla_decode_kernel_q`): kernel E on int8
// latent pools c and pe with per-slot absmax scales, f32 [NP, page, 1, 1]
// each.
//
// Bound: bytes, as E, on half the latent bytes ((dc + dr) B per slot) plus
// 8 B of scales per slot. Design: E's body (paged_mla_decode.cuh) with int8
// stages, converted to the query's type in shared memory (exact) after they
// land. The pages are never dequantized into device memory and the scales
// fold as the reference folds them: the latent score term and the pe term
// are kept apart (two fragment sets on the tensor cores), s = (S_c·cs +
// S_pe·ps)·scale, and the probabilities are multiplied by cs before the
// value product while the denominator keeps p.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_mla_decode.cuh"

extern "C" {

// dtype: queries and output, 0 = float32, 1 = bfloat16; pools int8, scales
// f32. part, counts: the merge's scratch; device: q's (launch_mla_decode in
// paged_mla_decode.cuh).
int paged_mla_decode_q(const void* q_lat, const void* q_pe, const void* c_pages,
                       const void* pe_pages, const void* c_scales, const void* pe_scales,
                       const void* table, const void* kv_lens, void* out, void* part,
                       void* counts, int B, int H, int dc, int dr, int page, int P, int cap,
                       float scale, int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mla_decode<float, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, out, part, counts, B, H, dc, dr, page, P, cap, scale, device, s);
    case 1: return launch_mla_decode<__nv_bfloat16, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, out, part, counts, B, H, dc, dr, page, P, cap, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_mla_decode_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
