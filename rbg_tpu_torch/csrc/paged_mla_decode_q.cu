// MLA latent decode attention (T == 1) for Hopper over int8 latent pools.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas_q` (`_mla_decode_kernel_q`): kernel E on int8
// latent pools c and pe with per-slot absmax scales, f32 [NP, page, 1, 1]
// each. The c scale multiplies the latent score term and the values (the
// latents), the pe scale the RoPE term.
//
// Bound: bytes, as E, on half the page bytes ((dc + dr) B per slot) plus
// 8 B of scales per slot. Design: E's block plan and page walk
// (paged_mla_decode.cuh), with the page load templated on the pool's
// element type. One slot has two scales, so neither the score nor the
// probability can carry a single factor as in kernel C: the scales are
// applied while each page is staged to f32 in shared memory (the c part of
// slot i times cs[i], the pe part times ps[i]), and the score, softmax and
// value steps run exactly as in E (paged_attn_common.cuh). No page is
// dequantized into device memory.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_mla_decode.cuh"

extern "C" {

// dtype: queries and output, 0 = float32, 1 = bfloat16; pools int8,
// scales f32. hg: heads per block, a divisor of H.
int paged_mla_decode_q(const void* q_lat, const void* q_pe, const void* c_pages,
                       const void* pe_pages, const void* c_scales, const void* pe_scales,
                       const void* table, const void* kv_lens, void* out, int B, int H,
                       int hg, int dc, int dr, int page, int P, float scale, int dtype,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_mla_decode<float, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    case 1: return launch_mla_decode<__nv_bfloat16, int8_t>(q_lat, q_pe, c_pages, pe_pages, c_scales, pe_scales, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_mla_decode_q_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
