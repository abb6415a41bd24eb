// Token-grid ragged paged attention for Hopper over model-dtype pools:
// kernel I, the baseline that the block-ragged kernel B is measured
// against.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas_tokengrid` (`_ragged_kernel`). It computes
// B's function: packed token t (row row_ids[t], position q_pos[t]) attends
// slots < min(kv_lens[row], q_pos[t] + 1) of its row's pages with scale
// hd^-0.5; a pad token (q_pos < 0) and a row with kv_len == 0 give 0.
// Kernel body, bound and design (kernel A's decode walk, one per packed
// token and kv head, the grid ordered so a row's pages are read from L2):
// paged_decode.cuh.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_decode.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output alike). part,
// counts: the merge's scratch; device: q's (launch_tokengrid in
// paged_decode.cuh).
int ragged_paged_tokengrid(const void* q, const void* k_pages, const void* v_pages,
                           const void* table, const void* kv_lens, const void* row_ids,
                           const void* q_pos, void* out, void* part, void* counts,
                           int n_tokens, int R, int KV, int G, int hd, int page, int P,
                           int cap, float scale, int dtype, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_tokengrid<float>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, part, counts, n_tokens, R, KV, G, hd, page, P, cap, scale, device, s);
    case 1: return launch_tokengrid<__nv_bfloat16>(q, k_pages, v_pages, table, kv_lens, row_ids, q_pos, out, part, counts, n_tokens, R, KV, G, hd, page, P, cap, scale, device, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_tokengrid_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
