// Block-ragged paged attention for Hopper over model-dtype pools (kernel B).
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/ragged_attention_kernel.py
// `ragged_paged_attention_pallas` (`_block_ragged_kernel`). Bound: bytes
// (each row's live K/V slots once per tile). Design (ragged_paged.cuh):
// work items of (row, up to 64 / G of its live tokens, kv head), a long
// walk split into up to 4 items merged by the last; persistent blocks
// take items from a queue; KV blocks of 64 slots in flight with cp.async;
// for bf16 both products on the tensor cores (mma.sync m16n8k16) with the
// softmax in registers; float32 runs the same walk on CUDA-core FMAs.
// Instances: hd 32, 64 and 128.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "ragged_paged.cuh"

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, pools and output alike). part / done:
// the split partials and the counts (ops/kernels/ragged_paged.py::scratch).
// invariant: 1 = a group's KV block always splits between two warps
// (batch-invariant serving), 0 = by the tile's fill.
int ragged_paged(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* kv_lens, const void* row_ids,
                 const void* q_pos, void* out, void* part, void* done, int n_tokens,
                 int R, int KV, int G, int hd, int page, int P, float scale, int dtype,
                 int invariant, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_ragged<float, float>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, part, done, n_tokens, R, KV, G, hd, page, P, scale, invariant, s);
    case 1: return launch_ragged<__nv_bfloat16, __nv_bfloat16>(q, k_pages, v_pages, nullptr, nullptr, table, kv_lens, row_ids, q_pos, out, part, done, n_tokens, R, KV, G, hd, page, P, scale, invariant, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* ragged_paged_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
