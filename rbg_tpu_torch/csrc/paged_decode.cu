// Paged decode attention (T == 1) for Hopper.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_attention_pallas` (`_decode_kernel`): GQA decode attention over a
// page table, flash online softmax in f32, denominator guarded at 1e-30 so
// a row with kv_len == 0 gives 0.
//
// Bound: bytes. A decode step reads each live K/V slot once and does
// 4·G·hd flops per slot, far below the ~295 flop/byte the card needs
// before arithmetic limits it. Design: one block per (row b, kv head),
// holding the G query heads of that group, so every K/V byte read from
// device memory serves all G heads. The block walks the row's page table
// only up to ceil(kv_len / page): unlike the TPU grid, dead pages are never
// loaded. Known gap: B·KV blocks (64 at B=8 on llama3-8b) leave most of the
// 132 SMs idle; splitting the page walk across blocks (split-K) is later
// work.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_attn_common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(rbg::kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ table,
                    const int* __restrict__ kv_lens, T* __restrict__ out, int KV,
                    int G, int hd, int page, int P, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, kv = blockIdx.y;
  const rbg::Smem sm = rbg::carve(smem, G, hd, page);
  // Head h = kv * G + g: q [B, 1, H, hd] read as [B, KV, G, hd].
  const long base = (long)(b * KV + kv) * G * hd;
  const int kv_len = kv_lens[b];
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    sm.q[i] = rbg::to_f32(q[base + i]);
    sm.acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    sm.m[g] = rbg::kNegInf;
    sm.l[g] = 0.f;
    sm.act[g] = g;
    sm.lim[g] = kv_len;
  }
  __syncthreads();
  rbg::attend_row(sm, G, kv_len, table + (long)b * P, P, k_pages, v_pages, kv,
                  KV, hd, page, scale);
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    out[base + i] = rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[i / hd], 1e-30f));
  }
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* table, const void* kv_lens, void* out, int B, int KV,
           int G, int hd, int page, int P, float scale, cudaStream_t stream) {
  const size_t smem = rbg::smem_bytes(G, hd, page);
  cudaError_t err = rbg::allow_smem(paged_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_kernel<T><<<dim3(B, KV), rbg::kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages),
      static_cast<const T*>(v_pages), static_cast<const int*>(table),
      static_cast<const int*>(kv_lens), static_cast<T*>(out), KV, G, hd, page, P,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.
int paged_decode(const void* q, const void* k_pages, const void* v_pages,
                 const void* table, const void* kv_lens, void* out, int B, int KV,
                 int G, int hd, int page, int P, float scale, int dtype,
                 void* stream) {
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q, k_pages, v_pages, table, kv_lens, out, B, KV, G, hd, page, P, scale, s);
    case 1: return launch<__nv_bfloat16>(q, k_pages, v_pages, table, kv_lens, out, B, KV, G, hd, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
