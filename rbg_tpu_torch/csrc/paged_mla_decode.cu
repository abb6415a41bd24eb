// MLA latent decode attention (T == 1) for Hopper.
//
// Replaces the TPU kernel rbg_tpu/ops/pallas/paged_attention_kernel.py
// `paged_mla_attention_pallas` (`_mla_decode_kernel`): absorbed-form
// multi-head latent attention over the paged latent pools c
// [NP, page, 1, dc] and pe [NP, page, 1, dr]. Head h of row b scores slot
// i as (q_lat[h]·c[i] + q_pe[h]·pe[i])·scale, the values are the latents
// c, and the output stays in latent space [B, 1, H, dc] (the model applies
// W_uv after). Online softmax in f32; a row with kv_len == 0 gives 0.
//
// Bound: bytes at decode batch sizes: each live slot moves (dc + dr)·2 B
// for about 4·H·dc flops of the block's heads, under the ~295 flop/byte
// ridge for H <= 64. Design: the latent cache is MQA-shaped (one latent
// per slot for every head), so a block owns (row b, group of hg heads) and
// every c/pe page it stages serves all hg heads. The head group is a launch
// parameter: the block holds hg·(dc + dr) of q and hg·dc of accumulator in
// f32 plus one staged page, about 108 KB at hg = 16, dc = 512, dr = 64, so
// two blocks share an SM; deepseek-v2-lite (H = 16) runs one group per row,
// deepseek-v3 (H = 128) eight. Known gap: B·H/hg blocks (8 at B = 8 on
// deepseek-v2-lite) leave most SMs idle; split-K over the page walk is
// later work.
//
// C interface (ctypes): pointers and the stream as void*, sizes as int.
// Returns cudaGetLastError() after the launch.

#include "paged_attn_common.cuh"

namespace {

constexpr int kMlaThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kMlaThreads)
paged_mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                        const T* __restrict__ c_pages, const T* __restrict__ pe_pages,
                        const int* __restrict__ table, const int* __restrict__ kv_lens,
                        T* __restrict__ out, int H, int hg, int dc, int dr, int page,
                        int P, float scale) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h0 = blockIdx.y * hg;
  const rbg::Plan pl = rbg::mla_plan(hg, dc, dr, page);
  const rbg::Smem sm = rbg::carve(smem, pl);
  const int dq = dc + dr, kv_len = kv_lens[b];
  // q row g = [q_lat | q_pe] of head h0 + g; q_lat [B, 1, H, dc], q_pe [B, 1, H, dr].
  for (int i = threadIdx.x; i < hg * dq; i += blockDim.x) {
    const int g = i / dq, d = i % dq;
    const long h = (long)b * H + h0 + g;
    sm.q[i] = rbg::to_f32(d < dc ? q_lat[h * dc + d] : q_pe[h * dr + d - dc]);
  }
  rbg::init_state(sm, pl);
  for (int g = threadIdx.x; g < hg; g += blockDim.x) {
    sm.act[g] = g;
    sm.lim[g] = kv_len;
  }
  __syncthreads();
  rbg::mla_attend_row(sm, pl, hg, kv_len, table + (long)b * P, P, c_pages, pe_pages,
                      scale);
  for (int i = threadIdx.x; i < hg * dc; i += blockDim.x) {
    const int g = i / dc, d = i % dc;
    out[((long)b * H + h0 + g) * dc + d] =
        rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[g], 1e-30f));
  }
}

template <typename T>
int launch(const void* q_lat, const void* q_pe, const void* c_pages,
           const void* pe_pages, const void* table, const void* kv_lens, void* out,
           int B, int H, int hg, int dc, int dr, int page, int P, float scale,
           cudaStream_t stream) {
  if (B == 0) return 0;
  const size_t smem = rbg::smem_bytes(rbg::mla_plan(hg, dc, dr, page));
  cudaError_t err = rbg::allow_smem(paged_mla_decode_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_mla_decode_kernel<T><<<dim3(B, H / hg), kMlaThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe),
      static_cast<const T*>(c_pages), static_cast<const T*>(pe_pages),
      static_cast<const int*>(table), static_cast<const int*>(kv_lens),
      static_cast<T*>(out), H, hg, dc, dr, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (queries, pools and output alike).
// hg: heads per block, a divisor of H.
int paged_mla_decode(const void* q_lat, const void* q_pe, const void* c_pages,
                     const void* pe_pages, const void* table, const void* kv_lens,
                     void* out, int B, int H, int hg, int dc, int dr, int page, int P,
                     float scale, int dtype, void* stream) {
  if (hg <= 0 || H % hg) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch<float>(q_lat, q_pe, c_pages, pe_pages, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    case 1: return launch<__nv_bfloat16>(q_lat, q_pe, c_pages, pe_pages, table, kv_lens, out, B, H, hg, dc, dr, page, P, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* paged_mla_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
