// MLA latent decode attention (T == 1) for Hopper: the kernel body shared
// by paged_mla_decode.cu (model-dtype latent pools, kernel E) and
// paged_mla_decode_q.cu (int8 latent pools, kernel G).
//
// Absorbed-form multi-head latent attention over the paged latent pools c
// [NP, page, 1, dc] and pe [NP, page, 1, dr]. Head h of row b scores slot
// i as (q_lat[h]·c[i] + q_pe[h]·pe[i])·scale, the values are the latents
// c, and the output stays in latent space [B, 1, H, dc] (the model applies
// W_uv after). Online softmax in f32; a row with kv_len == 0 gives 0.
//
// Bound: bytes at decode batch sizes: each live slot moves (dc + dr)·2 B
// (int8: (dc + dr) B plus 8 B of scales) for about 4·H·dc flops of the
// block's heads, under the ~295 flop/byte ridge for H <= 64. Design: the
// latent cache is MQA-shaped (one latent per slot for every head), so a
// block owns (row b, group of hg heads) and every c/pe page it stages
// serves all hg heads. The head group is a launch parameter: the block
// holds hg·(dc + dr) of q and hg·dc of accumulator in f32 plus one staged
// page, about 108 KB at hg = 16, dc = 512, dr = 64, so two blocks share an
// SM; deepseek-v2-lite (H = 16) runs one group per row, deepseek-v3
// (H = 128) eight. Staging is in f32 whatever the pool type, so int8 pools
// take the same shared memory. Known gap: B·H/hg blocks (8 at B = 8 on
// deepseek-v2-lite) leave most SMs idle; split-K over the page walk is
// later work.

#pragma once

#include "paged_attn_common.cuh"

namespace {

constexpr int kMlaThreads = 256;

// T: q and output element type; KVT: latent pool element type (T, or
// int8_t with f32 scales [NP, page, 1, 1] for c and for pe).
template <typename T, typename KVT>
__global__ void __launch_bounds__(kMlaThreads)
paged_mla_decode_kernel(const T* __restrict__ q_lat, const T* __restrict__ q_pe,
                        const KVT* __restrict__ c_pages, const KVT* __restrict__ pe_pages,
                        const float* __restrict__ c_scales,
                        const float* __restrict__ pe_scales,
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
                      c_scales, pe_scales, scale);
  for (int i = threadIdx.x; i < hg * dc; i += blockDim.x) {
    const int g = i / dc, d = i % dc;
    out[((long)b * H + h0 + g) * dc + d] =
        rbg::from_f32<T>(sm.acc[i] / fmaxf(sm.l[g], 1e-30f));
  }
}

template <typename T, typename KVT>
int launch_mla_decode(const void* q_lat, const void* q_pe, const void* c_pages,
                      const void* pe_pages, const void* c_scales, const void* pe_scales,
                      const void* table, const void* kv_lens, void* out, int B, int H,
                      int hg, int dc, int dr, int page, int P, float scale,
                      cudaStream_t stream) {
  if (hg <= 0 || H % hg) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const size_t smem = rbg::smem_bytes(rbg::mla_plan(hg, dc, dr, page));
  cudaError_t err = rbg::allow_smem(paged_mla_decode_kernel<T, KVT>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_mla_decode_kernel<T, KVT><<<dim3(B, H / hg), kMlaThreads, smem, stream>>>(
      static_cast<const T*>(q_lat), static_cast<const T*>(q_pe),
      static_cast<const KVT*>(c_pages), static_cast<const KVT*>(pe_pages),
      static_cast<const float*>(c_scales), static_cast<const float*>(pe_scales),
      static_cast<const int*>(table), static_cast<const int*>(kv_lens),
      static_cast<T*>(out), H, hg, dc, dr, page, P, scale);
  return (int)cudaGetLastError();
}

}  // namespace
