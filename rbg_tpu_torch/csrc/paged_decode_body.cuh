// The body of the paged decode kernels (paged_decode.cuh), included as
// the statements of each kernel: paged_decode_kernel (A, C: kTok false,
// item b is decode row b) and ragged_paged_tokengrid_kernel (I: kTok true,
// item b is packed token b; row_ids, q_pos and R are read only then). The
// kernel declares its arguments, T, KVT, HD and kTok. No include guard:
// it is included once per kernel.

using L = Layout<T, KVT, HD>;
constexpr int S = L::kStages, CLD = L::kCLd;
extern __shared__ __align__(16) unsigned char sm[];
__shared__ int s_last;
const int tid = threadIdx.x, bkv = blockIdx.x, split = blockIdx.y;
const int b = bkv / KV, kv = bkv % KV, cap_slots = P * page;

if (bkv == 0 && split == 0 && tid < 32) {  // the launch's report
  int n = 0;
  for (int r = tid; r < B; r += 32) {
    int len;
    if constexpr (kTok)
      len = token_len(row_ids, q_pos, kv_lens, R, r, cap_slots);
    else
      len = min(kv_lens[r], cap_slots);
    if (len > 0) n += splits_of((len + kBN - 1) / kBN, cap);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if (tid == 0) {
    counts[kItemsSlot] = n * KV;
    counts[kGridSlot] = (int)(gridDim.x * gridDim.y);
  }
}

// Head h = kv * G + g of item b: q and out [B, 1, H, hd] (A, C) or
// [1, B, H, hd] (I) read as [B·KV, G, hd].
T* dst = out + (long)bkv * G * HD;
int len;
if constexpr (kTok)
  len = token_len(row_ids, q_pos, kv_lens, R, b, cap_slots);
else
  len = min(kv_lens[b], cap_slots);
if (len <= 0) {
  if (split == 0)
    for (int c = tid; c < G * HD * (int)sizeof(T) / 16; c += kThreads)
      reinterpret_cast<uint4*>(dst)[c] = make_uint4(0u, 0u, 0u, 0u);
  return;
}
const int nkb = (len + kBN - 1) / kBN, ns = splits_of(nkb, cap);
if (split >= ns) return;
const int kb0 = split * nkb / ns, nblk = (split + 1) * nkb / ns - kb0;
const int* trow = table + (long)b * P;
if constexpr (kTok) trow = table + (long)row_ids[b] * P;
rbg::PageMap pmap{trow, 0, page, pshift};
pmap.last = pmap.last_of(len);
auto issue = [&](int st, int i) {
  issue_block<T, KVT, HD>(sm, st, kb0 + i, k_pages, v_pages, k_scales, v_scales, pmap, kv,
                          KV);
};
#pragma unroll
for (int st = 0; st < S; ++st) {
  if (st < nblk) issue(st, st);
  rbg::cp_async_commit();
}

const float* ks = reinterpret_cast<const float*>(sm + L::kScaleOff) + 2 * S * kBN;
const float* vs = ks + kBN;
// Wait for step i's stage; int8 pools convert it into the shared tiles
// and refill it at once. Returns K's tile; V's follows it.
auto take = [&](int i) -> const T* {
  const int stg = i % S;
  rbg::cp_async_wait<S - 1>();
  __syncthreads();
  if constexpr (L::kQuant) {
    convert_block<T, HD>(sm, stg);
    __syncthreads();
    if (i + S < nblk) issue(stg, i + S);
    rbg::cp_async_commit();
    return reinterpret_cast<const T*>(sm);
  } else {
    return reinterpret_cast<const T*>(sm + 2 * stg * L::kTile);
  }
};
// After step i: model-dtype pools refill the stage just read.
auto refill = [&](int i) {
  __syncthreads();
  if constexpr (!L::kQuant) {
    if (i + S < nblk) issue(i % S, i + S);
    rbg::cp_async_commit();
  }
};
// The split's result for query row r < G, column c: out when the row's
// walk is one split, else a partial of the merge.
auto finish = [&](int r, int c, float o, float m, float l) {
  if (ns == 1) {
    dst[r * HD + c] = rbg::from_f32<T>(o / fmaxf(l, 1e-30f));
  } else {
    float* mine = part + (((long)bkv * cap + split) * G + r) * CLD;
    mine[c] = o;
    if (c == 0) *reinterpret_cast<float2*>(mine + HD) = make_float2(m, l);
  }
};
const T* qb = q + (long)bkv * G * HD;

if constexpr (L::kMma) {
  rk::MmaState<HD> st;
  const int warp = tid >> 5, lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  // A fragments of Q rows gid and gid + 8 (zero past G), from device memory.
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = gid + 8 * (j & 1), c = kk * 16 + 2 * tig + 8 * (j >> 1);
      st.qa[kk][j] = r < G ? *reinterpret_cast<const uint32_t*>(qb + r * HD + c) : 0u;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = rbg::kNegInf;
    st.l[h] = 0.f;
    st.lim[h] = len;
  }
#pragma unroll
  for (int dt = 0; dt < HD / 8; ++dt)
    st.o[dt][0] = st.o[dt][1] = st.o[dt][2] = st.o[dt][3] = 0.f;
  const float sl2 = scale * rk::kLog2e;
  for (int i = 0; i < nblk; ++i) {
    const __nv_bfloat16* sk = take(i);
    const int nb = kb0 + i;
    rk::mma_block<KVT, HD, kBN / 4>(st, nb, warp * (kBN / 4), (nb + 1) * kBN > len, sk,
                                    sk + L::kTile / (int)sizeof(T), ks, vs, sl2);
    refill(i);
  }
  rbg::cp_async_wait<0>();
  __syncthreads();
  // Merge the four warps through shared memory (the stages are free
  // now): per warp and row, o then m and l (quad sums of l).
  float* cb = reinterpret_cast<float*>(sm);
  float* wb = cb + warp * kRows * CLD;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = st.l[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    float* rb = wb + (gid + 8 * h) * CLD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<float2*>(rb + dt * 8 + tig * 2) =
          make_float2(st.o[dt][2 * h], st.o[dt][2 * h + 1]);
    if (tig == 0) {
      rb[HD] = st.m[h];
      rb[HD + 1] = l;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const float* rb = cb + r * CLD;
    float m = rbg::kNegInf;
#pragma unroll
    for (int w = 0; w < 4; ++w) m = fmaxf(m, rb[w * kRows * CLD + HD]);
    float l = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      const float* wr = rb + w * kRows * CLD;
      const float x = exp2f(wr[HD] - m);  // 0 for a warp that saw no slot
      l = fmaf(x, wr[HD + 1], l);
      o = fmaf(x, wr[c], o);
    }
    finish(r, c, o, m, l);
  }
} else {
  float* sq = reinterpret_cast<float*>(sm + L::kQOff);
  float* sm_ = sq + kRows * (HD + L::kSLd);
  float* sl = sm_ + kRows;
  for (int i = tid; i < kRows * HD; i += kThreads) sq[i] = i < G * HD ? rbg::to_f32(qb[i]) : 0.f;
  for (int r = tid; r < kRows; r += kThreads) {
    sm_[r] = rbg::kNegInf;
    sl[r] = 0.f;
  }
  float o[HD / 8];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) o[i] = 0.f;
  for (int i = 0; i < nblk; ++i) {
    const float* sk = take(i);
    const int nb = kb0 + i;
    fma_block<KVT, HD>(sm, o, nb, (nb + 1) * kBN > len, len, sk, sk + L::kTile / 4, ks, vs,
                       scale);
    refill(i);
  }
  rbg::cp_async_wait<0>();
  const int c = tid % HD, r0 = tid / HD;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int r = r0 + i * (kThreads / HD);
    if (r < G) finish(r, c, o[i], sm_[r] * rk::kLog2e, sl[r]);
  }
}

// Several splits: the last to finish merges every split's partial, in
// split order (its atomicInc wraps the count back to 0).
if (ns > 1) {
  __threadfence();
  __syncthreads();
  if (tid == 0)
    s_last = atomicInc(reinterpret_cast<unsigned*>(counts) + kDoneSlot0 + bkv,
                       (unsigned)(ns - 1)) == (unsigned)(ns - 1);
  __syncthreads();
  if (s_last) {
    __threadfence();
    const float* all = part + (long)bkv * cap * G * CLD;
    for (int i = tid; i < G * (HD / 4); i += kThreads) {
      const int r = i / (HD / 4), c = (i % (HD / 4)) * 4;
      float m = rbg::kNegInf;
      for (int s = 0; s < ns; ++s) m = fmaxf(m, __ldcg(all + (s * G + r) * CLD + HD));
      float l = 0.f;
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int s = 0; s < ns; ++s) {
        const float* p = all + (s * G + r) * CLD;
        const float2 ml = __ldcg(reinterpret_cast<const float2*>(p + HD));
        const float4 v = __ldcg(reinterpret_cast<const float4*>(p + c));
        const float w = exp2f(ml.x - m);
        l = fmaf(w, ml.y, l);
        a.x = fmaf(w, v.x, a.x);
        a.y = fmaf(w, v.y, a.y);
        a.z = fmaf(w, v.z, a.z);
        a.w = fmaf(w, v.w, a.w);
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
      rbg::store4(dst + r * HD + c, make_float4(a.x * inv, a.y * inv, a.z * inv, a.w * inv));
    }
  }
}
