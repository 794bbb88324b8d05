// K1 and K4: DSA decode gather-attend for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/dsa_decode.py::dsa_decode_gather_attention (K1) and
//   src/repro/kernels/dsa_decode.py::dsa_decode_paged_gather_attention (K4)
//   (bodies _kernel and _paged_kernel)
// K4 is K1 over a flat page pool (P * block_k, Hkv, hd) shared by all
// batch rows: one more index stream, pidx (B, nb), names the PHYSICAL
// page of each selected block, while idx keeps the LOGICAL block that
// carries the key positions for the mask.  Both run one body; it reaches
// the rows of selected block j through a row function (dense: row
// b * S + idx * block_k + r of the cache; paged: row pidx * block_k + r of
// the pool) and does the same arithmetic in the same order, so K4 equals
// K1 bitwise on a pool that holds the dense cache's blocks.
// One decode query per (batch row, query head) attends only the nb cache
// blocks the block-pooled predictor selected: idx/ok (B, nb), ascending,
// block j = cache rows [j*block_k, (j+1)*block_k).  Rows at or past
// kv_len[b] (and past S: the cache is never padded or copied, the ragged
// tail is masked here), and blocks with ok = 0, get an explicit p = 0, as
// the Pallas body does; an invalid entry carries idx = 0, so masking is by
// ok, never by skipping on idx.  Online softmax in f32; the output is
// written in q's dtype.  q f32 or bf16; cache f32, bf16, int8 or fp8 e4m3;
// hd a multiple of 16 up to 128.
//
// K1q and K4q (the quantized bodies _quant_kernel and _paged_quant_kernel
// of the same Pallas file) are the int8 and fp8 instances of this body: a
// narrow row is multiplied by its f32 (row, head) scale as it is loaded
// (dsa::load4), the scale found through the same row function as the row,
// and everything after the load is unchanged, so K1q equals K1 bitwise on
// the f32 cache dequant(k, k_scale), and K4q equals K1q on a paged copy.
//
// What bounds it on the H100: bytes.  A step reads nb*block_k rows of K
// and V per (row, KV head): 6.3 MB at B=4, nb=6, bf16 cache (12.6 MB f32)
// against ~2 MFLOP per layer, far below the ~295 FLOP/byte ridge, so the
// bound is a few microseconds and the kernel must keep many loads in
// flight across the whole card.
//
// Design (flash-decoding split): the selected rows of one (b, KV head) are
// cut into 32-row tiles and each warp takes ONE tile, so B*Hkv*nb*4 warps
// (384 at the main path's shape) stream the rows at once instead of
// B*Hkv CTAs walking them in turn.  A warp serves the whole GQA group
// (G = Hq/Hkv query heads) from one read of its rows; the Pallas grid
// (B, Hq, nb) streams each block once per query head.  For the scores a
// lane owns one key row (no cross-lane reduction per row) and issues its
// row's loads 16 elements at a time; the tile's p goes through shared
// memory and the lanes then own 4-wide slices of hd for the p.V pass,
// loading 8 V rows ahead.  Each warp writes its partial (m, l, acc) to a
// workspace the wrapper allocates, and a second small kernel merges the
// partials of each (b, KV head) and writes the output.
#include "common.cuh"

namespace {

constexpr int WARPS = 4;
constexpr int EPL = 4;  // hd slice per lane in the p.V pass: hd <= 32 * 4
constexpr int VAHEAD = 8;  // V rows loaded ahead in the p.V pass

template <typename TQ, typename TC, int G, bool PAGED>
__global__ void __launch_bounds__(WARPS * 32)
dsa_decode_partial(const TQ* __restrict__ q, int64_t q_sb, int64_t q_sh,
                   const TC* __restrict__ k, const TC* __restrict__ v,
                   int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, int64_t s_sb,
                   int64_t s_ss, const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ pidx,
                   const int32_t* __restrict__ ok, int64_t i_sb,
                   const int32_t* __restrict__ kv_len,
                   float* __restrict__ ws_m, float* __restrict__ ws_l,
                   float* __restrict__ ws_acc, int hkv, int S, int hd,
                   int block_k, int tiles_per_blk, int n_tiles, float scale) {
  using dsa::NEG;
  extern __shared__ float smem[];
  float* qs = smem;                        // [G][hd]  q * scale, f32
  float* ps = qs + G * hd;                 // [WARPS][G][32]  tile p

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = blockIdx.z * WARPS + warp;  // this warp's tile

  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    qs[i] = dsa::to_f32(q[b * q_sb + (int64_t)(kvh * G + g) * q_sh + d]) * scale;
  }
  __syncthreads();
  if (t >= n_tiles) return;

  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
  const int d0 = lane * EPL;               // this lane's hd slice (p.V pass)
  const bool has_d = d0 < hd;

  const int j = t / tiles_per_blk;
  const int r0 = (t % tiles_per_blk) * 32;
  const int blk0 = idx[b * i_sb + j] * block_k;
  const int base = blk0 + r0;                          // first key row
  // rows at or past lim are masked (kv_len, the cache end, the block end)
  const int lim = min(min(kv_len[b], S), blk0 + block_k);
  if (ok[b * i_sb + j] != 0 && base < lim) {
    // the selected block's rows: logical positions blk0 + r, stored at
    // rows + r * c_ss (dense or paged); a narrow cache's scales at
    // srows + r * s_ss
    const int64_t rows = dsa::block_rows<PAGED>(pidx, b * i_sb + j, blk0,
                                                block_k, b * c_sb, c_ss)
                         + kvh * c_sh;
    const TC* kb = k + rows;
    const TC* vb = v + rows;
    const float* ksb = nullptr;
    const float* vsb = nullptr;
    if constexpr (dsa::Narrow<TC>::value) {
      const int64_t srows = dsa::block_rows<PAGED>(pidx, b * i_sb + j, blk0,
                                                   block_k, b * s_sb, s_ss)
                            + kvh;
      ksb = k_scale + srows;
      vsb = v_scale + srows;
    }
    // scores: lane owns key row base + lane
    const int kpos = base + lane;
    const bool live = kpos < lim;
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = live ? 0.f : NEG;
    if (live) {
      const TC* kr = kb + (int64_t)(r0 + lane) * c_ss;
      float ksc = 1.f;
      if constexpr (dsa::Narrow<TC>::value)
        ksc = ksb[(int64_t)(r0 + lane) * s_ss];
#pragma unroll 2
      for (int d = 0; d < hd; d += 16) {
        float kk[16];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          dsa::load4(kr + d + 4 * u, ksc, kk + 4 * u);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float* qg = qs + g * hd + d;
#pragma unroll
          for (int u = 0; u < 16; ++u) s[g] = fmaf(qg[u], kk[u], s[g]);
        }
      }
    }
    float* pw = ps + warp * G * 32;
    // online softmax update, p explicitly zero under the mask
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float m_new = fmaxf(m[g], dsa::warp_max(s[g]));
      const float p = live ? expf(s[g] - m_new) : 0.f;
      l[g] = dsa::warp_sum(p);
      m[g] = m_new;
      pw[g * 32 + lane] = p;
    }
    __syncwarp();
    // p.V: lanes own hd slices, V rows stream coalesced, VAHEAD at a time
    const int nrows = min(32, lim - base);
    for (int r = 0; r < nrows; r += VAHEAD) {
      float vv[VAHEAD][EPL];
#pragma unroll
      for (int u = 0; u < VAHEAD; ++u) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) vv[u][e] = 0.f;
        if (has_d && r + u < nrows) {
          float vsc = 1.f;
          if constexpr (dsa::Narrow<TC>::value)
            vsc = vsb[(int64_t)(r0 + r + u) * s_ss];
          dsa::load4(vb + (int64_t)(r0 + r + u) * c_ss + d0, vsc, vv[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < VAHEAD; ++u) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float p = (r + u < nrows) ? pw[g * 32 + r + u] : 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(p, vv[u][e], acc[g][e]);
        }
      }
    }
  }
  // this warp's partial softmax state
  const int64_t part = ((int64_t)(b * hkv + kvh) * n_tiles + t) * G;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      ws_m[part + g] = m[g];
      ws_l[part + g] = l[g];
    }
    if (has_d) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) ws_acc[(part + g) * hd + d0 + e] = acc[g][e];
    }
  }
}

// Merge the n_tiles partial states of each (b, KV head) into the output.
template <typename TQ>
__global__ void __launch_bounds__(256)
dsa_decode_combine(const float* __restrict__ ws_m,
                   const float* __restrict__ ws_l,
                   const float* __restrict__ ws_acc, TQ* __restrict__ out,
                   int64_t o_sb, int64_t o_sh, int hkv, int G, int hd,
                   int n_tiles) {
  using dsa::NEG;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int64_t p0 = (int64_t)(b * hkv + kvh) * n_tiles;
  for (int i = threadIdx.x; i < G * hd; i += blockDim.x) {
    const int g = i / hd, d = i % hd;
    float mx = NEG;
    for (int p = 0; p < n_tiles; ++p) mx = fmaxf(mx, ws_m[(p0 + p) * G + g]);
    float lsum = 0.f, a = 0.f;
    for (int p = 0; p < n_tiles; ++p) {
      const int64_t pg = (p0 + p) * G + g;
      const float f = expf(ws_m[pg] - mx);
      lsum = fmaf(ws_l[pg], f, lsum);
      a = fmaf(ws_acc[pg * hd + d], f, a);
    }
    dsa::store1(out + b * o_sb + (int64_t)(kvh * G + g) * o_sh + d,
                a / fmaxf(lsum, 1e-30f));
  }
}

template <typename TQ, typename TC, int G, bool PAGED>
cudaError_t launch(const void* q, int64_t q_sb, int64_t q_sh, const void* k,
                   const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   const float* k_scale, const float* v_scale, int64_t s_sb,
                   int64_t s_ss, const int32_t* idx, const int32_t* pidx,
                   const int32_t* ok, int64_t i_sb,
                   const int32_t* kv_len, float* ws, void* out, int64_t o_sb,
                   int64_t o_sh, int B, int hkv, int S, int hd, int nb,
                   int block_k, float scale, cudaStream_t stream) {
  const int tiles_per_blk = (block_k + 31) / 32;
  const int n_tiles = nb * tiles_per_blk;
  const int64_t parts = (int64_t)B * hkv * n_tiles * G;
  float* ws_m = ws;
  float* ws_l = ws + parts;
  float* ws_acc = ws + 2 * parts;
  const size_t smem = sizeof(float) * (G * hd + WARPS * G * 32);
  auto kern = dsa_decode_partial<TQ, TC, G, PAGED>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(hkv, B, (n_tiles + WARPS - 1) / WARPS);
  kern<<<grid, WARPS * 32, smem, stream>>>(
      static_cast<const TQ*>(q), q_sb, q_sh, static_cast<const TC*>(k),
      static_cast<const TC*>(v), c_sb, c_ss, c_sh, k_scale, v_scale, s_sb,
      s_ss, idx, pidx, ok, i_sb, kv_len, ws_m, ws_l, ws_acc, hkv, S, hd,
      block_k, tiles_per_blk, n_tiles, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dsa_decode_combine<TQ><<<dim3(hkv, B), 256, 0, stream>>>(
      ws_m, ws_l, ws_acc, static_cast<TQ*>(out), o_sb, o_sh, hkv, G, hd,
      n_tiles);
  return cudaGetLastError();
}

template <typename TQ, typename TC, bool PAGED>
cudaError_t dispatch_g(int g, const void* q, int64_t q_sb, int64_t q_sh,
                       const void* k, const void* v, int64_t c_sb,
                       int64_t c_ss, int64_t c_sh, const float* k_scale,
                       const float* v_scale, int64_t s_sb, int64_t s_ss,
                       const int32_t* idx,
                       const int32_t* pidx, const int32_t* ok, int64_t i_sb,
                       const int32_t* kv_len,
                       float* ws, void* out, int64_t o_sb, int64_t o_sh,
                       int B, int hkv, int S, int hd, int nb, int block_k,
                       float scale, cudaStream_t st) {
#define DSA_G(GV)                                                            \
  case GV:                                                                   \
    return launch<TQ, TC, GV, PAGED>(q, q_sb, q_sh, k, v, c_sb, c_ss, c_sh,  \
                                     k_scale, v_scale, s_sb, s_ss, idx,      \
                                     pidx, ok, i_sb, kv_len, ws, out, o_sb,  \
                                     o_sh, B, hkv, S, hd, nb, block_k,       \
                                     scale, st);
  switch (g) {
    DSA_G(1)
    DSA_G(2)
    DSA_G(4)
    DSA_G(8)
    DSA_G(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef DSA_G
}

template <bool PAGED>
int dispatch(int q_dtype, int c_dtype, const void* q, int64_t q_sb,
             int64_t q_sh, const void* k, const void* v, int64_t c_sb,
             int64_t c_ss, int64_t c_sh, const void* k_scale,
             const void* v_scale, int64_t s_sb, int64_t s_ss,
             const void* idx, const void* pidx, const void* ok, int64_t i_sb,
             const void* kv_len, void* ws, void* out, int64_t o_sb,
             int64_t o_sh, int B, int hq, int hkv, int S, int hd, int nb,
             int block_k, float scale, void* stream) {
  const bool narrow = c_dtype == dsa::kI8 || c_dtype == dsa::kFP8;
  if (hkv <= 0 || hq % hkv != 0 || hd % 16 != 0 || hd > 128 || hd <= 0 ||
      nb <= 0 || block_k <= 0 || B <= 0 ||
      narrow != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* px = static_cast<const int32_t*>(pidx);
  const auto* okp = static_cast<const int32_t*>(ok);
  const auto* kl = static_cast<const int32_t*>(kv_len);
  auto* w = static_cast<float*>(ws);
  auto st = static_cast<cudaStream_t>(stream);
#define DSA_ARGS                                                              \
  g, q, q_sb, q_sh, k, v, c_sb, c_ss, c_sh, ks, vs, s_sb, s_ss, ix, px, okp, \
      i_sb, kl, w, out, o_sb, o_sh, B, hkv, S, hd, nb, block_k, scale, st
#define DSA_CASE(QD, TQ, CD, TC)                    \
  if (q_dtype == dsa::QD && c_dtype == dsa::CD)     \
    return (int)dispatch_g<TQ, TC, PAGED>(DSA_ARGS);
  DSA_CASE(kF32, float, kF32, float)
  DSA_CASE(kBF16, __nv_bfloat16, kF32, float)
  DSA_CASE(kBF16, __nv_bfloat16, kBF16, __nv_bfloat16)
  DSA_CASE(kF32, float, kBF16, __nv_bfloat16)
  DSA_CASE(kF32, float, kI8, int8_t)
  DSA_CASE(kBF16, __nv_bfloat16, kI8, int8_t)
  DSA_CASE(kF32, float, kFP8, __nv_fp8_e4m3)
  DSA_CASE(kBF16, __nv_bfloat16, kFP8, __nv_fp8_e4m3)
#undef DSA_CASE
#undef DSA_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interfaces.  q: (B, Hq, 1, hd) with strides (q_sb, q_sh) and unit hd
// stride; idx/ok: (B, nb) int32 with row stride i_sb; kv_len: (B,) int32;
// ws: f32 workspace of B * Hq * nb * ceil(block_k / 32) * (hd + 2)
// elements (one partial (m, l, acc) per 32-row tile and query head);
// out: (B, Hq, 1, hd) in q's dtype.  Strides in elements.  Return the
// cudaError_t of the launches.
//
// An int8 or fp8 cache (K1q, K4q) comes with k_scale/v_scale, f32 per
// (row, head) with a unit head stride and row stride s_ss (batch stride
// s_sb); a full-width cache passes null scales.
//
// K1: k/v (B, S, Hkv, hd) with shared strides (c_sb, c_ss, c_sh).
extern "C" int dsa_decode_launch(
    int q_dtype, int c_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k, const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
    const void* k_scale, const void* v_scale, int64_t s_sb, int64_t s_ss,
    const void* idx, const void* ok, int64_t i_sb, const void* kv_len,
    void* ws, void* out, int64_t o_sb, int64_t o_sh, int B, int hq, int hkv,
    int S, int hd, int nb, int block_k, float scale, void* stream) {
  return dispatch<false>(q_dtype, c_dtype, q, q_sb, q_sh, k, v, c_sb, c_ss,
                         c_sh, k_scale, v_scale, s_sb, s_ss, idx, nullptr,
                         ok, i_sb, kv_len, ws, out, o_sb, o_sh, B, hq, hkv,
                         S, hd, nb, block_k, scale, stream);
}

// K4: k/v pools (P * block_k, Hkv, hd) with shared strides (c_ss, c_sh);
// pidx: (B, nb) int32 physical pages with row stride i_sb.  Keys are
// masked by their logical position idx * block_k + r < kv_len only.
extern "C" int dsa_decode_paged_launch(
    int q_dtype, int c_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    const void* k, const void* v, int64_t c_ss, int64_t c_sh,
    const void* k_scale, const void* v_scale, int64_t s_ss,
    const void* idx, const void* pidx, const void* ok, int64_t i_sb,
    const void* kv_len, void* ws, void* out, int64_t o_sb, int64_t o_sh,
    int B, int hq, int hkv, int hd, int nb, int block_k, float scale,
    void* stream) {
  return dispatch<true>(q_dtype, c_dtype, q, q_sb, q_sh, k, v, 0, c_ss, c_sh,
                        k_scale, v_scale, 0, s_ss, idx, pidx, ok, i_sb,
                        kv_len, ws, out, o_sb, o_sh, B, hq, hkv, 0x7fffffff,
                        hd, nb, block_k, scale, stream);
}
