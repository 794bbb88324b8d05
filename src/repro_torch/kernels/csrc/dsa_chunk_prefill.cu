// K3 and K5: DSA chunk-prefill gather-attend for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/dsa_chunk_prefill.py::dsa_chunk_gather_attention (K3)
//   and ::dsa_chunk_paged_gather_attention (K5) (bodies _kernel and
//   _paged_kernel), and their quantized bodies _quant_kernel (K3q) and
//   _paged_quant_kernel (K5q).
// K5 is K3 over a flat page pool (P * block_k, Hkv, hd): pidx, laid out as
// idx, names the PHYSICAL page of each selected block while idx keeps the
// LOGICAL block that carries the key positions.  One body reaches a
// block's rows through dsa::block_rows (K1/K4's row function), so K5
// equals K3 bitwise on a pool that holds the dense cache's blocks.  K3q
// and K5q are the int8 and fp8 instances: the tile loader multiplies each
// narrow row by its f32 (row, head) scale as it stages the row in shared
// memory, so the inner loops are untouched and K3q equals K3 bitwise on
// the f32 cache dequant(k, k_scale).
// A chunk of C fresh queries (C a multiple of block_q), appended at each
// batch row's own cache depth q_off[b], attends only the cache blocks the
// block-pooled predictor selected per chunk query block: idx/ok
// (B, C / block_q, nb), block j = cache rows [j*block_k, (j+1)*block_k).
// Key k_pos is live for query row i iff ok, k_pos <= q_off[b] + i and
// k_pos < kv_len[b]; p is explicitly ZERO under the mask, as in the
// Pallas body, so a row with no live key comes out 0.  An invalid entry
// carries idx = 0 and is masked by ok, never skipped on idx.  Rows at or
// past kv_len (and past S: the cache is never padded or copied) are
// neither used nor read.  GQA maps query head h to KV head h / (Hq / Hkv).
// Online softmax in f32 with q scaled in f32 before the dot, as in the
// Pallas body; the output is written in q's dtype.  q f32 or bf16, cache
// f32, bf16, int8 or fp8 e4m3, every pair; hd a multiple of 16 up to 128.
//
// What bounds it on the H100: operations, at f32.  At yi_6b's chunk (B=4,
// C=512, Hq 32, Hkv 4, hd 128, block 128, nb=3 of a 4096-row bucket) the
// live causal pairs take ~11 GFLOP against ~60 MB of q, out and selected
// f32 K/V rows: ~0.16 ms at the 67 TFLOP/s f32 rate, ~18 us of bytes.
// The main path feeds bf16 q against the f32 cache and the Pallas body
// computes in f32; rounding the cache rows to bf16 to feed an MMA would
// change what is computed, so this body stays on the f32 FMA pipe.
//
// Design.  One CTA per (slice of RQ query rows of a query block, KV head,
// batch row) serves all G = Hq/Hkv query heads of that KV head from one
// read of each gathered K/V tile: RQ*G (query row, head) pairs, four
// threads per pair each holding a quarter of hd for q and the accumulator
// (K2's f32 layout: a whole 128-wide f32 row of both would overflow the
// 255-register budget), scores summed with two shuffles.  RQ is the
// largest power of two with RQ*G <= 128 (512 threads), capped at block_q;
// a whole query block's G*block_q pairs (1024 at the main shape) carry
// more f32 state than one SM's register file holds.  K/V are staged in
// 16-row f32 shared-memory tiles (16 KB); a tile that no row of the CTA
// can see (past kv_len, above the causal diagonal) and ok = 0 blocks are
// skipped whole, which equals the Pallas body's p = 0 there exactly.
// Not yet done (later PRs): tensor cores for the bf16-cache pair, and a
// split of the selected blocks over more CTAs when B*Hkv*C/RQ is small.
#include "common.cuh"

namespace {

constexpr int KT = 16;      // key rows per shared-memory tile
constexpr int TPR = 4;      // threads per (query row, head) pair
constexpr int MAXC = 8;     // 4-wide hd chunks per thread: hd <= TPR*MAXC*4
constexpr int HDMAX = TPR * MAXC * 4;
constexpr int MAXPAIRS = 128;

template <typename TQ, typename TC, bool PAGED>
__global__ void __launch_bounds__(MAXPAIRS * TPR)
dsa_chunk_f32(const TQ* __restrict__ q, int64_t q_sb, int64_t q_sh,
              int64_t q_sl, const TC* __restrict__ k,
              const TC* __restrict__ v, int64_t c_sb, int64_t c_ss,
              int64_t c_sh, const float* __restrict__ k_scale,
              const float* __restrict__ v_scale, int64_t s_sb, int64_t s_ss,
              const int32_t* __restrict__ idx,
              const int32_t* __restrict__ pidx,
              const int32_t* __restrict__ ok, int64_t i_sb, int64_t i_sq,
              const int32_t* __restrict__ q_off,
              const int32_t* __restrict__ kv_len, TQ* __restrict__ out,
              int64_t o_sb, int64_t o_sh, int64_t o_sl, int g, int rq, int S,
              int hd, int nb, int block_q, int block_k, float scale) {
  using dsa::NEG;
  __shared__ __align__(16) float ks[KT][HDMAX];
  __shared__ __align__(16) float vs[KT][HDMAX];

  const int slices = block_q / rq;
  const int qb = blockIdx.x / slices, sl = blockIdx.x % slices;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int pair = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int gi = pair / rq, r = pair % rq;
  const int h = kvh * g + gi;
  const int row0 = qb * block_q + sl * rq;          // first chunk row
  const int row = row0 + r;
  const int q_lo = q_off[b] + row0;                 // CTA-uniform range
  const int q_hi = q_lo + rq - 1;
  const int qpos = q_off[b] + row;
  const int kvl = min(kv_len[b], S);
  const int nch = hd / (4 * TPR);
  const int hd4 = hd / 4;

  float qr[MAXC][4], acc[MAXC][4];
  const TQ* qp = q + b * q_sb + h * q_sh + (int64_t)row * q_sl;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
#pragma unroll
    for (int e = 0; e < 4; ++e) qr[c][e] = acc[c][e] = 0.f;
    if (c < nch) {
      dsa::load4(qp + 4 * (part + TPR * c), qr[c]);
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[c][e] *= scale;
    }
  }
  float m = NEG, l = 0.f;

  const int64_t i0 = b * i_sb + qb * i_sq;
  const int32_t* ib = idx + i0;
  const int32_t* okb = ok + i0;

  for (int j = 0; j < nb; ++j) {
    if (okb[j] == 0) continue;                      // whole block masked
    const int kstart = ib[j] * block_k;             // logical position
    // the block's rows (dense cache or pool page) and, narrow, scales
    const int64_t rows = dsa::block_rows<PAGED>(pidx, i0 + j, kstart,
                                                block_k, b * c_sb, c_ss)
                         + kvh * c_sh;
    const TC* kb = k + rows;
    const TC* vb = v + rows;
    const float* ksb = nullptr;
    const float* vsb = nullptr;
    if constexpr (dsa::Narrow<TC>::value) {
      const int64_t srows = dsa::block_rows<PAGED>(pidx, i0 + j, kstart,
                                                   block_k, b * s_sb, s_ss)
                            + kvh;
      ksb = k_scale + srows;
      vsb = v_scale + srows;
    }
    for (int r0 = 0; r0 < block_k; r0 += KT) {
      const int k_lo = kstart + r0;
      // keys at or past kv_len (<= S) are masked and never read
      const int nk = min(KT, min(block_k - r0, kvl - k_lo));
      if (nk <= 0) break;
      if (k_lo > q_hi) break;                       // above the diagonal
      __syncthreads();                              // last tile consumed
      for (int i = threadIdx.x; i < KT * hd4; i += blockDim.x) {
        const int rr = i / hd4, c = (i % hd4) * 4;
        float kt[4] = {0.f, 0.f, 0.f, 0.f}, vt[4] = {0.f, 0.f, 0.f, 0.f};
        if (rr < nk) {                              // zero-fill the tail
          const int64_t br = r0 + rr;               // row in the block
          float ksc = 1.f, vsc = 1.f;               // narrow: dequantize
          if constexpr (dsa::Narrow<TC>::value) {
            ksc = ksb[br * s_ss];
            vsc = vsb[br * s_ss];
          }
          dsa::load4(kb + br * c_ss + c, ksc, kt);
          dsa::load4(vb + br * c_ss + c, vsc, vt);
        }
        *reinterpret_cast<float4*>(&ks[rr][c]) = make_float4(kt[0], kt[1], kt[2], kt[3]);
        *reinterpret_cast<float4*>(&vs[rr][c]) = make_float4(vt[0], vt[1], vt[2], vt[3]);
      }
      __syncthreads();

      float s[KT];
      unsigned live = 0u;
      float mt = NEG;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        float ps = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < nch) {
            const float4 k4 = *reinterpret_cast<const float4*>(&ks[kk][4 * (part + TPR * c)]);
            ps = fmaf(qr[c][0], k4.x, ps);
            ps = fmaf(qr[c][1], k4.y, ps);
            ps = fmaf(qr[c][2], k4.z, ps);
            ps = fmaf(qr[c][3], k4.w, ps);
          }
        }
        ps += __shfl_xor_sync(0xffffffffu, ps, 1);
        ps += __shfl_xor_sync(0xffffffffu, ps, 2);
        const bool on = kk < nk && k_lo + kk <= qpos;
        s[kk] = on ? ps : NEG;
        live |= (on ? 1u : 0u) << kk;
        mt = fmaxf(mt, s[kk]);
      }
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c][e] *= alpha;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const float p = ((live >> kk) & 1u) ? expf(s[kk] - m_new) : 0.f;
        psum += p;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c < nch) {
            const float4 v4 = *reinterpret_cast<const float4*>(&vs[kk][4 * (part + TPR * c)]);
            acc[c][0] = fmaf(p, v4.x, acc[c][0]);
            acc[c][1] = fmaf(p, v4.y, acc[c][1]);
            acc[c][2] = fmaf(p, v4.z, acc[c][2]);
            acc[c][3] = fmaf(p, v4.w, acc[c][3]);
          }
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  const float den = fmaxf(l, 1e-30f);
  TQ* op = out + b * o_sb + h * o_sh + (int64_t)row * o_sl;
#pragma unroll
  for (int c = 0; c < MAXC; ++c) {
    if (c < nch) {
      float o4[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) o4[e] = acc[c][e] / den;
      dsa::store4(op + 4 * (part + TPR * c), o4);
    }
  }
}

// Query rows per CTA: the largest power of two with rq * g <= MAXPAIRS,
// capped at block_q.
int rows_per_cta(int g, int block_q) {
  int rq = 1;
  while (2 * rq * g <= MAXPAIRS && 2 * rq <= block_q) rq *= 2;
  return rq;
}

template <typename TQ, typename TC, bool PAGED>
cudaError_t launch(const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sl,
                   const void* k, const void* v, int64_t c_sb, int64_t c_ss,
                   int64_t c_sh, const float* k_scale, const float* v_scale,
                   int64_t s_sb, int64_t s_ss, const int32_t* idx,
                   const int32_t* pidx, const int32_t* ok, int64_t i_sb,
                   int64_t i_sq, const int32_t* q_off, const int32_t* kv_len,
                   void* out, int64_t o_sb, int64_t o_sh, int64_t o_sl,
                   int B, int hkv, int g, int C, int S, int hd, int nb,
                   int block_q, int block_k, float scale,
                   cudaStream_t stream) {
  const int rq = rows_per_cta(g, block_q);
  // whole warps for the shuffles, whole slices of the query block
  if ((rq * g * TPR) % 32 != 0 || block_q % rq != 0)
    return cudaErrorInvalidValue;
  const dim3 grid((C / block_q) * (block_q / rq), hkv, B);
  dsa_chunk_f32<TQ, TC, PAGED><<<grid, rq * g * TPR, 0, stream>>>(
      static_cast<const TQ*>(q), q_sb, q_sh, q_sl, static_cast<const TC*>(k),
      static_cast<const TC*>(v), c_sb, c_ss, c_sh, k_scale, v_scale, s_sb,
      s_ss, idx, pidx, ok, i_sb, i_sq, q_off, kv_len,
      static_cast<TQ*>(out), o_sb, o_sh, o_sl, g, rq, S, hd, nb, block_q,
      block_k, scale);
  return cudaGetLastError();
}

template <bool PAGED>
int dispatch(int q_dtype, int c_dtype, const void* q, int64_t q_sb,
             int64_t q_sh, int64_t q_sl, const void* k, const void* v,
             int64_t c_sb, int64_t c_ss, int64_t c_sh, const void* k_scale,
             const void* v_scale, int64_t s_sb, int64_t s_ss,
             const void* idx, const void* pidx, const void* ok, int64_t i_sb,
             int64_t i_sq, const void* q_off, const void* kv_len, void* out,
             int64_t o_sb, int64_t o_sh, int64_t o_sl, int B, int hq,
             int hkv, int C, int S, int hd, int nb, int block_q, int block_k,
             float scale, void* stream) {
  const bool narrow = c_dtype == dsa::kI8 || c_dtype == dsa::kFP8;
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > MAXPAIRS || hd <= 0 ||
      hd % 16 != 0 || hd > HDMAX || block_q <= 0 || C <= 0 ||
      C % block_q != 0 || block_k <= 0 || nb <= 0 || B <= 0 || S <= 0 ||
      narrow != (k_scale != nullptr && v_scale != nullptr))
    return (int)cudaErrorInvalidValue;
  const int g = hq / hkv;
  const auto* ks = static_cast<const float*>(k_scale);
  const auto* vs = static_cast<const float*>(v_scale);
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* px = static_cast<const int32_t*>(pidx);
  const auto* okp = static_cast<const int32_t*>(ok);
  const auto* qo = static_cast<const int32_t*>(q_off);
  const auto* kl = static_cast<const int32_t*>(kv_len);
  auto st = static_cast<cudaStream_t>(stream);
#define DSA_ARGS                                                           \
  q, q_sb, q_sh, q_sl, k, v, c_sb, c_ss, c_sh, ks, vs, s_sb, s_ss, ix, px, \
      okp, i_sb, i_sq, qo, kl, out, o_sb, o_sh, o_sl, B, hkv, g, C, S, hd, \
      nb, block_q, block_k, scale, st
#define DSA_CASE(QD, TQ, CD, TC)                \
  if (q_dtype == dsa::QD && c_dtype == dsa::CD) \
    return (int)launch<TQ, TC, PAGED>(DSA_ARGS);
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

// C interfaces.  q/out: (B, Hq, C, hd) with (batch, head, row) strides in
// elements and a unit hd stride, in one dtype; idx/ok: (B, C / block_q,
// nb) int32 with strides (i_sb, i_sq) and a unit nb stride; q_off/kv_len:
// (B,) int32.  An int8 or fp8 cache (K3q, K5q) comes with k_scale/v_scale,
// f32 per (row, head) with a unit head stride and row stride s_ss (batch
// stride s_sb); a full-width cache passes null scales.  Return the
// cudaError_t of the launch.
//
// K3: k/v (B, S, Hkv, hd) with shared strides (c_sb, c_ss, c_sh).
extern "C" int dsa_chunk_prefill_launch(
    int q_dtype, int c_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    int64_t q_sl, const void* k, const void* v, int64_t c_sb, int64_t c_ss,
    int64_t c_sh, const void* k_scale, const void* v_scale, int64_t s_sb,
    int64_t s_ss, const void* idx, const void* ok, int64_t i_sb,
    int64_t i_sq, const void* q_off, const void* kv_len, void* out,
    int64_t o_sb, int64_t o_sh, int64_t o_sl, int B, int hq, int hkv, int C,
    int S, int hd, int nb, int block_q, int block_k, float scale,
    void* stream) {
  return dispatch<false>(q_dtype, c_dtype, q, q_sb, q_sh, q_sl, k, v, c_sb,
                         c_ss, c_sh, k_scale, v_scale, s_sb, s_ss, idx,
                         nullptr, ok, i_sb, i_sq, q_off, kv_len, out, o_sb,
                         o_sh, o_sl, B, hq, hkv, C, S, hd, nb, block_q,
                         block_k, scale, stream);
}

// K5: k/v pools (P * block_k, Hkv, hd) with shared strides (c_ss, c_sh);
// pidx: (B, C / block_q, nb) int32 physical pages laid out as idx.  Keys
// are masked by their logical position idx * block_k + r only.
extern "C" int dsa_chunk_prefill_paged_launch(
    int q_dtype, int c_dtype, const void* q, int64_t q_sb, int64_t q_sh,
    int64_t q_sl, const void* k, const void* v, int64_t c_ss, int64_t c_sh,
    const void* k_scale, const void* v_scale, int64_t s_ss, const void* idx,
    const void* pidx, const void* ok, int64_t i_sb, int64_t i_sq,
    const void* q_off, const void* kv_len, void* out, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, int B, int hq, int hkv, int C, int hd,
    int nb, int block_q, int block_k, float scale, void* stream) {
  return dispatch<true>(q_dtype, c_dtype, q, q_sb, q_sh, q_sl, k, v, 0, c_ss,
                        c_sh, k_scale, v_scale, 0, s_ss, idx, pidx, ok, i_sb,
                        i_sq, q_off, kv_len, out, o_sb, o_sh, o_sl, B, hq,
                        hkv, C, 0x7fffffff, hd, nb, block_q, block_k, scale,
                        stream);
}
