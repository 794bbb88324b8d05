// K2: DSA block-sparse flash attention (prefill) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/dsa_attention.py::dsa_block_sparse_attention (body _kernel)
// Each query block attends only the key blocks its predictor selected:
// idx/valid (B, nQb, nb).  Causal and sliding-window masks are applied by
// absolute position, GQA maps query head h to KV head h / (Hq / Hkv), and
// the online softmax runs in f32 with q scaled in f32 before the dot, as
// in the Pallas body.  Unlike the Pallas body, p is explicitly ZERO under
// the mask.  That equals the Pallas kernel wherever the Pallas kernel is
// exact, i.e. whenever some visited block holds a live key for the row
// (the Pallas garbage of an all-masked leading block is wiped by the
// alpha = exp(NEG - m) = 0 rescale at the first live key).  On the main
// path the diagonal force-keep with block_q == block_k guarantees every
// row a live key in its first visited block (core/masks.py,
// block_topk_indices).  A row with no live key at all gets 0 here.
//
// What bounds it on the H100: bytes and operations about evenly.  At
// yi_6b's prefill (B=4, L=4096, 32 heads, hd 128, nb=3) the live causal
// pairs of the visited blocks take ~83 GFLOP (84 us at the 989 TFLOP/s
// bf16 tensor-core rate) against ~302 MB read and written (90 us at
// 3.35 TB/s), so the products must run on the tensor cores to get near
// the bound.
//
// Design.  One CTA per (query block, q head, batch row) loops over its nb
// selected key blocks, staging K and V sub-tiles in shared memory, and
// skips whole sub-tiles no query row of the CTA can see (above the causal
// diagonal, behind the window) and ok = 0 blocks.  One body per dtype:
//  - bf16 (the main path): warp-level tensor-core MMAs (WMMA, 16x16x16
//    bf16 -> f32), 16 query rows per warp, 64-row K/V sub-tiles.  The
//    bf16 x bf16 products are exact in f32, so scaling the f32 scores
//    after QK^T equals the Pallas body's f32 scaling of q to f32 rounding.
//    The softmax runs in f32 on the scores in a per-warp scratch.  The
//    Pallas body keeps p in f32 for p.v; a bf16 MMA operand would round p
//    to 8 bits, so p is split into p_hi = bf16(p) and p_lo = bf16(p - p_hi)
//    and PV runs as two MMAs, which carries p to about 2^-17 of its value.
//    The body needs 16-row tiles and 16-byte aligned rows; the C entry
//    refuses other shapes.
//  - f32: the f32 FMA pipe, four threads per query row each holding a
//    quarter of hd for q and the accumulator (a whole 128-wide f32 row of
//    both would overflow the 255-register budget), scores summed with two
//    shuffles, 16-row K/V sub-tiles (16 KB, inside the static limit).
// Not yet done (later PRs): wgmma on warpgroups with TMA-fed, double
// buffered tiles; the WMMA body reloads its B operands from shared memory
// for every MMA and keeps one CTA per SM.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int KT = 16;     // key rows per shared-memory sub-tile
constexpr int TPR = 4;     // threads per query row
constexpr int MAXC = 8;    // 4-wide hd chunks per thread: hd <= TPR*MAXC*4
constexpr int HDMAX = TPR * MAXC * 4;

__global__ void __launch_bounds__(512)
dsa_attention_f32(const float* __restrict__ q, int64_t q_sb, int64_t q_sh,
                  int64_t q_sl, const float* __restrict__ k, int64_t k_sb,
                  int64_t k_sh, int64_t k_sl, const float* __restrict__ v,
                  int64_t v_sb, int64_t v_sh, int64_t v_sl,
                  const int32_t* __restrict__ idx,
                  const int32_t* __restrict__ valid, int64_t i_sb,
                  int64_t i_sq, float* __restrict__ out, int64_t o_sb,
                  int64_t o_sh, int64_t o_sl, int g, int Lk, int hd, int nb,
                  int block_q, int block_k, int causal, int window,
                  float scale) {
  using dsa::NEG;
  __shared__ __align__(16) float ks[KT][HDMAX];
  __shared__ __align__(16) float vs[KT][HDMAX];

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g;
  const int row = threadIdx.x / TPR, part = threadIdx.x % TPR;
  const int nch = hd / (4 * TPR);
  const int hd4 = hd / 4;
  const int q_lo = qb * block_q, q_hi = q_lo + block_q - 1;
  const int qpos = q_lo + row;

  float qr[MAXC][4], acc[MAXC][4];
  const float* qp = q + b * q_sb + h * q_sh + (int64_t)qpos * q_sl;
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

  const float* kb = k + b * k_sb + kvh * k_sh;
  const float* vb = v + b * v_sb + kvh * v_sh;
  const int32_t* ib = idx + b * i_sb + qb * i_sq;
  const int32_t* okb = valid + b * i_sb + qb * i_sq;

  for (int j = 0; j < nb; ++j) {
    if (okb[j] == 0) continue;                       // whole block masked
    const int kstart = ib[j] * block_k;
    for (int r0 = 0; r0 < block_k; r0 += KT) {
      const int k_lo = kstart + r0;
      const int nk = min(KT, min(block_k - r0, Lk - k_lo));
      if (nk <= 0) break;
      if (causal && k_lo > q_hi) break;              // above the diagonal
      if (window && k_lo + nk - 1 <= q_lo - window) continue;
      __syncthreads();                               // last tile consumed
      for (int i = threadIdx.x; i < KT * hd4; i += blockDim.x) {
        const int r = i / hd4, c = (i % hd4) * 4;
        float kt[4] = {0.f, 0.f, 0.f, 0.f}, vt[4] = {0.f, 0.f, 0.f, 0.f};
        if (r < nk) {                                // zero-fill the tail
          dsa::load4(kb + (int64_t)(k_lo + r) * k_sl + c, kt);
          dsa::load4(vb + (int64_t)(k_lo + r) * v_sl + c, vt);
        }
        *reinterpret_cast<float4*>(&ks[r][c]) = make_float4(kt[0], kt[1], kt[2], kt[3]);
        *reinterpret_cast<float4*>(&vs[r][c]) = make_float4(vt[0], vt[1], vt[2], vt[3]);
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
        const int kpos = k_lo + kk;
        bool on = kk < nk;
        if (causal) on = on && kpos <= qpos;
        if (window) on = on && kpos > qpos - window;
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
  float* op = out + b * o_sb + h * o_sh + (int64_t)qpos * o_sl;
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

// Tensor-core body for bf16 operands: one warp per 16 query rows; QK^T and
// PV run as 16x16x16 bf16 MMAs (WMMA) with f32 accumulation; K and V
// sub-tiles of WKT rows are staged in shared memory as bf16, the scores and
// the PV partial product pass through a per-warp f32 scratch, and the
// softmax state and output accumulator stay in registers (lane 2r and
// 2r+1 own row r, one half of hd each).  p goes to the PV product as the
// bf16 pair (p_hi, p_lo) and l sums the f32 p, as in the Pallas body.
constexpr int WKT = 64;                    // key rows per sub-tile
constexpr int WROWS = 16;                  // query rows per warp

__host__ __device__ constexpr int wmma_hdp(int hd) { return hd + 8; }
__host__ __device__ constexpr int wmma_scratch_ld(int hd) {
  return (hd > WKT ? hd : WKT) + 4;
}

size_t wmma_smem_bytes(int hd, int warps) {
  return sizeof(__nv_bfloat16) * 2 * WKT * wmma_hdp(hd)          // K, V
         + (size_t)warps * (sizeof(float) * WROWS * wmma_scratch_ld(hd)
                            + sizeof(__nv_bfloat16) * 2 * WROWS * (WKT + 8)
                            + sizeof(__nv_bfloat16) * WROWS * wmma_hdp(hd));
}

__global__ void __launch_bounds__(256)
dsa_attention_wmma(const __nv_bfloat16* __restrict__ q, int64_t q_sb,
                   int64_t q_sh, int64_t q_sl,
                   const __nv_bfloat16* __restrict__ k, int64_t k_sb,
                   int64_t k_sh, int64_t k_sl,
                   const __nv_bfloat16* __restrict__ v, int64_t v_sb,
                   int64_t v_sh, int64_t v_sl, const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ valid, int64_t i_sb,
                   int64_t i_sq, __nv_bfloat16* __restrict__ out,
                   int64_t o_sb, int64_t o_sh, int64_t o_sl, int g, int Lk,
                   int hd, int nb, int block_q, int block_k, int causal,
                   int window, float scale) {
  using namespace nvcuda;
  using dsa::NEG;
  extern __shared__ __align__(128) unsigned char wsm[];
  const int hdp = wmma_hdp(hd), sld = wmma_scratch_ld(hd), pld = WKT + 8;
  const int warps = blockDim.x / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(wsm);
  __nv_bfloat16* vs = ks + WKT * hdp;
  float* scr = reinterpret_cast<float*>(vs + WKT * hdp) + warp * WROWS * sld;
  // after the scratches: each warp's p_hi and p_lo (16 x pld each), then
  // each warp's q rows (16 x hdp)
  __nv_bfloat16* pbase = reinterpret_cast<__nv_bfloat16*>(
      reinterpret_cast<float*>(vs + WKT * hdp) + warps * WROWS * sld);
  __nv_bfloat16* pb = pbase + warp * 2 * WROWS * pld;
  __nv_bfloat16* pl = pb + WROWS * pld;
  __nv_bfloat16* qsm = pbase + warps * 2 * WROWS * pld + warp * WROWS * hdp;

  const int qb = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / g;
  const int q_lo = qb * block_q, q_hi = q_lo + block_q - 1;
  const int row0 = q_lo + warp * WROWS;      // this warp's first query row
  const int nkf = hd / 16;
  const int hd8 = hd / 8;

  // this warp's 16 query rows -> shared memory -> A fragments
  for (int i = lane; i < WROWS * hd8; i += 32) {
    const int r = i / hd8, c = (i % hd8) * 8;
    *reinterpret_cast<uint4*>(qsm + r * hdp + c) = *reinterpret_cast<const uint4*>(
        q + b * q_sb + h * q_sh + (int64_t)(row0 + r) * q_sl + c);
  }
  __syncwarp();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[8];
#pragma unroll
  for (int kf = 0; kf < 8; ++kf)
    if (kf < nkf) wmma::load_matrix_sync(qf[kf], qsm + kf * 16, hdp);

  // softmax state and output accumulator: lane 2r / 2r+1 own row r
  const int my_r = lane / 2, half = lane % 2;
  const int qpos = row0 + my_r;
  const int hh = hd / 2;                      // columns per lane
  float o[64];
#pragma unroll
  for (int c = 0; c < 64; ++c) o[c] = 0.f;
  float m = NEG, l = 0.f;

  const __nv_bfloat16* kb = k + b * k_sb + kvh * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + kvh * v_sh;
  const int32_t* ib = idx + b * i_sb + qb * i_sq;
  const int32_t* okb = valid + b * i_sb + qb * i_sq;

  for (int j = 0; j < nb; ++j) {
    if (okb[j] == 0) continue;                       // whole block masked
    const int kstart = ib[j] * block_k;
    for (int r0 = 0; r0 < block_k; r0 += WKT) {
      const int k_lo = kstart + r0;
      const int nk = min(WKT, min(block_k - r0, Lk - k_lo));
      if (nk <= 0) break;
      if (causal && k_lo > q_hi) break;              // above the diagonal
      if (window && k_lo + nk - 1 <= q_lo - window) continue;
      __syncthreads();                               // last tile consumed
      for (int i = threadIdx.x; i < WKT * hd8; i += blockDim.x) {
        const int r = i / hd8, c = (i % hd8) * 8;
        uint4 kt = make_uint4(0u, 0u, 0u, 0u), vt = kt;
        if (r < nk) {                                // zero-fill the tail
          kt = *reinterpret_cast<const uint4*>(kb + (int64_t)(k_lo + r) * k_sl + c);
          vt = *reinterpret_cast<const uint4*>(vb + (int64_t)(k_lo + r) * v_sl + c);
        }
        *reinterpret_cast<uint4*>(ks + r * hdp + c) = kt;
        *reinterpret_cast<uint4*>(vs + r * hdp + c) = vt;
      }
      __syncthreads();

      // S = Q K^T (16 x WKT) into the scratch
#pragma unroll
      for (int nf = 0; nf < WKT / 16; ++nf) {
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
        wmma::fill_fragment(sf, 0.f);
#pragma unroll
        for (int kf = 0; kf < 8; ++kf) {
          if (kf < nkf) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kfm;
            wmma::load_matrix_sync(kfm, ks + nf * 16 * hdp + kf * 16, hdp);
            wmma::mma_sync(sf, qf[kf], kfm, sf);
          }
        }
        wmma::store_matrix_sync(scr + nf * 16, sf, sld, wmma::mem_row_major);
      }
      __syncwarp();

      // online softmax on row my_r, columns [half*32, half*32+32)
      float sv[32];
      float mt = NEG;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int kk = half * 32 + c;
        const int kpos = k_lo + kk;
        bool on = kk < nk;
        if (causal) on = on && kpos <= qpos;
        if (window) on = on && kpos > qpos - window;
        sv[c] = on ? scr[my_r * sld + kk] * scale : NEG;
        mt = fmaxf(mt, sv[c]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_new = fmaxf(m, mt);
      const float alpha = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const float p = sv[c] > 0.5f * NEG ? expf(sv[c] - m_new) : 0.f;
        const __nv_bfloat16 hi = __float2bfloat16(p);
        psum += p;
        pb[my_r * pld + half * 32 + c] = hi;
        pl[my_r * pld + half * 32 + c] = __float2bfloat16(p - __bfloat162float(hi));
      }
      psum += __shfl_xor_sync(0xffffffffu, psum, 1);
      l = l * alpha + psum;
      m = m_new;
#pragma unroll
      for (int c = 0; c < 64; ++c) o[c] *= alpha;
      __syncwarp();

      // O += (P_hi + P_lo) V (16 x hd) through the scratch
#pragma unroll
      for (int nf = 0; nf < 8; ++nf) {
        if (nf < nkf) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
          wmma::fill_fragment(of, 0.f);
#pragma unroll
          for (int kf = 0; kf < WKT / 16; ++kf) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
            wmma::load_matrix_sync(vf, vs + kf * 16 * hdp + nf * 16, hdp);
            wmma::load_matrix_sync(pf, pb + kf * 16, pld);
            wmma::mma_sync(of, pf, vf, of);
            wmma::load_matrix_sync(pf, pl + kf * 16, pld);
            wmma::mma_sync(of, pf, vf, of);
          }
          wmma::store_matrix_sync(scr + nf * 16, of, sld, wmma::mem_row_major);
        }
      }
      __syncwarp();
#pragma unroll
      for (int c = 0; c < 64; ++c)
        if (c < hh) o[c] += scr[my_r * sld + half * hh + c];
      __syncwarp();
    }
  }

  const float den = fmaxf(l, 1e-30f);
  __nv_bfloat16* op = out + b * o_sb + h * o_sh + (int64_t)qpos * o_sl + half * hh;
#pragma unroll
  for (int c = 0; c < 64; c += 4) {
    if (c < hh) {
      float o4[4] = {o[c] / den, o[c + 1] / den, o[c + 2] / den, o[c + 3] / den};
      dsa::store4(op + c, o4);
    }
  }
}

cudaError_t launch_f32(const void* q, int64_t q_sb, int64_t q_sh,
                       int64_t q_sl, const void* k, int64_t k_sb,
                       int64_t k_sh, int64_t k_sl, const void* v,
                       int64_t v_sb, int64_t v_sh, int64_t v_sl,
                       const int32_t* idx, const int32_t* valid,
                       int64_t i_sb, int64_t i_sq, void* out, int64_t o_sb,
                       int64_t o_sh, int64_t o_sl, int B, int hq, int hkv,
                       int Lq, int Lk, int hd, int nb, int block_q,
                       int block_k, int causal, int window, float scale,
                       cudaStream_t stream) {
  const dim3 grid(Lq / block_q, hq, B);
  dsa_attention_f32<<<grid, TPR * block_q, 0, stream>>>(
      static_cast<const float*>(q), q_sb, q_sh, q_sl,
      static_cast<const float*>(k), k_sb, k_sh, k_sl,
      static_cast<const float*>(v), v_sb, v_sh, v_sl, idx, valid, i_sb,
      i_sq, static_cast<float*>(out), o_sb, o_sh, o_sl, hq / hkv, Lk, hd,
      nb, block_q, block_k, causal, window, scale);
  return cudaGetLastError();
}

cudaError_t launch_wmma(const void* q, int64_t q_sb, int64_t q_sh,
                        int64_t q_sl, const void* k, int64_t k_sb,
                        int64_t k_sh, int64_t k_sl, const void* v,
                        int64_t v_sb, int64_t v_sh, int64_t v_sl,
                        const int32_t* idx, const int32_t* valid,
                        int64_t i_sb, int64_t i_sq, void* out, int64_t o_sb,
                        int64_t o_sh, int64_t o_sl, int B, int hq, int hkv,
                        int Lq, int Lk, int hd, int nb, int block_q,
                        int block_k, int causal, int window, float scale,
                        cudaStream_t stream) {
  const int warps = block_q / WROWS;
  const size_t smem = wmma_smem_bytes(hd, warps);
  const cudaError_t ea = cudaFuncSetAttribute(
      dsa_attention_wmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (ea != cudaSuccess) return ea;
  const dim3 grid(Lq / block_q, hq, B);
  using T = __nv_bfloat16;
  dsa_attention_wmma<<<grid, 32 * warps, smem, stream>>>(
      static_cast<const T*>(q), q_sb, q_sh, q_sl, static_cast<const T*>(k),
      k_sb, k_sh, k_sl, static_cast<const T*>(v), v_sb, v_sh, v_sl, idx,
      valid, i_sb, i_sq, static_cast<T*>(out), o_sb, o_sh, o_sl, hq / hkv,
      Lk, hd, nb, block_q, block_k, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// C interface.  q/out: (B, Hq, Lq, hd), k/v: (B, Hkv, Lk, hd), each with
// its own (batch, head, row) strides in elements and a unit hd stride;
// idx/valid: (B, nQb, nb) int32 with strides (i_sb, i_sq) and unit nb
// stride.  q, k, v and out share one dtype.  Returns the cudaError_t of
// the launch.
extern "C" int dsa_attention_launch(
    int dtype, const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sl,
    const void* k, int64_t k_sb, int64_t k_sh, int64_t k_sl, const void* v,
    int64_t v_sb, int64_t v_sh, int64_t v_sl, const void* idx,
    const void* valid, int64_t i_sb, int64_t i_sq, void* out, int64_t o_sb,
    int64_t o_sh, int64_t o_sl, int B, int hq, int hkv, int Lq, int Lk,
    int hd, int nb, int block_q, int block_k, int causal, int window,
    float scale, void* stream) {
  if (hkv <= 0 || hq % hkv != 0 || hd <= 0 || hd % 16 != 0 || hd > HDMAX ||
      block_q <= 0 || block_q % 8 != 0 || block_q > 128 || Lq % block_q != 0 ||
      block_k <= 0 || nb <= 0 || B <= 0 || Lq <= 0)
    return (int)cudaErrorInvalidValue;
  const auto* ix = static_cast<const int32_t*>(idx);
  const auto* ok = static_cast<const int32_t*>(valid);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == dsa::kF32) {
    e = launch_f32(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh,
                   v_sl, ix, ok, i_sb, i_sq, out, o_sb, o_sh, o_sl, B, hq,
                   hkv, Lq, Lk, hd, nb, block_q, block_k, causal, window,
                   scale, st);
  } else if (dtype == dsa::kBF16) {
    // the tensor-core body takes 16-row tiles and 16-byte aligned rows
    if (block_q % 16 != 0 || block_k % 16 != 0 || q_sb % 8 || q_sh % 8 ||
        q_sl % 8 || k_sb % 8 || k_sh % 8 || k_sl % 8 || v_sb % 8 ||
        v_sh % 8 || v_sl % 8)
      return (int)cudaErrorInvalidValue;
    e = launch_wmma(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh,
                    v_sl, ix, ok, i_sb, i_sq, out, o_sb, o_sh, o_sl, B, hq,
                    hkv, Lq, Lk, hd, nb, block_q, block_k, causal, window,
                    scale, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
