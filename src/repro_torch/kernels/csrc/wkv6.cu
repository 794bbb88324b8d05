// K7: chunked RWKV6 linear attention (wkv6) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/wkv6.py::wkv6_chunked (body _kernel)
// The recurrence S_t = diag(w_t) S_{t-1} + k_t^T v_t,
// y_t = r_t (S_{t-1} + diag(u) k_t^T v_t) runs C tokens at a time (C = 32 on
// the model path).  Within a chunk, per column d of the head:
//   logw = log(max(w, 1e-38)),  cum = cumsum_t logw,  cum_c = clip(cum, -30, 0)
//   rr   = r * exp(cum_c - logw),  kk = k * exp(-cum_c)
//   y    = rr S + tril_strict(rr kk^T) v + (r*u*k).sum(-1) v
//   S   <- exp(clip(cum_last))^T * S + (k * exp(clip(cum_last - cum)))^T v
// in f32, in the Pallas body's order.  The clamp at -30 is part of what the
// kernel computes: where a chunk's decay product falls below e^-30 the
// chunked form differs from the token recurrence, as the Pallas kernel does.
//
// What bounds it on the H100: operations.  At the rwkv6_3b slice (B 4,
// H 40, S 4096, hd 64, bf16 r/k/v/w/y) the four products per chunk need
// 4 C hd^2 + 2 hd C (C - 1) flops (the strict triangle only): 13.3 GFLOP
// for the whole call, 0.199 ms on the 67 TFLOP/s f32 FMA pipe, against
// 0.42 GB moved (0.125 ms at 3.35 TB/s).
//
// Design.  One CTA of 256 threads per (head, batch row) walks the chunks in
// order: the loop takes the place of the Pallas grid's sequential chunk
// axis, and the hd x hd f32 state stays on chip across it (each thread
// holds 16 entries of it in registers, and a copy in shared memory feeds
// the next chunk's y).  Each chunk's r/k/v/w tile is staged as f32 in
// shared memory; the next chunk's tile is loaded into registers while this
// one is computed.  One thread per column takes the cumulative log decay in
// order from registers (log w is taken as the tile is staged); the
// products run on the FMA pipe with each operand read from
// shared memory as a broadcast or by consecutive lanes (kk is stored
// transposed, with a padded pitch).  Inputs are read by strides, so the
// model layout (B, S, H, hd) needs no transpose copy, and y is written in
// the caller's (B, S, H, hd) memory.  s0 is read at chunk 0 and s_last
// written after the last chunk; each CTA reads and writes only its own
// (b, h) state, so s_out may alias s0.
// Not yet done (later PRs): tensor cores (the products are 32 x 64 x 64
// with f32 operands; TF32 or split-bf16 MMAs), more than one CTA per
// (b, h) by splitting the value columns, TMA-fed tiles.
#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int MAXC = 32;         // chunk rows
constexpr int MAXD = 64;         // head dim
constexpr int KTP = MAXC + 1;    // pitch of the transposed kk tile
constexpr int YR = MAXC / 4;     // y rows per thread (4 row groups)
constexpr int SR = MAXD / 4;     // state rows per thread
constexpr int PR = MAXC / 8;     // score rows per warp
constexpr int NV = MAXC * MAXD / 4 / NT;  // float4 groups per thread per tile
constexpr float CLAMP = -30.f;
constexpr float WMIN = 1e-38f;

struct Smem {
  float r[MAXC][MAXD];     // r, then rr = r * exp(cum_c - logw)
  float k[MAXC][MAXD];     // k, then k_hat = k * exp(clip(cum_last - cum))
  float v[MAXC][MAXD];
  float lw[MAXC][MAXD];    // log(max(w, 1e-38))
  float cum[MAXC][MAXD];   // cumulative log decay within the chunk
  float kkt[MAXD][KTP];    // (k * exp(-cum_c))^T
  float p[MAXC][MAXC];     // strictly lower triangle of rr kk^T
  float s[MAXD][MAXD];     // the state at the start of the chunk
  float u[MAXD];
  float dec[MAXD];         // exp(clip(cum_last))
  float cl[MAXD];          // cum_last
  float diag[MAXC];        // (r * u * k).sum(-1)
};

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, CLAMP), 0.f);
}

// The next tile (C rows of r, k, v, w) into registers, as f32.
template <typename T>
__device__ __forceinline__ void fetch(const T* r, const T* k, const T* v,
                                      const T* w, int64_t x_ss, int c0, int C,
                                      int D, float (&pf)[4][NV][4]) {
  const int d4 = D / 4;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int gi = threadIdx.x + q * NT;
    if (gi < C * d4) {
      const int64_t off = (int64_t)(c0 + gi / d4) * x_ss + (gi % d4) * 4;
      dsa::load4(r + off, pf[0][q]);
      dsa::load4(k + off, pf[1][q]);
      dsa::load4(v + off, pf[2][q]);
      dsa::load4(w + off, pf[3][q]);
    }
  }
}

// The fetched tile into shared memory, w as log(max(w, 1e-38)).
__device__ __forceinline__ void stage(Smem& sm, int C, int D,
                                      float (&pf)[4][NV][4]) {
  const int d4 = D / 4;
#pragma unroll
  for (int q = 0; q < NV; ++q) {
    const int gi = threadIdx.x + q * NT;
    if (gi < C * d4) {
      const int t = gi / d4, d = (gi % d4) * 4;
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[3][q][e] = logf(fmaxf(pf[3][q][e], WMIN));
      float* dst[4] = {&sm.r[t][d], &sm.k[t][d], &sm.v[t][d], &sm.lw[t][d]};
#pragma unroll
      for (int a = 0; a < 4; ++a)
        *reinterpret_cast<float4*>(dst[a]) =
            make_float4(pf[a][q][0], pf[a][q][1], pf[a][q][2], pf[a][q][3]);
    }
  }
}

template <typename T, typename TU>
__global__ void __launch_bounds__(NT, 2)
wkv6_chunked_kernel(const T* __restrict__ r, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ w,
                    int64_t x_sb, int64_t x_sh, int64_t x_ss,
                    const TU* __restrict__ u, int64_t u_sh, const float* s0,
                    float* s_out, T* __restrict__ y, int64_t y_sb,
                    int64_t y_sh, int64_t y_ss, int H, int S, int D, int C) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t xo = b * x_sb + h * x_sh;
  r += xo; k += xo; v += xo; w += xo;
  y += b * y_sb + h * y_sh;
  const int64_t so = ((int64_t)b * H + h) * D * D;

  // this thread's share of the state: column j, rows g * SR .. + SR - 1;
  // and of y: column j, rows g * YR .. + YR - 1
  const int j = tid % MAXD, g = tid / MAXD;
  const bool jin = j < D;
  float sreg[SR];
#pragma unroll
  for (int e = 0; e < SR; ++e) {
    const int i = g * SR + e;
    sreg[e] = (s0 != nullptr && i < D && jin) ? s0[so + i * D + j] : 0.f;
    sm.s[i][j] = sreg[e];
  }
  if (tid < D) sm.u[tid] = dsa::to_f32(u[h * u_sh + tid]);

  float pf[4][NV][4];
  fetch(r, k, v, w, x_ss, 0, C, D, pf);
  const int n_chunks = S / C;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = ci * C;
    __syncthreads();                       // the last chunk is consumed
    stage(sm, C, D, pf);
    if (ci + 1 < n_chunks) fetch(r, k, v, w, x_ss, c0 + C, C, D, pf);
    __syncthreads();

    // cumulative log decay, one thread per column, in token order
    if (tid < D) {
      float l[MAXC];
#pragma unroll
      for (int t = 0; t < MAXC; ++t) l[t] = t < C ? sm.lw[t][tid] : 0.f;
      float c = 0.f;
#pragma unroll
      for (int t = 0; t < MAXC; ++t) {
        if (t < C) {
          c += l[t];
          sm.cum[t][tid] = c;
        }
      }
      sm.cl[tid] = c;
      sm.dec[tid] = expf(clip(c));
    }
    // the u bonus, one warp per row, on the raw r and k
    for (int t = warp; t < C; t += NT / 32) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32)
        a += __fmul_rn(__fmul_rn(sm.r[t][d], sm.u[d]), sm.k[t][d]);
      a = dsa::warp_sum(a);
      if (lane == 0) sm.diag[t] = a;
    }
    __syncthreads();

    // decayed operands: rr in place of r, kk transposed, k_hat in place of
    // k; column j, rows g + 4 q
    if (jin) {
      const float cl = sm.cl[j];
#pragma unroll
      for (int q = 0; q < MAXC / 4; ++q) {
        const int t = g + 4 * q;
        if (t < C) {
          const float cm = sm.cum[t][j];
          const float cc = clip(cm);
          const float kv = sm.k[t][j];
          sm.r[t][j] = __fmul_rn(sm.r[t][j], expf(cc - sm.lw[t][j]));
          sm.kkt[j][t] = __fmul_rn(kv, expf(-cc));
          sm.k[t][j] = __fmul_rn(kv, expf(clip(cl - cm)));
        }
      }
    }
    __syncthreads();

    // scores: lane s, rows warp + 8 m; strictly lower triangle kept
    {
      float acc[PR];
#pragma unroll
      for (int m = 0; m < PR; ++m) acc[m] = 0.f;
      if (lane < C) {
#pragma unroll
        for (int d = 0; d < MAXD; d += 4) {
          if (d >= D) break;
          const float k0 = sm.kkt[d][lane], k1 = sm.kkt[d + 1][lane];
          const float k2 = sm.kkt[d + 2][lane], k3 = sm.kkt[d + 3][lane];
#pragma unroll
          for (int m = 0; m < PR; ++m) {
            const int t = warp + 8 * m;
            if (t < C) {
              const float4 q4 = *reinterpret_cast<const float4*>(&sm.r[t][d]);
              acc[m] = fmaf(q4.x, k0, acc[m]);
              acc[m] = fmaf(q4.y, k1, acc[m]);
              acc[m] = fmaf(q4.z, k2, acc[m]);
              acc[m] = fmaf(q4.w, k3, acc[m]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < PR; ++m) {
          const int t = warp + 8 * m;
          if (t < C) sm.p[t][lane] = lane < t ? acc[m] : 0.f;
        }
      }
    }
    __syncthreads();

    // y = rr S + P v + diag v: column j, rows g * YR + m
    if (jin) {
      float ys[YR], yi[YR];
#pragma unroll
      for (int m = 0; m < YR; ++m) ys[m] = yi[m] = 0.f;
      const int t0 = g * YR;
      if (t0 < C) {
#pragma unroll
        for (int d = 0; d < MAXD; d += 4) {
          if (d >= D) break;
          const float s_0 = sm.s[d][j], s_1 = sm.s[d + 1][j];
          const float s_2 = sm.s[d + 2][j], s_3 = sm.s[d + 3][j];
#pragma unroll
          for (int m = 0; m < YR; ++m) {
            if (t0 + m < C) {
              const float4 q4 = *reinterpret_cast<const float4*>(&sm.r[t0 + m][d]);
              ys[m] = fmaf(q4.x, s_0, ys[m]);
              ys[m] = fmaf(q4.y, s_1, ys[m]);
              ys[m] = fmaf(q4.z, s_2, ys[m]);
              ys[m] = fmaf(q4.w, s_3, ys[m]);
            }
          }
        }
#pragma unroll
        for (int s = 0; s < MAXC; s += 4) {
          if (s >= C) break;
          const float v0 = sm.v[s][j], v1 = sm.v[s + 1][j];
          const float v2 = sm.v[s + 2][j], v3 = sm.v[s + 3][j];
#pragma unroll
          for (int m = 0; m < YR; ++m) {
            if (t0 + m < C) {
              const float4 p4 = *reinterpret_cast<const float4*>(&sm.p[t0 + m][s]);
              yi[m] = fmaf(p4.x, v0, yi[m]);
              yi[m] = fmaf(p4.y, v1, yi[m]);
              yi[m] = fmaf(p4.z, v2, yi[m]);
              yi[m] = fmaf(p4.w, v3, yi[m]);
            }
          }
        }
#pragma unroll
        for (int m = 0; m < YR; ++m) {
          const int t = t0 + m;
          if (t < C) {
            const float o = __fadd_rn(__fadd_rn(ys[m], yi[m]),
                                      __fmul_rn(sm.diag[t], sm.v[t][j]));
            dsa::store1(y + (int64_t)(c0 + t) * y_ss + j, o);
          }
        }
      }
    }
    __syncthreads();

    // S <- exp(clip(cum_last))^T * S + k_hat^T v: column j, rows g * SR + e
    if (jin) {
      float acc[SR];
#pragma unroll
      for (int e = 0; e < SR; ++e) acc[e] = 0.f;
      const int i0 = g * SR;
      if (i0 < D) {
#pragma unroll
        for (int t = 0; t < MAXC; ++t) {
          if (t >= C) break;
          const float vt = sm.v[t][j];
#pragma unroll
          for (int e4 = 0; e4 < SR; e4 += 4) {
            const float4 k4 = *reinterpret_cast<const float4*>(&sm.k[t][i0 + e4]);
            acc[e4] = fmaf(k4.x, vt, acc[e4]);
            acc[e4 + 1] = fmaf(k4.y, vt, acc[e4 + 1]);
            acc[e4 + 2] = fmaf(k4.z, vt, acc[e4 + 2]);
            acc[e4 + 3] = fmaf(k4.w, vt, acc[e4 + 3]);
          }
        }
#pragma unroll
        for (int e = 0; e < SR; ++e) {
          const int i = i0 + e;
          if (i < D) {
            sreg[e] = __fadd_rn(__fmul_rn(sm.dec[i], sreg[e]), acc[e]);
            sm.s[i][j] = sreg[e];
          }
        }
      }
    }
  }
  if (jin) {
#pragma unroll
    for (int e = 0; e < SR; ++e) {
      const int i = g * SR + e;
      if (i < D) s_out[so + i * D + j] = sreg[e];
    }
  }
}

template <typename T, typename TU>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, int64_t x_sb, int64_t x_sh, int64_t x_ss,
                   const void* u, int64_t u_sh, const float* s0,
                   float* s_out, void* y, int64_t y_sb, int64_t y_sh,
                   int64_t y_ss, int B, int H, int S, int D, int C,
                   cudaStream_t stream) {
  auto kern = wkv6_chunked_kernel<T, TU>;
  const int smem = (int)sizeof(Smem);
  const cudaError_t ea = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ea != cudaSuccess) return ea;
  kern<<<dim3(H, B), NT, smem, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(w), x_sb, x_sh, x_ss,
      static_cast<const TU*>(u), u_sh, s0, s_out, static_cast<T*>(y), y_sb,
      y_sh, y_ss, H, S, D, C);
  return cudaGetLastError();
}

}  // namespace

// C interface.  r/k/v/w: (B, H, S, hd) sharing (batch, head, row) strides
// in elements with a unit hd stride, f32 or bf16 (dtype); u: (H, hd) with
// head stride u_sh, f32 or bf16 (u_dtype); s0: (B, H, hd, hd) contiguous
// f32 or null (zeros); s_out: the same shape, may alias s0; y: (B, H, S,
// hd) in r's dtype with its own strides.  hd <= 64 and a multiple of 4,
// chunk a multiple of 8 up to 32 dividing S.  Returns the cudaError_t of
// the launch.
extern "C" int wkv6_chunked_launch(
    int dtype, int u_dtype, const void* r, const void* k, const void* v,
    const void* w, int64_t x_sb, int64_t x_sh, int64_t x_ss, const void* u,
    int64_t u_sh, const void* s0, void* s_out, void* y, int64_t y_sb,
    int64_t y_sh, int64_t y_ss, int B, int H, int S, int D, int C,
    void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > MAXD || D % 4 != 0 ||
      C <= 0 || C > MAXC || C % 8 != 0 || S % C != 0 || x_ss % 4 != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s0f = static_cast<const float*>(s0);
  auto* sof = static_cast<float*>(s_out);
#define WKV6_LAUNCH(T, TU)                                                   \
  launch<T, TU>(r, k, v, w, x_sb, x_sh, x_ss, u, u_sh, s0f, sof, y, y_sb,    \
                y_sh, y_ss, B, H, S, D, C, st)
  using bf = __nv_bfloat16;
  cudaError_t e;
  if (dtype == dsa::kF32 && u_dtype == dsa::kF32) e = WKV6_LAUNCH(float, float);
  else if (dtype == dsa::kF32 && u_dtype == dsa::kBF16) e = WKV6_LAUNCH(float, bf);
  else if (dtype == dsa::kBF16 && u_dtype == dsa::kBF16) e = WKV6_LAUNCH(bf, bf);
  else if (dtype == dsa::kBF16 && u_dtype == dsa::kF32) e = WKV6_LAUNCH(bf, float);
  else e = cudaErrorInvalidValue;
#undef WKV6_LAUNCH
  return (int)e;
}
