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
// in f32, the elementwise steps in the plain version's operations and
// order.  The clamp at -30 is part of what the kernel computes: where a
// chunk's decay product falls below e^-30 the chunked form differs from
// the token recurrence, as the Pallas kernel does.
//
// What bounds it on the H100.  At the rwkv6_3b slice (B 4, H 40, S 4096,
// hd 64, bf16 r/k/v/w/y) the four products per chunk need
// 4 C hd^2 + 2 hd C (C - 1) flops (the strict triangle only): 13.3 GFLOP
// for the whole call, 0.199 ms on the 67 TFLOP/s f32 FMA pipe, against
// 0.42 GB moved (0.125 ms at 3.35 TB/s).  With the products on the TF32
// tensor cores the least time is the byte bound.  In practice the chain
// of 128 dependent chunks per (b, h) bounds it: the first design (1.72 ms
// at that shape, H100 80GB HBM3 at 700 W) took ~10 us a chunk on one CTA
// per (b, h), 160 CTAs on 132 SMs, all four products on the FMA pipe.
//
// Design.  The chain is cut into G segments of consecutive chunks (G = 4
// at the slice's shape: about six CTAs per SM of work, three resident)
// and the state is carried across them by the associativity of
// S <- D * S + U:
//   1. wkv6_segment<FULL = false>: each segment but the last runs its
//      chunks from a zero state: its local end state S_loc and the product
//      Dprod of its chunks' row decays exp(clip(cum_last));
//   2. wkv6_carry: S_start(0) = s0, S_start(g + 1) = Dprod(g) *
//      S_start(g) + S_loc(g), elementwise over the hd x hd state;
//   3. wkv6_segment<FULL = true>: each segment runs its chunks again from
//      S_start(g), writing y; the last one writes s_last.
// One CTA of 256 threads runs one (segment, h, b): each thread stages one
// row and 8 columns of the chunk (log w, then rr, kk, k_hat after a
// column-wise cumsum in token order, one thread per column), and the next
// chunk's r/k/v/w are loaded into registers while this one is computed.
// The state stays in registers across the chunks, each warp an m16 row
// tile over half the column tiles (a copy in shared memory feeds rr S).
// The state update k_hat^T v runs on the tensor cores as 3xTF32 (mma.sync
// m16n8k8: each f32 operand split into a TF32 head and its rest, hi.hi +
// hi.lo + lo.hi accumulated in f32; the bf16 instance splits by masking,
// the f32 one rounds), which holds s_last to f32's tolerance.  The products that make y (scores, rr S, scores v) run as
// 3xTF32 in the bf16 instance (the main path), whose y is rounded to bf16;
// 3xTF32 does not hold y to f32's 1e-5 (about 2^-21 per product, summed
// in another order, and y sums terms much larger than itself), so the f32
// instance keeps those three on the FMA pipe, each output summed in index
// order.  The products sum in another order than the plain version and
// the segments re-associate the state, so K7 is not bitwise equal to its
// plain version: it holds f32's tolerance on s_last and the dtype's on y.
// Inputs are read by strides, so the model layout (B, S, H, hd) needs no
// transpose copy, and y is written in the caller's memory; s_out may
// alias s0.
// What bounds it now: per chunk a CTA runs five barrier-separated steps of
// small tiles (the y products of one chunk are 16 m16n8 tiles, 12 k-steps
// deep, split on the fly), so the SMs issue at a fraction of their rate;
// the elementwise steps (one log and three exps an element) are about
// half the instructions, and pass 1 repeats the state part of all but the
// last segment.
// Not yet done (later PRs): operands split once into TF32 heads and
// tails in shared memory, the chunks' state-independent part (scores,
// P v) computed for all chunks in parallel, and cp.async or TMA tiles.
#include "common.cuh"

namespace {

constexpr int NT = 256;          // threads per CTA
constexpr int EL = 8;            // elements of a row each thread stages
// CTAs an SM: three for bf16 tiles; an f32 tile's registers leave room
// for two
template <typename T> constexpr int min_blocks() { return sizeof(T) == 2 ? 3 : 2; }
constexpr int MAXC = 32;         // chunk rows
constexpr int MAXD = 64;         // head dim
constexpr int PV = MAXD + 8;     // pitch of v and of the state copy
constexpr int PC = MAXC + 4;     // pitch of the score tile
constexpr float CLAMP = -30.f;
constexpr float WMIN = 1e-38f;

// rr and kk are read as row-major A / B fragments (row t, column d) and
// k_hat as a transposed A fragment (row d, column t); each is stored
// [t][64] with its columns XOR-swizzled by the row, so that the fragment
// reads and the 16-byte writes of four columns are free of bank conflicts.
__device__ __forceinline__ int sw_rk(int t, int d) {
  return t * MAXD + (d ^ ((t & 7) << 2));
}
__device__ __forceinline__ int sw_kh(int t, int d) {
  return t * MAXD + (d ^ ((t & 3) << 3));
}

struct Smem {
  float rr[MAXC * MAXD];   // r * exp(cum_c - logw)
  float kk[MAXC * MAXD];   // k * exp(-cum_c)
  float kh[MAXC * MAXD];   // k * exp(clip(cum_last - cum))
  float lw[MAXC][MAXD];    // log(max(w, 1e-38)); then the score tile
  float cum[MAXC][MAXD];   // the cumulative log decay
  float v[MAXC][PV];
  float s[MAXD][PV];       // the state at the start of the chunk
  float dec[MAXD];         // exp(clip(cum_last))
  float cl[MAXD];          // cum_last
  float diag[MAXC];        // (r * u * k).sum(-1)
  float u[MAXD];
};

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, CLAMP), 0.f);
}

// -- 3xTF32 tensor-core products ----------------------------------------------

// x as a TF32 head and the rest.  RN: the head rounded to nearest and the
// rest rounded to TF32 (cvt.rna.tf32, about five instructions each), x to
// about 2^-22; otherwise the head is x with its 13 low mantissa bits
// cleared (exact, one instruction) and the tensor core reads the rest as
// TF32, truncated: x to about 2^-21.
template <bool RN>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (RN) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
    const float rest = x - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
  } else {
    hi = __float_as_uint(x) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (m16 x k8: rows g and g + 8, columns q and q + 4; g =
// lane / 4, q = lane % 4), split once for several products.
template <bool RN>
struct AFrag {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split<RN>(a0, hi[0], lo[0]);
    split<RN>(a1, hi[1], lo[1]);
    split<RN>(a2, hi[2], lo[2]);
    split<RN>(a3, hi[3], lo[3]);
  }
};

// c += a b for the B fragment (k8 x n8: rows q and q + 4, column g) b0, b1,
// as three TF32 products, the small ones first.
template <bool RN>
__device__ __forceinline__ void mma3(float (&c)[4], const AFrag<RN>& a,
                                     float b0, float b1) {
  uint32_t bh[2], bl[2];
  split<RN>(b0, bh[0], bl[0]);
  split<RN>(b1, bh[1], bl[1]);
  mma_tf32(c, a.lo, bh);
  mma_tf32(c, a.hi, bl);
  mma_tf32(c, a.hi, bh);
}

// This thread's share of a chunk, row t and EL columns of r, k, v and w,
// as loaded (16-byte loads; bf16 pairs or f32 words), zeros outside the
// chunk.
template <typename T>
struct Raw {
  static constexpr int W = EL * (int)sizeof(T) / 4;   // words per array
  uint32_t x[4][W];
  __device__ __forceinline__ void fetch(const T* r, const T* k, const T* v,
                                        const T* w, int64_t off, bool in) {
    const T* src[4] = {r, k, v, w};
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int i = 0; i < W; i += 4) {
        uint4 u4 = make_uint4(0u, 0u, 0u, 0u);
        if (in)
          u4 = *reinterpret_cast<const uint4*>(
              reinterpret_cast<const unsigned char*>(src[a] + off) + 4 * i);
        x[a][i] = u4.x;
        x[a][i + 1] = u4.y;
        x[a][i + 2] = u4.z;
        x[a][i + 3] = u4.w;
      }
    }
  }
  // element e of array a (0 r, 1 k, 2 v, 3 w) as f32
  __device__ __forceinline__ float get(int a, int e) const {
    if constexpr (sizeof(T) == 2) {
      const uint32_t wd = x[a][e >> 1];
      return __uint_as_float((e & 1) ? (wd & 0xffff0000u) : (wd << 16));
    } else {
      return __uint_as_float(x[a][e]);
    }
  }
};

// One segment of the chunks of one (b, h): from chunk seg * seg_chunks,
// from the state s_in (f32 (D, D) row-major per (b, h): in_g states per
// (b, h), this segment's the seg-th if in_g > 1; null: zeros).  FULL
// writes y; either way the state at the end goes to s_last (the last
// segment of a FULL pass) or to s_other, and a pass that is not FULL
// writes the product of its chunks' row decays to dprod.
template <typename T, typename TU, bool FULL>
__global__ void __launch_bounds__(NT, min_blocks<T>())
wkv6_segment(const T* __restrict__ r, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ w, int64_t x_sb,
             int64_t x_sh, int64_t x_ss, const TU* __restrict__ u,
             int64_t u_sh, const float* s_in, int in_g, float* s_last,
             float* s_other, float* __restrict__ dprod, T* __restrict__ y,
             int64_t y_sb, int64_t y_sh, int64_t y_ss, int H, int D, int C,
             int seg_chunks, int n_chunks_total, int G) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  // the f32 instance splits its operands rounded (its y must hold f32's
  // tolerance through rr S), the bf16 one by masking
  constexpr bool RN = sizeof(T) == 4;
  const int seg = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int c_first = seg * seg_chunks;
  const int n_chunks = min(seg_chunks, n_chunks_total - c_first);
  const int64_t xo = b * x_sb + h * x_sh;
  r += xo; k += xo; v += xo; w += xo;
  y += b * y_sb + h * y_sh;
  const int64_t bh = (int64_t)b * H + h, dd = (int64_t)D * D;
  const float* sin =
      s_in == nullptr ? nullptr : s_in + (bh * in_g + (in_g > 1 ? seg : 0)) * dd;
  float* send = (FULL && seg == G - 1) ? s_last + bh * dd
                                       : s_other + (bh * (G - 1) + seg) * dd;

  // the elementwise role: row t, EL columns from ce
  const int t = tid / (MAXD / EL), ce = (tid % (MAXD / EL)) * EL;
  const bool mine = t < C && ce < D;
  if (FULL && tid < D) sm.u[tid] = dsa::to_f32(u[h * u_sh + tid]);

  // the state: warp w holds m16 row tile w / 2 (rows 16 (w / 2) + g, + 8)
  // over the n8 column tiles n = w % 2 + 2 i (columns 8 n + 2 q, + 1)
  const int sm0 = 16 * (warp >> 1);
  const bool srows = sm0 < D;
  float sreg[MAXD / 16][4];
  float dp[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < MAXD / 16; ++i) {
    const int n = (warp & 1) + 2 * i;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = sm0 + g + 8 * (c >> 1), col = 8 * n + 2 * q + (c & 1);
      float x = 0.f;
      if (srows && col < D && sin != nullptr) x = sin[(int64_t)row * D + col];
      sreg[i][c] = x;
      if (FULL && srows && col < D) sm.s[row][col] = x;
    }
  }
  // rows past C stay zero in the operand tiles
  for (int i = tid; i < MAXC * MAXD; i += NT) {
    sm.rr[i] = 0.f;
    sm.kk[i] = 0.f;
    sm.kh[i] = 0.f;
  }
  for (int i = tid; i < MAXC * PV; i += NT) (&sm.v[0][0])[i] = 0.f;

  Raw<T> cur, nxt;
  cur.fetch(r, k, v, w, (int64_t)(c_first * C + t) * x_ss + ce, mine);
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int c0 = (c_first + ci) * C;
    __syncthreads();                       // the last chunk is consumed
    // stage: log w, v, and this thread's part of the u bonus of row t
    float dg = 0.f;
    if (mine) {
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        sm.lw[t][ce + e] = logf(fmaxf(cur.get(3, e), WMIN));
        sm.v[t][ce + e] = cur.get(2, e);
        if (FULL)
          dg += __fmul_rn(__fmul_rn(cur.get(0, e), sm.u[ce + e]), cur.get(1, e));
      }
    }
    if (FULL) {
#pragma unroll
      for (int o = 1; o < MAXD / EL; o <<= 1)
        dg += __shfl_xor_sync(0xffffffffu, dg, o);
      if (tid % (MAXD / EL) == 0) sm.diag[t] = dg;
    }
    if (ci + 1 < n_chunks)
      nxt.fetch(r, k, v, w, (int64_t)(c0 + C + t) * x_ss + ce, mine);
    __syncthreads();

    // the cumulative log decay, one thread per column, in token order
    if (tid < D) {
      float lv[MAXC];
#pragma unroll
      for (int tt = 0; tt < MAXC; ++tt) lv[tt] = sm.lw[tt][tid];
      float c = 0.f;
#pragma unroll
      for (int tt = 0; tt < MAXC; ++tt) {
        if (tt < C) {
          c += lv[tt];
          sm.cum[tt][tid] = c;
        }
      }
      sm.cl[tid] = c;
      sm.dec[tid] = expf(clip(c));
    }
    __syncthreads();

    // the decayed operands of row t
    if (mine) {
#pragma unroll
      for (int e4 = 0; e4 < EL; e4 += 4) {
        float a[4], bk[4], kh[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = ce + e4 + e;
          const float cm = sm.cum[t][d];
          const float cc = clip(cm);
          const float kv = cur.get(1, e4 + e);
          if (FULL) {
            a[e] = __fmul_rn(cur.get(0, e4 + e), expf(cc - sm.lw[t][d]));
            bk[e] = __fmul_rn(kv, expf(-cc));
          }
          kh[e] = __fmul_rn(kv, expf(clip(sm.cl[d] - cm)));
        }
        const int d = ce + e4;
        if (FULL) {
          *reinterpret_cast<float4*>(&sm.rr[sw_rk(t, d)]) =
              make_float4(a[0], a[1], a[2], a[3]);
          *reinterpret_cast<float4*>(&sm.kk[sw_rk(t, d)]) =
              make_float4(bk[0], bk[1], bk[2], bk[3]);
        }
        *reinterpret_cast<float4*>(&sm.kh[sw_kh(t, d)]) =
            make_float4(kh[0], kh[1], kh[2], kh[3]);
      }
    }
    __syncthreads();

    if (FULL) {
      // scores: the strictly lower triangle of rr kk^T (C x C), in log w's
      // place; one m16 x n8 tile a warp
      float (*sc)[PC] = reinterpret_cast<float (*)[PC]>(&sm.lw[0][0]);
      const int ntc = C / 8;
      for (int e = warp; e < ((C + 15) / 16) * ntc; e += NT / 32) {
        const int m0 = 16 * (e / ntc), n0 = 8 * (e % ntc);
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        if (n0 < m0 + 15) {
          if constexpr (sizeof(T) == 2) {
            for (int k0 = 0; k0 < D; k0 += 8) {
              AFrag<RN> fa;
              fa.set(sm.rr[sw_rk(m0 + g, k0 + q)], sm.rr[sw_rk(m0 + g + 8, k0 + q)],
                     sm.rr[sw_rk(m0 + g, k0 + q + 4)],
                     sm.rr[sw_rk(m0 + g + 8, k0 + q + 4)]);
              mma3(acc, fa, sm.kk[sw_rk(n0 + g, k0 + q)],
                   sm.kk[sw_rk(n0 + g, k0 + q + 4)]);
            }
          } else {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const int tt = m0 + g + 8 * (c >> 1), ss = n0 + 2 * q + (c & 1);
              for (int d = 0; d < D; ++d)
                acc[c] = fmaf(sm.rr[sw_rk(tt, d)], sm.kk[sw_rk(ss, d)], acc[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int tt = m0 + g + 8 * (c >> 1), ss = n0 + 2 * q + (c & 1);
          sc[tt][ss] = (ss < tt && tt < C) ? acc[c] : 0.f;
        }
      }
      __syncthreads();

      // y = rr S + scores v + diag v: warp w takes row tile w / 4 and the
      // n8 column tiles w % 4 + 4 i
      const int m0 = 16 * (warp >> 2);
      if (m0 < C) {
        if constexpr (sizeof(T) == 2) {
          float acc[MAXD / 32][4];
#pragma unroll
          for (int i = 0; i < MAXD / 32; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
          for (int k0 = 0; k0 < D; k0 += 8) {
            AFrag<RN> fa;
            fa.set(sm.rr[sw_rk(m0 + g, k0 + q)], sm.rr[sw_rk(m0 + g + 8, k0 + q)],
                   sm.rr[sw_rk(m0 + g, k0 + q + 4)],
                   sm.rr[sw_rk(m0 + g + 8, k0 + q + 4)]);
#pragma unroll
            for (int i = 0; i < MAXD / 32; ++i) {
              const int n0 = 8 * ((warp & 3) + 4 * i);
              if (n0 < D)
                mma3(acc[i], fa, sm.s[k0 + q][n0 + g], sm.s[k0 + q + 4][n0 + g]);
            }
          }
          for (int k0 = 0; k0 < C && k0 < m0 + 16; k0 += 8) {
            AFrag<RN> fa;
            fa.set(sc[m0 + g][k0 + q], sc[m0 + g + 8][k0 + q],
                   sc[m0 + g][k0 + q + 4], sc[m0 + g + 8][k0 + q + 4]);
#pragma unroll
            for (int i = 0; i < MAXD / 32; ++i) {
              const int n0 = 8 * ((warp & 3) + 4 * i);
              if (n0 < D)
                mma3(acc[i], fa, sm.v[k0 + q][n0 + g], sm.v[k0 + q + 4][n0 + g]);
            }
          }
#pragma unroll
          for (int i = 0; i < MAXD / 32; ++i) {
            const int j = 8 * ((warp & 3) + 4 * i) + 2 * q;
            if (j < D) {
#pragma unroll
              for (int hh = 0; hh < 2; ++hh) {
                const int tt = m0 + g + 8 * hh;
                if (tt < C) {
                  const float dgt = sm.diag[tt];
                  dsa::store2(y + (int64_t)(c0 + tt) * y_ss + j,
                              __fadd_rn(acc[i][2 * hh], __fmul_rn(dgt, sm.v[tt][j])),
                              __fadd_rn(acc[i][2 * hh + 1],
                                        __fmul_rn(dgt, sm.v[tt][j + 1])));
                }
              }
            }
          }
        } else {
          // f32: each output summed on the FMA pipe in index order, as
          // rr @ S and scores @ v are
#pragma unroll
          for (int i = 0; i < MAXD / 32; ++i) {
            const int j0 = 8 * ((warp & 3) + 4 * i) + 2 * q;
            if (j0 < D) {
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const int tt = m0 + g + 8 * (c >> 1), j = j0 + (c & 1);
                if (tt < C) {
                  float ys = 0.f, yi = 0.f;
                  for (int d = 0; d < D; ++d)
                    ys = fmaf(sm.rr[sw_rk(tt, d)], sm.s[d][j], ys);
                  for (int s2 = 0; s2 < C; ++s2)
                    yi = fmaf(sc[tt][s2], sm.v[s2][j], yi);
                  dsa::store1(y + (int64_t)(c0 + tt) * y_ss + j,
                              __fadd_rn(__fadd_rn(ys, yi),
                                        __fmul_rn(sm.diag[tt], sm.v[tt][j])));
                }
              }
            }
          }
        }
      }
    }

    // S <- exp(clip(cum_last))^T * S + k_hat^T v on this warp's tiles: the
    // decayed state is the products' accumulator
    if (srows) {
      const float d0 = sm.dec[sm0 + g], d1 = sm.dec[sm0 + g + 8];
      dp[0] *= d0;
      dp[1] *= d1;
#pragma unroll
      for (int i = 0; i < MAXD / 16; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sreg[i][c] = __fmul_rn(c < 2 ? d0 : d1, sreg[i][c]);
      for (int k0 = 0; k0 < C; k0 += 8) {
        AFrag<RN> fa;
        fa.set(sm.kh[sw_kh(k0 + q, sm0 + g)], sm.kh[sw_kh(k0 + q, sm0 + g + 8)],
               sm.kh[sw_kh(k0 + q + 4, sm0 + g)],
               sm.kh[sw_kh(k0 + q + 4, sm0 + g + 8)]);
#pragma unroll
        for (int i = 0; i < MAXD / 16; ++i) {
          const int n0 = 8 * ((warp & 1) + 2 * i);
          if (n0 < D)
            mma3(sreg[i], fa, sm.v[k0 + q][n0 + g], sm.v[k0 + q + 4][n0 + g]);
        }
      }
    }
    if (FULL) {
      __syncthreads();                     // every read of the state copy
      if (srows) {
#pragma unroll
        for (int i = 0; i < MAXD / 16; ++i) {
          const int n0 = 8 * ((warp & 1) + 2 * i);
          if (n0 < D) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              sm.s[sm0 + g + 8 * (c >> 1)][n0 + 2 * q + (c & 1)] = sreg[i][c];
          }
        }
      }
    }
    cur = nxt;
  }

  if (srows) {
#pragma unroll
    for (int i = 0; i < MAXD / 16; ++i) {
      const int n0 = 8 * ((warp & 1) + 2 * i);
      if (n0 < D) {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          send[(int64_t)(sm0 + g + 8 * (c >> 1)) * D + n0 + 2 * q + (c & 1)] =
              sreg[i][c];
      }
    }
    if (!FULL && q == 0 && (warp & 1) == 0) {
      float* dpo = dprod + (bh * (G - 1) + seg) * D + sm0 + g;
      dpo[0] = dp[0];
      dpo[8] = dp[1];
    }
  }
}

// S_start(0) = s0, S_start(g + 1) = Dprod(g) * S_start(g) + S_loc(g), one
// thread per state element of one (b, h).
__global__ void wkv6_carry(const float* s0, const float* __restrict__ s_loc,
                           const float* __restrict__ dprod,
                           float* __restrict__ s_start, int64_t n, int D,
                           int G) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int64_t dd = (int64_t)D * D, bh = i / dd, e = i % dd;
  const int row = (int)(e / D);
  float s = s0 == nullptr ? 0.f : s0[i];
  for (int gg = 0; gg < G; ++gg) {
    s_start[(bh * G + gg) * dd + e] = s;
    if (gg + 1 < G)
      s = __fadd_rn(__fmul_rn(dprod[(bh * (G - 1) + gg) * D + row], s),
                    s_loc[(bh * (G - 1) + gg) * dd + e]);
  }
}

template <typename T, typename TU>
cudaError_t launch(const void* r, const void* k, const void* v,
                   const void* w, int64_t x_sb, int64_t x_sh, int64_t x_ss,
                   const void* u, int64_t u_sh, const float* s0,
                   float* s_out, void* y, int64_t y_sb, int64_t y_sh,
                   int64_t y_ss, int B, int H, int S, int D, int C, int G,
                   float* scratch, cudaStream_t stream) {
  static int granted[2][32];
  auto k_state = wkv6_segment<T, TU, false>;
  auto k_full = wkv6_segment<T, TU, true>;
  const int smem = (int)sizeof(Smem);
  cudaError_t e = dsa::allow_smem(k_state, smem, granted[0]);
  if (e == cudaSuccess) e = dsa::allow_smem(k_full, smem, granted[1]);
  if (e != cudaSuccess) return e;
  const auto* rt = static_cast<const T*>(r);
  const auto* kt = static_cast<const T*>(k);
  const auto* vt = static_cast<const T*>(v);
  const auto* wt = static_cast<const T*>(w);
  const auto* ut = static_cast<const TU*>(u);
  auto* yt = static_cast<T*>(y);
  const int n_chunks = S / C;
  const int seg_chunks = (n_chunks + G - 1) / G;
  G = (n_chunks + seg_chunks - 1) / seg_chunks;     // no empty segment
  if (G == 1) {
    k_full<<<dim3(1, H, B), NT, smem, stream>>>(
        rt, kt, vt, wt, x_sb, x_sh, x_ss, ut, u_sh, s0, 1, s_out, nullptr,
        nullptr, yt, y_sb, y_sh, y_ss, H, D, C, seg_chunks, n_chunks, 1);
    return cudaGetLastError();
  }
  // scratch: S_loc (B, H, G - 1, D, D), then S_start (B, H, G, D, D), then
  // Dprod (B, H, G - 1, D)
  const int64_t dd = (int64_t)D * D, bh = (int64_t)B * H;
  float* s_loc = scratch;
  float* s_start = s_loc + bh * (G - 1) * dd;
  float* dprod = s_start + bh * G * dd;
  k_state<<<dim3(G - 1, H, B), NT, smem, stream>>>(
      rt, kt, vt, wt, x_sb, x_sh, x_ss, ut, u_sh, nullptr, 1, nullptr, s_loc,
      dprod, yt, y_sb, y_sh, y_ss, H, D, C, seg_chunks, n_chunks, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int64_t n = bh * dd;
  wkv6_carry<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      s0, s_loc, dprod, s_start, n, D, G);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the segments but the last leave their end states in S_loc, which the
  // carry has read
  k_full<<<dim3(G, H, B), NT, smem, stream>>>(
      rt, kt, vt, wt, x_sb, x_sh, x_ss, ut, u_sh, s_start, G, s_out, s_loc,
      nullptr, yt, y_sb, y_sh, y_ss, H, D, C, seg_chunks, n_chunks, G);
  return cudaGetLastError();
}

}  // namespace

// Floats of scratch the C interface needs for G segments.
extern "C" int64_t wkv6_scratch_floats(int B, int H, int D, int G) {
  if (G <= 1) return 0;
  const int64_t bh = (int64_t)B * H;
  return bh * (2 * G - 1) * D * D + bh * (G - 1) * D;
}

// C interface.  r/k/v/w: (B, H, S, hd) sharing (batch, head, row) strides
// in elements with a unit hd stride, f32 or bf16 (dtype); u: (H, hd) with
// head stride u_sh, f32 or bf16 (u_dtype); s0: (B, H, hd, hd) contiguous
// f32 or null (zeros); s_out: the same shape, may alias s0; y: (B, H, S,
// hd) in r's dtype with its own strides.  hd a multiple of 16 up to 64,
// chunk a multiple of 8 up to 32 dividing S.  G: segments of the chunk
// chain; scratch: wkv6_scratch_floats(B, H, hd, G) f32 (unused if G = 1).
// Returns the cudaError_t of the launches.
extern "C" int wkv6_chunked_launch(
    int dtype, int u_dtype, const void* r, const void* k, const void* v,
    const void* w, int64_t x_sb, int64_t x_sh, int64_t x_ss, const void* u,
    int64_t u_sh, const void* s0, void* s_out, void* y, int64_t y_sb,
    int64_t y_sh, int64_t y_ss, int B, int H, int S, int D, int C, int G,
    void* scratch, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || D > MAXD || D % 16 != 0 ||
      C <= 0 || C > MAXC || C % 8 != 0 || S % C != 0 || G <= 0 ||
      (G > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  // rows of r/k/v/w are loaded 16 bytes at a time
  const int64_t al = dtype == dsa::kBF16 ? 8 : 4;
  if (x_ss % al != 0 || x_sh % al != 0 || x_sb % al != 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* s0f = static_cast<const float*>(s0);
  auto* sof = static_cast<float*>(s_out);
  auto* scr = static_cast<float*>(scratch);
#define WKV6_LAUNCH(T, TU)                                                   \
  launch<T, TU>(r, k, v, w, x_sb, x_sh, x_ss, u, u_sh, s0f, sof, y, y_sb,    \
                y_sh, y_ss, B, H, S, D, C, G, scr, st)
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
