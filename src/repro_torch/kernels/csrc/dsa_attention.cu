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
// What held the first design back (2.33 ms at that shape, 26x the bound,
// H100 80GB HBM3 at 700 W): warp-level 16x16x16 MMAs that reloaded every
// B fragment from shared memory, S and each P.V partial round-tripped
// through a per-warp f32 scratch, and K/V copied by synchronous loads
// between two barriers, so no copy overlapped any math; ~174 KB of
// shared memory left one CTA of 8 warps an SM.
//
// Design of the bf16 body (the main path).  One CTA per (query block,
// q head, batch row), heaviest query blocks first and the G heads of a KV
// head next to each other (they read the same K/V tiles from L2): two
// consumer warpgroups of 64 query rows and one producer warpgroup, which
// hands most of its registers to the consumers (setmaxnreg 40 / 232).  One
// producer thread reads idx/valid itself (the block's "scalar prefetch")
// and keeps the selected K and V tiles (128 keys x hd, bf16, 128-byte
// swizzle) coming through TMA into a two-stage ring with mbarriers; the
// tensor maps are the strided model-layout views, so q/k/v need no copy.
// Each consumer runs S = Q K^T as wgmma from shared memory into a 64 x 128
// f32 register fragment, masks it and runs the online softmax there (the
// scores never touch shared memory), and passes P to the second wgmma as
// its register A operand.  The Pallas body multiplies p in f32; a bf16
// operand would round p to 8 bits, so p is split into p_hi = bf16(p) and
// p_lo = bf16(p - p_hi), two register operands accumulating into the same
// O fragment, which carries p to about 2^-17 of its value.  That makes
// P.V cost twice its flops, so this design's own floor is ~1.5x the
// bound (the bound still counts 4 flops per (pair, hd), what the inputs
// need).  Whole tiles above the causal diagonal, behind the window and of
// valid = 0 blocks are skipped; a warpgroup whose rows see no key of a
// tile skips its products, and one whose rows see only the first 64 keys
// (the lower half of the diagonal tile) runs 64-key products.  O / l goes
// as bf16 into the group's own q rows in shared memory and out by TMA
// stores.  Query blocks under 64 rows run the same body with the rows
// past block_q not stored; hd up to 64 runs a 64-column instance, up to
// 128 a 128-column one (columns past hd load as zeros and are not
// stored).  bf16 x bf16 products are exact in f32, so scaling the f32
// scores after QK^T equals the Pallas body's f32 scaling of q to f32
// rounding; the softmax runs in base 2 with the scale folded into
// log2(e), p = 2^(s c - m) by one FMA and one MUFU op.
//
// The f32 body (the reduced parity runs and the f32 checks): the f32 FMA
// pipe, four threads per query row each holding a quarter of hd for q
// and the accumulator, scores summed with two shuffles, 16-row K/V
// sub-tiles (16 KB, inside the static limit).
// Not yet done (later PRs): a persistent grid that overlaps one query
// block's q load and output store with the last one's products, overlap
// of the softmax with the products inside a warpgroup (the split P
// leaves no registers for a second S tile), and a native hd-80 instance
// (hd 80 runs the 128-column one).
#include "common.cuh"
#include "hopper.cuh"

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

// -- bf16: warpgroup MMAs fed by TMA -----------------------------------------

constexpr int TKT = 128;              // keys per K/V tile
constexpr int WG_ROWS = 64;           // query rows per consumer warpgroup
constexpr int CONSUMERS = 2;          // consumer warpgroups: 128 query rows
constexpr int TC_THREADS = 128 * (CONSUMERS + 1);  // + the producer group
constexpr int STAGES = 2;             // depth of the K/V ring
constexpr int PRODUCER_REGS = 40;     // registers a producer thread keeps
constexpr int CONSUMER_REGS = 232;    // and a consumer thread takes
constexpr int CB = TKT * 128;         // bytes of one 64-column block of a tile
constexpr float LOG2E = 1.4426950408889634f;

// Dynamic shared memory, in bytes from a 1024-byte boundary: the q tile
// (NCB column blocks of 128 rows; warpgroup w's rows at + w * 8192), the K
// and V rings (STAGES tiles of NCB blocks each), then the mbarriers.
template <int HDP>
struct TcSmem {
  static constexpr int NCB = HDP / 64;
  static constexpr int Q = 0;
  static constexpr int K = NCB * CB;
  static constexpr int V = K + STAGES * NCB * CB;
  static constexpr int BAR = V + STAGES * NCB * CB;
  static constexpr int BYTES = BAR + 8 * (2 + 3 * STAGES) + 1024;
};

// The CTA's K/V tiles in the order both roles walk them: the selected
// blocks in order, each cut into TKT-row tiles; tiles of valid = 0 blocks,
// past Lk, above the causal diagonal or behind the window of every row of
// the query block are skipped whole.
struct Tiles {
  const int32_t* ib;
  const int32_t* okb;
  int nb, block_k, Lk, causal, window, q_lo, q_hi;
  int j, r0;
  __device__ bool next(int& k_lo, int& nk) {
    while (j < nb) {
      if (r0 >= block_k || __ldg(okb + j) == 0) {
        ++j;
        r0 = 0;
        continue;
      }
      const int lo = __ldg(ib + j) * block_k + r0;
      const int n = min(TKT, min(block_k - r0, Lk - lo));
      r0 += TKT;
      if (n <= 0 || (causal && lo > q_hi)) {
        r0 = block_k;
        continue;
      }
      if (window && lo + n - 1 <= q_lo - window) continue;
      k_lo = lo;
      nk = n;
      return true;
    }
    return false;
  }
};

__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the MUFU (about 2^-22 relative error; underflows to 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as the bf16 pairs hi = bf16(a, b) and lo = bf16(a - hi, b - hi).
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = bf16x2(a - hf.x, b - hf.y);
}

// S = Q K^T for this warpgroup's 64 query rows and the tile's first N
// keys, issued (not waited for).  s[4j + e]: row half e / 2, key
// 8j + 2 (lane % 4) + e % 2 (the wgmma accumulator layout).
template <int HDP, int N>
__device__ __forceinline__ void issue_s(float (&s)[N / 2],
                                        const unsigned char* qs,
                                        const unsigned char* ks) {
  using namespace hopper;
#pragma unroll
  for (int kc = 0; kc < HDP / 16; ++kc) {
    const int off = (kc >> 2) * CB + (kc & 3) * 32;
    const uint64_t da = sw128_desc(qs + off, 0);
    const uint64_t db = sw128_desc(ks + off, 0);
    if constexpr (N == 128)
      wgmma_ss128(s, da, db, kc);
    else
      wgmma_ss64(s, da, db, kc);
  }
}

// O += (P_hi + P_lo) V over the tile's first N keys, issued.
template <int HDP, int N>
__device__ __forceinline__ void issue_pv(float (&o)[HDP / 2],
                                         uint32_t (&phi)[N / 16][4],
                                         uint32_t (&plo)[N / 16][4],
                                         const unsigned char* vs) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint64_t db = sw128_desc(vs + kk * 16 * 128, CB);
    if constexpr (HDP == 128) {
      wgmma_rs128(o, phi[kk], db, 1);
      wgmma_rs128(o, plo[kk], db, 1);
    } else {
      wgmma_rs64(o, phi[kk], db, 1);
      wgmma_rs64(o, plo[kk], db, 1);
    }
  }
}

// The online softmax on S (the tile's first N keys) in registers: the
// masked scores (where `masked`: keys outside [klo, khi) of each row
// half) are set to NEG, m (base 2), l and O are rescaled, and P goes to
// the bf16 pairs phi and plo in the A-operand layout of the P.V wgmma.
template <int HDP, int N>
__device__ __forceinline__ void softmax(float (&s)[N / 2],
                                        float (&o)[HDP / 2], float (&m)[2],
                                        float (&l)[2],
                                        uint32_t (&phi)[N / 16][4],
                                        uint32_t (&plo)[N / 16][4],
                                        bool masked, const int (&klo)[2],
                                        const int (&khi)[2], float sl2) {
  using dsa::NEG;
  const int cq = 2 * (threadIdx.x & 3);
  // row maxima of the raw scores (the scale is positive); then
  // p = 2^(s sl2 - m) by one FMA and one MUFU op
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int kk = 8 * j + cq + (e & 1);
        if (kk < klo[e >> 1] || kk >= khi[e >> 1]) s[4 * j + e] = NEG;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float alpha[2], nm[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
    mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    const float mn = fmaxf(m[hh], mx[hh] * sl2);
    alpha[hh] = ex2(m[hh] - mn);
    m[hh] = mn;
    nm[hh] = -mn;
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = s[4 * j + e];
      const float p =
          (!masked || x > 0.5f * NEG) ? ex2(fmaf(x, sl2, nm[e >> 1])) : 0.f;
      ps[e >> 1] += p;
      s[4 * j + e] = p;
    }
  }
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split_pair(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1], phi[kk][i],
                 plo[kk][i]);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + ps[hh];
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// One K/V tile for this warpgroup's 64 query rows (this thread's rows
// qpos0 and qpos0 + 8): S on the tile's first N keys, the softmax, then
// P.V once V has landed.
template <int HDP, int N>
__device__ __forceinline__ void tile_step(float (&o)[HDP / 2], float (&m)[2],
                                          float (&l)[2],
                                          const unsigned char* qs,
                                          const unsigned char* ks,
                                          const unsigned char* vs,
                                          uint64_t* vbar, int vpar, int k_lo,
                                          int nk, bool masked, int qpos0,
                                          int causal, int window, float sl2) {
  using namespace hopper;
  float s[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) s[i] = 0.f;
  fence_regs(s);
  wgmma_fence();
  issue_s<HDP, N>(s, qs, ks);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(s);

  int klo[2], khi[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qpos = qpos0 + 8 * hh;
    khi[hh] = causal ? min(nk, qpos - k_lo + 1) : nk;
    klo[hh] = window ? qpos - window + 1 - k_lo : 0;
  }
  uint32_t phi[N / 16][4], plo[N / 16][4];
  softmax<HDP, N>(s, o, m, l, phi, plo, masked, klo, khi, sl2);

  mbar_wait(vbar, vpar);
  fence_regs(o);
  fence_regs(phi);
  fence_regs(plo);
  wgmma_fence();
  issue_pv<HDP, N>(o, phi, plo, vs);
  wgmma_commit();
  wgmma_wait0();
  fence_regs(o);
  fence_regs(phi);
  fence_regs(plo);
}

template <int HDP>
__global__ void __launch_bounds__(TC_THREADS, 1)
dsa_attention_tc(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 const int32_t* __restrict__ idx,
                 const int32_t* __restrict__ valid, int64_t i_sb,
                 int64_t i_sq, int B, int hq, int g, int n_qb, int Lk, int nb,
                 int block_q, int block_k, int causal, int window, float sl2) {
  using namespace hopper;
  using dsa::NEG;
  using SM = TcSmem<HDP>;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  unsigned char* sm = tc_smem + ((1024 - (smem_u32(tc_smem) & 1023)) & 1023);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + SM::BAR);  // [2]
  uint64_t* kfull = qfull + 2;                                  // [STAGES]
  uint64_t* vfull = kfull + STAGES;
  uint64_t* empty = vfull + STAGES;

  int t = blockIdx.x;
  const int h = t % hq;
  t /= hq;
  const int b = t % B;
  const int qb = n_qb - 1 - t / B;     // heaviest query blocks first
  const int kvh = h / g;
  const int q_lo = qb * block_q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    mbar_init(qfull + 1, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, 4 * CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  Tiles it{idx + b * i_sb + qb * i_sq, valid + b * i_sb + qb * i_sq, nb,
           block_k, Lk, causal, window, q_lo, q_lo + block_q - 1, 0, 0};
  int k_lo, nk;

  if (warp >= 4 * CONSUMERS) {             // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 128 * CONSUMERS) {
      for (int w = 0; w < CONSUMERS && w * WG_ROWS < block_q; ++w) {
        mbar_expect_tx(qfull + w, SM::NCB * WG_ROWS * 128);
        for (int c = 0; c < SM::NCB; ++c)
          tma_load4(sm + SM::Q + c * CB + w * WG_ROWS * 128, &tq, qfull + w,
                    64 * c, q_lo + w * WG_ROWS, h, b);
      }
      for (int n = 0; it.next(k_lo, nk); ++n) {
        const int s = n % STAGES, r = n / STAGES;
        if (r > 0) mbar_wait(empty + s, (r - 1) & 1);
        mbar_expect_tx(kfull + s, SM::NCB * CB);
        for (int c = 0; c < SM::NCB; ++c)
          tma_load4(sm + SM::K + (s * SM::NCB + c) * CB, &tk, kfull + s,
                    64 * c, k_lo, kvh, b);
        mbar_expect_tx(vfull + s, SM::NCB * CB);
        for (int c = 0; c < SM::NCB; ++c)
          tma_load4(sm + SM::V + (s * SM::NCB + c) * CB, &tv, vfull + s,
                    64 * c, k_lo, kvh, b);
      }
    }
    return;
  }

  // a consumer warpgroup: rows wrow0 .. wrow0 + 63 of the query block
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  const int wrow0 = wg * WG_ROWS;
  const bool has_rows = wrow0 < block_q;
  const int wq_lo = q_lo + wrow0;
  const int wq_hi = q_lo + min(block_q, wrow0 + WG_ROWS) - 1;
  const int rr = (warp & 3) * 16 + (lane >> 2);
  const unsigned char* qs = sm + SM::Q + wrow0 * 128;
  float o[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) o[i] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  if (has_rows) mbar_wait(qfull + wg, 0);

  for (int n = 0; it.next(k_lo, nk); ++n) {
    const int st = n % STAGES, par = (n / STAGES) & 1;
    mbar_wait(kfull + st, par);
    // keys of this tile the group's rows can see: none (skip), the first
    // 64 (64-key products) or more
    const int nvis = causal ? min(nk, wq_hi - k_lo + 1) : nk;
    if (has_rows && nvis > 0 &&
        !(window && k_lo + nk - 1 <= wq_lo - window)) {
      const unsigned char* ks = sm + SM::K + st * SM::NCB * CB;
      const unsigned char* vs = sm + SM::V + st * SM::NCB * CB;
      const int kn = nvis <= 64 ? 64 : TKT;
      const bool masked = nk < kn || (causal && k_lo + kn - 1 > wq_lo) ||
                          (window && k_lo <= wq_hi - window);
      if (kn == 64)
        tile_step<HDP, 64>(o, m, l, qs, ks, vs, vfull + st, par, k_lo, nk,
                           masked, wq_lo + rr, causal, window, sl2);
      else
        tile_step<HDP, TKT>(o, m, l, qs, ks, vs, vfull + st, par, k_lo, nk,
                            masked, wq_lo + rr, causal, window, sl2);
    }
    mbar_wait(vfull + st, par);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + st);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
  }
  // O / l as bf16 into this group's q rows (its last wgmma has read them),
  // in the tiles' swizzled layout, then TMA stores of the rows < block_q
  if (has_rows) {
    const int cq = 2 * (lane & 3);
    unsigned char* os = sm + SM::Q + wrow0 * 128;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float inv = 1.f / fmaxf(l[hh], 1e-30f);
      const int row = rr + 8 * hh;
#pragma unroll
      for (int j = 0; j < HDP / 8; ++j)
        *reinterpret_cast<uint32_t*>(os + (j >> 3) * CB + row * 128 +
                                     (((j & 7) ^ (row & 7)) << 4) + 2 * cq) =
            bf16x2(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
    }
    tma_store_fence();
    named_sync(1 + wg, 128);
    if ((threadIdx.x & 127) == 0) {
      for (int r0 = 0; r0 < WG_ROWS && wrow0 + r0 < block_q; r0 += 16)
        for (int c = 0; c < SM::NCB; ++c)
          tma_store4(&to, os + c * CB + r0 * 128, 64 * c, q_lo + wrow0 + r0,
                     h, b);
      tma_store_wait();
    }
  }
}

template <int HDP>
cudaError_t launch_tc(const void* q, int64_t q_sb, int64_t q_sh, int64_t q_sl,
                      const void* k, int64_t k_sb, int64_t k_sh, int64_t k_sl,
                      const void* v, int64_t v_sb, int64_t v_sh, int64_t v_sl,
                      const int32_t* idx, const int32_t* valid, int64_t i_sb,
                      int64_t i_sq, void* out, int64_t o_sb, int64_t o_sh,
                      int64_t o_sl, int B, int hq, int hkv, int Lq, int Lk,
                      int hd, int nb, int block_q, int block_k, int causal,
                      int window, float scale, cudaStream_t stream) {
  static int granted[32];
  auto kern = dsa_attention_tc<HDP>;
  const int smem = TcSmem<HDP>::BYTES;
  const cudaError_t e = dsa::allow_smem(kern, smem, granted);
  if (e != cudaSuccess) return e;
  CUtensorMap mq, mk, mv, mo;
  if (!hopper::bf16_rows_map(&mq, q, B, hq, Lq, hd, q_sb, q_sh, q_sl,
                             WG_ROWS) ||
      !hopper::bf16_rows_map(&mk, k, B, hkv, Lk, hd, k_sb, k_sh, k_sl, TKT) ||
      !hopper::bf16_rows_map(&mv, v, B, hkv, Lk, hd, v_sb, v_sh, v_sl, TKT) ||
      !hopper::bf16_rows_map(&mo, out, B, hq, Lq, hd, o_sb, o_sh, o_sl, 16))
    return cudaErrorInvalidValue;
  const int n_qb = Lq / block_q;
  kern<<<n_qb * B * hq, TC_THREADS, smem, stream>>>(
      mq, mk, mv, mo, idx, valid, i_sb, i_sq, B, hq, hq / hkv, n_qb, Lk, nb,
      block_q, block_k, causal, window, scale * LOG2E);
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
    // (the TMA boxes' strides)
    if (block_q % 16 != 0 || block_k % 16 != 0 || q_sb % 8 || q_sh % 8 ||
        q_sl % 8 || k_sb % 8 || k_sh % 8 || k_sl % 8 || v_sb % 8 ||
        v_sh % 8 || v_sl % 8)
      return (int)cudaErrorInvalidValue;
    auto launch = hd <= 64 ? launch_tc<64> : launch_tc<128>;
    e = launch(q, q_sb, q_sh, q_sl, k, k_sb, k_sh, k_sl, v, v_sb, v_sh, v_sl,
               ix, ok, i_sb, i_sq, out, o_sb, o_sh, o_sl, B, hq, hkv, Lq, Lk,
               hd, nb, block_q, block_k, causal, window, scale, st);
  } else {
    e = cudaErrorInvalidValue;
  }
  return (int)e;
}
