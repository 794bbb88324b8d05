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
// and K5q are the int8 and fp8 instances: each tile's narrow rows are
// widened once, in shared memory, to f32 by dsa::load4 (the row times its
// f32 (row, head) scale, rounded on its own), so the product loops read
// the same f32 values as on the f32 cache dequant(k, k_scale) and K3q
// equals K3 bitwise there.
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
// f32, bf16, int8 or fp8 e4m3, every pair; hd a multiple of 16 up to 128;
// G = Hq / Hkv up to 16; block_q a multiple of 8; cache rows 16-byte
// aligned.
//
// What bounds it on the H100: operations, at f32.  At yi_6b's chunk (B=4,
// C=512, Hq 32, Hkv 4, hd 128, block 128, nb=3 of a 4096-row bucket) the
// live causal pairs take 10.4 GFLOP against ~60 MB of q, out and selected
// f32 K/V rows: 0.155 ms at the 67 TFLOP/s f32 rate, ~18 us of bytes.
// The main path feeds bf16 q against the f32 cache and the Pallas body
// computes in f32; rounding the cache rows to bf16 to feed an MMA would
// change what is computed, so this body stays on the f32 FMA pipe.
//
// What held the first design back (0.847 ms at that shape, 5.5x the
// bound; 28.4 ms of a 191 ms chunk step; H100 80GB HBM3 at 700 W): four
// threads per (query row, head) pair, so every float read from shared
// memory fed one FMA and all four threads computed the same 16 exps a
// tile; K/V staged through registers in 16-row tiles between two
// barriers, so copies never overlapped compute; 32 bytes spilled at the
// 128-register cap of 512 threads.
//
// Design.  One CTA of 256 threads per (slice of RQ query rows of a query
// block, KV head, batch row) serves all G query heads of that KV head
// from one copy of each K/V tile: 128 (row, head) pairs (RQ = 128 / G
// rows).  q * scale sits in shared memory hd-major.  The selected rows
// stream in 64-key tiles, double-buffered with cp.async (16 bytes a
// thread, raw bytes; the next tile's copy is in flight while this one is
// computed).  A warp owns 16 pairs and all keys of a tile: S is an 8
// pairs x 4 keys register micro-tile per thread (12 floats read per 32
// FMAs), the row max is taken with shuffles among the 16 lanes that share
// a pair, each exp is computed once per (pair, key) and p goes once to
// the warp's shared memory; p.V is an 8 pairs x 8 hd columns micro-tile
// (16 floats per 64 FMAs), keys in ascending order.  The accumulator is
// 64 KB a CTA (64 registers a thread); with ~230 registers and 226 KB of
// shared memory a CTA has the SM to itself, 8 warps.  Tiles above the
// causal diagonal, past kv_len and of ok = 0 blocks are skipped whole,
// and a tile cut by the diagonal computes S for its first 16/32/48 keys
// only and p.V up to its last visible key.  The grid runs the last
// slices of the query blocks first: they carry the most tiles.  Each
// output is summed in one fixed order, so runs are deterministic.
// Not yet done (later PRs): tensor cores for the bf16-cache pair (no
// slice runs it), a split-precision (3xTF32) route for f32 operands.
#include "common.cuh"

namespace {

constexpr int PAIRS = 128;    // (query row, head) pairs per CTA
constexpr int THREADS = 256;  // 8 warps, 16 pairs each
constexpr int KT = 64;        // keys per K/V tile
constexpr int TM = 8;         // pairs per thread
constexpr int TN = 4;         // keys per thread in S: kg + 16 * jj
constexpr int HDMAX = 128;

// The element type the product loops read from shared memory: int8 and
// fp8 rows are widened to f32 once per tile; f32 and bf16 rows are read
// as copied.
template <typename TC> struct Stage { using type = TC; };
template <> struct Stage<int8_t> { using type = float; };
template <> struct Stage<__nv_fp8_e4m3> { using type = float; };

// Dynamic shared memory, in bytes from its start: q * scale as f32
// [hd][PAIRS] (hd-major, so a thread's 8 pairs at one d are two LDS.128);
// each warp's p [KT][16 pairs]; two tile buffers, each a K and a V tile of
// raw cache rows (K rows padded by 16 bytes so the rows kg + 16 jj that
// one load of a warp touches fall on distinct banks) and, narrow, the
// rows' K and V scales; narrow: one K and one V tile widened to f32.
struct Layout {
  int krs, vrs;    // bytes per copied K / V row
  int wkrs, wvrs;  // bytes per row the product loops read
  int p, buf0, bufsz, v, ks, vs, wk, wv, total;  // v, ks, vs: in a buffer
};

__host__ __device__ inline Layout layout(int hd, int esz, bool narrow) {
  Layout L;
  L.krs = hd * esz + 16;
  L.vrs = hd * esz;
  L.wkrs = narrow ? hd * 4 + 16 : L.krs;
  L.wvrs = narrow ? hd * 4 : L.vrs;
  L.p = hd * PAIRS * 4;
  L.buf0 = L.p + (THREADS / 32) * KT * 16 * 4;
  L.v = KT * L.krs;
  L.ks = L.v + KT * L.vrs;
  L.vs = L.ks + (narrow ? KT * 4 : 0);
  L.bufsz = L.vs + (narrow ? KT * 4 : 0);
  L.wk = L.buf0 + 2 * L.bufsz;
  L.wv = L.wk + (narrow ? KT * L.wkrs : 0);
  L.total = L.wv + (narrow ? KT * L.wvrs : 0);
  return L;
}

// S += (q * scale) K^T over ascending d for this thread's 8 pairs (qp:
// their first column of the hd-major q) and keys kg + 16 jj, jj < NJ (kd:
// key kg's row; the other rows 16 * krs bytes apart).  Keys at NJ and
// beyond are past every live key of the tile and stay 0.
template <int NJ, typename TS>
__device__ __forceinline__ void qk(const float* qp, const unsigned char* kd,
                                   int krs, int hd, float (&s)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) s[i][jj] = 0.f;
#pragma unroll 2
  for (int d = 0; d < hd; d += 4) {
    float kf[NJ][4];
#pragma unroll
    for (int jj = 0; jj < NJ; ++jj)
      dsa::load4(reinterpret_cast<const TS*>(kd + jj * 16 * krs) + d, kf[jj]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 qa = *reinterpret_cast<const float4*>(qp + (d + e) * PAIRS);
      const float4 qc = *reinterpret_cast<const float4*>(qp + (d + e) * PAIRS + 4);
      const float qv[TM] = {qa.x, qa.y, qa.z, qa.w, qc.x, qc.y, qc.z, qc.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj)
          s[i][jj] = fmaf(qv[i], kf[jj][e], s[i][jj]);
    }
  }
}

// acc += p V over keys 0..kmax-1 in ascending order for this thread's 8
// pairs (pp: their p at key 0, 16 floats a key) and NC groups of 4 hd
// columns, 64 apart (vd: key 0's first column; vrs bytes a key).
template <int NC, typename TS>
__device__ __forceinline__ void pv(const float* pp, const unsigned char* vd,
                                   int vrs, int kmax, float (&acc)[TM][8]) {
#pragma unroll 4
  for (int kk = 0; kk < kmax; ++kk) {
    const float4 pa = *reinterpret_cast<const float4*>(pp + kk * 16);
    const float4 pc = *reinterpret_cast<const float4*>(pp + kk * 16 + 4);
    const float p[TM] = {pa.x, pa.y, pa.z, pa.w, pc.x, pc.y, pc.z, pc.w};
    const TS* vr = reinterpret_cast<const TS*>(vd + kk * vrs);
    float vv[4 * NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) dsa::load4(vr + c * HDMAX / 2, vv + 4 * c);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
  }
}

template <typename TQ, typename TC, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
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
              int64_t o_sb, int64_t o_sh, int64_t o_sl, int B, int g, int rq,
              int S, int hd, int nb, int block_q, int block_k, float scale) {
  using dsa::NEG;
  using TS = typename Stage<TC>::type;
  constexpr int ESZ = sizeof(TC);
  constexpr bool NARROW = dsa::Narrow<TC>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(hd, ESZ, NARROW);
  float* qs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  const int pgi = lane / 16, kg = lane % 16;
  // the grid runs the last slices of the query blocks first: they reach
  // furthest along the causal diagonal and carry the most tiles
  const int slices = block_q / rq;
  const int qb = blockIdx.x, kvh = blockIdx.y;
  const int sl = slices - 1 - (int)blockIdx.z / B, b = blockIdx.z % B;
  const int row0 = qb * block_q + sl * rq;         // first chunk row
  const int q_lo = q_off[b] + row0;                // CTA-uniform range
  const int q_hi = q_lo + rq - 1;
  const int kvl = min(kv_len[b], S);
  const int nch = hd * ESZ / 16;                   // 16-byte chunks a row
  const int64_t i0 = b * i_sb + qb * i_sq;
  const int32_t* ib = idx + i0;
  const int32_t* okb = ok + i0;

  // The next tile, from (j, r0) on, that some pair of the CTA can see:
  // ok, below kv_len and not wholly above the causal diagonal.  A tile
  // that fails ends its block (every later tile of it fails too).
  auto find = [=](int& j, int& r0) -> bool {
    for (; j < nb; ++j, r0 = 0) {
      if (r0 >= block_k || okb[j] == 0) continue;
      const int k_lo = ib[j] * block_k + r0;
      if (kvl - k_lo > 0 && k_lo <= q_hi) return true;
    }
    return false;
  };
  // Start the copy of tile (j, r0)'s K and V rows (and, narrow, scales)
  // into buffer `buf`; rows past the tile's live keys are not read.
  auto issue = [=](int j, int r0, int buf) {
    const int kstart = ib[j] * block_k;
    const int nk = min(KT, min(block_k - r0, kvl - (kstart + r0)));
    const int64_t rows = dsa::block_rows<PAGED>(pidx, i0 + j, kstart,
                                                block_k, b * c_sb, c_ss)
                         + kvh * c_sh + (int64_t)r0 * c_ss;
    unsigned char* bp = smem + L.buf0 + buf * L.bufsz;
    dsa::copy_rows<THREADS>(bp, L.krs, k + rows, c_ss, nk, nch, tid);
    dsa::copy_rows<THREADS>(bp + L.v, L.vrs, v + rows, c_ss, nk, nch, tid);
    if constexpr (NARROW) {
      const int64_t srows = dsa::block_rows<PAGED>(pidx, i0 + j, kstart,
                                                   block_k, b * s_sb, s_ss)
                            + kvh + (int64_t)r0 * s_ss;
      if (tid < nk) {
        dsa::cp_async4(bp + L.ks + 4 * tid, k_scale + srows + tid * s_ss);
        dsa::cp_async4(bp + L.vs + 4 * tid, v_scale + srows + tid * s_ss);
      }
    }
  };

  int j = 0, r0 = 0;
  bool have = find(j, r0);
  if (have) issue(j, r0, 0);
  dsa::cp_async_commit();

  // q * scale, f32, hd-major; pair p = (head gi, row r) = (p / rq, p % rq),
  // pairs past rq * g are zero
  for (int i = tid; i < PAIRS * (hd / 4); i += THREADS) {
    const int p = i % PAIRS, d = (i / PAIRS) * 4;
    const int gi = p / rq, r = p % rq;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (gi < g) {
      dsa::load4(q + b * q_sb + (int64_t)(kvh * g + gi) * q_sh
                     + (int64_t)(row0 + r) * q_sl + d, x);
#pragma unroll
      for (int e = 0; e < 4; ++e) x[e] *= scale;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) qs[(d + e) * PAIRS + p] = x[e];
  }

  // This thread's pairs: 8 consecutive rows of one head (rq >= 8 is a
  // multiple of 8); its keys in S: kg + 16 jj; its hd columns in p.V:
  // kg * 4 + {0..3} and 64 + kg * 4 + {0..3}.
  const int pbase = w * 16 + pgi * 8;
  const bool pvalid = pbase / rq < g;
  const int qpos0 = pvalid ? q_lo + pbase % rq : -(1 << 30);  // nothing live
  const bool has0 = kg * 4 < hd, has1 = HDMAX / 2 + kg * 4 < hd;
  float acc[TM][8], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[i][c] = 0.f;
  }
  float* pw = reinterpret_cast<float*>(smem + L.p) + w * KT * 16;

  int buf = 0;
  while (have) {
    int jn = j, rn = r0 + KT;
    const bool next = find(jn, rn);
    if (next) issue(jn, rn, buf ^ 1);
    dsa::cp_async_commit();
    dsa::cp_async_wait<1>();                        // this tile landed
    __syncthreads();

    const int k_lo = ib[j] * block_k + r0;
    const int nk = min(KT, min(block_k - r0, kvl - k_lo));
    const int kmax = min(nk, q_hi - k_lo + 1);      // keys any pair sees
    const unsigned char* bp = smem + L.buf0 + buf * L.bufsz;
    if constexpr (NARROW) {
      // widen the tile's rows once: dequant(row, scale), as dsa::load4
      const float* ksc = reinterpret_cast<const float*>(bp + L.ks);
      const float* vsc = reinterpret_cast<const float*>(bp + L.vs);
      const int n4 = hd / 4;
      for (int i = tid; i < nk * n4; i += THREADS) {
        const int r = i / n4, d = (i - r * n4) * 4;
        float x[4], y[4];
        dsa::load4(reinterpret_cast<const TC*>(bp + r * L.krs) + d, ksc[r], x);
        dsa::load4(reinterpret_cast<const TC*>(bp + L.v + r * L.vrs) + d, vsc[r], y);
        *reinterpret_cast<float4*>(smem + L.wk + r * L.wkrs + 4 * d) = make_float4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<float4*>(smem + L.wv + r * L.wvrs + 4 * d) = make_float4(y[0], y[1], y[2], y[3]);
      }
      __syncthreads();
    }
    const unsigned char* kst = NARROW ? smem + L.wk : bp;
    const unsigned char* vst = NARROW ? smem + L.wv : bp + L.v;

    // S = (q * scale) K^T: an 8 x 4 micro-tile, fewer keys on a tile cut
    // by the causal diagonal
    float s[TM][TN];
    const float* qp = qs + pbase;
    const unsigned char* kd = kst + kg * L.wkrs;
    switch ((kmax + 15) / 16) {
      case 1: qk<1, TS>(qp, kd, L.wkrs, hd, s); break;
      case 2: qk<2, TS>(qp, kd, L.wkrs, hd, s); break;
      case 3: qk<3, TS>(qp, kd, L.wkrs, hd, s); break;
      default: qk<4, TS>(qp, kd, L.wkrs, hd, s); break;
    }

    // online softmax: the row max over the 16 lanes that share a pair,
    // each exp once per (pair, key), p = 0 under the mask
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float mt = NEG;
      unsigned live = 0u;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const int kk = kg + 16 * jj;
        const bool on = kk < kmax && k_lo + kk <= qpos0 + i;
        live |= (on ? 1u : 0u) << jj;
        s[i][jj] = on ? s[i][jj] : NEG;
        mt = fmaxf(mt, s[i][jj]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < TN; ++jj) {
        const float p = ((live >> jj) & 1u) ? expf(s[i][jj] - m_new) : 0.f;
        s[i][jj] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + psum;       // this lane's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < TN; ++jj) {
      float* pk = pw + (kg + 16 * jj) * 16 + pgi * 8;
      *reinterpret_cast<float4*>(pk) = make_float4(s[0][jj], s[1][jj], s[2][jj], s[3][jj]);
      *reinterpret_cast<float4*>(pk + 4) = make_float4(s[4][jj], s[5][jj], s[6][jj], s[7][jj]);
    }
    __syncwarp();

    // acc += P V: 8 pairs x 8 hd columns, ascending key
    const unsigned char* vd = vst + kg * 4 * sizeof(TS);
    if (has1)
      pv<2, TS>(pw + pgi * 8, vd, L.wvrs, kmax, acc);
    else if (has0)
      pv<1, TS>(pw + pgi * 8, vd, L.wvrs, kmax, acc);
    __syncthreads();                                // buffers consumed
    j = jn;
    r0 = rn;
    have = next;
    buf ^= 1;
  }
  dsa::cp_async_wait<0>();

  if (!pvalid) return;
  const int gi = pbase / rq;
  TQ* op = out + b * o_sb + (int64_t)(kvh * g + gi) * o_sh
           + (int64_t)(row0 + pbase % rq) * o_sl;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float li = l[i];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) li += __shfl_xor_sync(0xffffffffu, li, o);
    const float den = fmaxf(li, 1e-30f);
    float o4[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) o4[c] = acc[i][c] / den;
    if (has0) dsa::store4(op + i * o_sl + kg * 4, o4);
    if (has1) dsa::store4(op + i * o_sl + HDMAX / 2 + kg * 4, o4 + 4);
  }
}

// Query rows per CTA: the largest power of two with rq * g <= PAIRS and
// rq <= block_q that divides block_q (>= 8 for g <= 16 and block_q a
// multiple of 8).
int rows_per_cta(int g, int block_q) {
  int rq = 1;
  while (2 * rq * g <= PAIRS && 2 * rq <= block_q) rq *= 2;
  while (block_q % rq) rq /= 2;
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
  if (rq < 8) return cudaErrorInvalidValue;
  const Layout L = layout(hd, sizeof(TC), dsa::Narrow<TC>::value);
  auto kern = dsa_chunk_f32<TQ, TC, PAGED>;
  static int granted[32];
  const cudaError_t e = dsa::allow_smem(kern, L.total, granted);
  if (e != cudaSuccess) return e;
  const dim3 grid(C / block_q, hkv, (block_q / rq) * B);
  kern<<<grid, THREADS, L.total, stream>>>(
      static_cast<const TQ*>(q), q_sb, q_sh, q_sl, static_cast<const TC*>(k),
      static_cast<const TC*>(v), c_sb, c_ss, c_sh, k_scale, v_scale, s_sb,
      s_ss, idx, pidx, ok, i_sb, i_sq, q_off, kv_len,
      static_cast<TQ*>(out), o_sb, o_sh, o_sl, B, g, rq, S, hd, nb,
      block_q, block_k, scale);
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
  if (hkv <= 0 || hq % hkv != 0 || hq / hkv > 16 || hd <= 0 ||
      hd % 16 != 0 || hd > HDMAX || block_q <= 0 || block_q % 8 != 0 ||
      C <= 0 || C % block_q != 0 || block_k <= 0 || nb <= 0 || B <= 0 ||
      S <= 0 || narrow != (k_scale != nullptr && v_scale != nullptr))
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
