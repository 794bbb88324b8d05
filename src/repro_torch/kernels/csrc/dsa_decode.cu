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
// narrow row is multiplied by its f32 (row, head) scale as it is read from
// shared memory (dsa::load4), the scale found through the same row
// function as the row, and everything after is unchanged, so K1q equals
// K1 bitwise on the f32 cache dequant(k, k_scale), and K4q equals K1q on a
// paged copy.
//
// What bounds it on the H100: bytes.  A step reads nb*block_k rows of K
// and V per (row, KV head): 12.6 MB at B=4, nb=6, f32 cache (6.3 MB bf16)
// against ~2 MFLOP per layer, far below the ~295 FLOP/byte ridge, so the
// bound is 3.3 us and the kernel must keep many bytes in flight across
// the whole card.
//
// What held the first design back (H100 80GB HBM3 at 700 W, K1's shape:
// 62 us a call, of which the partial kernel 30.9 us and the merge kernel
// 21.2 us; K4 at the continuous slice's shape 33.3 + 29.4 us): the merge
// ran on B * Hkv = 16 CTAs whose threads walked every partial twice with
// dependent loads; the partial kernel's lanes each read their own 512-byte
// K row 16 floats at a time and kept 8 V rows ahead, about one CTA of 4
// warps an SM, so few bytes were in flight.
//
// Design.  One CTA of 4 warps per 64-row tile of the selection of one
// (b, KV head): B*Hkv*nb*ceil(block_k/64) CTAs (192 at K1's shape, 288 at
// K4's), three resident an SM.  A CTA copies its K rows, then its V rows,
// straight into shared memory with cp.async (16 bytes a thread,
// neighbouring threads on neighbouring bytes of a row), so all of a
// tile's bytes are in flight at once and V's copy lands under the scores.
// The whole GQA group is served from one copy of each row: a thread per
// (row, half of the group) for the scores, a warp per head for the
// tile's softmax state, a thread per (4 hd columns, quarter of the group)
// for p.V.  Each CTA writes its partial (acc, m, l) to the workspace and
// takes a ticket; the last CTA of a (b, KV head) merges the partials in
// ascending tile order (m and l read once into shared memory, exp(m -
// max) once per (tile, head), a thread per 4 hd columns of a quarter of
// the group) and resets the ticket for the next call, so no second kernel
// runs.  ok is read as bytes, as the selection produces it.
#include "common.cuh"

namespace {

constexpr int TR = 64;        // cache rows per CTA (one tile)
constexpr int THREADS = 128;  // 4 warps

// Int32 tickets at the head of the workspace, one per (b, KV head),
// rounded up to a whole 256 bytes; the f32 partials follow.
inline int64_t ticket_ints(int B, int hkv) {
  return ((int64_t)B * hkv + 63) / 64 * 64;
}

// Dynamic shared memory of the kernel, in bytes from its start: the
// tile's raw K rows (padded by 16 bytes, so the 32 rows one score load of
// a warp touches spread over the banks) and V rows, narrow: their scales;
// q * scale as f32 [G][hd]; the scores, then p, [G][TR]; for the merge,
// the partials' m (then exp(m - max)) and l [n_tiles][G] and the
// denominators [G].
struct Layout {
  int krs, vrs, v, ks, vs, q, s, mg, total;
};

__host__ __device__ inline Layout layout(int hd, int esz, bool narrow, int G,
                                         int n_tiles) {
  Layout L;
  L.krs = hd * esz + 16;
  L.vrs = hd * esz;
  L.v = TR * L.krs;
  L.ks = L.v + TR * L.vrs;
  L.vs = L.ks + (narrow ? TR * 4 : 0);
  L.q = L.vs + (narrow ? TR * 4 : 0);
  L.s = L.q + G * hd * 4;
  L.mg = L.s + G * TR * 4;
  L.total = L.mg + (2 * n_tiles * G + G) * 4;
  return L;
}

// The minimum of one CTA an SM lifts ptxas's register cap: without it
// some instances are held to 64 registers and spill.
template <typename TQ, typename TC, int G, bool PAGED>
__global__ void __launch_bounds__(THREADS, 1)
dsa_decode_partial(const TQ* __restrict__ q, int64_t q_sb, int64_t q_sh,
                   const TC* __restrict__ k, const TC* __restrict__ v,
                   int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   const float* __restrict__ k_scale,
                   const float* __restrict__ v_scale, int64_t s_sb,
                   int64_t s_ss, const int32_t* __restrict__ idx,
                   const int32_t* __restrict__ pidx,
                   const uint8_t* __restrict__ ok, int64_t i_sb,
                   const int32_t* __restrict__ kv_len, int* tickets,
                   float* ws_acc, float* ws_m, float* ws_l,
                   TQ* __restrict__ out, int64_t o_sb, int64_t o_sh, int hkv,
                   int S, int hd, int block_k, int tiles_per_blk,
                   int n_tiles, float scale) {
  using dsa::NEG;
  constexpr int ESZ = sizeof(TC);
  constexpr bool NARROW = dsa::Narrow<TC>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const Layout L = layout(hd, ESZ, NARROW, G, n_tiles);
  float* qs = reinterpret_cast<float*>(smem + L.q);
  float* ss = reinterpret_cast<float*>(smem + L.s);
  const float* ksc = reinterpret_cast<const float*>(smem + L.ks);
  const float* vsc = reinterpret_cast<const float*>(smem + L.vs);

  const int t = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int j = t / tiles_per_blk;
  const int r0 = (t % tiles_per_blk) * TR;
  const int64_t ij = b * i_sb + j;
  const int blk0 = idx[ij] * block_k;
  // rows at or past lim are masked (kv_len, the cache end, the block end)
  const int lim = min(min(kv_len[b], S), blk0 + block_k);
  const int nrows = ok[ij] != 0 ? min(TR, lim - (blk0 + r0)) : 0;
  const int64_t p0 = (int64_t)(b * hkv + kvh) * n_tiles * G;  // (b, kvh)
  const int64_t part = p0 + (int64_t)t * G;                   // this tile

  if (nrows <= 0) {                          // an empty partial state
    for (int i = tid; i < G * hd; i += THREADS) ws_acc[part * hd + i] = 0.f;
    if (tid < G) {
      ws_m[part + tid] = NEG;
      ws_l[part + tid] = 0.f;
    }
  } else {
    // K's rows, then V's, as two copy groups straight into shared memory:
    // 16 bytes a thread, neighbouring threads on neighbouring bytes of a row
    const int64_t rows = dsa::block_rows<PAGED>(pidx, ij, blk0, block_k,
                                                b * c_sb, c_ss)
                         + kvh * c_sh + (int64_t)r0 * c_ss;
    const int nch = hd * ESZ / 16;
    int64_t srows = 0;
    if constexpr (NARROW)
      srows = dsa::block_rows<PAGED>(pidx, ij, blk0, block_k, b * s_sb, s_ss)
              + kvh + (int64_t)r0 * s_ss;
    dsa::copy_rows<THREADS>(smem, L.krs, k + rows, c_ss, nrows, nch, tid);
    if (NARROW && tid < nrows)
      dsa::cp_async4(smem + L.ks + 4 * tid, k_scale + srows + tid * s_ss);
    dsa::cp_async_commit();
    dsa::copy_rows<THREADS>(smem + L.v, L.vrs, v + rows, c_ss, nrows, nch,
                            tid);
    if (NARROW && tid < nrows)
      dsa::cp_async4(smem + L.vs + 4 * tid, v_scale + srows + tid * s_ss);
    dsa::cp_async_commit();

    for (int i = tid; i < G * hd; i += THREADS) {
      const int g = i / hd, d = i % hd;
      qs[i] = dsa::to_f32(q[b * q_sb + (int64_t)(kvh * G + g) * q_sh + d]) * scale;
    }
    dsa::cp_async_wait<1>();                 // K landed; V still in flight
    __syncthreads();

    // scores: thread (row r, half hh of the group) over ascending d
    {
      constexpr int HPT = (G + 1) / 2;
      const int r = tid % TR, h0 = (tid / TR) * HPT;
      if (r < nrows && h0 < G) {
        const TC* kr = reinterpret_cast<const TC*>(smem + r * L.krs);
        const float ks1 = NARROW ? ksc[r] : 1.f;
        float s[HPT];
#pragma unroll
        for (int u = 0; u < HPT; ++u) s[u] = 0.f;
#pragma unroll 4
        for (int d = 0; d < hd; d += 4) {
          float kk[4];
          dsa::load4(kr + d, ks1, kk);
#pragma unroll
          for (int u = 0; u < HPT; ++u) {
            if (h0 + u < G) {
              const float4 q4 = *reinterpret_cast<const float4*>(qs + (h0 + u) * hd + d);
              s[u] = fmaf(q4.x, kk[0], s[u]);
              s[u] = fmaf(q4.y, kk[1], s[u]);
              s[u] = fmaf(q4.z, kk[2], s[u]);
              s[u] = fmaf(q4.w, kk[3], s[u]);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < HPT; ++u)
          if (h0 + u < G) ss[(h0 + u) * TR + r] = s[u];
      }
    }
    __syncthreads();

    // the tile's softmax state per head: a warp per head, two rows a lane
    for (int g = warp; g < G; g += THREADS / 32) {
      const bool la = lane < nrows, lc = lane + 32 < nrows;
      const float a = la ? ss[g * TR + lane] : NEG;
      const float c = lc ? ss[g * TR + lane + 32] : NEG;
      const float m = dsa::warp_max(fmaxf(a, c));
      const float pa = la ? expf(a - m) : 0.f;
      const float pc = lc ? expf(c - m) : 0.f;
      const float l = dsa::warp_sum(pa + pc);
      ss[g * TR + lane] = pa;
      ss[g * TR + lane + 32] = pc;
      if (lane == 0) {
        ws_m[part + g] = m;
        ws_l[part + g] = l;
      }
    }
    dsa::cp_async_wait<0>();                 // V landed
    __syncthreads();

    // acc = p V: thread (4 hd columns, a quarter of the group), ascending row
    constexpr int HPW = (G + 3) / 4;
    const int d0 = (tid % 32) * 4, h0 = (tid / 32) * HPW;
    if (d0 < hd && h0 < G) {
      float acc[HPW][4];
#pragma unroll
      for (int u = 0; u < HPW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
      const unsigned char* vb = smem + L.v + d0 * ESZ;
#pragma unroll 4
      for (int r = 0; r < nrows; ++r) {
        float vv[4];
        dsa::load4(reinterpret_cast<const TC*>(vb + r * L.vrs),
                   NARROW ? vsc[r] : 1.f, vv);
#pragma unroll
        for (int u = 0; u < HPW; ++u) {
          if (h0 + u < G) {
            const float p = ss[(h0 + u) * TR + r];
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[u][e] = fmaf(p, vv[e], acc[u][e]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HPW; ++u)
        if (h0 + u < G)
          *reinterpret_cast<float4*>(ws_acc + (part + h0 + u) * hd + d0) =
              make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
    }
  }

  // Publish this tile's partial; the last tile of (b, KV head) to finish
  // merges all of them and resets the ticket for the next call.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + b * hkv + kvh, 1) == n_tiles - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // merge in ascending tile order: m and l once into shared memory, the
  // factors exp(m - max) once per (tile, head), then a thread per hd column
  float* mm = reinterpret_cast<float*>(smem + L.mg);
  float* ll = mm + n_tiles * G;
  float* den = ll + n_tiles * G;
  for (int i = tid; i < n_tiles * G; i += THREADS) {
    mm[i] = __ldcg(ws_m + p0 + i);
    ll[i] = __ldcg(ws_l + p0 + i);
  }
  __syncthreads();
  for (int g = tid; g < G; g += THREADS) {
    float mx = NEG;
    for (int u = 0; u < n_tiles; ++u) mx = fmaxf(mx, mm[u * G + g]);
    float lsum = 0.f;
    for (int u = 0; u < n_tiles; ++u) {
      const float f = expf(mm[u * G + g] - mx);
      mm[u * G + g] = f;
      lsum = fmaf(ll[u * G + g], f, lsum);
    }
    den[g] = fmaxf(lsum, 1e-30f);
  }
  __syncthreads();
  {
    constexpr int HPW = (G + 3) / 4;
    const int d0 = (tid % 32) * 4, h0 = (tid / 32) * HPW;
    if (d0 < hd && h0 < G) {
      float a[HPW][4];
#pragma unroll
      for (int u = 0; u < HPW; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) a[u][e] = 0.f;
      const float* ap = ws_acc + p0 * hd + d0;
#pragma unroll 4
      for (int t2 = 0; t2 < n_tiles; ++t2) {
#pragma unroll
        for (int u = 0; u < HPW; ++u) {
          if (h0 + u < G) {
            const int pg = t2 * G + h0 + u;
            const float4 x = __ldcg(reinterpret_cast<const float4*>(ap + (int64_t)pg * hd));
            const float f = mm[pg];
            a[u][0] = fmaf(x.x, f, a[u][0]);
            a[u][1] = fmaf(x.y, f, a[u][1]);
            a[u][2] = fmaf(x.z, f, a[u][2]);
            a[u][3] = fmaf(x.w, f, a[u][3]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < HPW; ++u) {
        if (h0 + u < G) {
          float o4[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) o4[e] = a[u][e] / den[h0 + u];
          dsa::store4(out + b * o_sb + (int64_t)(kvh * G + h0 + u) * o_sh + d0, o4);
        }
      }
    }
  }
  if (tid == 0) tickets[b * hkv + kvh] = 0;
}

template <typename TQ, typename TC, int G, bool PAGED>
cudaError_t launch(const void* q, int64_t q_sb, int64_t q_sh, const void* k,
                   const void* v, int64_t c_sb, int64_t c_ss, int64_t c_sh,
                   const float* k_scale, const float* v_scale, int64_t s_sb,
                   int64_t s_ss, const int32_t* idx, const int32_t* pidx,
                   const uint8_t* ok, int64_t i_sb,
                   const int32_t* kv_len, float* ws, void* out, int64_t o_sb,
                   int64_t o_sh, int B, int hkv, int S, int hd, int nb,
                   int block_k, float scale, cudaStream_t stream) {
  const int tiles_per_blk = (block_k + TR - 1) / TR;
  const int n_tiles = nb * tiles_per_blk;
  const int64_t parts = (int64_t)B * hkv * n_tiles * G;
  int* tickets = reinterpret_cast<int*>(ws);
  float* ws_acc = ws + ticket_ints(B, hkv);
  float* ws_m = ws_acc + parts * hd;
  float* ws_l = ws_m + parts;
  const Layout L = layout(hd, sizeof(TC), dsa::Narrow<TC>::value, G,
                          n_tiles);
  auto kern = dsa_decode_partial<TQ, TC, G, PAGED>;
  static int granted[32];
  const cudaError_t e = dsa::allow_smem(kern, L.total, granted);
  if (e != cudaSuccess) return e;
  kern<<<dim3(n_tiles, hkv, B), THREADS, L.total, stream>>>(
      static_cast<const TQ*>(q), q_sb, q_sh, static_cast<const TC*>(k),
      static_cast<const TC*>(v), c_sb, c_ss, c_sh, k_scale, v_scale, s_sb,
      s_ss, idx, pidx, ok, i_sb, kv_len, tickets, ws_acc, ws_m, ws_l,
      static_cast<TQ*>(out), o_sb, o_sh, hkv, S, hd, block_k, tiles_per_blk,
      n_tiles, scale);
  return cudaGetLastError();
}

template <typename TQ, typename TC, bool PAGED>
cudaError_t dispatch_g(int g, const void* q, int64_t q_sb, int64_t q_sh,
                       const void* k, const void* v, int64_t c_sb,
                       int64_t c_ss, int64_t c_sh, const float* k_scale,
                       const float* v_scale, int64_t s_sb, int64_t s_ss,
                       const int32_t* idx,
                       const int32_t* pidx, const uint8_t* ok, int64_t i_sb,
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
  const auto* okp = static_cast<const uint8_t*>(ok);
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
// stride; idx: (B, nb) int32 and ok: (B, nb) bool (one byte each), both
// with row stride i_sb; kv_len: (B,) int32; ws: workspace of
// round_up(B * Hkv, 64) int32 tickets, ZERO before the call (the launch
// leaves them zero again), then B * Hq * nb * ceil(block_k / 64) *
// (hd + 2) f32 (one partial (acc, m, l) per 64-row tile and query head);
// out: (B, Hq, 1, hd) in q's dtype.  Strides in elements.  Return the
// cudaError_t of the launch.
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
