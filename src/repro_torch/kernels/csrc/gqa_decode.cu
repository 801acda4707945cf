// GQA flash-decode for Hopper (sm_90a): one query token per sequence
// against a KV cache. q (B, Hq, Dh); k, v (B, S, Hkv, Dh); cache_len (B,)
// int32; out (B, Hq, Dh) in q's dtype. The g = Hq / Hkv query heads of a kv
// head share its K/V rows. f32 or bf16 in, f32 inside.
//
// Replaces src/repro/kernels/gqa_decode.py:_decode_kernel, the Pallas TPU
// kernel entered through gqa_decode_pallas (and kernels/ops.py
// decode_attention). It computes the same function: scores q.k * scale with
// scale the f32 rounding of 1/sqrt(Dh) (passed in from the host), online
// softmax, slots >= cache_len[b] left out, the sum clamped at 1e-30, f32
// accumulation, output rounded once to q's dtype. Like the Pallas kernel it
// keeps the probabilities in f32 for the PV product (the bf16 path as two
// bf16 parts, below), where the model path models/flash.py:decode_attention
// rounds them to the cache's dtype first.
//
// What it does not carry over: the Pallas grid (B, Hkv, S/TS) walks the S
// tiles in order and carries (m, l, acc) in VMEM from one to the next. Hopper
// blocks run in no order, and (B, Hkv) alone is 16 blocks at the main shape
// (B = 8, Hkv = 2) on a card with 132 SMs. So S is split across blocks
// (flash-decoding): pass 1 gives each block one (S-chunk, kv head, b); its 4
// warps each walk a quarter of the chunk, keeping their own running
// (m, l, acc), merge them through shared memory at the end and write one
// partial (m, l, acc) per query head to scratch. Pass 2 (gqa_combine) merges
// the partials of each (b, query head) and writes the output. The wrapper
// picks the chunk (about 1,024 blocks) and allocates the scratch; the
// kernels allocate nothing. Each K/V byte is read once and serves all g
// query heads of its kv head (group reuse).
//
// Pass 1 has two forms, chosen by dtype:
//  * bf16 (gqa_split_bf16, the model's path): tensor cores. A warp stages
//    16-slot K and V tiles in shared memory with cp.async, one tile ahead of
//    its compute. S = Q K^T is mma.sync m16n8k16 with the g heads padded to
//    the 16 rows of Q (exact bf16 products, f32 accumulation); the online
//    softmax runs in f32 on the score fragments; O += P V is mma.sync again,
//    with V read through ldmatrix.trans and P kept in f32 as the sum of two
//    bf16 parts, hi + lo (|p - hi - lo| <= 2^-16 p, where the model's jnp
//    path rounds p itself to bf16).
//  * f32 (gqa_split_f32): CUDA cores, since bf16 tensor cores would round
//    the inputs. Lane L owns dims [L*DPL, L*DPL + DPL) of Dh = 32*DPL, holds
//    those q dims of all g heads in registers, and reads its DPL elements of
//    each K and V row; the g partial dot products of a slot are summed by a
//    shuffle reduce-scatter that leaves each head's score on 32/g lanes,
//    which share the tile's probabilities through shared memory for PV.
//
// Slots past cache_len: blocks whose chunk starts at or after cache_len[b]
// return at once, warps stop at cache_len[b], and no K/V row at or past it is
// ever read (the bf16 path fills those tile rows with zeros), so garbage
// there, even NaN, cannot reach the result. For cache_len >= 1 that is the
// reference's function: a masked slot's weight exp(-1e30 - m) is exactly 0
// in f32. At cache_len <= 0 no slot counts and the output is 0 (acc = 0 over
// l clamped at 1e-30); the JAX reference then averages V over S and the
// Pallas kernel over the padded S. The model never passes 0
// (cache_len = min(pos + 1, Smax)).
//
// What bounds it on an H100: bytes. It must read q, then K and V up to
// cache_len, and write the output: at the main shape with a full cache
// (8 x 32768 slots x 2 kv heads x 128 dims x 2 bytes x K,V) 268 MB, 80 us at
// 3.35 TB/s. Its 4 * B * Hq * cache_len * Dh flops (4.3 GFLOP there) take
// 4.3 us on bf16 tensor cores but 64 us on f32 CUDA cores (g = 16 FMAs per
// K element and 16 per V element), which is why the bf16 path moved to
// tensor cores: what is left is the byte stream, kept dense by cp.async
// prefetch and about eight blocks per SM. The partials add 8.4 MB at the
// main shape. wgmma and TMA are later work.
//
// No fast math: expf, IEEE division, f32 accumulation; bf16 is widened
// exactly and the output rounded once with __float2bfloat16 (nearest).
//
// Plain C interface (gqa_decode_launch), loaded with ctypes by
// repro_torch/kernels/gqa_decode.py; it launches both passes on the given
// stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kWarps = 4;            // warps per block of pass 1
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 8;             // slots per step, f32 path
constexpr int kTileTc = 16;          // slots per step, bf16 path (mma k)
constexpr int kGroupTc = 16;         // query heads per block, bf16 (mma m)
constexpr float kNegInf = -1e30f;    // the reference's mask value
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// End of pass 1, shared by both paths: merge the kWarps running states
// (m_s, l_s: [kWarps][G]; acc_s: [kWarps][G][DH]) of the block and write
// one partial per query head. Warps with no slot carry (-1e30, 0, 0),
// which weighs exp(-1e30 - M) = 0.
template <int G, int DH>
__device__ __forceinline__ void merge_block(const float* m_s,
                                            const float* l_s,
                                            const float* acc_s, int g,
                                            size_t part, float* part_m,
                                            float* part_l, float* part_acc) {
  for (int o = threadIdx.x; o < g * DH; o += kThreads) {
    const int i = o / DH, dd = o % DH;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, m_s[w * G + i]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = expf(m_s[w * G + i] - M);
      L += l_s[w * G + i] * wt;
      A += acc_s[(w * G + i) * DH + dd] * wt;
    }
    part_acc[(part * g + i) * DH + dd] = A;
    if (dd == 0) {
      part_m[part * g + i] = M;
      part_l[part * g + i] = L;
    }
  }
}

// ------------------------------------------------------- f32: CUDA cores

template <int DPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&o)[DPL]) {
  if constexpr (DPL == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  } else {
    static_assert(DPL == 2, "Dh is 64 or 128");
    const float2 r = *reinterpret_cast<const float2*>(p);
    o[0] = r.x; o[1] = r.y;
  }
}

__host__ __device__ constexpr int log2i(int g) {
  return g <= 1 ? 0 : 1 + log2i(g / 2);
}

// Level LV of the reduce-scatter of G per-lane values across the warp: the
// lanes with bit (16 >> LV) set keep the upper half of the remaining values,
// the others the lower half, each adding its partner's copy; after log2 G
// levels d[0] holds one head's sum over 32 / G lanes. Written as a template
// so that every index is a constant and d stays in registers.
template <int G, int LV>
__device__ __forceinline__ void halve(float (&d)[G], int lane) {
  constexpr int half = G >> (LV + 1);
  if constexpr (half >= 1) {
    constexpr int mask = 16 >> LV;
    const bool up = lane & mask;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = up ? d[i] : d[i + half];
      const float keep = up ? d[i + half] : d[i];
      d[i] = keep + __shfl_xor_sync(kFull, send, mask);
    }
    halve<G, LV + 1>(d, lane);
  }
}

// Pass 1, f32: one block per (S-chunk c, kv head h, sequence b). Lane L
// owns dims [L*DPL, L*DPL + DPL) of every q, K and V row.
// part_m/part_l: (B, Hkv, n_chunks, g); part_acc: (B, Hkv, n_chunks, g, Dh).
template <int G, int DPL>
__global__ void __launch_bounds__(kThreads)
gqa_split_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ cache_len,
              float* __restrict__ part_m, float* __restrict__ part_l,
              float* __restrict__ part_acc, int S, int Hkv, int g,
              int chunk, int n_chunks, float scale) {
  constexpr int DH = 32 * DPL;
  constexpr int kLevels = log2i(G);    // halvings of the reduce-scatter
  constexpr int kRep = 32 / G;         // lanes holding each head's score
  __shared__ float p_s[kWarps][kTile][G];
  __shared__ float corr_s[kWarps][G];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][DH];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(cache_len[b], 0), S);
  const int lo = c * chunk;
  if (lo >= len) return;               // whole block: nothing to attend to
  const int hi = min(lo + chunk, len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = chunk / kWarps;
  const int wlo = lo + warp * per_warp;
  const int whi = min(wlo + per_warp, hi);

  // the head whose score this lane holds after the reduce-scatter
  int head = 0;
#pragma unroll
  for (int lv = 0; lv < kLevels; ++lv)
    head += ((lane >> (4 - lv)) & 1) * (G >> (lv + 1));
  const bool owner = (lane & (kRep - 1)) == 0;

  const int Hq = Hkv * g;
  float qr[G][DPL];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    if (i < g) {
      load_row<DPL>(q + (static_cast<size_t>(b) * Hq + h * g + i) * DH
                    + lane * DPL, qr[i]);
    } else {
#pragma unroll
      for (int e = 0; e < DPL; ++e) qr[i][e] = 0.f;
    }
  }

  float acc[G][DPL];
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[i][e] = 0.f;
  float m_run = kNegInf, l_run = 0.f;

  const size_t row_stride = static_cast<size_t>(Hkv) * DH;
  const size_t base = (static_cast<size_t>(b) * S * Hkv + h) * DH + lane * DPL;
  const float* kb = k + base;
  const float* vb = v + base;

  for (int t0 = wlo; t0 < whi; t0 += kTile) {
    float kr[kTile][DPL], vr[kTile][DPL];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (t0 + j < whi) {
        load_row<DPL>(kb + static_cast<size_t>(t0 + j) * row_stride, kr[j]);
        load_row<DPL>(vb + static_cast<size_t>(t0 + j) * row_stride, vr[j]);
      } else {
#pragma unroll
        for (int e = 0; e < DPL; ++e) kr[j][e] = vr[j][e] = 0.f;
      }
    }

    float s[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      float d[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float x = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e) x = fmaf(qr[i][e], kr[j][e], x);
        d[i] = x;
      }
      halve<G, 0>(d, lane);
      float x = d[0];
#pragma unroll
      for (int mask = 16 >> kLevels; mask >= 1; mask >>= 1)
        x += __shfl_xor_sync(kFull, x, mask);
      s[j] = (t0 + j < whi) ? x * scale : kNegInf;
    }

    // online softmax of this lane's head over the tile
    float mt = s[0];
#pragma unroll
    for (int j = 1; j < kTile; ++j) mt = fmaxf(mt, s[j]);
    const float m_new = fmaxf(m_run, mt);
    const float corr = expf(m_run - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      s[j] = expf(s[j] - m_new);
      psum += s[j];
    }
    l_run = l_run * corr + psum;
    m_run = m_new;
    if (owner) {
#pragma unroll
      for (int j = 0; j < kTile; ++j) p_s[warp][j][head] = s[j];
      corr_s[warp][head] = corr;
    }
    __syncwarp();

#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float cr = corr_s[warp][i];
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[i][e] *= cr;
    }
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const float pj = p_s[warp][j][i];
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[i][e] = fmaf(pj, vr[j][e], acc[i][e]);
      }
    }
    __syncwarp();                      // p_s is rewritten by the next tile
  }

  if (owner) {
    m_s[warp][head] = m_run;
    l_s[warp][head] = l_run;
  }
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc_s[warp][i][lane * DPL + e] = acc[i][e];
  __syncthreads();
  merge_block<G, DH>(&m_s[0][0], &l_s[0][0], &acc_s[0][0][0], g,
                     (static_cast<size_t>(b) * Hkv + h) * n_chunks + c,
                     part_m, part_l, part_acc);
}

// ----------------------------------------------------- bf16: tensor cores

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <bool TRANS>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  if constexpr (TRANS) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  } else {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)) : "memory");
  }
}

// 16 bytes global -> shared, asynchronously; nbytes = 0 reads nothing and
// fills zeros (the slots at or past cache_len).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int nbytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(nbytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Dynamic shared memory of the bf16 path: per warp, two stages of a
// kTileTc-slot K tile and V tile, rows padded by 16 bytes so that the eight
// rows an ldmatrix phase reads fall in distinct banks. After the loop the
// same memory holds the warps' accumulators for the merge.
template <int DH>
struct TcSmem {
  static constexpr int kRow = DH + 8;              // bf16 per padded row
  static constexpr int kStage = 2 * kTileTc * kRow;  // K then V
  static constexpr int kWarpElems = 2 * kStage;
  static constexpr size_t kBytes =
      static_cast<size_t>(kWarps) * kWarpElems * sizeof(__nv_bfloat16);
  static_assert(kBytes >= sizeof(float) * kWarps * kGroupTc * DH,
                "the accumulators must fit in the staging memory");
};

// Pass 1, bf16: one block per (S-chunk c, kv head h, sequence b). Each warp
// walks its slots in tiles of 16, staged in shared memory by cp.async one
// tile ahead. S = Q K^T on tensor cores (m16n8k16, the g heads padded to
// 16 rows of Q, f32 accumulation of exact bf16 products); the online
// softmax in f32 on the score fragments; O += P V on tensor cores with P
// kept in f32 as the sum of two bf16 parts (p = hi + lo, |p - hi - lo| <=
// 2^-16 p), V read through ldmatrix.trans.
template <int DPL>
__global__ void __launch_bounds__(kThreads)
gqa_split_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ cache_len, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int S, int Hkv, int g, int chunk, int n_chunks, float scale) {
  constexpr int DH = 32 * DPL;
  constexpr int KS = DH / 16;          // mma k-steps of QK^T
  constexpr int NT = DH / 8;           // mma n-tiles of PV
  constexpr int CH = DH * 2 / 16;      // 16-byte chunks of a row
  using Sm = TcSmem<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[kWarps][kGroupTc];
  __shared__ float l_s[kWarps][kGroupTc];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(cache_len[b], 0), S);
  const int lo = c * chunk;
  if (lo >= len) return;               // whole block: nothing to attend to
  const int hi = min(lo + chunk, len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int per_warp = chunk / kWarps;
  const int wlo = lo + warp * per_warp;
  const int whi = min(wlo + per_warp, hi);

  __nv_bfloat16* stage0 = reinterpret_cast<__nv_bfloat16*>(smem_raw)
                          + warp * Sm::kWarpElems;

  // Q as the A operand: rows gid and gid + 8 are heads, zero past g
  const int Hq = Hkv * g;
  const __nv_bfloat16* qb = q + (static_cast<size_t>(b) * Hq + h * g) * DH;
  uint32_t qa[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = gid + 8 * (r & 1);
      const int col = 16 * ks + 2 * tig + 8 * (r >> 1);
      qa[ks][r] = row < g ? *reinterpret_cast<const uint32_t*>(
                                qb + static_cast<size_t>(row) * DH + col)
                          : 0u;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_run[2] = {kNegInf, kNegInf};   // rows gid, gid + 8
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sum

  const size_t row_stride = static_cast<size_t>(Hkv) * DH;
  const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * DH;
  const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * DH;

  // stage the tile at t0 into buffer st: rows of K, then rows of V
  auto stage_tile = [&](int t0, int st) {
    __nv_bfloat16* dst = stage0 + st * Sm::kStage;
#pragma unroll
    for (int i = lane; i < 2 * kTileTc * CH; i += 32) {
      const int row = i / CH, ch = i % CH;
      const int slot = t0 + (row % kTileTc);
      const bool valid = slot < whi;
      const __nv_bfloat16* src =
          (row < kTileTc ? kb : vb)
          + (valid ? static_cast<size_t>(slot) * row_stride : 0) + ch * 8;
      cp_async16(dst + row * Sm::kRow + ch * 8, src, valid ? 16 : 0);
    }
    cp_async_commit();
  };

  const int n_tiles = whi > wlo ? (whi - wlo + kTileTc - 1) / kTileTc : 0;
  if (n_tiles > 0) stage_tile(wlo, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int t0 = wlo + t * kTileTc;
    if (t + 1 < n_tiles) {
      stage_tile(t0 + kTileTc, (t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* ks_ = stage0 + (t & 1) * Sm::kStage;
    const __nv_bfloat16* vs_ = ks_ + kTileTc * Sm::kRow;

    // S (16 heads x 16 slots) = Q K^T: n-tile j covers slots 8j..8j+7
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t kf[4];
      const int mi = lane >> 3, r = lane & 7;
      ldmatrix_x4<false>(kf, ks_ + (r + 8 * (mi >> 1)) * Sm::kRow
                                 + 16 * ks + 8 * (mi & 1));
      mma_bf16(s[0], qa[ks], kf[0], kf[1]);
      mma_bf16(s[1], qa[ks], kf[2], kf[3]);
    }

    // scale, mask, online softmax; element e of n-tile j is row
    // gid + 8 * (e >> 1), slot t0 + 8j + 2 tig + (e & 1)
    float corr[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          const int slot = t0 + 8 * j + 2 * tig + (e & 1);
          s[j][e] = slot < whi ? s[j][e] * scale : kNegInf;
          mt = fmaxf(mt, s[j][e]);
        }
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      const float m_new = fmaxf(m_run[rr], mt);
      corr[rr] = expf(m_run[rr] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);
          psum += s[j][e];
        }
      l_run[rr] = l_run[rr] * corr[rr] + psum;
      m_run[rr] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= corr[0]; o[n][1] *= corr[0];
      o[n][2] *= corr[1]; o[n][3] *= corr[1];
    }

    // P as the A operand (k = the tile's 16 slots), split into bf16 hi + lo
    uint32_t pa_hi[4], pa_lo[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = s[r >> 1][2 * (r & 1)], x1 = s[r >> 1][2 * (r & 1) + 1];
      const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
      pa_hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
      pa_lo[r] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
    }

    // O (16 heads x Dh) += P V, two n-tiles of 8 dims per ldmatrix
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t vf[4];
      const int mi = lane >> 3, r = lane & 7;
      ldmatrix_x4<true>(vf, vs_ + (r + 8 * (mi & 1)) * Sm::kRow
                                + 8 * n + 8 * (mi >> 1));
      mma_bf16(o[n], pa_hi, vf[0], vf[1]);
      mma_bf16(o[n], pa_lo, vf[0], vf[1]);
      mma_bf16(o[n + 1], pa_hi, vf[2], vf[3]);
      mma_bf16(o[n + 1], pa_lo, vf[2], vf[3]);
    }
    __syncwarp();                      // the buffer is refilled next step
  }

  // the row sums over the quad, then the warps' states to shared memory
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(kFull, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(kFull, l_run[rr], 2);
  }
  __syncthreads();                     // every warp is done with staging
  float* acc_s = reinterpret_cast<float*>(smem_raw);
  if (tig == 0) {
    m_s[warp][gid] = m_run[0];
    m_s[warp][gid + 8] = m_run[1];
    l_s[warp][gid] = l_run[0];
    l_s[warp][gid + 8] = l_run[1];
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc_s[(warp * kGroupTc + gid + 8 * (e >> 1)) * DH + 8 * n + 2 * tig
            + (e & 1)] = o[n][e];
  __syncthreads();
  merge_block<kGroupTc, DH>(&m_s[0][0], &l_s[0][0], acc_s, g,
                            (static_cast<size_t>(b) * Hkv + h) * n_chunks + c,
                            part_m, part_l, part_acc);
}

// Pass 2: one block of Dh threads per (query head, sequence b) merges the
// partials of the chunks that hold a slot below cache_len[b].
template <class T>
__global__ void gqa_combine(const float* __restrict__ part_m,
                            const float* __restrict__ part_l,
                            const float* __restrict__ part_acc,
                            const int* __restrict__ cache_len,
                            T* __restrict__ out, int S, int Hkv, int g,
                            int chunk, int n_chunks) {
  const int hq = blockIdx.x, b = blockIdx.y, dd = threadIdx.x;
  const int DH = blockDim.x;
  const int h = hq / g, i = hq % g;
  const int len = min(max(cache_len[b], 0), S);
  const int used = (len + chunk - 1) / chunk;
  const size_t base = (static_cast<size_t>(b) * Hkv + h) * n_chunks;
  float M = kNegInf;
  for (int c = 0; c < used; ++c) M = fmaxf(M, part_m[(base + c) * g + i]);
  float L = 0.f, A = 0.f;
  for (int c = 0; c < used; ++c) {
    const size_t pi = (base + c) * g + i;
    const float wt = expf(part_m[pi] - M);
    L += part_l[pi] * wt;
    A += part_acc[pi * DH + dd] * wt;
  }
  store(out + (static_cast<size_t>(b) * Hkv * g + hq) * DH + dd,
        A / fmaxf(L, 1e-30f));
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* cache_len;
  void* out;
  float* part_m;
  float* part_l;
  float* part_acc;
  int B, S, Hkv, g, chunk, n_chunks;
  float scale;
  cudaStream_t stream;
};

template <class T>
cudaError_t combine(const Args& a, int DH) {
  gqa_combine<T><<<dim3(a.Hkv * a.g, a.B), DH, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, a.cache_len, static_cast<T*>(a.out),
      a.S, a.Hkv, a.g, a.chunk, a.n_chunks);
  return cudaGetLastError();
}

template <int G, int DPL>
cudaError_t launch_f32(const Args& a) {
  gqa_split_f32<G, DPL><<<dim3(a.n_chunks, a.Hkv, a.B), kThreads, 0,
                          a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.cache_len, a.part_m, a.part_l,
      a.part_acc, a.S, a.Hkv, a.g, a.chunk, a.n_chunks, a.scale);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : combine<float>(a, 32 * DPL);
}

template <int DPL>
cudaError_t launch_bf16(const Args& a) {
  using Sm = TcSmem<32 * DPL>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      gqa_split_bf16<DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Sm::kBytes));
  if (attr != cudaSuccess) return attr;
  gqa_split_bf16<DPL><<<dim3(a.n_chunks, a.Hkv, a.B), kThreads, Sm::kBytes,
                        a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), a.cache_len, a.part_m,
      a.part_l, a.part_acc, a.S, a.Hkv, a.g, a.chunk, a.n_chunks, a.scale);
  const cudaError_t err = cudaGetLastError();
  return err != cudaSuccess ? err : combine<__nv_bfloat16>(a, 32 * DPL);
}

template <int G>
cudaError_t f32_by_head_dim(const Args& a, int Dh) {
  if (Dh == 64) return launch_f32<G, 2>(a);
  if (Dh == 128) return launch_f32<G, 4>(a);
  return cudaErrorInvalidValue;
}

cudaError_t launch_any(const Args& a, int Dh, int dtype) {
  if (dtype == 1) {                    // bf16: tensor cores, any g <= 16
    if (a.g > kGroupTc) return cudaErrorInvalidValue;
    if (Dh == 64) return launch_bf16<2>(a);
    if (Dh == 128) return launch_bf16<4>(a);
    return cudaErrorInvalidValue;
  }
  if (dtype != 0) return cudaErrorInvalidValue;
  if (a.g <= 1) return f32_by_head_dim<1>(a, Dh);
  if (a.g <= 2) return f32_by_head_dim<2>(a, Dh);
  if (a.g <= 4) return f32_by_head_dim<4>(a, Dh);
  if (a.g <= 8) return f32_by_head_dim<8>(a, Dh);
  if (a.g <= 16) return f32_by_head_dim<16>(a, Dh);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). chunk is a
// multiple of 64 (16 slots for each of the 4 warps of a block), n_chunks =
// ceil(S / chunk).
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* out,
                                 void* part_m, void* part_l, void* part_acc,
                                 int B, int S, int Hkv, int g, int Dh,
                                 int chunk, int n_chunks, int dtype,
                                 float scale, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || g < 1 || chunk < kWarps * kTileTc ||
      chunk % (kWarps * kTileTc) || n_chunks < 1 ||
      static_cast<long long>(n_chunks) * chunk < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(cache_len), out,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), B, S, Hkv, g, chunk, n_chunks,
               scale, static_cast<cudaStream_t>(stream)};
  return static_cast<int>(launch_any(a, Dh, dtype));
}
