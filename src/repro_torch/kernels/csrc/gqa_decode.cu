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
// (B = 8, Hkv = 2) on a card with 132 SMs. So the cache is split across
// blocks (flash-decoding): pass 1 (gqa_split_*) gives each block one (chunk,
// kv head, b); its 4 computing warps keep their own running (m, l, acc),
// merge them through shared memory and write one partial (m, l, acc) per
// query head to scratch. Pass 2 (gqa_combine) merges the partials of each
// (b, query head) and writes the output. Each K/V byte is read once and
// serves all g query heads of its kv head (group reuse).
//
// The grid comes from the card. The wrapper asks gqa_decode_occupancy for
// the split pass's resident blocks per SM and makes n_chunks the chunks per
// (b, kv head) that one wave of the card's block slots holds. The kernel
// splits each sequence's own cache_len[b] into n_chunks chunks of a
// multiple of 64 slots (chunk_for), so a short cache spreads over the same
// blocks as a full one instead of leaving most of them idle, and no wave
// runs part full. The combine spreads each head's chunks over its block's
// warps (a warp reduction of (m, l), then a weighted sum per warp added in
// warp order), so every thread's loads are independent.
//
// Pass 1 has two forms, chosen by dtype:
//  * bf16 (gqa_split_bf16, the model's path): tensor cores, fed by TMA.
//    One producer warp keeps a ring of kStages stages in flight, each one
//    16-slot tile of K and of V for each of the 4 consumer warps, copied by
//    cp.async.bulk.tensor from the (B * S, Hkv * Dh) view of the cache with
//    completion on an mbarrier; the consumers release a stage through a
//    second mbarrier. Consumer warp w takes tiles w, w + 4, ... of its chunk
//    (so a short chunk still spreads over the warps). S = Q K^T is mma.sync
//    m16n8k16 with the g heads padded to the 16 rows of Q (exact bf16
//    products, f32 accumulation); the online softmax runs in f32 on the
//    score fragments; O += P V is mma.sync again, with V read through
//    ldmatrix.trans and P kept in f32 as the sum of two bf16 parts, hi + lo
//    (|p - hi - lo| <= 2^-16 p, where the model's jnp path rounds p itself
//    to bf16). wgmma needs 64 rows of Q and a kv head has g <= 16, so
//    mma.sync stays; the tensor cores' 4.3 us at the main shape are not the
//    bound.
//  * f32 (gqa_split_f32): CUDA cores, since bf16 tensor cores would round
//    the inputs. Lane L owns dims [L*DPL, L*DPL + DPL) of Dh, DPL =
//    ceil(Dh / 32), holds those q dims of all g heads in registers, and
//    reads its DPL elements of each K and V row; the g partial dot products
//    of a slot are summed by a shuffle reduce-scatter that leaves each
//    head's score on 32/g lanes, which share the tile's probabilities
//    through shared memory for PV.
//
// Head dims 64, 112 and 128. At Dh = 112 (zamba2-7b) a row is not a whole
// number of 64-dim TMA boxes or of 32-lane quads: the bf16 path reads each
// row as two 64-column boxes, the second reaching 16 columns into the next
// kv head (or, past the last head, TMA's zero fill), which no k-step of
// QK^T and no n-tile of PV touches (7 k-steps and 14 n-tiles cover dims
// 0..111); this reads 128/112 = 1.14x the row's bytes. The f32 path and
// the combine give lanes 0..27 four dims each; lanes 28..31 load nothing
// and hold zeros, which add nothing to a dot product.
//
// Slots past cache_len: blocks whose chunk starts at or after cache_len[b]
// return at once, warps stop at cache_len[b], and no K/V row at or past it is
// ever read, so garbage there, even NaN, cannot reach the result. TMA copies
// only whole 16-slot tiles below cache_len; the one tile of a chunk that
// ends past it is read by its consumer warp row by row, with zeros after.
// For cache_len >= 1 that is the reference's function: a masked slot's
// weight exp(-1e30 - m) is exactly 0 in f32. At cache_len <= 0 no slot
// counts and the output is 0 (acc = 0 over l clamped at 1e-30); the JAX
// reference then averages V over S and the Pallas kernel over the padded S.
// The model never passes 0 (cache_len = min(pos + 1, Smax)).
//
// What bounds it on an H100: bytes. It must read q, then K and V up to
// cache_len, and write the output: at the main shape with a full cache
// (8 x 32768 slots x 2 kv heads x 128 dims x 2 bytes x K,V) 268 MB, 80 us at
// 3.35 TB/s. Its 4 * B * Hq * cache_len * Dh flops (4.3 GFLOP there) take
// 4.3 us on bf16 tensor cores but 64 us on f32 CUDA cores, which is why the
// bf16 path runs on tensor cores. What is left is the byte stream and what
// the split adds to it: the partials (1 MB written and read again at the
// main shape) and the second launch. The ring is 4 stages deep (128 KB at
// Dh = 128), so one block fits on an SM and the plan at the main shape is
// 8 chunks of 4,096 slots. On the card (tools/kernel_compare.py) TMA is a
// few percent faster than a 2-deep per-warp cp.async ring at one plan; the
// rest of the time follows the plan: fewer, longer chunks are faster at a
// full cache.
//
// No fast math: expf, IEEE division, f32 accumulation; bf16 is widened
// exactly and the output rounded once with __float2bfloat16 (nearest).
//
// Plain C interface, loaded with ctypes by repro_torch/kernels/gqa_decode.py:
// gqa_decode_launch launches both passes on the given stream and returns
// cudaGetLastError(); gqa_decode_occupancy reports the split pass's
// resident blocks per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kWarps = 4;            // computing warps per block, pass 1
constexpr int kThreads = 32 * kWarps;
constexpr int kThreadsTc = kThreads + 32;  // bf16: and one producer warp
constexpr int kTile = 8;             // slots per step, f32 path
constexpr int kTileTc = 16;          // slots per tile, bf16 path (mma k)
constexpr int kGroupTc = 16;         // query heads per block, bf16 (mma m)
constexpr int kStages = 4;           // stages of the bf16 ring
constexpr int kHalf = 64;            // dims per TMA box: 128 bytes of bf16
constexpr int kBox = kTileTc * 128;  // bytes of one box in shared memory
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
template <int G, int DH, int NTHREADS>
__device__ __forceinline__ void merge_block(const float* m_s,
                                            const float* l_s,
                                            const float* acc_s, int g,
                                            size_t part, float* part_m,
                                            float* part_l, float* part_acc) {
  for (int o = threadIdx.x; o < g * DH; o += NTHREADS) {
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

// The slots each block takes of a sequence holding len >= 1 slots, split
// into at most n_chunks chunks: ceil(len / n_chunks) rounded up to the 64
// slots a block's warps walk. Computed on the card from cache_len, so a
// short cache is spread over the same blocks as a long one.
__device__ __forceinline__ int chunk_for(int len, int n_chunks) {
  const int per = (len + n_chunks - 1) / n_chunks;
  return (per + kWarps * kTileTc - 1) / (kWarps * kTileTc)
         * (kWarps * kTileTc);
}

// ------------------------------------------------------- f32: CUDA cores

// Dims a lane owns of a Dh-wide row, and the lanes that own any: 64 -> 2
// on 32 lanes, 112 -> 4 on 28, 128 -> 4 on 32.
template <int DH>
struct Lanes {
  static constexpr int kDpl = (DH + 31) / 32;
  static constexpr int kLive = DH / kDpl;
  static_assert(DH == 64 || DH == 112 || DH == 128, "Dh is 64, 112 or 128");
};

// This lane's DPL dims of a row, zeros on a lane past the row (live false),
// which must not read: its address lies in the next row.
template <int DPL>
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&o)[DPL], bool live = true) {
  if (!live) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) o[e] = 0.f;
  } else if constexpr (DPL == 4) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    o[0] = r.x; o[1] = r.y; o[2] = r.z; o[3] = r.w;
  } else {
    static_assert(DPL == 2, "a lane holds 2 or 4 dims");
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

// f32: one block per (chunk c, kv head h, sequence b). Lane L owns dims
// [L*DPL, L*DPL + DPL) of every q, K and V row (lanes past the row hold
// zeros); warp w walks the w-th quarter of the chunk.
// part_m/part_l: (B, Hkv, n_chunks, g); part_acc: (B, Hkv, n_chunks, g, Dh).
template <int G, int DH>
__global__ void __launch_bounds__(kThreads)
gqa_split_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ cache_len,
              float* __restrict__ part_m, float* __restrict__ part_l,
              float* __restrict__ part_acc, int S, int Hkv, int g,
              int n_chunks, float scale) {
  constexpr int DPL = Lanes<DH>::kDpl;
  constexpr int kLevels = log2i(G);    // halvings of the reduce-scatter
  constexpr int kRep = 32 / G;         // lanes holding each head's score
  __shared__ float p_s[kWarps][kTile][G];
  __shared__ float corr_s[kWarps][G];
  __shared__ float m_s[kWarps][G];
  __shared__ float l_s[kWarps][G];
  __shared__ float acc_s[kWarps][G][DH];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(cache_len[b], 0), S);
  const int chunk = chunk_for(len, n_chunks);
  const int lo = c * chunk;
  if (lo >= len) return;               // whole block: nothing to attend to
  const int hi = min(lo + chunk, len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = lane < Lanes<DH>::kLive;
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
                    + lane * DPL, qr[i], live);
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
        load_row<DPL>(kb + static_cast<size_t>(t0 + j) * row_stride, kr[j],
                      live);
        load_row<DPL>(vb + static_cast<size_t>(t0 + j) * row_stride, vr[j],
                      live);
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
  if (live) {
#pragma unroll
    for (int i = 0; i < G; ++i)
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc_s[warp][i][lane * DPL + e] = acc[i][e];
  }
  __syncthreads();
  merge_block<G, DH, kThreads>(
      &m_s[0][0], &l_s[0][0], &acc_s[0][0][0], g,
      (static_cast<size_t>(b) * Hkv + h) * n_chunks + c, part_m, part_l,
      part_acc);
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

// The mbarriers of the bf16 ring (PTX, sm_90). A full barrier completes
// when its producer has arrived and the bytes it announced have landed; an
// empty barrier when every consumer warp has arrived.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// TMA: the box of the tensor map at (c0 = column, c1 = row) into shared
// memory at dst, counted against the barrier bar.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(bar)
      : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Byte offset of (row, col) in a tile of kTileTc rows (col a multiple of
// 8): the tile is ceil(Dh / kHalf) boxes of kTileTc rows x 128 bytes, as TMA
// writes them under CU_TENSOR_MAP_SWIZZLE_128B, which XORs the 16-byte
// chunk index of a row with the row's index mod 8 (box bases 1024-byte
// aligned). The eight rows an ldmatrix phase reads at one column then fall
// in distinct banks.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return (col / kHalf) * kBox + row * 128
         + ((((col % kHalf) >> 3) ^ (row & 7)) << 4);
}

// Dynamic shared memory of the bf16 path: a ring of kStages stages, each
// holding one tile of K and one of V for every consumer warp, plus 1 KB to
// align the ring to the 1,024 bytes of the swizzle pattern. After the loop
// the ring holds the warps' accumulators for the merge.
template <int DH>
struct TcSmem {
  static constexpr int kHalves = (DH + kHalf - 1) / kHalf;  // boxes a row
  static constexpr int kTile = 2 * kHalves * kBox;   // K then V, bytes
  static constexpr int kStage = kWarps * kTile;
  static constexpr size_t kBytes = size_t{kStages} * kStage + 1024;
  static_assert(kStages * kStage >= sizeof(float) * kWarps * kGroupTc * DH,
                "the accumulators must fit in the ring");
};

// bf16: one block per (chunk c, kv head h, sequence b): kWarps consumer
// warps and one producer warp. Stage i of the ring holds the chunk's tiles
// i * kWarps .. i * kWarps + kWarps - 1, tile i * kWarps + w for consumer
// warp w. The producer waits until the consumers have released a stage,
// then one lane announces the stage's bytes on its full barrier and copies
// every whole tile of K and V into it with TMA (2-D boxes of kTileTc slots x
// 64 dims from this kv head's first dim; at Dh = 112 the second box's last
// 16 columns are the next head's, or zero fill, and are never read); a tile
// that ends past cache_len is read by its consumer warp itself, row by row
// below cache_len, with zeros after. The
// consumers wait on the full barrier, compute, and arrive on the empty
// barrier. Math per tile: S = Q K^T on tensor cores (m16n8k16, the g heads
// padded to 16 rows of Q, f32 accumulation of exact bf16 products); the
// online softmax in f32 on the score fragments; O += P V on tensor cores
// with P kept in f32 as the sum of two bf16 parts (p = hi + lo, |p - hi -
// lo| <= 2^-16 p), V read through ldmatrix.trans.
template <int DH>
__global__ void __launch_bounds__(kThreadsTc, 2)
gqa_split_bf16(const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               const int* __restrict__ cache_len, float* __restrict__ part_m,
               float* __restrict__ part_l, float* __restrict__ part_acc,
               int S, int Hkv, int g, int n_chunks, float scale) {
  constexpr int KS = DH / 16;          // mma k-steps of QK^T
  constexpr int NT = DH / 8;           // mma n-tiles of PV
  constexpr int CH = DH / 8;           // 16-byte chunks of a row
  static_assert(DH % 16 == 0 && NT % 2 == 0, "whole k-steps, n-tile pairs");
  constexpr int kStep = kWarps * kTileTc;   // slots per stage
  using Sm = TcSmem<DH>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float m_s[kWarps][kGroupTc];
  __shared__ float l_s[kWarps][kGroupTc];
  __shared__ __align__(8) uint64_t full_bar[kStages];
  __shared__ __align__(8) uint64_t empty_bar[kStages];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = min(max(cache_len[b], 0), S);
  const int chunk = chunk_for(len, n_chunks);
  const int lo = c * chunk;
  if (lo >= len) return;               // whole block: nothing to attend to
  const int hi = min(lo + chunk, len);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_iter = (hi - lo + kStep - 1) / kStep;

  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  unsigned char* ring_p = smem_raw + (ring - raw);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_addr(&full_bar[s]), 1);
      mbar_init(smem_addr(&empty_bar[s]), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const size_t row_stride = static_cast<size_t>(Hkv) * DH;
  float m_run[2] = {kNegInf, kNegInf};   // rows gid, gid + 8
  float l_run[2] = {0.f, 0.f};           // this lane's part of the row sum
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  const int gid = lane >> 2, tig = lane & 3;

  if (warp == kWarps) {
    // the producer: stage i once the consumers have released its slot
    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      if (i >= kStages)
        mbar_wait(smem_addr(&empty_bar[s]), ((i / kStages) - 1) & 1);
      if (lane == 0) {
        const int t0 = lo + i * kStep;
        // the stage's whole tiles are a prefix of its kWarps tiles; TMA
        // counts every box's bytes in full, zero fill included
        const int whole = min(kWarps, max(0, (hi - t0) / kTileTc));
        const uint32_t bar = smem_addr(&full_bar[s]);
        mbar_arrive_tx(bar, whole * Sm::kTile);
        for (int w = 0; w < whole; ++w) {
          const uint32_t dst = ring + s * Sm::kStage + w * Sm::kTile;
          const int row = b * S + t0 + w * kTileTc;
#pragma unroll
          for (int hf = 0; hf < Sm::kHalves; ++hf) {
            tma_load(dst + hf * kBox, &k_map, h * DH + hf * kHalf, row, bar);
            tma_load(dst + (Sm::kHalves + hf) * kBox, &v_map,
                     h * DH + hf * kHalf, row, bar);
          }
        }
      }
      __syncwarp();
    }
  } else {
    // a consumer: Q as the A operand, rows gid and gid + 8 are heads, zero
    // past g
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
    const __nv_bfloat16* kb = k + (static_cast<size_t>(b) * S * Hkv + h) * DH;
    const __nv_bfloat16* vb = v + (static_cast<size_t>(b) * S * Hkv + h) * DH;

    for (int i = 0; i < n_iter; ++i) {
      const int s = i % kStages;
      mbar_wait(smem_addr(&full_bar[s]), (i / kStages) & 1);
      const int t0 = lo + i * kStep + warp * kTileTc;
      unsigned char* ks_ = ring_p + s * Sm::kStage + warp * Sm::kTile;
      unsigned char* vs_ = ks_ + Sm::kHalves * kBox;
      if (t0 < hi) {
        if (t0 + kTileTc > hi) {
          // the chunk's last tile ends past cache_len: its rows below
          // cache_len, zeros after, in the layout TMA writes (dims past Dh
          // in the second box are left as they are: nothing reads them)
          for (int u = lane; u < 2 * kTileTc * CH; u += 32) {
            const int kv = u / (kTileTc * CH), row = (u / CH) % kTileTc;
            const int col = 8 * (u % CH);
            uint4 x = make_uint4(0u, 0u, 0u, 0u);
            if (t0 + row < hi)
              x = *reinterpret_cast<const uint4*>(
                  (kv ? vb : kb) + static_cast<size_t>(t0 + row) * row_stride
                  + col);
            *reinterpret_cast<uint4*>((kv ? vs_ : ks_) + swizzled(row, col))
                = x;
          }
          // these writes come before any later TMA write to the same bytes
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          __syncwarp();
        }

        // S (16 heads x 16 slots) = Q K^T: n-tile jj covers slots 8jj..8jj+7
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t kf[4];
          const int mi = lane >> 3, r = lane & 7;
          ldmatrix_x4<false>(kf, ks_ + swizzled(r + 8 * (mi >> 1),
                                                16 * ks + 8 * (mi & 1)));
          mma_bf16(sc[0], qa[ks], kf[0], kf[1]);
          mma_bf16(sc[1], qa[ks], kf[2], kf[3]);
        }

        // scale, mask, online softmax; element e of n-tile jj is row
        // gid + 8 * (e >> 1), slot t0 + 8jj + 2 tig + (e & 1)
        float corr[2];
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float mt = kNegInf;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              const int slot = t0 + 8 * jj + 2 * tig + (e & 1);
              sc[jj][e] = slot < hi ? sc[jj][e] * scale : kNegInf;
              mt = fmaxf(mt, sc[jj][e]);
            }
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
          mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
          const float m_new = fmaxf(m_run[rr], mt);
          corr[rr] = expf(m_run[rr] - m_new);
          float psum = 0.f;
#pragma unroll
          for (int jj = 0; jj < 2; ++jj)
#pragma unroll
            for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
              sc[jj][e] = expf(sc[jj][e] - m_new);
              psum += sc[jj][e];
            }
          l_run[rr] = l_run[rr] * corr[rr] + psum;
          m_run[rr] = m_new;
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[n][0] *= corr[0]; o[n][1] *= corr[0];
          o[n][2] *= corr[1]; o[n][3] *= corr[1];
        }

        // P as the A operand (k = the tile's 16 slots), bf16 hi + lo
        uint32_t pa_hi[4], pa_lo[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float x0 = sc[r >> 1][2 * (r & 1)];
          const float x1 = sc[r >> 1][2 * (r & 1) + 1];
          const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
          pa_hi[r] = *reinterpret_cast<const uint32_t*>(&h2);
          pa_lo[r] = pack_bf16(x0 - __low2float(h2), x1 - __high2float(h2));
        }

        // O (16 heads x Dh) += P V, two n-tiles of 8 dims per ldmatrix
#pragma unroll
        for (int n = 0; n < NT; n += 2) {
          uint32_t vf[4];
          const int mi = lane >> 3, r = lane & 7;
          ldmatrix_x4<true>(vf, vs_ + swizzled(r + 8 * (mi & 1),
                                               8 * n + 8 * (mi >> 1)));
          mma_bf16(o[n], pa_hi, vf[0], vf[1]);
          mma_bf16(o[n], pa_lo, vf[0], vf[1]);
          mma_bf16(o[n + 1], pa_hi, vf[2], vf[3]);
          mma_bf16(o[n + 1], pa_lo, vf[2], vf[3]);
        }
      }
      // the warp is done with its tile of stage i
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(&empty_bar[s]));
    }
  }

  // the row sums over the quad, then the warps' states to shared memory
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l_run[rr] += __shfl_xor_sync(kFull, l_run[rr], 1);
    l_run[rr] += __shfl_xor_sync(kFull, l_run[rr], 2);
  }
  __syncthreads();                     // every stage consumed, no copy left
  float* acc_s = reinterpret_cast<float*>(ring_p);
  if (warp < kWarps) {
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
  }
  __syncthreads();
  merge_block<kGroupTc, DH, kThreadsTc>(
      &m_s[0][0], &l_s[0][0], acc_s, g,
      (static_cast<size_t>(b) * Hkv + h) * n_chunks + c, part_m, part_l,
      part_acc);
}

// Pass 2: one block per (query head, sequence b) merges the partials of the
// chunks below cache_len[b] with merge_block's arithmetic (the max,
// exp(m_c - M) weights, l clamped at 1e-30). The chunks are spread over the
// block: every warp finds (M, L) with its lanes over the chunks, then warp
// w sums chunks w, w + kWarps, ... with its lanes over the head's dims, and
// the warps' sums are added in warp order. Each thread's loads are
// independent, so a short walk of the chunks is a few memory latencies.
template <int DH, class T>
__global__ void __launch_bounds__(kThreads)
gqa_combine(const float* __restrict__ part_m, const float* __restrict__ part_l,
            const float* __restrict__ part_acc,
            const int* __restrict__ cache_len, T* __restrict__ out, int S,
            int Hkv, int g, int n_chunks) {
  constexpr int DPL = Lanes<DH>::kDpl;
  __shared__ float a_s[kWarps][DH];
  const int hq = blockIdx.x, b = blockIdx.y;
  const int h = hq / g, i = hq % g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool live = lane < Lanes<DH>::kLive;
  const int len = min(max(cache_len[b], 0), S);
  const int used = len > 0 ? (len + chunk_for(len, n_chunks) - 1)
                                 / chunk_for(len, n_chunks)
                           : 0;
  const size_t base = (static_cast<size_t>(b) * Hkv + h) * n_chunks * g + i;
  float M = kNegInf;
  for (int c = lane; c < used; c += 32)
    M = fmaxf(M, part_m[base + static_cast<size_t>(c) * g]);
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(kFull, M, o));
  float L = 0.f;
  for (int c = lane; c < used; c += 32) {
    const size_t pi = base + static_cast<size_t>(c) * g;
    L += part_l[pi] * expf(part_m[pi] - M);
  }
  for (int o = 16; o > 0; o >>= 1) L += __shfl_xor_sync(kFull, L, o);
  float A[DPL];
#pragma unroll
  for (int e = 0; e < DPL; ++e) A[e] = 0.f;
  for (int c = warp; c < used; c += kWarps) {
    const size_t pi = base + static_cast<size_t>(c) * g;
    const float wt = expf(part_m[pi] - M);
    float x[DPL];
    load_row<DPL>(part_acc + pi * DH + lane * DPL, x, live);
#pragma unroll
    for (int e = 0; e < DPL; ++e) A[e] += x[e] * wt;
  }
  if (live) {
#pragma unroll
    for (int e = 0; e < DPL; ++e) a_s[warp][lane * DPL + e] = A[e];
  }
  __syncthreads();
  for (int dd = threadIdx.x; dd < DH; dd += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += a_s[w][dd];
    store(out + (static_cast<size_t>(b) * Hkv * g + hq) * DH + dd,
          a / fmaxf(L, 1e-30f));
  }
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
  int B, S, Hkv, g, n_chunks;
  float scale;
  cudaStream_t stream;
};

using BfKernel = void(CUtensorMap, CUtensorMap, const __nv_bfloat16*,
                      const __nv_bfloat16*, const __nv_bfloat16*, const int*,
                      float*, float*, float*, int, int, int, int, float);

// The split pass of each (dtype, Dh, g) at Dh = DH: f32 instantiates its
// group G, bf16 pads g to 16 rows of Q. The visitor gets the kernel, its
// threads per block and its dynamic shared memory, for a launch or an
// occupancy query.
template <int DH, class V>
cudaError_t with_head_dim(int dtype, int g, V&& visit) {
  if (dtype == 1) {                    // bf16: tensor cores, any g <= 16
    if (g > kGroupTc) return cudaErrorInvalidValue;
    return visit(gqa_split_bf16<DH>, kThreadsTc, TcSmem<DH>::kBytes);
  }
  if (dtype != 0) return cudaErrorInvalidValue;
#define GQA_F32(G) \
  if (g <= G) return visit(gqa_split_f32<G, DH>, kThreads, size_t{0});
  GQA_F32(1) GQA_F32(2) GQA_F32(4) GQA_F32(8) GQA_F32(16)
#undef GQA_F32
  return cudaErrorInvalidValue;
}

template <class V>
cudaError_t with_kernel(int Dh, int dtype, int g, V&& visit) {
  if (g < 1) return cudaErrorInvalidValue;
  switch (Dh) {
    case 64: return with_head_dim<64>(dtype, g, visit);
    case 112: return with_head_dim<112>(dtype, g, visit);
    case 128: return with_head_dim<128>(dtype, g, visit);
    default: return cudaErrorInvalidValue;
  }
}

template <class K>
cudaError_t allow_smem(K* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// cuTensorMapEncodeTiled, a driver function, reached through the runtime so
// that the library needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The (B * S, Hkv * Dh) bf16 view of a K or V cache, read in boxes of
// kTileTc rows x kHalf columns (16 slots x 64 dims of one kv head), 128-byte
// swizzled in shared memory.
cudaError_t cache_map(CUtensorMap* map, const void* base, const Args& a,
                      int Dh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(a.Hkv) * Dh,
                              static_cast<cuuint64_t>(a.B) * a.S};
  const cuuint64_t strides[1] = {dims[0] * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {kHalf, kTileTc};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <class T, int DH>
void combine(const Args& a) {
  gqa_combine<DH, T><<<dim3(a.Hkv * a.g, a.B), kThreads, 0, a.stream>>>(
      a.part_m, a.part_l, a.part_acc, a.cache_len, static_cast<T*>(a.out),
      a.S, a.Hkv, a.g, a.n_chunks);
}

// Both passes on the stream: the split pass, then the combine.
template <class K>
cudaError_t launch(K* kernel, int threads, size_t smem, int Dh,
                   const Args& a) {
  constexpr bool kBf16 = std::is_same_v<K, BfKernel>;
  using T = std::conditional_t<kBf16, __nv_bfloat16, float>;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.n_chunks, a.Hkv, a.B);
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  if constexpr (kBf16) {
    CUtensorMap k_map, v_map;
    if ((err = cache_map(&k_map, a.k, a, Dh)) != cudaSuccess ||
        (err = cache_map(&v_map, a.v, a, Dh)) != cudaSuccess)
      return err;
    kernel<<<grid, threads, smem, a.stream>>>(
        k_map, v_map, q, k, v, a.cache_len, a.part_m, a.part_l, a.part_acc,
        a.S, a.Hkv, a.g, a.n_chunks, a.scale);
  } else {
    kernel<<<grid, threads, smem, a.stream>>>(
        q, k, v, a.cache_len, a.part_m, a.part_l, a.part_acc, a.S, a.Hkv,
        a.g, a.n_chunks, a.scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (Dh == 64) combine<T, 64>(a);
  else if (Dh == 112) combine<T, 112>(a);
  else combine<T, 128>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and out alike). n_chunks: the
// chunks each sequence's cache_len is split into (chunk_for). part_m,
// part_l: B * Hkv * n_chunks * g floats; part_acc: that times Dh.
extern "C" int gqa_decode_launch(const void* q, const void* k, const void* v,
                                 const void* cache_len, void* out,
                                 void* part_m, void* part_l, void* part_acc,
                                 int B, int S, int Hkv, int g, int Dh,
                                 int n_chunks, int dtype, float scale,
                                 void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || g < 1 || n_chunks < 1 ||
      n_chunks > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const int*>(cache_len), out,
               static_cast<float*>(part_m), static_cast<float*>(part_l),
               static_cast<float*>(part_acc), B, S, Hkv, g, n_chunks, scale,
               static_cast<cudaStream_t>(stream)};
  return static_cast<int>(with_kernel(
      Dh, dtype, g, [&](auto* kernel, int threads, size_t smem) {
        return launch(kernel, threads, smem, Dh, a);
      }));
}

// Resident blocks per SM of the split pass for (g, Dh, dtype), as the
// occupancy calculator gives them for its block size and shared memory.
extern "C" int gqa_decode_occupancy(int g, int Dh, int dtype, int* blocks) {
  return static_cast<int>(with_kernel(
      Dh, dtype, g, [&](auto* kernel, int threads, size_t smem) {
        const cudaError_t err = allow_smem(kernel, smem);
        if (err != cudaSuccess) return err;
        return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks, kernel, threads, smem);
      }));
}
