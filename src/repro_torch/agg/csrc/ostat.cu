// Batched order-statistics aggregation over the machine axis, for Hopper
// (sm_90a). Two kernels compute every coordinate-wise rule of
// repro_torch.agg: mean, k-th order statistic, median, trimmed mean, DCQ
// with a supplied scale, MAD-scaled DCQ, and the fused median+MAD+DCQ.
//
// Replaces src/repro/agg/kernel.py:_ostat_kernel, the Pallas TPU kernel
// entered through ostat_pallas, and keeps its results: an order statistic
// is the upper bracket after at most n_bisect fp32 halvings of the value
// range, each step counting the rows <= the midpoint; the trimmed mean is
// recovered from masked sums with the exact tie correction; the
// composite-quantile (CQ) correction counts ranks at K thresholds
// med + scale * Delta_k.
//
// The bisection path (ostat_kernel) runs every op at every m. The
// bisection is a chain of dependent steps, each a count over the m rows
// and a branch:
//  * Lane groups. G lanes (a power of two <= 32, chosen by the wrapper)
//    own one coordinate. Lane s of a group holds rows s, s + G, ...; where
//    they fit (ceil(m/G) <= 8, the template R) they sit in registers,
//    padded with NaN, which no count sees (NaN <= t is false); otherwise the
//    block's columns are staged in shared memory, and past 227 KB read
//    through L1/L2. Each step sums the lanes' counts over the group: one
//    redux.sync for G = 32, log2 G shuffles below; counts taken together
//    (an even-m median's two searches, three CQ knots) are packed 10 bits
//    each into one word. Rank counts are integers, so kth, median and the
//    CQ counts are bit-equal to the plain version's one-thread search; the
//    sums of mean and trimmed are taken in another order (within 1e-5 of
//    max(1, |ref|) at the 99.9th percentile).
//  * Stop at the fixed point. A halving maps (lo, hi) to a new (lo, hi)
//    deterministically; once a step leaves both bit-identical, every later
//    step does too, so stopping there returns the bits of all n_bisect
//    steps. The exit is voted over the warp (__all_sync).
// It reads (nb, m, p) f32 rows, so the wrapper widens other dtypes first.
//
// The small-m path (ostat_kernel_small) takes m <= 8 for the selection ops
// (median, kth, dcq, dcq_mad, median_mad_dcq) on bf16, fp16 or f32 rows:
// the training wire's (1, 4, d) stacks. One thread holds kV = 4
// consecutive coordinates, their rows read in the rows' own dtype with one
// vector load a row (8 bytes for bf16, coalesced along p) and widened in
// registers, which is exact; it sorts each coordinate's rows with a
// compare-exchange network (5 exchanges at m = 4, 19 at m = 8; NaN last)
// and the MAD's deviations likewise, takes the CQ counts against the sorted
// rows, and writes the result in the rows' dtype rounded to nearest even,
// as the wrapper's cast did. Its bound at (1, 4, 620.8M) bf16 is bytes: 4
// rows read and 1 written, 6.2 GB, 1.853 ms at 3.35 TB/s, against ~0.9 ms
// of its ~100 fp32 operations a coordinate; its compares and selects are
// what it waits on.
//
// Why the small-m path returns the bisection's bits. With NaN-free rows,
// count(v <= mid) <= k holds exactly when mid < x, x the k-th smallest row,
// so the bisection depends on (x, lo0, hi0, n_bisect) alone, lo0 and hi0
// the rows' min and max. Write w for hi0 - lo0. Where |lo0|, |hi0| <=
// 2^126 (no sum overflows) and 2^-100 <= |x|:
//  * Each step keeps a bracket that holds x; its width w' <= w/2 + the
//    midpoint's rounding, at most 2^-24 (|x| + w) + 2^-150. So after
//    ceil(log2(w0/|x|)) + 21 steps the bracket lies within 2^-20 |x| of
//    x: in one binade or two, at most 31 floats wide. There the midpoint
//    is the fp32 midpoint rounded to nearest even, strictly inside the
//    bracket until lo and hi are neighbours, and the half kept holds at
//    most 2/3 of the floats plus one half, so 8 more steps make them
//    neighbours. Neighbours with lo < x <= hi leave hi = x, a fixed point.
//  * Where x = lo0 (the k-th row ties the minimum: at even m the MAD's
//    two smallest deviations always do), lo never moves and hi descends
//    hi <- fl(0.5 fl(lo0 + hi)). Between neighbours the midpoint is a
//    tie, rounded to the even one, so the descent ends at lo0 where lo0's
//    last mantissa bit is 0 and one ulp above it where that bit is 1
//    (unless hi0 = lo0); one step more than above.
// So where expo(x) >= expo(w0) + 32 - n_bisect (biased exponent fields,
// which bound log2(w0/|x|) from above with a step to spare), the result is
// x, or its odd-lo0 neighbour at a tie with the minimum. Where x = lo0 = 0
// and hi0 > 0, the descent is exact halvings of hi0 while they stay normal:
// hi0 * 2^-n_bisect where hi0's exponent field exceeds n_bisect. Every
// other search (a zero above the minimum, whose sign only the halvings
// give; ranges of more than 2^28 x; tiny or huge magnitudes; NaN; short
// trip counts) replays the bisection with one compare a step against x,
// "!(mid >= x)", which is the count's test also where x is NaN, from the
// bisection path's own (lo0, hi0) fold, with its fixed-point exit. A
// device counter gains the coordinates replayed, one atomic a warp. The
// torch twin in tests/test_torch_agg.py holds the closed forms to the
// plain version bit for bit on ties, +-0.0, binade edges, odd mantissas,
// 1e-30..1e30 and n_bisect down to 0.
//
// No FMA contraction where bits matter: nvcc contracts a*b+c into an FMA by
// default, which would move CQ thresholds (med + scale*delta), the MAD scale
// (1.4826*mad + 1e-12) and the trimmed tie correction by an ulp and flip
// indicators against the reference. Every such site is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts; the file is built with the default --fmad.
//
// Plain C interface, loaded with ctypes by repro_torch/agg/kernel.py:
// ostat_launch (the bisection path, laid out by the wrapper's plan: G,
// register rows, slab) and ostat_small_launch (the small-m path). Each
// launches on the given stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxK = 64;            // CQ knots carried by value
constexpr int kThreads = 128;        // threads per block
constexpr int kMaxSmem = 232448;     // 227 KB of dynamic shared memory
constexpr int kDefaultSmem = 48 * 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kPackBits = 10;        // counts packed per word when m < 1024

// Op codes: the order of repro_torch.agg.kernel.OPS.
enum Op : int {
  kMean = 0, kMedian = 1, kKth = 2, kTrimmed = 3, kDcq = 4, kDcqMad = 5,
  kMedMadDcq = 6,
};

struct CqConst {
  int K;
  float denom;           // f32(m * sum_k psi(Delta_k))
  float delta[kMaxK];    // f32 knots Delta_k
  float mk[kMaxK];       // f32(m * kappa_k)
};

// The lane group of one coordinate: G lanes, aligned in the warp.
struct Group {
  int G;
  bool pack;             // m < 1024: three counts fit one word
};

// ---------------------------------------------- reductions over a group
// Every lane of the warp calls these together (full mask); xor offsets
// below G never leave the group.

__device__ __forceinline__ int gsum(int x, int G) {
  if (G == 32) return static_cast<int>(
      __reduce_add_sync(kFull, static_cast<unsigned>(x)));
  for (int o = G >> 1; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float gsumf(float x, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    x = __fadd_rn(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ void gminmax(float& lo, float& hi, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) {
    lo = fminf(lo, __shfl_xor_sync(kFull, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(kFull, hi, o));
  }
}

// Sum N lane-local counts over the group, three to a reduction when packed.
template <int N>
__device__ __forceinline__ void gsum_counts(int (&c)[N], const Group& grp) {
  if (grp.pack && N > 1) {
#pragma unroll
    for (int i = 0; i < N; i += 3) {
      int w = c[i];
      if (i + 1 < N) w |= c[i + 1] << kPackBits;
      if (i + 2 < N) w |= c[i + 2] << (2 * kPackBits);
      w = gsum(w, grp.G);
      constexpr int mask = (1 << kPackBits) - 1;
      c[i] = w & mask;
      if (i + 1 < N) c[i + 1] = (w >> kPackBits) & mask;
      if (i + 2 < N) c[i + 2] = (w >> (2 * kPackBits)) & mask;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = gsum(c[i], grp.G);
  }
}

// ------------------------------------------------- a lane's machine rows

// Rows lane, lane + G, ... held in registers; NaN past the lane's n rows.
template <int R>
struct RegRows {
  float v[R];
  int n;
  template <int N>
  __device__ __forceinline__ void count(const float (&t)[N],
                                        int (&c)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = 0;
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < N; ++i) c[i] += v[j] <= t[i];
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
#pragma unroll
    for (int j = 0; j < R; ++j)
      if (j < n) f(v[j]);
  }
  // |v - center| of the same rows (the MAD pass); the padding stays NaN
  __device__ __forceinline__ RegRows deviation(float center) const {
    RegRows d;
    d.n = n;
#pragma unroll
    for (int j = 0; j < R; ++j) d.v[j] = fabsf(__fsub_rn(v[j], center));
    return d;
  }
};

// Rows read from memory (the staged slab, or device memory through L1/L2):
// row j of the lane at col[j * step]; with ABS the row is |v - center|.
template <bool ABS>
struct MemRows {
  const float* col;
  size_t step;
  int n;
  float center;
  __device__ __forceinline__ float at(int j) const {
    const float v = col[static_cast<size_t>(j) * step];
    return ABS ? fabsf(__fsub_rn(v, center)) : v;
  }
  template <int N>
  __device__ __forceinline__ void count(const float (&t)[N],
                                        int (&c)[N]) const {
#pragma unroll
    for (int i = 0; i < N; ++i) c[i] = 0;
    for (int j = 0; j < n; ++j) {
      const float v = at(j);
#pragma unroll
      for (int i = 0; i < N; ++i) c[i] += v <= t[i];
    }
  }
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int j = 0; j < n; ++j) f(at(j));
  }
  __device__ __forceinline__ MemRows<true> deviation(float c) const {
    return MemRows<true>{col, step, n, c};
  }
};

// ------------------------------------------------------- the statistics

template <class Rows>
__device__ __forceinline__ void min_max(const Rows& r, const Group& grp,
                                        float& lo, float& hi) {
  lo = __int_as_float(0x7f800000);     // +inf: a lane without rows
  hi = -lo;
  r.each([&](float v) {
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  });
  gminmax(lo, hi, grp.G);
}

__device__ __forceinline__ float half(float lo, float hi) {
  return __fmul_rn(0.5f, __fadd_rn(lo, hi));
}

__device__ __forceinline__ bool same(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}

// One halving of the bracket (lo, hi) of the k-th value at mid, given the
// group's count of rows <= mid: go right while the count is <= k.
__device__ __forceinline__ void step(int cnt, int k, float mid, float& lo,
                                     float& hi) {
  if (cnt <= k) lo = mid; else hi = mid;
}

// The ka-th (and, with TWO, the kb-th) smallest value (0-indexed) by
// bisection from (lo0, hi0): the upper bracket after n_bisect halvings,
// ended at the fixed point.
template <bool TWO, class Rows>
__device__ __forceinline__ void kth(const Rows& r, const Group& grp, int ka,
                                    int kb, int n_bisect, float lo0,
                                    float hi0, float& out_a, float& out_b) {
  float lo_a = lo0, hi_a = hi0, lo_b = lo0, hi_b = hi0;
  for (int it = 0; it < n_bisect; ++it) {
    const float pa = lo_a, qa = hi_a, pb = lo_b, qb = hi_b;
    constexpr int N = TWO ? 2 : 1;
    float t[N];
    t[0] = half(lo_a, hi_a);
    if (TWO) t[N - 1] = half(lo_b, hi_b);
    int c[N];
    r.count(t, c);
    gsum_counts(c, grp);
    step(c[0], ka, t[0], lo_a, hi_a);
    bool fixed = same(lo_a, pa) && same(hi_a, qa);
    if (TWO) {
      step(c[N - 1], kb, t[N - 1], lo_b, hi_b);
      fixed = fixed && same(lo_b, pb) && same(hi_b, qb);
    }
    if (__all_sync(kFull, fixed)) break;
  }
  out_a = hi_a;
  out_b = hi_b;
}

template <class Rows>
__device__ __forceinline__ float median(const Rows& r, const Group& grp,
                                        int m, int n_bisect) {
  float lo, hi, a, b;
  min_max(r, grp, lo, hi);
  if (m & 1) {
    kth<false>(r, grp, (m - 1) / 2, 0, n_bisect, lo, hi, a, b);
    return a;
  }
  kth<true>(r, grp, m / 2 - 1, m / 2, n_bisect, lo, hi, a, b);
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

template <class Rows>
__device__ __forceinline__ float mean(const Rows& r, const Group& grp,
                                      int m) {
  float s = 0.f;
  r.each([&](float v) { s = __fadd_rn(s, v); });
  return __fdiv_rn(gsumf(s, grp.G), static_cast<float>(m));
}

// Beta-trimmed mean, g values dropped per side, without a sort:
// kept = [S(v<=t_hi) - (N(v<=t_hi) - (m-g)) t_hi]
//      - [S(v<=t_lo) - (N(v<=t_lo) - g) t_lo],   divided by m - 2g.
template <class Rows>
__device__ __forceinline__ float trimmed(const Rows& r, const Group& grp,
                                         int m, int g, int n_bisect) {
  if (g == 0) return mean(r, grp, m);
  float lo, hi, t_lo, t_hi;
  min_max(r, grp, lo, hi);
  kth<true>(r, grp, g, m - 1 - g, n_bisect, lo, hi, t_lo, t_hi);
  float s_hi = 0.f, s_lo = 0.f;
  int n[2] = {0, 0};
  r.each([&](float v) {
    s_hi = __fadd_rn(s_hi, __fmul_rn(v, v <= t_hi ? 1.f : 0.f));
    s_lo = __fadd_rn(s_lo, __fmul_rn(v, v <= t_lo ? 1.f : 0.f));
    n[0] += v <= t_hi;
    n[1] += v <= t_lo;
  });
  s_hi = gsumf(s_hi, grp.G);
  s_lo = gsumf(s_lo, grp.G);
  gsum_counts(n, grp);
  const float top =
      __fsub_rn(s_hi, __fmul_rn(static_cast<float>(n[0] - (m - g)), t_hi));
  const float bot =
      __fsub_rn(s_lo, __fmul_rn(static_cast<float>(n[1] - g), t_lo));
  return __fdiv_rn(__fsub_rn(top, bot), static_cast<float>(m - 2 * g));
}

// med - scale * S / (m * psi_sum),
// S = sum_k sum_j [I(v_j <= med + scale * Delta_k) - kappa_k].
// Three knots per pass over the rows and per group reduction; S is summed
// in knot order as before.
template <class Rows>
__device__ __forceinline__ float cq_correct(const Rows& r, const Group& grp,
                                            float med, float scale,
                                            const CqConst& cq) {
  float s = 0.f;
  for (int k0 = 0; k0 < cq.K; k0 += 3) {
    float t[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int k = min(k0 + i, cq.K - 1);
      t[i] = __fadd_rn(med, __fmul_rn(scale, cq.delta[k]));
    }
    int c[3];
    r.count(t, c);
    gsum_counts(c, grp);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      if (k0 + i < cq.K)
        s = __fsub_rn(__fadd_rn(s, static_cast<float>(c[i])),
                      cq.mk[k0 + i]);
  }
  return __fsub_rn(med, __fdiv_rn(__fmul_rn(scale, s), cq.denom));
}

struct Args {
  const float* vals;
  const float* scale;
  float* out0;
  float* out1;
  float* out2;
  int n_coord, m, p, G, use_smem, kth_k, g, n_bisect;
};

template <int OP, class Rows>
__device__ __forceinline__ void compute(const Rows& v, const Args& a,
                                        const Group& grp, const CqConst& cq,
                                        bool store, size_t o) {
  const int m = a.m;
  if (OP == kMean) {
    const float r = mean(v, grp, m);
    if (store) a.out0[o] = r;
  } else if (OP == kKth) {
    float lo, hi, r, unused;
    min_max(v, grp, lo, hi);
    kth<false>(v, grp, a.kth_k, 0, a.n_bisect, lo, hi, r, unused);
    if (store) a.out0[o] = r;
  } else if (OP == kMedian) {
    const float r = median(v, grp, m, a.n_bisect);
    if (store) a.out0[o] = r;
  } else if (OP == kTrimmed) {
    const float r = trimmed(v, grp, m, a.g, a.n_bisect);
    if (store) a.out0[o] = r;
  } else if (OP == kDcq) {
    const float med = median(v, grp, m, a.n_bisect);
    const float r = cq_correct(v, grp, med, a.scale[o], cq);
    if (store) a.out0[o] = r;
  } else {  // kDcqMad, kMedMadDcq
    const float med = median(v, grp, m, a.n_bisect);
    const float mad = median(v.deviation(med), grp, m, a.n_bisect);
    const float sc = __fadd_rn(__fmul_rn(1.4826f, mad), 1e-12f);
    const float dcq = cq_correct(v, grp, med, sc, cq);
    if (store) {
      if (OP == kDcqMad) {
        a.out0[o] = dcq;
      } else {
        a.out0[o] = med;
        a.out1[o] = mad;
        a.out2[o] = dcq;
      }
    }
  }
}

// One group of G lanes per coordinate, kThreads / G coordinates per block,
// coordinates flattened over (batch row, p). Groups past the last
// coordinate repeat it and store nothing, so that every lane of a warp
// takes part in its shuffles. R > 0: each lane's ceil(m/G) <= R rows in
// registers; R = 0: from the staged slab (use_smem) or device memory.
template <int OP, int R>
__global__ void __launch_bounds__(kThreads)
ostat_kernel(Args a, CqConst cq) {
  extern __shared__ float slab[];
  const int G = a.G, m = a.m, p = a.p;
  const int per_block = kThreads / G;
  const int sub = threadIdx.x & (G - 1);
  const int local = threadIdx.x / G;
  const int first = blockIdx.x * per_block;
  const int coord = min(first + local, a.n_coord - 1);
  const bool store = first + local < a.n_coord && sub == 0;
  const int b = coord / p, c = coord % p;
  const float* col = a.vals + static_cast<size_t>(b) * m * p + c;
  const size_t o = static_cast<size_t>(b) * p + c;
  const Group grp{G, m < (1 << kPackBits)};
  const int n = sub < m ? (m - sub + G - 1) / G : 0;   // this lane's rows

  if constexpr (R > 0) {
    RegRows<R> v;
    v.n = n;
#pragma unroll
    for (int j = 0; j < R; ++j)
      v.v[j] = j < n ? __ldg(col + static_cast<size_t>(sub + j * G) * p)
                     : __int_as_float(0x7fc00000);
    compute<OP>(v, a, grp, cq, store, o);
  } else {
    const float* rows = col + static_cast<size_t>(sub) * p;
    size_t step = static_cast<size_t>(G) * p;
    if (a.use_smem) {
      // the block's columns, one after another: slab[local * m + i]
      for (int idx = threadIdx.x; idx < per_block * m; idx += kThreads) {
        const int i = idx / per_block, cc = idx % per_block;
        const int k = min(first + cc, a.n_coord - 1);
        slab[cc * m + i] =
            __ldg(a.vals + (static_cast<size_t>(k / p) * m + i) * p + k % p);
      }
      __syncthreads();
      rows = slab + local * m + sub;
      step = G;
    }
    const MemRows<false> v{rows, step, n, 0.f};
    compute<OP>(v, a, grp, cq, store, o);
  }
}

template <int OP, int R>
cudaError_t launch(int grid, size_t smem, cudaStream_t stream,
                   const Args& a, const CqConst& cq) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ostat_kernel<OP, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ostat_kernel<OP, R><<<grid, kThreads, smem, stream>>>(a, cq);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_rows(int reg_rows, int grid, size_t smem,
                        cudaStream_t s, const Args& a, const CqConst& cq) {
  switch (reg_rows) {
    case 0: return launch<OP, 0>(grid, smem, s, a, cq);
    case 1: return launch<OP, 1>(grid, smem, s, a, cq);
    case 2: return launch<OP, 2>(grid, smem, s, a, cq);
    case 4: return launch<OP, 4>(grid, smem, s, a, cq);
    case 8: return launch<OP, 8>(grid, smem, s, a, cq);
    default: return cudaErrorInvalidValue;
  }
}

// ------------------------------------------------- the small-m path
//
// One thread per kV consecutive coordinates, every row of each in
// registers, read in the wire's own dtype and widened in registers; the
// rows sorted by a compare-exchange network, each order statistic taken
// from the sorted rows in closed form where that provably gives the bits of
// the bisection, and the bisection replayed against the selected value
// where it does not (see the note at the top).

constexpr int kSmallThreads = 256;
constexpr int kV = 4;                // consecutive coordinates per thread
constexpr int kSmallM = 8;           // the largest m the path takes
constexpr int kCommonK = 10;         // the K the CQ loop is unrolled for

// Storage dtypes: the order of repro_torch.agg.kernel.SMALL_DTYPES.
enum Dtype : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

template <int DT> struct Wire;
template <> struct Wire<kF32> {
  using S = float;
  __device__ __forceinline__ static float widen(S s) { return s; }
  __device__ __forceinline__ static S narrow(float f) { return f; }
  __device__ __forceinline__ static void load(const S* p, float (&o)[kV]) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = w.x; o[1] = w.y; o[2] = w.z; o[3] = w.w;
  }
  __device__ __forceinline__ static void store(S* p, const float (&r)[kV]) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
};
template <int DT> struct Wire16 {
  using S = unsigned short;
  __device__ __forceinline__ static float widen(S s) {
    return DT == kBF16 ? __uint_as_float(static_cast<unsigned>(s) << 16)
                       : __half2float(__ushort_as_half(s));
  }
  __device__ __forceinline__ static S narrow(float f) {
    return DT == kBF16 ? __bfloat16_as_ushort(__float2bfloat16_rn(f))
                       : __half_as_ushort(__float2half_rn(f));
  }
  __device__ __forceinline__ static void load(const S* p, float (&o)[kV]) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
    o[0] = widen(static_cast<S>(w.x & 0xffffu));
    o[1] = widen(static_cast<S>(w.x >> 16));
    o[2] = widen(static_cast<S>(w.y & 0xffffu));
    o[3] = widen(static_cast<S>(w.y >> 16));
  }
  __device__ __forceinline__ static void store(S* p, const float (&r)[kV]) {
    uint2 w;
    w.x = narrow(r[0]) | (static_cast<unsigned>(narrow(r[1])) << 16);
    w.y = narrow(r[2]) | (static_cast<unsigned>(narrow(r[3])) << 16);
    *reinterpret_cast<uint2*>(p) = w;
  }
};
template <> struct Wire<kBF16> : Wire16<kBF16> {};
template <> struct Wire<kF16> : Wire16<kF16> {};

// max that returns NaN where either input is (PTX max.NaN, sm_80 on)
__device__ __forceinline__ float fmax_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Ascending, NaN last (NaN rows count nowhere, so they rank above all):
// fminf keeps the number of a pair, max.NaN its NaN. A pair of zeros may
// leave with other signs; nothing reads a sorted zero's sign.
__device__ __forceinline__ void cx(float& a, float& b) {
  const float lo = fminf(a, b);
  b = fmax_nan(a, b);
  a = lo;
}

template <int R>
__device__ __forceinline__ void sort_rows(float (&s)[R]) {
  if constexpr (R == 4) {
    cx(s[0], s[1]); cx(s[2], s[3]); cx(s[0], s[2]); cx(s[1], s[3]);
    cx(s[1], s[2]);
  } else {  // Batcher's odd-even merge sort, 19 exchanges
    cx(s[0], s[1]); cx(s[2], s[3]); cx(s[4], s[5]); cx(s[6], s[7]);
    cx(s[0], s[2]); cx(s[1], s[3]); cx(s[1], s[2]);
    cx(s[4], s[6]); cx(s[5], s[7]); cx(s[5], s[6]);
    cx(s[0], s[4]); cx(s[1], s[5]); cx(s[2], s[6]); cx(s[3], s[7]);
    cx(s[2], s[4]); cx(s[3], s[5]);
    cx(s[1], s[2]); cx(s[3], s[4]); cx(s[5], s[6]);
  }
}

// s[k] for a k the whole grid shares, without indexing registers
template <int R>
__device__ __forceinline__ float pick(const float (&s)[R], int k) {
  float r = s[0];
#pragma unroll
  for (int j = 1; j < R; ++j) r = j == k ? s[j] : r;
  return r;
}

__device__ __forceinline__ int expo(float f) {
  return static_cast<int>((__float_as_uint(f) >> 23) & 0xffu);
}

// The bisection of kth() for one search, replayed against the selected
// value x: with NaN-free rows "count(v <= mid) <= k" is "!(mid >= x)",
// and so it stays where x is NaN (k past the rows that are not).
__device__ __noinline__ float replay(float x, float lo, float hi,
                                     int n_bisect) {
  for (int it = 0; it < n_bisect; ++it) {
    const float pl = lo, ph = hi;
    const float mid = half(lo, hi);
    if (!(mid >= x)) lo = mid; else hi = mid;
    if (same(lo, pl) && same(hi, ph)) break;
  }
  return hi;
}

// One set of searches: the rows' fold (lo, hi), as the bisection path's
// min_max gives it; the least exponent field of a selected value that the
// closed forms take (255: none); and where the descent onto lo ends (one
// ulp above an odd lo, unless hi = lo).
struct Bracket {
  float lo, hi, lo_end;
  int least;
};

__device__ __forceinline__ Bracket bracket(float lo, float hi,
                                           int n_bisect) {
  const bool in_range =
      fmaxf(fabsf(lo), fabsf(hi)) <= __int_as_float(0x7e800000);  // 2^126
  const int least = max(27, expo(__fsub_rn(hi, lo)) + 32 - n_bisect);
  const unsigned lb = __float_as_uint(lo);
  const bool up = hi != lo && (lb & 1u);
  return Bracket{lo, hi,
                 up ? __uint_as_float(lo > 0.f ? lb + 1u : lb - 1u) : lo,
                 in_range ? min(least, 255) : 255};
}

// The upper bracket of n_bisect halvings from (br.lo, br.hi) toward x,
// the k-th smallest row: in closed form where the note at the top proves
// its bits, else replayed (and `replayed` set).
__device__ __forceinline__ float search(float x, const Bracket& br,
                                        int n_bisect, bool& replayed) {
  if (static_cast<unsigned>(expo(x) - br.least) <
      static_cast<unsigned>(255 - br.least))
    return x == br.lo ? br.lo_end : x;
  const int eh = expo(br.hi);
  // the descent onto lo = 0: exact halvings of hi while they stay normal
  if (x == 0.f && br.lo == 0.f && br.hi > 0.f && eh > n_bisect &&
      eh <= 254)
    return __uint_as_float(__float_as_uint(br.hi) -
                           (static_cast<unsigned>(n_bisect) << 23));
  replayed = true;
  return replay(x, br.lo, br.hi, n_bisect);
}

// median of the sorted rows s
template <int R>
__device__ __forceinline__ float small_median(const float (&s)[R], int m,
                                              const Bracket& br,
                                              int n_bisect, bool& rp) {
  if (m & 1) return search(pick(s, (m - 1) / 2), br, n_bisect, rp);
  const float a = search(pick(s, m / 2 - 1), br, n_bisect, rp);
  const float b = search(pick(s, m / 2), br, n_bisect, rp);
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

// sum_k [count(v <= med + sc * Delta_k) - m kappa_k] in knot order; KC > 0:
// the loop unrolled at K = KC (the paper's K), the knots read as constants
template <int KC, int R>
__device__ __forceinline__ float cq_sum(const float (&v)[R], float med,
                                       float sc, const CqConst& cq) {
  float s = 0.f;
#pragma unroll(KC ? KC : 1)
  for (int k = 0; k < (KC ? KC : cq.K); ++k) {
    const float t = __fadd_rn(med, __fmul_rn(sc, cq.delta[k]));
    float c = 0.f;          // the count, exact as a float
#pragma unroll
    for (int j = 0; j < R; ++j) c += v[j] <= t ? 1.f : 0.f;
    s = __fsub_rn(__fadd_rn(s, c), cq.mk[k]);
  }
  return s;
}

struct SmallArgs {
  const void* vals;
  const float* scale;
  void* out0;
  void* out1;
  void* out2;
  unsigned long long* replays;
  int n_coord, nb, m, p, op, kth_k, n_bisect, vec;
};

// One coordinate's rows v (NaN past m) -> r0 (and r1, r2 for the triple).
// FAM 0: kth and median; FAM 1: dcq, dcq_mad, median_mad_dcq. EXACT:
// m = R, so that the middle rows are known registers.
template <int FAM, bool EXACT, int R>
__device__ __forceinline__ void small_compute(float (&v)[R],
                                              const SmallArgs& a,
                                              const CqConst& cq, float sc,
                                              float& r0, float& r1,
                                              float& r2, bool& rp) {
  // the fold in row order, as min_max takes it (the bits of a zero bound
  // depend on the order; the replay starts from them)
  float lo = __int_as_float(0x7f800000), hi = -lo;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    lo = fminf(lo, v[j]);
    hi = fmaxf(hi, v[j]);
  }
  const int m = EXACT ? R : a.m;
  const Bracket br = bracket(lo, hi, a.n_bisect);
  sort_rows(v);
  if (FAM == 0) {
    r0 = a.op == kKth ? search(pick(v, a.kth_k), br, a.n_bisect, rp)
                      : small_median(v, m, br, a.n_bisect, rp);
    return;
  }
  const float med = small_median(v, m, br, a.n_bisect, rp);
  r1 = 0.f;
  if (a.op != kDcq) {
    float d[R];
#pragma unroll
    for (int j = 0; j < R; ++j) d[j] = fabsf(__fsub_rn(v[j], med));
    sort_rows(d);
    // deviations are never -0.0, so their fold is the least number and
    // the greatest, whatever the order
    float dhi = -__int_as_float(0x7f800000);
#pragma unroll
    for (int j = 0; j < R; ++j) dhi = fmaxf(dhi, d[j]);
    const Bracket dbr =
        bracket(fminf(d[0], __int_as_float(0x7f800000)), dhi, a.n_bisect);
    r1 = small_median(d, m, dbr, a.n_bisect, rp);
    sc = __fadd_rn(__fmul_rn(1.4826f, r1), 1e-12f);
  }
  const float s = cq.K == kCommonK ? cq_sum<kCommonK>(v, med, sc, cq)
                                   : cq_sum<0>(v, med, sc, cq);
  const float dcq = __fsub_rn(med, __fdiv_rn(__fmul_rn(sc, s), cq.denom));
  r0 = a.op == kMedMadDcq ? med : dcq;
  r2 = dcq;
}

template <int FAM, int DT, int R>
__global__ void __launch_bounds__(kSmallThreads)
ostat_kernel_small(SmallArgs a, CqConst cq) {
  using W = Wire<DT>;
  using S = typename W::S;
  const S* vals = static_cast<const S*>(a.vals);
  const int first = (blockIdx.x * kSmallThreads + threadIdx.x) * kV;
  const int m = a.m, p = a.p;
  // the row-major offset of coordinate i's first row
  auto at = [&](int i) {
    const int b = a.nb == 1 ? 0 : i / p;
    return static_cast<size_t>(b) * (m - 1) * p + i;
  };
  int replays = 0;
  if (first < a.n_coord) {
    const float nan = __int_as_float(0x7fc00000);
    float v[kV][R];
    if (a.vec) {             // kV columns of one batch row, aligned
      const S* col = vals + at(first);
#pragma unroll
      for (int j = 0; j < R; ++j) {
        float row[kV];
        if (j < m) W::load(col + static_cast<size_t>(j) * p, row);
#pragma unroll
        for (int u = 0; u < kV; ++u) v[u][j] = j < m ? row[u] : nan;
      }
    } else {
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        const S* col = vals + at(min(first + u, a.n_coord - 1));
#pragma unroll
        for (int j = 0; j < R; ++j)
          v[u][j] = j < m ? W::widen(col[static_cast<size_t>(j) * p]) : nan;
      }
    }
    float r0[kV], r1[kV], r2[kV];
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int i = min(first + u, a.n_coord - 1);
      const float sc = FAM == 1 && a.op == kDcq ? a.scale[i] : 0.f;
      bool rp = false;
      if (m == R)
        small_compute<FAM, true>(v[u], a, cq, sc, r0[u], r1[u], r2[u], rp);
      else
        small_compute<FAM, false>(v[u], a, cq, sc, r0[u], r1[u], r2[u], rp);
      replays += rp && first + u < a.n_coord;
    }
    S* o0 = static_cast<S*>(a.out0);
    const bool three = FAM == 1 && a.op == kMedMadDcq;
    if (a.vec) {
      W::store(o0 + first, r0);
      if (three) {
        W::store(static_cast<S*>(a.out1) + first, r1);
        W::store(static_cast<S*>(a.out2) + first, r2);
      }
    } else {
#pragma unroll
      for (int u = 0; u < kV; ++u) {
        if (first + u >= a.n_coord) break;
        o0[first + u] = W::narrow(r0[u]);
        if (three) {
          static_cast<S*>(a.out1)[first + u] = W::narrow(r1[u]);
          static_cast<S*>(a.out2)[first + u] = W::narrow(r2[u]);
        }
      }
    }
  }
  // one atomic per warp: the coordinates of its lanes that replayed
  const unsigned total =
      __reduce_add_sync(kFull, static_cast<unsigned>(replays));
  if ((threadIdx.x & 31) == 0 && total)
    atomicAdd(a.replays, static_cast<unsigned long long>(total));
}

template <int FAM, int DT>
cudaError_t launch_small(int R, int grid, cudaStream_t s,
                         const SmallArgs& a, const CqConst& cq) {
  if (R == 4)
    ostat_kernel_small<FAM, DT, 4><<<grid, kSmallThreads, 0, s>>>(a, cq);
  else
    ostat_kernel_small<FAM, DT, 8><<<grid, kSmallThreads, 0, s>>>(a, cq);
  return cudaGetLastError();
}

template <int FAM>
cudaError_t launch_small_dt(int dtype, int R, int grid, cudaStream_t s,
                            const SmallArgs& a, const CqConst& cq) {
  switch (dtype) {
    case kF32: return launch_small<FAM, kF32>(R, grid, s, a, cq);
    case kBF16: return launch_small<FAM, kBF16>(R, grid, s, a, cq);
    case kF16: return launch_small<FAM, kF16>(R, grid, s, a, cq);
    default: return cudaErrorInvalidValue;
  }
}

CqConst make_cq(int K, const float* delta, const float* mk, float denom) {
  CqConst cq;
  cq.K = K;
  cq.denom = denom;
  for (int k = 0; k < K; ++k) {
    cq.delta[k] = delta[k];
    cq.mk[k] = mk[k];
  }
  return cq;
}

}  // namespace

// values (nb, m, p) f32 contiguous; scale (nb, p) for op kDcq, else null;
// out0 (and out1/out2 for kMedMadDcq) (nb, p) f32. delta/mk: K host floats.
// The plan: G lanes per coordinate (a power of two <= 32); reg_rows in
// {1, 2, 4, 8} with ceil(m/G) <= reg_rows, or 0 to read the rows from the
// staged slab (use_smem) or device memory.
// Returns a cudaError_t as int: 0 on a successful launch.
extern "C" int ostat_launch(const float* vals, const float* scale,
                            float* out0, float* out1, float* out2, int nb,
                            int m, int p, int op, int kth_k, int g,
                            int n_bisect, int K, const float* delta,
                            const float* mk, float denom, int G,
                            int reg_rows, int use_smem, void* stream) {
  if (nb <= 0 || m <= 0 || p <= 0 || K < 0 || K > kMaxK ||
      G < 1 || G > 32 || (G & (G - 1)) ||
      (reg_rows > 0 && (m + G - 1) / G > reg_rows) ||
      (reg_rows > 0 && use_smem))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_coord = static_cast<long long>(nb) * p;
  const int per_block = kThreads / G;
  const long long grid = (n_coord + per_block - 1) / per_block;
  if (n_coord > INT_MAX || grid > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = 0;
  if (use_smem) {
    smem = static_cast<size_t>(m) * per_block * sizeof(float);
    if (smem > static_cast<size_t>(kMaxSmem))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const CqConst cq = make_cq(K, delta, mk, denom);
  const Args a{vals, scale, out0, out1, out2, static_cast<int>(n_coord), m,
               p, G, use_smem, kth_k, g, n_bisect};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int gr = static_cast<int>(grid);
  switch (op) {
    case kMean: return launch_rows<kMean>(reg_rows, gr, smem, s, a, cq);
    case kMedian: return launch_rows<kMedian>(reg_rows, gr, smem, s, a, cq);
    case kKth: return launch_rows<kKth>(reg_rows, gr, smem, s, a, cq);
    case kTrimmed:
      return launch_rows<kTrimmed>(reg_rows, gr, smem, s, a, cq);
    case kDcq: return launch_rows<kDcq>(reg_rows, gr, smem, s, a, cq);
    case kDcqMad: return launch_rows<kDcqMad>(reg_rows, gr, smem, s, a, cq);
    case kMedMadDcq:
      return launch_rows<kMedMadDcq>(reg_rows, gr, smem, s, a, cq);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The small-m path: values (nb, m, p) contiguous in `dtype` (kF32, kBF16,
// kF16), m <= 8, op one of kMedian, kKth, kDcq, kDcqMad, kMedMadDcq; scale
// (nb, p) f32 for op kDcq, else null; out0 (and out1/out2 for kMedMadDcq)
// (nb, p) in `dtype`. vec: p % 4 == 0 and `vals` aligned to 4 elements.
// replays: a device counter that gains the coordinates whose search was
// replayed. Returns a cudaError_t as int: 0 on a successful launch.
extern "C" int ostat_small_launch(const void* vals, const float* scale,
                                  void* out0, void* out1, void* out2,
                                  unsigned long long* replays, int nb,
                                  int m, int p, int dtype, int op,
                                  int kth_k, int n_bisect, int K,
                                  const float* delta, const float* mk,
                                  float denom, int vec, void* stream) {
  const bool sel = op == kKth || op == kMedian;
  if (nb <= 0 || m <= 0 || m > kSmallM || p <= 0 || K < 0 || K > kMaxK ||
      n_bisect < 0 || !replays ||
      !(sel || op == kDcq || op == kDcqMad || op == kMedMadDcq) ||
      (op == kKth && (kth_k < 0 || kth_k >= m)) ||
      (op == kDcq && !scale) || (vec && p % kV))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_coord = static_cast<long long>(nb) * p;
  if (n_coord > INT_MAX - kV * kSmallThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(
      (n_coord + kV * kSmallThreads - 1) / (kV * kSmallThreads));
  const CqConst cq = make_cq(K, delta, mk, denom);
  const SmallArgs a{vals, scale, out0, out1, out2, replays,
                    static_cast<int>(n_coord), nb, m, p, op, kth_k,
                    n_bisect, vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = m <= 4 ? 4 : 8;
  return static_cast<int>(
      sel ? launch_small_dt<0>(dtype, R, grid, s, a, cq)
          : launch_small_dt<1>(dtype, R, grid, s, a, cq));
}
