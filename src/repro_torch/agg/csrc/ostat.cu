// Batched order-statistics aggregation over the machine axis, for Hopper
// (sm_90a). One kernel, templated on the op, computes every coordinate-wise
// rule of repro_torch.agg: mean, k-th order statistic, median, trimmed mean,
// DCQ with a supplied scale, MAD-scaled DCQ, and the fused median+MAD+DCQ.
//
// Replaces src/repro/agg/kernel.py:_ostat_kernel, the Pallas TPU kernel
// entered through ostat_pallas. It keeps that kernel's algorithm and
// arithmetic, not its blocking: order statistics come from bisection on the
// value range with rank counts, at most n_bisect fp32 halvings, returning
// the upper bracket; the trimmed mean is recovered from masked sums with the
// exact tie correction; the composite-quantile (CQ) correction counts ranks
// at K thresholds med + scale * Delta_k.
//
// What bounds it on an H100. The bisection is a chain of dependent steps,
// each a count over the m machine rows followed by a branch. At the paper's
// shapes (20 x 51 x 10: 200 coordinates) the card has room for 270,000
// threads and the work is a few thousand compares, so the chain's latency
// is the whole cost; at the gradient shape (1 x 8 x 262144) the card is
// full and the compares themselves are. The design serves both:
//  * Lane groups. G lanes (a power of two <= 32, chosen by the wrapper)
//    own one coordinate. Lane s of a group holds rows s, s + G, s + 2G,
//    ...; where they fit (ceil(m/G) <= 8, the template R) they sit in
//    registers, padded with NaN, which no count sees (NaN <= t is false).
//    Otherwise the block's columns are staged once in shared memory (one
//    column per group, contiguous, so a group's lanes read neighbouring
//    words), and past 227 KB read through L1/L2. Each step counts on the
//    lane's own rows and sums the counts over the group: one redux.sync
//    (__reduce_add_sync) for G = 32, a chain of log2 G shuffles below.
//    Every lane sees the same sums and so keeps the same (lo, hi). Counts
//    taken together (the two searches of an even-m median, three CQ knots)
//    are packed into one word (10 bits each, m < 1024) and summed by one
//    reduction. The wrapper gives m <= 8 one lane (no reduction at all)
//    and larger m a full warp where the card has the threads.
//  * Stop at the fixed point. A halving maps (lo, hi) to a new (lo, hi)
//    deterministically; once a step leaves both bit-identical, every later
//    step does too, so stopping there returns the bits of all n_bisect
//    steps. The exit is voted over the warp (__all_sync), since groups of
//    one warp share its shuffles. On random data the search pins the value
//    in about 25-35 steps instead of 60.
// A two-level pass (counting at the midpoint and at both next-level
// midpoints, half the dependent steps for 1.5x the compares) paid on the
// card only for groups of 4-16 lanes on a nearly idle card, a layout the
// wrapper never picks, and is not built.
// Rank counts are integers, so summing them over lanes in another order
// changes nothing: kth, median and the CQ indicator counts are bit-equal to
// the one-thread search of the plain version. min/max are exact in any
// order. The sums of mean and trimmed are taken per lane and then over the
// group's butterfly, an order the plain version does not share (within
// 1e-5 of max(1, |ref|) at the 99.9th percentile).
//
// Why kth took about twice median's time at odd m in the earlier
// one-thread-per-coordinate design (0.0677 against 0.0366 ms at 20 x 51 x
// 10 on an H100) was not found: both ran the same 60 steps over the same
// slab. This design shows no such gap: kth and median share one search
// with the fixed-point exit, and chip_smoke.py phase 3 times them side by
// side.
//
// No FMA contraction where bits matter: nvcc contracts a*b+c into an FMA by
// default, which would move CQ thresholds (med + scale*delta), the MAD scale
// (1.4826*mad + 1e-12) and the trimmed tie correction by an ulp and flip
// indicators against the reference. Every such site is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts; the file is built with the default --fmad.
//
// Plain C interface (ostat_launch), loaded with ctypes by
// repro_torch/agg/kernel.py, which plans the launch (G, register rows,
// slab); it launches on the given stream and returns
// cudaGetLastError().

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
  CqConst cq;
  cq.K = K;
  cq.denom = denom;
  for (int k = 0; k < K; ++k) {
    cq.delta[k] = delta[k];
    cq.mk[k] = mk[k];
  }
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
