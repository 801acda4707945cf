// Batched order-statistics aggregation over the machine axis, for Hopper
// (sm_90a). One kernel, templated on the op, computes every coordinate-wise
// rule of repro_torch.agg: mean, k-th order statistic, median, trimmed mean,
// DCQ with a supplied scale, MAD-scaled DCQ, and the fused median+MAD+DCQ.
//
// Replaces src/repro/agg/kernel.py:_ostat_kernel, the Pallas TPU kernel
// entered through ostat_pallas. It keeps that kernel's algorithm and
// arithmetic, not its blocking: order statistics come from bisection on the
// value range with rank counts, n_bisect fp32 halvings, returning the upper
// bracket; the trimmed mean is recovered from masked sums with the exact tie
// correction; the composite-quantile (CQ) correction counts ranks at K
// thresholds med + scale * Delta_k.
//
// Layout: values (B, m, p) f32, p contiguous; outputs (B, p) f32. One thread
// owns one coordinate of one batch row and walks the m machine rows; a block
// covers up to 128 neighbouring coordinates of one batch row, so neighbouring
// threads read neighbouring addresses. The grid is flat, batch row x
// coordinate block, and threads past p exit (the ragged edge that the TPU
// padded with zeros and a scale of 1.0). Where the block's (m, threads)
// slab fits in the 227 KB of shared memory it is staged there once and
// re-read from there by every bisection step; where it does not (m in the
// thousands) the columns are re-read from global memory through L1/L2.
// Every thread touches only its own column of the slab, so no barrier is
// needed.
//
// What bounds it on an H100:
//  * At the paper's shape (B=20, m=51, p=10) the whole call is 20 blocks of
//    32 threads doing ~10^4 compares each: launch latency bounds it, and the
//    design does nothing about that beyond making the replicate axis one
//    launch instead of 20.
//  * At the gradient shape (1, 8, 262144) the kernel must read B*m*p*4 = 8 MB
//    once (about 2.5 us at 3.35 TB/s) but does about n_bisect*m compares and
//    adds per coordinate and per search (two searches for an even-m median):
//    operations bound it. The design stages the slab in shared memory so the
//    device memory is read once, runs the two searches of an even-m median
//    (and the two brackets of the trimmed mean) in one pass over the rows,
//    and counts ranks in integers.
//
// No FMA contraction where bits matter: nvcc contracts a*b+c into an FMA by
// default, which would move CQ thresholds (med + scale*delta), the MAD scale
// (1.4826*mad + 1e-12) and the trimmed tie correction by an ulp and flip
// indicators against the reference. Every such site is written with the
// round-to-nearest intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn),
// which nvcc never contracts; the file is built with the default --fmad.
//
// Plain C interface (ostat_launch), loaded with ctypes by
// repro_torch/agg/kernel.py; it launches on the given stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kMaxK = 64;            // CQ knots carried by value
constexpr int kMaxThreads = 128;     // coordinates per block
constexpr int kMaxSmem = 232448;     // 227 KB of dynamic shared memory
constexpr int kDefaultSmem = 48 * 1024;

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

// One machine column: v(i) = col[i * stride]; with ABS the column is
// |v - center|, the MAD pass, formed on the fly.
template <bool ABS>
struct Column {
  const float* col;
  int stride;
  int m;
  float center;
  __device__ __forceinline__ float operator()(int i) const {
    const float v = col[static_cast<size_t>(i) * stride];
    return ABS ? fabsf(__fsub_rn(v, center)) : v;
  }
};

template <class C>
__device__ __forceinline__ void min_max(const C& c, float& lo, float& hi) {
  lo = c(0);
  hi = lo;
  for (int i = 1; i < c.m; ++i) {
    const float v = c(i);
    lo = fminf(lo, v);
    hi = fmaxf(hi, v);
  }
}

// The k_a-th (and, with TWO, the k_b-th) smallest value (0-indexed) by
// bisection: mid = 0.5*(lo+hi); go right while rank(mid) <= k; the result
// is the converged upper bracket hi. Two searches share one pass per step.
template <bool TWO, class C>
__device__ __forceinline__ void kth(const C& c, int ka, int kb, int n_bisect,
                                    float lo0, float hi0, float& out_a,
                                    float& out_b) {
  float lo_a = lo0, hi_a = hi0, lo_b = lo0, hi_b = hi0;
  for (int it = 0; it < n_bisect; ++it) {
    const float mid_a = __fmul_rn(0.5f, __fadd_rn(lo_a, hi_a));
    const float mid_b = TWO ? __fmul_rn(0.5f, __fadd_rn(lo_b, hi_b)) : 0.f;
    int cnt_a = 0, cnt_b = 0;
    for (int i = 0; i < c.m; ++i) {
      const float v = c(i);
      cnt_a += v <= mid_a;
      if (TWO) cnt_b += v <= mid_b;
    }
    if (cnt_a <= ka) lo_a = mid_a; else hi_a = mid_a;
    if (TWO) {
      if (cnt_b <= kb) lo_b = mid_b; else hi_b = mid_b;
    }
  }
  out_a = hi_a;
  out_b = hi_b;
}

template <class C>
__device__ __forceinline__ float median(const C& c, int n_bisect) {
  float lo, hi, a, b;
  min_max(c, lo, hi);
  if (c.m & 1) {
    kth<false>(c, (c.m - 1) / 2, 0, n_bisect, lo, hi, a, b);
    return a;
  }
  kth<true>(c, c.m / 2 - 1, c.m / 2, n_bisect, lo, hi, a, b);
  return __fmul_rn(0.5f, __fadd_rn(a, b));
}

__device__ __forceinline__ float mean(const Column<false>& c) {
  float s = 0.f;
  for (int i = 0; i < c.m; ++i) s = __fadd_rn(s, c(i));
  return __fdiv_rn(s, static_cast<float>(c.m));
}

// Beta-trimmed mean, g values dropped per side, without a sort:
// kept = [S(v<=t_hi) - (N(v<=t_hi) - (m-g)) t_hi]
//      - [S(v<=t_lo) - (N(v<=t_lo) - g) t_lo],   divided by m - 2g.
__device__ __forceinline__ float trimmed(const Column<false>& c, int g,
                                         int n_bisect) {
  if (g == 0) return mean(c);
  float lo, hi, t_lo, t_hi;
  min_max(c, lo, hi);
  kth<true>(c, g, c.m - 1 - g, n_bisect, lo, hi, t_lo, t_hi);
  float s_hi = 0.f, s_lo = 0.f;
  int n_hi = 0, n_lo = 0;
  for (int i = 0; i < c.m; ++i) {
    const float v = c(i);
    const float in_hi = v <= t_hi ? 1.f : 0.f;
    const float in_lo = v <= t_lo ? 1.f : 0.f;
    s_hi = __fadd_rn(s_hi, __fmul_rn(v, in_hi));
    s_lo = __fadd_rn(s_lo, __fmul_rn(v, in_lo));
    n_hi += v <= t_hi;
    n_lo += v <= t_lo;
  }
  const float top =
      __fsub_rn(s_hi, __fmul_rn(static_cast<float>(n_hi - (c.m - g)), t_hi));
  const float bot =
      __fsub_rn(s_lo, __fmul_rn(static_cast<float>(n_lo - g), t_lo));
  return __fdiv_rn(__fsub_rn(top, bot), static_cast<float>(c.m - 2 * g));
}

// med - scale * S / (m * psi_sum),
// S = sum_k sum_j [I(v_j <= med + scale * Delta_k) - kappa_k].
__device__ __forceinline__ float cq_correct(const Column<false>& c, float med,
                                            float scale, const CqConst& cq) {
  float s = 0.f;
  for (int k = 0; k < cq.K; ++k) {
    const float thr = __fadd_rn(med, __fmul_rn(scale, cq.delta[k]));
    int cnt = 0;
    for (int i = 0; i < c.m; ++i) cnt += c(i) <= thr;
    s = __fsub_rn(__fadd_rn(s, static_cast<float>(cnt)), cq.mk[k]);
  }
  return __fsub_rn(med, __fdiv_rn(__fmul_rn(scale, s), cq.denom));
}

template <int OP>
__global__ void ostat_kernel(const float* __restrict__ vals,
                             const float* __restrict__ scale,
                             float* __restrict__ out0,
                             float* __restrict__ out1,
                             float* __restrict__ out2, int m, int p,
                             int n_cblk, int kth_k, int g, int n_bisect,
                             int use_smem, CqConst cq) {
  extern __shared__ float slab[];
  const int b = blockIdx.x / n_cblk;
  const int c = (blockIdx.x % n_cblk) * blockDim.x + threadIdx.x;
  if (c >= p) return;

  const float* col = vals + static_cast<size_t>(b) * m * p + c;
  int stride = p;
  if (use_smem) {
    float* mine = slab + threadIdx.x;
    for (int i = 0; i < m; ++i)
      mine[i * blockDim.x] = col[static_cast<size_t>(i) * p];
    col = mine;
    stride = blockDim.x;
  }
  const Column<false> v{col, stride, m, 0.f};
  const size_t o = static_cast<size_t>(b) * p + c;

  if (OP == kMean) {
    out0[o] = mean(v);
  } else if (OP == kKth) {
    float lo, hi, r, unused;
    min_max(v, lo, hi);
    kth<false>(v, kth_k, 0, n_bisect, lo, hi, r, unused);
    out0[o] = r;
  } else if (OP == kMedian) {
    out0[o] = median(v, n_bisect);
  } else if (OP == kTrimmed) {
    out0[o] = trimmed(v, g, n_bisect);
  } else if (OP == kDcq) {
    const float med = median(v, n_bisect);
    out0[o] = cq_correct(v, med, scale[o], cq);
  } else {  // kDcqMad, kMedMadDcq
    const float med = median(v, n_bisect);
    const Column<true> dev{col, stride, m, med};
    const float mad = median(dev, n_bisect);
    const float sc = __fadd_rn(__fmul_rn(1.4826f, mad), 1e-12f);
    const float dcq = cq_correct(v, med, sc, cq);
    if (OP == kDcqMad) {
      out0[o] = dcq;
    } else {
      out0[o] = med;
      out1[o] = mad;
      out2[o] = dcq;
    }
  }
}

template <int OP>
cudaError_t launch(int grid, int threads, size_t smem, cudaStream_t stream,
                   const float* vals, const float* scale, float* out0,
                   float* out1, float* out2, int m, int p, int n_cblk,
                   int kth_k, int g, int n_bisect, int use_smem,
                   const CqConst& cq) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        ostat_kernel<OP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  ostat_kernel<OP><<<grid, threads, smem, stream>>>(
      vals, scale, out0, out1, out2, m, p, n_cblk, kth_k, g, n_bisect,
      use_smem, cq);
  return cudaGetLastError();
}

}  // namespace

// values (nb, m, p) f32 contiguous; scale (nb, p) for op kDcq, else null;
// out0 (and out1/out2 for kMedMadDcq) (nb, p) f32. delta/mk: K host floats.
// Returns a cudaError_t as int: 0 on a successful launch.
extern "C" int ostat_launch(const float* vals, const float* scale,
                            float* out0, float* out1, float* out2, int nb,
                            int m, int p, int op, int kth_k, int g,
                            int n_bisect, int K, const float* delta,
                            const float* mk, float denom, void* stream) {
  if (nb <= 0 || m <= 0 || p <= 0 || K < 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  CqConst cq;
  cq.K = K;
  cq.denom = denom;
  for (int k = 0; k < K; ++k) {
    cq.delta[k] = delta[k];
    cq.mk[k] = mk[k];
  }
  const int threads = p < kMaxThreads ? (p + 31) / 32 * 32 : kMaxThreads;
  const int n_cblk = (p + threads - 1) / threads;
  const long long grid = static_cast<long long>(nb) * n_cblk;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  size_t smem = static_cast<size_t>(m) * threads * sizeof(float);
  const int use_smem = smem <= static_cast<size_t>(kMaxSmem);
  if (!use_smem) smem = 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
#define OSTAT_CASE(OPC)                                                     \
  case OPC:                                                                 \
    err = launch<OPC>(static_cast<int>(grid), threads, smem, s, vals,       \
                      scale, out0, out1, out2, m, p, n_cblk, kth_k, g,      \
                      n_bisect, use_smem, cq);                              \
    break;
  switch (op) {
    OSTAT_CASE(kMean)
    OSTAT_CASE(kMedian)
    OSTAT_CASE(kKth)
    OSTAT_CASE(kTrimmed)
    OSTAT_CASE(kDcq)
    OSTAT_CASE(kDcqMad)
    OSTAT_CASE(kMedMadDcq)
    default:
      err = cudaErrorInvalidValue;
  }
#undef OSTAT_CASE
  return static_cast<int>(err);
}
