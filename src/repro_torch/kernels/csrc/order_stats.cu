// Per-row m-th smallest element of a row-major (rows, n) block.
//
// Replaces the TPU kernel src/repro/kernels/order_stats.py::mth_smallest_pallas
// (body _mth_smallest_kernel -> _extract_mth) and the fused XLA selections the
// reference scan runs by default (mth_smallest_iterative / _counting /
// _rowwise). It computes the same function, sort(x)[:, m-1] counting
// multiplicity, but not the same way: the TPU kernel holds the block in VMEM
// and removes the running minimum's tie class m times (O(m*n) work). Here one
// CTA owns one row and runs a radix select on the order-preserving unsigned
// key of each float: 8-bit digits from the top, 4 passes for float32 and 8 for
// float64. Each pass builds a 256-bin shared-memory histogram of the digit
// among the elements that still match the selected prefix, and a block-wide
// scan of the histogram picks the bin that holds the m-th element. The final
// prefix is the full key of the answer, so the result is an element of the
// row, bit for bit, and ties count with multiplicity.
//
// Bound on an H100: bytes. The least traffic is one read of the row (n
// elements) and one write; the passes after the first re-read the row, which
// stays in L2 at the main path's sizes. The work per element is a handful of
// integer operations, far below the card's rate. With one CTA per row, a
// block with few rows (S < 132) leaves most SMs idle; that is the known cost
// of this simple design.
//
// The comparisons are integer comparisons of keys, so there is no
// flush-to-zero question: subnormals and +inf (a worker that never finishes)
// order exactly as IEEE-754 does. Signed zeros compare equal and NaN sorts
// last, as in torch.sort (see to_key).
//
// The file includes no PyTorch header: the binding in binding.cpp
// calls the two launchers below.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;

// The key orders as torch.sort does: -0.0 takes the key of +0.0, and every
// NaN, whatever its sign and payload, takes the key of the canonical quiet
// NaN, which lies above the key of +inf. So a selected zero comes back as
// +0.0 and a selected NaN as the canonical quiet NaN.
__device__ __forceinline__ uint32_t to_key(float v) {
  uint32_t u = __float_as_uint(v);
  if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffc00000u;  // NaN
  if ((u << 1) == 0u) u = 0u;                                // -0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ uint64_t to_key(double v) {
  uint64_t u = static_cast<uint64_t>(__double_as_longlong(v));
  if ((u & 0x7fffffffffffffffull) > 0x7ff0000000000000ull)  // NaN
    return 0xfff8000000000000ull;
  if ((u << 1) == 0ull) u = 0ull;                            // -0.0
  return (u & 0x8000000000000000ull) ? ~u : (u | 0x8000000000000000ull);
}

__device__ __forceinline__ float from_key(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k ^ 0x80000000u) : ~k;
  return __uint_as_float(u);
}

__device__ __forceinline__ double from_key(uint64_t k) {
  uint64_t u = (k & 0x8000000000000000ull) ? (k ^ 0x8000000000000000ull) : ~k;
  return __longlong_as_double(static_cast<long long>(u));
}

// blockDim.x is a multiple of 32 and at least kRadix.
template <typename T, typename Key>
__global__ void mth_smallest_kernel(const T* __restrict__ x, int64_t n,
                                    int64_t m, T* __restrict__ out) {
  constexpr int kBits = 8 * sizeof(Key);
  __shared__ unsigned int hist[kRadix];
  __shared__ unsigned int warp_total[kRadix / 32];
  __shared__ Key sel_prefix;
  __shared__ unsigned int sel_rank;

  const T* row = x + static_cast<int64_t>(blockIdx.x) * n;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  Key prefix = 0;  // selected high digits of the answer's key
  Key mask = 0;    // which bits of the key the prefix fixes
  // rank of the answer among the elements that match the prefix (1-based);
  // 1 <= m <= n <= 2^31 - 1 is checked by the wrapper
  unsigned int rank = static_cast<unsigned int>(m);

#pragma unroll 1
  for (int shift = kBits - kRadixBits; shift >= 0; shift -= kRadixBits) {
    for (int i = tid; i < kRadix; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int64_t i = tid; i < n; i += blockDim.x) {
      const Key key = to_key(row[i]);
      if ((key & mask) == prefix) {
        atomicAdd(&hist[static_cast<int>((key >> shift) & (kRadix - 1))], 1u);
      }
    }
    __syncthreads();

    // inclusive scan of the 256 bins over the first 256 threads
    unsigned int count = 0, incl = 0;
    if (tid < kRadix) {
      count = hist[tid];
      incl = count;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned int up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      if (lane == 31) warp_total[warp] = incl;
    }
    __syncthreads();
    if (tid < kRadix) {
      for (int w = 0; w < warp; ++w) incl += warp_total[w];
      const unsigned int excl = incl - count;
      // exactly one bin holds the rank-th matching element
      if (excl < rank && rank <= incl) {
        sel_prefix = prefix | (static_cast<Key>(tid) << shift);
        sel_rank = rank - excl;
      }
    }
    __syncthreads();
    prefix = sel_prefix;
    rank = sel_rank;
    mask |= static_cast<Key>(kRadix - 1) << shift;
    // hist is next written after this point and was last read before the
    // barrier above; sel_* are next written after two more barriers
  }
  if (tid == 0) out[blockIdx.x] = from_key(prefix);
}

template <typename T, typename Key>
void launch(const T* x, int64_t rows, int64_t n, int64_t m, T* out,
            cudaStream_t stream) {
  // wide rows get more threads per CTA; the radix scan needs >= 256
  const int threads = n >= 8192 ? 1024 : 256;
  mth_smallest_kernel<T, Key><<<static_cast<unsigned int>(rows), threads, 0,
                                stream>>>(x, n, m, out);
}

}  // namespace

// The launchers only enqueue; the caller checks cudaGetLastError().
void mth_smallest_launch_f32(const float* x, int64_t rows, int64_t n, int64_t m,
                             float* out, cudaStream_t stream) {
  launch<float, uint32_t>(x, rows, n, m, out, stream);
}

void mth_smallest_launch_f64(const double* x, int64_t rows, int64_t n,
                             int64_t m, double* out, cudaStream_t stream) {
  launch<double, uint64_t>(x, rows, n, m, out, stream);
}
