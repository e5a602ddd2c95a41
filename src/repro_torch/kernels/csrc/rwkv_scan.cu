// RWKV-6 linear recurrence with the u bonus, over a whole sequence.
//
// Replaces the TPU kernel src/repro/kernels/rwkv_scan.py::rwkv_scan_pallas
// (body _rwkv_kernel). It computes the same function, the step recurrence of
// src/repro/models/ssm.py::reference_scan in the u-form: per (batch, head),
// with the (K, V) state S starting at zero,
//
//     y_t = r_t . (S + diag(u) k_t v_t^T)       S <- diag(w_t) S + k_t v_t^T
//
// and returns every y_t and the final S, both in float32.
//
// Design. One CTA owns one (batch, head). It keeps the (K, V) state in
// shared memory and walks the sequence in chunks of kChunk = 16 tokens. Per
// chunk, with L_t = sum_{s<=t} log2 w_s taken inside the chunk:
//
//     y_t   = (r_t * 2^L_{t-1}) . S_in                           carry-in
//           + sum_{j<t} [sum_k r_t k_j 2^(L_{t-1} - L_j)] v_j     intra-chunk
//           + [sum_k r_t u k_t] v_t                               bonus
//     S_out = diag(2^L_last) S_in + sum_j diag(2^(L_last - L_j)) k_j v_j^T
//
// Every exponent above is <= 0, so no decay factor can overflow, whatever
// the decays. The TPU kernel instead divides by the running product
// P_t = prod w over a 64-token chunk (k / P), which leaves float32 range once
// w is small (0.066^33 < 1e-38 at the model's least decay exp(-e)); the
// pairwise differences in log space here avoid that division altogether.
// A decay below 1e-30 is taken as 1e-30, as in the reference's chunked form.
// Padding tokens past T have r = k = v = 0 and w = 1.
//
// Bound on an H100: at the prefill shape the bytes (r, k, v, w read once,
// y written once) and the float32 operations (about 4 K V per token and head
// plus the intra-chunk terms) both come to about 0.1 ms. This version runs
// float32 FMA in the SM's cores, no tensor cores, and is about 12x off that
// bound (PERF.md): each chunk is a chain of dependent steps between
// barriers, and the intra-chunk weights take one exponential per pair and
// channel. Each thread loads the next chunk's inputs into registers while
// the current chunk computes, and shared memory is read in 16-byte loads
// where a warp reads along a row. Computing the whole head in one CTA does
// the intra-chunk weights once per head; splitting the state's columns
// across CTAs, which repeats them, measured slower. Making it fast (wgmma on
// the chunk products, TMA and a deeper pipeline of chunks) is later work.
//
// The file includes no PyTorch header: the binding in binding.cpp calls
// rwkv_scan_launch below.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 16;     // tokens per chunk
constexpr int kThreads = 256;  // = kChunk * kChunk: one intra-chunk pair each

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename In> __device__ __forceinline__ In zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.0f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// r, k: (B, T, H, K); v: (B, T, H, K) (V == K); w: (B, T, H, K) float32;
// u: (H, K) float32; y: (B, T, H, K) float32; s_out: (B, H, K, K) float32.
// Grid: B * H; block: kThreads.
// The launch bound asks for only one resident CTA per SM (the prefill's grid
// has 80 CTAs for 132 SMs), which lets the compiler give each thread more
// registers: 14% faster at the prefill shape than the default bound.
template <typename In, int K>
__global__ void __launch_bounds__(kThreads, 1)
rwkv_scan_kernel(const In* __restrict__ r, const In* __restrict__ k,
                 const In* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, float* __restrict__ y,
                 float* __restrict__ s_out, int T, int H) {
  constexpr int V = K;
  constexpr int kRowsPerPass = kThreads / V;           // state rows per pass
  constexpr int kLoads = kChunk * K / kThreads;        // per thread and chunk
  constexpr int kTokensPerThread = kChunk / kRowsPerPass;  // in step (d)
  static_assert(kLoads * kThreads == kChunk * K && kChunk % kRowsPerPass == 0,
                "unsupported head size");

  // Shared memory is read four floats at a time wherever a warp reads along
  // a row. Rows of r, k, L and a are padded by four floats: the intra-chunk
  // pairs read 16 rows at once, and with the pad each quarter-warp's 16-byte
  // loads fall in distinct banks. b is stored transposed, so that the state
  // update reads a row of it.
  __shared__ __align__(16) float r_s[kChunk][K + 4];
  __shared__ __align__(16) float k_s[kChunk][K + 4];
  __shared__ __align__(16) float L_s[kChunk][K + 4];  // log2 w, then cumsum
  __shared__ __align__(16) float v_s[kChunk][V];
  __shared__ __align__(16) float a_s[kChunk][K + 4];  // r_t * 2^L_{t-1}
  __shared__ __align__(16) float bT_s[K][kChunk + 4];  // k_j * 2^(L_last - L_j)
  __shared__ __align__(16) float att[kChunk][kChunk];
  __shared__ __align__(16) float S[K][V];
  __shared__ __align__(16) float u_s[K];
  __shared__ float decay_s[K];                        // 2^L_last

  const int bh = blockIdx.x;             // b * H + h
  const int h = bh % H;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int col = tid % V;               // this thread's state column
  const int row0 = tid / V;

  // element (b, t, h, c) of a (B, T, H, K) tensor
  auto at = [&](int t, int c) -> int64_t {
    return ((static_cast<int64_t>(b) * T + t) * H + h) * K + c;
  };
  const int64_t state_base = static_cast<int64_t>(bh) * K * V;

  for (int kk = row0; kk < K; kk += kRowsPerPass) S[kk][col] = 0.0f;
  if (tid < K) u_s[tid] = u[static_cast<int64_t>(h) * K + tid];

  // A chunk's inputs, as loaded, zero past the end (w = 1 there). The next
  // chunk's loads are issued right after this chunk's inputs reach shared
  // memory, so they are in flight while this chunk computes; nothing reads
  // these registers until the next chunk's step (a).
  In r_n[kLoads], k_n[kLoads], v_n[kLoads];
  float w_n[kLoads];
  auto fetch = [&](int c0) {
    const int n = T - c0;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, t = i / K, c = i % K;
      r_n[j] = zero<In>();
      k_n[j] = zero<In>();
      v_n[j] = zero<In>();
      w_n[j] = 1.0f;
      if (t < n) {
        r_n[j] = r[at(c0 + t, c)];
        k_n[j] = k[at(c0 + t, c)];
        v_n[j] = v[at(c0 + t, c)];
        w_n[j] = w[at(c0 + t, c)];
      }
    }
  };
  fetch(0);

  for (int c0 = 0; c0 < T; c0 += kChunk) {
    const int n = min(kChunk, T - c0);

    // (a) the chunk's inputs into shared memory, then the next chunk's loads
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int i = tid + j * kThreads, t = i / K, c = i % K;
      r_s[t][c] = to_float(r_n[j]);
      k_s[t][c] = to_float(k_n[j]);
      v_s[t][c] = to_float(v_n[j]);
      L_s[t][c] = log2f(fmaxf(w_n[j], 1e-30f));
    }
    __syncthreads();
    if (c0 + kChunk < T) fetch(c0 + kChunk);

    // (b) inclusive cumulative log2 decay along the chunk
    if (tid < K) {
      float acc = 0.0f;
#pragma unroll
      for (int t = 0; t < kChunk; ++t) {
        acc += L_s[t][tid];
        L_s[t][tid] = acc;
      }
      decay_s[tid] = exp2f(acc);
    }
    __syncthreads();

    // (c) decayed readouts and writes, and the intra-chunk weights
#pragma unroll
    for (int i = tid; i < kChunk * K; i += kThreads) {
      const int t = i / K, c = i % K;
      const float l_prev = t ? L_s[t - 1][c] : 0.0f;
      a_s[t][c] = r_s[t][c] * exp2f(l_prev);
    }
#pragma unroll
    for (int i = tid; i < kChunk * K; i += kThreads) {
      const int c = i / kChunk, t = i % kChunk;
      bT_s[c][t] = k_s[t][c] * exp2f(L_s[kChunk - 1][c] - L_s[t][c]);
    }
    {
      const int t = tid / kChunk, j = tid % kChunk;
      float acc = 0.0f;
      if (j < t) {
#pragma unroll 4
        for (int c = 0; c < K; c += 4) {
          const float4 rt = *reinterpret_cast<const float4*>(&r_s[t][c]);
          const float4 kj = *reinterpret_cast<const float4*>(&k_s[j][c]);
          const float4 lt = *reinterpret_cast<const float4*>(&L_s[t - 1][c]);
          const float4 lj = *reinterpret_cast<const float4*>(&L_s[j][c]);
          acc += rt.x * kj.x * exp2f(lt.x - lj.x);
          acc += rt.y * kj.y * exp2f(lt.y - lj.y);
          acc += rt.z * kj.z * exp2f(lt.z - lj.z);
          acc += rt.w * kj.w * exp2f(lt.w - lj.w);
        }
      } else if (j == t) {
#pragma unroll 4
        for (int c = 0; c < K; c += 4) {
          const float4 rt = *reinterpret_cast<const float4*>(&r_s[t][c]);
          const float4 kt = *reinterpret_cast<const float4*>(&k_s[t][c]);
          const float4 uc = *reinterpret_cast<const float4*>(&u_s[c]);
          acc += rt.x * uc.x * kt.x + rt.y * uc.y * kt.y +
                 rt.z * uc.z * kt.z + rt.w * uc.w * kt.w;
        }
      }
      att[t][j] = acc;
    }
    __syncthreads();

    // (d) outputs: tokens row0, row0 + kRowsPerPass, ... of the chunk,
    // column col
    {
      float acc[kTokensPerThread];
#pragma unroll
      for (int m = 0; m < kTokensPerThread; ++m) acc[m] = 0.0f;
#pragma unroll 4
      for (int c = 0; c < K; c += 4) {
        const float s0c = S[c][col], s1c = S[c + 1][col];
        const float s2c = S[c + 2][col], s3c = S[c + 3][col];
#pragma unroll
        for (int m = 0; m < kTokensPerThread; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(
              &a_s[row0 + m * kRowsPerPass][c]);
          acc[m] += a.x * s0c + a.y * s1c + a.z * s2c + a.w * s3c;
        }
      }
#pragma unroll
      for (int j = 0; j < kChunk; j += 4) {  // att is zero above the diagonal
        const float v0j = v_s[j][col], v1j = v_s[j + 1][col];
        const float v2j = v_s[j + 2][col], v3j = v_s[j + 3][col];
#pragma unroll
        for (int m = 0; m < kTokensPerThread; ++m) {
          const float4 a = *reinterpret_cast<const float4*>(
              &att[row0 + m * kRowsPerPass][j]);
          acc[m] += a.x * v0j + a.y * v1j + a.z * v2j + a.w * v3j;
        }
      }
#pragma unroll
      for (int m = 0; m < kTokensPerThread; ++m) {
        const int t = row0 + m * kRowsPerPass;
        if (t < n) y[at(c0 + t, col)] = acc[m];
      }
    }
    __syncthreads();

    // (e) the state at the end of the chunk
    {
      float vj[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) vj[j] = v_s[j][col];
      for (int kk = row0; kk < K; kk += kRowsPerPass) {
        float acc = decay_s[kk] * S[kk][col];
#pragma unroll
        for (int j = 0; j < kChunk; j += 4) {
          const float4 bk = *reinterpret_cast<const float4*>(&bT_s[kk][j]);
          acc += bk.x * vj[j] + bk.y * vj[j + 1] + bk.z * vj[j + 2] +
                 bk.w * vj[j + 3];
        }
        S[kk][col] = acc;
      }
    }
    __syncthreads();
  }

  for (int kk = row0; kk < K; kk += kRowsPerPass) {
    s_out[state_base + static_cast<int64_t>(kk) * V + col] = S[kk][col];
  }
}

static_assert(kThreads == kChunk * kChunk, "one intra-chunk pair per thread");

template <typename In, int K>
void launch(const void* r, const void* k, const void* v, const float* w,
            const float* u, float* y, float* s_out, int B, int T, int H,
            cudaStream_t stream) {
  rwkv_scan_kernel<In, K><<<static_cast<unsigned int>(B) * H, kThreads, 0,
                             stream>>>(
      static_cast<const In*>(r), static_cast<const In*>(k),
      static_cast<const In*>(v), w, u, y, s_out, T, H);
}

}  // namespace

// Enqueues the scan; the caller has checked the shapes (head size K = V of
// 32 or 64, B, T, H >= 1, contiguous tensors) and checks cudaGetLastError().
// r, k, v are bfloat16 when bf16 is true, else float32. Returns false,
// launching nothing, for a head size it has no kernel for.
bool rwkv_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, float* y, float* s_out,
                      int B, int T, int H, int K, bool bf16,
                      cudaStream_t stream) {
  if (K == 64) {
    if (bf16) launch<__nv_bfloat16, 64>(r, k, v, w, u, y, s_out, B, T, H, stream);
    else launch<float, 64>(r, k, v, w, u, y, s_out, B, T, H, stream);
    return true;
  }
  if (K == 32) {
    if (bf16) launch<__nv_bfloat16, 32>(r, k, v, w, u, y, s_out, B, T, H, stream);
    else launch<float, 32>(r, k, v, w, u, y, s_out, B, T, H, stream);
    return true;
  }
  return false;
}
