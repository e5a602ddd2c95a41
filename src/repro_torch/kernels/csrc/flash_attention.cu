// Flash attention forward for Hopper (sm_90a): the port of
// src/repro/kernels/flash_attention.py::flash_attention_pallas (body
// _attn_kernel), called by src/repro_torch/kernels/flash_attention.py.
//
// q (B, Sq, H, D) and k, v (B, Sk, KV, D), bfloat16 or float32, read in
// place through their batch, sequence and head strides (the head dimension
// is contiguous); o (B, Sq, H, D) contiguous, in q's type. Query head h
// reads key/value head h / (H / KV): grouped-query attention by index,
// with no repeated K/V in memory.
//
// What bounds it: operations. A causal prefill of llama3.2-3b (B=2,
// S=4096, 24 heads of 128) is 2.06e11 flops a layer over 134 MB of
// inputs and output, some 1500 flops a byte. This first version does its
// arithmetic as scalar float32 FMAs (no tensor cores), so its bound is the
// card's float32 rate; the tensor-core redesign (wgmma, TMA, warp
// specialisation) is later work.
//
// Design. One CTA of 128 threads owns a (64-row query tile, head, batch);
// the CTAs of the longest causal rows start first. The scaled query tile
// sits in shared memory as float32 for the whole run. Each 64-key tile of
// K, then of V, is converted to float32 into one shared buffer, 16 bytes a
// load where every row starts 16-byte aligned (as the model's do). Thread
// (rg, cg) = (tid / 8, tid % 8) owns query rows rg + 16 i (i < 4): it
// computes the scores of those rows against keys cg + 8 j (j < 8), takes
// the row max and sum over the 8 threads of its row group by warp
// shuffles, and keeps the output columns of chunks cg*4 + 32 c of those
// rows in registers. The online softmax is the TPU kernel's: the running
// max m, sum l and accumulator are float32, masked scores are -1e30 and
// their weights 0, and the output is acc / max(l, 1e-30), so a row with no
// valid key is zero. Scores are kept in base-2 units (q is scaled by
// log2(e) / sqrt(D)) so each weight is one exp2. Key tiles wholly above
// the diagonal or before the window are never loaded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr int PAD = 4;        // floats of padding per shared row
constexpr float NEG = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int64_t q_sb, q_ss, q_sh;  // strides in elements: batch, sequence, head
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int Sq, Sk, H, group;
  int causal;
  int window;        // <= 0: no window
  int vec;           // every row of q, k, v starts 16-byte aligned
  float q_scale;     // log2(e) / sqrt(D)
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void unpack(const uint4& u, float* x, float) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float* x, __nv_bfloat16) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bfloat16 is the high half of a float32
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Rows [r0, r0 + 64) of a (rows, D) slice with row stride `stride`, times
// `mul`, into `dst` (row stride D + PAD) as float32; rows past the end are 0.
// With `vec`, every row starts 16-byte aligned and is read 16 bytes a load.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t stride, int r0,
                                          int rows, float mul, bool vec) {
  if (vec) {
    constexpr int V = 16 / sizeof(T);  // elements per load
    for (int i = threadIdx.x; i < 64 * D / V; i += THREADS) {
      const int r = i / (D / V), c = i % (D / V) * V;
      float x[V];
      if (r0 + r < rows) {
        unpack(*reinterpret_cast<const uint4*>(src + (int64_t)(r0 + r) * stride + c), x, T());
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < V; e += 4)
        *reinterpret_cast<float4*>(dst + r * (D + PAD) + c + e) =
            make_float4(x[e] * mul, x[e + 1] * mul, x[e + 2] * mul, x[e + 3] * mul);
    }
    return;
  }
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    float x = 0.f;
    if (r0 + r < rows) x = to_f32(src[(int64_t)(r0 + r) * stride + c]) * mul;
    dst[r * (D + PAD) + c] = x;
  }
}

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ void fma4(float4& a, float s, const float4& b) {
  a.x = fmaf(s, b.x, a.x);
  a.y = fmaf(s, b.y, a.y);
  a.z = fmaf(s, b.z, a.z);
  a.w = fmaf(s, b.w, a.w);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_attention_kernel(Params p) {
  constexpr int LD = D + PAD;   // row stride of the Q and K/V tiles
  constexpr int LP = BQ + PAD;  // row stride of P transposed
  constexpr int NC = D / 32;    // float4 output chunks per thread and row
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // BQ x LD
  float* kv = qs + BQ * LD;                     // BK x LD: K, then V
  float* pt = kv + BK * LD;                     // BK x LP: P[row][key] at [key][slot]

  const int nq = (p.Sq + BQ - 1) / BQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / p.group;
  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + kh * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + kh * p.v_sh;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg + 16 i; their P slots rg * 4 + i
  const int cg = tid & 7;   // keys cg + 8 j; output columns cg * 4 + 32 c

  load_tile<T, D>(qs, qg, p.q_ss, q0, p.Sq, p.q_scale, p.vec);

  // keys any row of this tile may see: [k_lo, k_hi)
  int k_hi = p.Sk, k_lo = 0;
  if (p.causal) k_hi = min(k_hi, q0 + BQ);
  if (p.window > 0) k_lo = max(0, q0 - p.window + 1);
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;

  float m[4], l[4];
  float4 acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the last tile's P.V is done with kv and pt
    load_tile<T, D>(kv, kg, p.k_ss, k0, p.Sk, 1.f, p.vec);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kk[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(qs + (rg + 16 * i) * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kk[j] = *reinterpret_cast<const float4*>(kv + (cg + 8 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          float a = s[i][j];
          a = fmaf(qv[i].x, kk[j].x, a);
          a = fmaf(qv[i].y, kk[j].y, a);
          a = fmaf(qv[i].z, kk[j].z, a);
          a = fmaf(qv[i].w, kk[j].w, a);
          s[i][j] = a;
        }
    }

    // mask, then the online-softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + rg + 16 * i;
      unsigned ok = 0;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + cg + 8 * j;
        bool valid = kj < p.Sk;
        if (p.causal) valid = valid && kj <= qi;
        if (p.window > 0) valid = valid && kj > qi - p.window;
        ok |= (unsigned)valid << j;
        if (valid) mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = exp2f(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = ((ok >> j) & 1u) ? exp2f(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        acc[i][c].x *= alpha;
        acc[i][c].y *= alpha;
        acc[i][c].z *= alpha;
        acc[i][c].w *= alpha;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(pt + (cg + 8 * j) * LP + rg * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);

    __syncthreads();  // every thread is done with K, and P is written
    load_tile<T, D>(kv, vg, p.v_ss, k0, p.Sk, 1.f, p.vec);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 pr = *reinterpret_cast<const float4*>(pt + j * LP + rg * 4);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(kv + j * LD + c * 32 + cg * 4);
        fma4(acc[0][c], pr.x, vv);
        fma4(acc[1][c], pr.y, vv);
        fma4(acc[2][c], pr.z, vv);
        fma4(acc[3][c], pr.w, vv);
      }
    }
  }

  T* og = static_cast<T*>(p.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + rg + 16 * i;
    if (qi >= p.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* row = og + ((int64_t)b * p.Sq + qi) * ((int64_t)p.H * D) + (int64_t)h * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      T* out = row + c * 32 + cg * 4;
      out[0] = from_f32<T>(acc[i][c].x / den);
      out[1] = from_f32<T>(acc[i][c].y / den);
      out[2] = from_f32<T>(acc[i][c].z / den);
      out[3] = from_f32<T>(acc[i][c].w / den);
    }
  }
}

template <typename T, int D>
void launch(const Params& p, int B, cudaStream_t stream) {
  constexpr int LD = D + PAD;
  const int smem = (int)sizeof(float) * (BQ * LD + BK * LD + BK * (BQ + PAD));
  cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, B);
  flash_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
}

template <typename T>
bool launch_head_size(const Params& p, int B, int D, cudaStream_t stream) {
  switch (D) {
    case 32: launch<T, 32>(p, B, stream); return true;
    case 64: launch<T, 64>(p, B, stream); return true;
    case 128: launch<T, 128>(p, B, stream); return true;
    default: return false;
  }
}

}  // namespace

// strides: q, k, v as (batch, sequence, head) in elements. Returns false,
// launching nothing, for a head size the kernel is not built for.
bool flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                            const int64_t* strides, int B, int Sq, int Sk, int H, int KV,
                            int D, bool causal, int window, bool bf16,
                            cudaStream_t stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.q_sb = strides[0], p.q_ss = strides[1], p.q_sh = strides[2];
  p.k_sb = strides[3], p.k_ss = strides[4], p.k_sh = strides[5];
  p.v_sb = strides[6], p.v_ss = strides[7], p.v_sh = strides[8];
  p.Sq = Sq;
  p.Sk = Sk;
  p.H = H;
  p.group = H / KV;
  p.causal = causal ? 1 : 0;
  p.window = window;
  const int64_t item = bf16 ? 2 : 4;
  bool vec = true;
  for (const void* ptr : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] * item % 16 == 0;
  p.vec = vec ? 1 : 0;
  p.q_scale = 1.4426950408889634f / sqrtf((float)D);
  return bf16 ? launch_head_size<__nv_bfloat16>(p, B, D, stream)
              : launch_head_size<float>(p, B, D, stream);
}
