// PyTorch binding of the kernels in order_stats.cu, rwkv_scan.cu and
// flash_attention.cu. This is the one file that includes PyTorch's headers;
// it checks its arguments, launches on the current stream and checks the
// launch.

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <initializer_list>
#include <limits>

void mth_smallest_launch_f32(const float* x, int64_t rows, int64_t n, int64_t m,
                             float* out, cudaStream_t stream);
void mth_smallest_launch_f64(const double* x, int64_t rows, int64_t n,
                             int64_t m, double* out, cudaStream_t stream);
bool rwkv_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, float* y, float* s_out,
                      int B, int T, int H, int K, bool bf16,
                      cudaStream_t stream);
bool flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                            const int64_t* strides, int B, int Sq, int Sk, int H, int KV,
                            int D, bool causal, int window, bool bf16,
                            cudaStream_t stream);

void mth_smallest(const torch::Tensor& x, int64_t m, torch::Tensor& out) {
  TORCH_CHECK(x.is_cuda() && out.is_cuda(), "mth_smallest: tensors must be on CUDA");
  TORCH_CHECK(x.dim() == 2, "mth_smallest: x must be (rows, n)");
  TORCH_CHECK(x.is_contiguous() && out.is_contiguous(),
              "mth_smallest: tensors must be contiguous");
  TORCH_CHECK(x.scalar_type() == out.scalar_type(), "mth_smallest: dtype mismatch");
  TORCH_CHECK(x.device() == out.device(), "mth_smallest: device mismatch");
  const int64_t rows = x.size(0);
  const int64_t n = x.size(1);
  TORCH_CHECK(out.dim() == 1 && out.size(0) == rows, "mth_smallest: out must be (rows,)");
  TORCH_CHECK(rows >= 1 && rows <= std::numeric_limits<int32_t>::max(),
              "mth_smallest: rows out of range");
  TORCH_CHECK(n <= std::numeric_limits<int32_t>::max(), "mth_smallest: n too large");
  TORCH_CHECK(1 <= m && m <= n, "mth_smallest: m out of range [1, n]");

  const c10::cuda::CUDAGuard guard(x.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(x.device().index()).stream();
  if (x.scalar_type() == torch::kFloat32) {
    mth_smallest_launch_f32(x.data_ptr<float>(), rows, n, m, out.data_ptr<float>(), stream);
  } else if (x.scalar_type() == torch::kFloat64) {
    mth_smallest_launch_f64(x.data_ptr<double>(), rows, n, m, out.data_ptr<double>(),
                            stream);
  } else {
    TORCH_CHECK(false, "mth_smallest: dtype must be float32 or float64");
  }
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// r, k, v: (B, T, H, K) bfloat16 or float32, one dtype; w: (B, T, H, K) and
// u: (H, K) float32; y: (B, T, H, K) and state: (B, H, K, K) float32, written.
void rwkv_scan(const torch::Tensor& r, const torch::Tensor& k,
               const torch::Tensor& v, const torch::Tensor& w,
               const torch::Tensor& u, torch::Tensor& y, torch::Tensor& state) {
  for (const torch::Tensor* t :
       std::initializer_list<const torch::Tensor*>{&r, &k, &v, &w, &u, &y, &state}) {
    TORCH_CHECK(t->is_cuda() && t->device() == r.device(),
                "rwkv_scan: tensors must be on one CUDA device");
    TORCH_CHECK(t->is_contiguous(), "rwkv_scan: tensors must be contiguous");
  }
  TORCH_CHECK(r.dim() == 4, "rwkv_scan: r must be (B, T, H, K)");
  const int64_t B = r.size(0), T = r.size(1), H = r.size(2), K = r.size(3);
  for (const torch::Tensor* t : std::initializer_list<const torch::Tensor*>{&k, &v, &w, &y}) {
    TORCH_CHECK(t->sizes().equals(r.sizes()), "rwkv_scan: r, k, v, w, y shapes differ");
  }
  TORCH_CHECK(u.dim() == 2 && u.size(0) == H && u.size(1) == K,
              "rwkv_scan: u must be (H, K)");
  TORCH_CHECK(state.dim() == 4 && state.size(0) == B && state.size(1) == H &&
                  state.size(2) == K && state.size(3) == K,
              "rwkv_scan: state must be (B, H, K, K)");
  const auto in_type = r.scalar_type();
  TORCH_CHECK(in_type == torch::kBFloat16 || in_type == torch::kFloat32,
              "rwkv_scan: r, k, v must be bfloat16 or float32");
  TORCH_CHECK(k.scalar_type() == in_type && v.scalar_type() == in_type,
              "rwkv_scan: r, k, v must share a dtype");
  for (const torch::Tensor* t : std::initializer_list<const torch::Tensor*>{&w, &u, &y, &state}) {
    TORCH_CHECK(t->scalar_type() == torch::kFloat32,
                "rwkv_scan: w, u, y and state must be float32");
  }
  TORCH_CHECK(B >= 1 && T >= 1 && H >= 1, "rwkv_scan: empty input");
  TORCH_CHECK(B * H <= std::numeric_limits<int32_t>::max() &&
                  T <= std::numeric_limits<int32_t>::max(),
              "rwkv_scan: input too large");

  const c10::cuda::CUDAGuard guard(r.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(r.device().index()).stream();
  const bool launched = rwkv_scan_launch(
      r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr<float>(), u.data_ptr<float>(),
      y.data_ptr<float>(), state.data_ptr<float>(), static_cast<int>(B), static_cast<int>(T),
      static_cast<int>(H), static_cast<int>(K), in_type == torch::kBFloat16, stream);
  TORCH_CHECK(launched, "rwkv_scan: head size must be 32 or 64, not ", K);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

// q: (B, Sq, H, D); k, v: (B, Sk, KV, D); bfloat16 or float32, one dtype,
// the head dimension contiguous; o: (B, Sq, H, D) contiguous, q's dtype,
// written. window <= 0 means no window.
void flash_attention(const torch::Tensor& q, const torch::Tensor& k,
                     const torch::Tensor& v, torch::Tensor& o, bool causal,
                     int64_t window) {
  for (const torch::Tensor* t : std::initializer_list<const torch::Tensor*>{&q, &k, &v, &o}) {
    TORCH_CHECK(t->is_cuda() && t->device() == q.device(),
                "flash_attention: tensors must be on one CUDA device");
    TORCH_CHECK(t->dim() == 4, "flash_attention: tensors must be 4-d");
    TORCH_CHECK(t->stride(3) == 1, "flash_attention: the head dimension must be contiguous");
    TORCH_CHECK(t->scalar_type() == q.scalar_type(), "flash_attention: dtypes differ");
  }
  TORCH_CHECK(q.scalar_type() == torch::kBFloat16 || q.scalar_type() == torch::kFloat32,
              "flash_attention: q, k, v must be bfloat16 or float32");
  const int64_t B = q.size(0), Sq = q.size(1), H = q.size(2), D = q.size(3);
  const int64_t Sk = k.size(1), KV = k.size(2);
  TORCH_CHECK(k.size(0) == B && k.size(3) == D && v.sizes().equals(k.sizes()),
              "flash_attention: k and v must be (B, Sk, KV, D)");
  TORCH_CHECK(o.sizes().equals(q.sizes()) && o.is_contiguous(),
              "flash_attention: o must be a contiguous (B, Sq, H, D)");
  TORCH_CHECK(B >= 1 && Sq >= 1 && Sk >= 1 && KV >= 1 && H % KV == 0,
              "flash_attention: empty input, or H not a multiple of KV");
  TORCH_CHECK(B <= 65535 && H <= 65535 && Sq <= std::numeric_limits<int32_t>::max() &&
                  Sk <= std::numeric_limits<int32_t>::max(),
              "flash_attention: input too large");
  TORCH_CHECK(window >= 0 && window <= std::numeric_limits<int32_t>::max(),
              "flash_attention: window out of range");
  const int64_t strides[9] = {q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
                              k.stride(2), v.stride(0), v.stride(1), v.stride(2)};

  const c10::cuda::CUDAGuard guard(q.device());
  cudaStream_t stream = c10::cuda::getCurrentCUDAStream(q.device().index()).stream();
  const bool launched = flash_attention_launch(
      q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), strides, static_cast<int>(B),
      static_cast<int>(Sq), static_cast<int>(Sk), static_cast<int>(H), static_cast<int>(KV),
      static_cast<int>(D), causal, static_cast<int>(window),
      q.scalar_type() == torch::kBFloat16, stream);
  TORCH_CHECK(launched, "flash_attention: head size must be 32, 64 or 128, not ", D);
  C10_CUDA_KERNEL_LAUNCH_CHECK();
}

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("mth_smallest", &mth_smallest, "per-row m-th smallest (out-parameter)");
  mod.def("rwkv_scan", &rwkv_scan, "RWKV-6 scan with the u bonus (out-parameters)");
  mod.def("flash_attention", &flash_attention,
          "causal / windowed GQA attention forward (out-parameter)");
}
