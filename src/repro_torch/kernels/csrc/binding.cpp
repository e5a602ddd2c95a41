// PyTorch binding of the kernels in order_stats.cu and rwkv_scan.cu. This is
// the one file that includes PyTorch's headers; it checks its arguments,
// launches on the current stream and checks the launch.

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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("mth_smallest", &mth_smallest, "per-row m-th smallest (out-parameter)");
  mod.def("rwkv_scan", &rwkv_scan, "RWKV-6 scan with the u bonus (out-parameters)");
}
