// PyTorch binding of the kernels in order_stats.cu. This is the one file that
// includes PyTorch's headers; it checks its arguments, launches on the
// current stream and checks the launch.

#include <torch/extension.h>

#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>

#include <limits>

void mth_smallest_launch_f32(const float* x, int64_t rows, int64_t n, int64_t m,
                             float* out, cudaStream_t stream);
void mth_smallest_launch_f64(const double* x, int64_t rows, int64_t n,
                             int64_t m, double* out, cudaStream_t stream);

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

PYBIND11_MODULE(TORCH_EXTENSION_NAME, mod) {
  mod.def("mth_smallest", &mth_smallest, "per-row m-th smallest (out-parameter)");
}
