// Python binding of the kernels (pack.cu, decode.cu, hash.cu, window.cu).
//
// The only file that includes PyTorch's headers, so the kernel sources
// stay quick to compile. The codec functions take the tensors the Python
// wrapper (ops/codec_kernels.py) has checked and allocated; `window`
// checks and allocates itself (ops/window_kernels.py). Each makes the
// tensors' device current, launches on PyTorch's current stream of that
// device and raises if the launch was refused.

#include <torch/extension.h>

#include <ATen/cuda/CUDAContext.h>
#include <c10/cuda/CUDAException.h>
#include <c10/cuda/CUDAGuard.h>

cudaError_t m3_pack(const void* c0, const void* c1, const void* c2,
                    const void* nb, void* out, int n, int slots,
                    int max_words, cudaStream_t stream);
cudaError_t m3_decode(const void* words, const void* npoints, void* dt,
                      void* ts, void* vals, void* flags, int n, int mw,
                      int window, cudaStream_t stream);
cudaError_t m3_hash(const void* words, const void* lens, void* out, int n,
                    int cols, uint32_t seed, cudaStream_t stream);
cudaError_t m3_window(const void* resid, void* stat, void* count, int rows,
                      int k, int w, int stride, int which,
                      cudaStream_t stream);

namespace {

void pack(const torch::Tensor& c0, const torch::Tensor& c1,
          const torch::Tensor& c2, const torch::Tensor& nb,
          const torch::Tensor& out) {
  const c10::cuda::CUDAGuard guard(out.device());
  C10_CUDA_CHECK(m3_pack(c0.data_ptr(), c1.data_ptr(), c2.data_ptr(),
                         nb.data_ptr(), out.data_ptr(), nb.size(0),
                         nb.size(1), out.size(1),
                         at::cuda::getCurrentCUDAStream()));
}

void decode(const torch::Tensor& words, const torch::Tensor& npoints,
            const torch::Tensor& dt, const torch::Tensor& ts,
            const torch::Tensor& vals, const torch::Tensor& flags) {
  const c10::cuda::CUDAGuard guard(words.device());
  C10_CUDA_CHECK(m3_decode(words.data_ptr(), npoints.data_ptr(),
                           dt.data_ptr(), ts.data_ptr(), vals.data_ptr(),
                           flags.data_ptr(), words.size(0), words.size(1),
                           dt.size(1), at::cuda::getCurrentCUDAStream()));
}

void hash(const torch::Tensor& words, const torch::Tensor& lens,
          const torch::Tensor& out, int64_t seed) {
  const c10::cuda::CUDAGuard guard(words.device());
  C10_CUDA_CHECK(m3_hash(words.data_ptr(), lens.data_ptr(), out.data_ptr(),
                         words.size(0), words.size(1),
                         static_cast<uint32_t>(seed),
                         at::cuda::getCurrentCUDAStream()));
}

// K4 checks its own input (the Python wrapper checks only on the CPU
// route) and returns the stat and count planes as one [2, S, T_out]
// tensor, so a query pays one allocation and no Python checks per call.
// The messages are literals: a message with streamed values crashed the
// process on the card's torch 2.11.0+cu128 instead of raising.
torch::Tensor window(const torch::Tensor& resid, int64_t w, int64_t stride,
                     int64_t which) {
  TORCH_CHECK_TYPE(resid.scalar_type() == torch::kFloat32 && resid.dim() == 2,
                   "window_stat: resid must be a 2-D torch.float32 tensor");
  TORCH_CHECK_VALUE(resid.is_cuda() && resid.is_contiguous(),
                    "window_stat: resid must be a contiguous CUDA tensor");
  const int64_t s = resid.size(0), k = resid.size(1);
  TORCH_CHECK_VALUE(w >= 1 && stride >= 1 && k >= w,
                    "window_stat: need 1 <= W <= K and stride >= 1");
  TORCH_CHECK_VALUE(s <= INT32_MAX && k <= INT32_MAX && which >= 0 && which < 6,
                    "window_stat: grid or stat out of range");
  const c10::cuda::CUDAGuard guard(resid.device());
  const int64_t t_out = (k - w) / stride + 1;
  torch::Tensor out = torch::empty({2, s, t_out}, resid.options());
  if (s > 0) {
    float* stat = out.data_ptr<float>();
    C10_CUDA_CHECK(m3_window(resid.data_ptr(), stat, stat + s * t_out, s, k,
                             static_cast<int>(w), static_cast<int>(stride),
                             static_cast<int>(which),
                             at::cuda::getCurrentCUDAStream()));
  }
  return out;
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("pack", &pack);
  m.def("decode", &decode);
  m.def("hash", &hash);
  m.def("window", &window);
}
