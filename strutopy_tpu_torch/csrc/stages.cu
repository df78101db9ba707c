// Hand-written Hopper (sm_90a) kernels for the three stages of one
// damped-Newton iteration of the STM E-step.
//
//   stm_fgh  objective f, gradient g and Hessian H per document
//            (replaces strutopy_tpu/ops/pallas_stages.py::_fgh_kernel)
//   stm_cg   Jacobi-preconditioned Steihaug CG direction
//            (replaces strutopy_tpu/ops/pallas_stages.py::_cg_kernel)
//   stm_ls   the parallel Armijo sweep f(eta + t p) for T step sizes
//            (replaces strutopy_tpu/ops/pallas_stages.py::_ls_kernel)
//
// One thread block per document in all three.  Every entry point has a
// plain C interface (loaded with ctypes): it launches on the stream it
// is given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// Notation: K topics, Km1 = K - 1 free coordinates, L padded unique-term
// slots of the document, T step sizes.  All arrays are row-major,
// contiguous float32:
//   siginv (Km1, Km1) symmetric; eta, mu, p, g (B, Km1);
//   beta_doc (B, K, L); counts (B, L); H (B, Km1, Km1); f (B,); fs (B, T).
//
// Arithmetic follows the plain PyTorch versions in
// strutopy_tpu_torch/ops/stages.py operation for operation (the same
// divisions, the same bf16 rounding points); only the order of the
// float32 sums differs.  expf/logf/sqrtf are the accurate versions (no
// fast-math).  The per-document bodies live in newton_doc.cuh, shared
// with the fused kernels of newton.cu.

#include "newton_doc.cuh"

namespace {

// B1: f, g, H of document blockIdx.x; scratch fgh_scratch(K, L) floats.
__global__ void __launch_bounds__(kThreads)
fgh_kernel(const float* __restrict__ siginv, const float* __restrict__ eta,
           const float* __restrict__ mu, const float* __restrict__ beta_doc,
           const float* __restrict__ counts, float* __restrict__ f_out,
           float* __restrict__ g_out, float* __restrict__ H_out,
           int K, int L, int bf16) {
  extern __shared__ float smem[];
  const int Km1 = K - 1;
  const size_t d = blockIdx.x;
  doc_fgh(siginv, eta + d * Km1, mu + d * Km1, beta_doc + d * K * L, counts + d * L,
          f_out + d, g_out + d * Km1, H_out + d * Km1 * Km1, K, L, bf16, smem);
}

// B2: Steihaug CG of document blockIdx.x; scratch cg_scratch(Km1) floats,
// then Hs[Km1*Km1] when h_smem.  With h_smem the (bf16-rounded) Hessian
// is read from device memory once and every matvec reads shared memory;
// without it (K above ~238, where Km1² floats exceed a block's shared
// memory) the matvecs read H from device memory/L2 and round on the fly.
__global__ void __launch_bounds__(kThreads)
cg_kernel(const float* __restrict__ H, const float* __restrict__ g,
          float* __restrict__ x_out, int Km1, int iters, int bf16, int h_smem) {
  extern __shared__ float smem[];
  const size_t d = blockIdx.x;
  float* Hs = smem + cg_scratch(Km1);
  const float* H_d = H + d * Km1 * Km1;
  if (h_smem) {
    for (int idx = threadIdx.x; idx < Km1 * Km1; idx += kThreads) {
      const float v = H_d[idx];
      Hs[idx] = bf16 ? bf16_round(v) : v;
    }
  }
  // doc_cg's first barrier publishes Hs
  doc_cg(H_d, h_smem ? Hs : H_d, bf16 && !h_smem, g + d * Km1, x_out + d * Km1, Km1, iters,
         smem);
}

// B3: Armijo sweep of document blockIdx.x; scratch sweep_scratch(K, T)
// floats, then sig[Km1*Km1] when sig_smem.
__global__ void __launch_bounds__(kThreads)
ls_kernel(const float* __restrict__ siginv, const float* __restrict__ ts,
          const float* __restrict__ eta, const float* __restrict__ pdir,
          const float* __restrict__ mu, const float* __restrict__ beta_doc,
          const float* __restrict__ counts, float* __restrict__ fs,
          int K, int L, int T, int sig_smem) {
  extern __shared__ float smem[];
  const int Km1 = K - 1;
  const size_t d = blockIdx.x;
  float* sig_s = smem + sweep_scratch(K, T);
  if (sig_smem) {
    for (int idx = threadIdx.x; idx < Km1 * Km1; idx += kThreads) sig_s[idx] = siginv[idx];
  }
  doc_sweep(sig_smem ? sig_s : siginv, ts, eta + d * Km1, pdir + d * Km1, mu + d * Km1,
            beta_doc + d * K * L, counts + d * L, fs + d * T, K, L, T, smem);
}

}  // namespace

extern "C" {

const char* stm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int stm_fgh(const void* siginv, const void* eta, const void* mu, const void* beta_doc,
            const void* counts, void* f, void* g, void* H, int B, int K, int L, int bf16,
            void* stream) {
  if (B == 0) return 0;
  const size_t bytes = sizeof(float) * fgh_scratch(K, L);
  if ((int)bytes > max_optin_smem()) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(fgh_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  fgh_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)siginv, (const float*)eta, (const float*)mu, (const float*)beta_doc,
      (const float*)counts, (float*)f, (float*)g, (float*)H, K, L, bf16);
  return (int)cudaGetLastError();
}

int stm_cg(const void* H, const void* g, void* x, int B, int Km1, int iters, int bf16,
           void* stream) {
  if (B == 0) return 0;
  const size_t base = sizeof(float) * cg_scratch(Km1);
  const size_t with_h = base + sizeof(float) * (size_t)Km1 * Km1;
  const int h_smem = (int)with_h <= max_optin_smem();
  const size_t bytes = h_smem ? with_h : base;
  cudaError_t err = allow_smem(cg_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  cg_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)H, (const float*)g, (float*)x, Km1, iters, bf16, h_smem);
  return (int)cudaGetLastError();
}

int stm_ls(const void* siginv, const void* ts, const void* eta, const void* p,
           const void* mu, const void* beta_doc, const void* counts, void* fs, int B, int K,
           int L, int T, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const size_t Km1 = (size_t)K - 1;
  const size_t base = sizeof(float) * sweep_scratch(K, T);
  const size_t with_sig = base + sizeof(float) * Km1 * Km1;
  const int optin = max_optin_smem();
  if ((int)base > optin) return (int)cudaErrorInvalidValue;
  const int sig_smem = (int)with_sig <= optin;
  const size_t bytes = sig_smem ? with_sig : base;
  cudaError_t err = allow_smem(ls_kernel, bytes);
  if (err != cudaSuccess) return (int)err;
  ls_kernel<<<B, kThreads, bytes, (cudaStream_t)stream>>>(
      (const float*)siginv, (const float*)ts, (const float*)eta, (const float*)p,
      (const float*)mu, (const float*)beta_doc, (const float*)counts, (float*)fs, K, L, T,
      sig_smem);
  return (int)cudaGetLastError();
}

}  // extern "C"
