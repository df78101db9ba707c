// Hand-written Hopper (sm_90a) kernels for the fused damped-Newton
// E-step and the beta row gather.
//
//   stm_iter     ONE Newton iteration per document: f/g/H, the CG
//                direction, the -g fallback, the Armijo sweep, the step
//                choice and the eta update, with done/advance flags out
//                (replaces strutopy_tpu/ops/pallas_stages.py::_iter_kernel)
//   stm_newton   the WHOLE Newton loop per document: the same body in a
//                loop of at most max_iters steps that the block leaves
//                when its document is done; eta and the Newton count out
//                (replaces strutopy_tpu/ops/pallas_estep.py::_newton_kernel)
//   stm_gather_rows  out[r, :] = beta_T[words[r], :]
//                (replaces strutopy_tpu/ops/pallas_stages.py::_gather_rows_kernel)
//
// The two Newton kernels chain the per-document bodies of
// newton_doc.cuh: doc_cg is the code of the stage kernel B2, while
// doc_fgh and doc_sweep compute what the stage kernels B1 and B3 do with
// float32 sums in another order, so a fused step matches the stage path
// to rounding.  The step choice and the update follow the
// PyTorch glue of strutopy_tpu_torch/ops/stages.py::_newton_step operation
// for operation, with __fmul_rn/__fadd_rn so that nvcc does not contract
// them into FMAs that PyTorch's elementwise kernels do not use.
//
// What bounds them on the H100, and what the design does about it:
//   * iter/newton: one block per document; the B·Bᵀ product of f/g/H
//     (2·(K-1)²·L flops a document) on the CUDA cores dominates, as in
//     B1.  Fusing removes the device-memory round trips of H, g, p and
//     the sweep values between the stages and, for newton, every host
//     synchronisation of the Newton loop: a block stops when its own
//     document is done, so a chunk costs the sum of its documents'
//     iterations over the SMs, not B x the slowest document's count.
//     H stays in shared memory between f/g/H and CG (39 KB at K=100); the
//     shared-memory plan (fused_plan) then adds siginv where it fits
//     (~94 KB a block at K=100, L=384: two blocks per SM).  Above ~K=160
//     siginv is read from L2, above ~K=238 H too (a (B, K-1, K-1) global
//     scratch that the caller allocates).
//   * gather_rows: a pure copy, bound by device-memory bandwidth (B·L·K·4
//     bytes written, about as many read from the L2-resident beta_T).
//     One warp per output row, 16-byte loads and stores where K % 4 == 0.
//
// Plain C interface (loaded with ctypes): each entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError().  Booleans are 1-byte (torch.bool).

#include <stdint.h>

#include "newton_doc.cuh"

namespace {

// Shared-memory layout of the fused kernels, in floats:
//   red[32] | f[32] | eta | mu | g | p (Km1 each) | ts[kMaxT] | fs[kMaxT]
//   | work (the largest of the three bodies' scratch; they run in turn)
//   | H[Km1*Km1] when h_smem | sig[Km1*Km1] when sig_smem
struct Shared {
  float *red, *f, *eta, *mu, *g, *p, *ts, *fs, *work, *H, *sig;
};

__host__ __device__ inline size_t fused_work(int K, int L, int T) {
  size_t w = fgh_scratch(K, L);
  const size_t c = cg_scratch(K - 1), s = sweep_scratch(K, T);
  if (c > w) w = c;
  if (s > w) w = s;
  return w;
}

__host__ __device__ inline size_t fused_base(int K, int L, int T) {
  return 64 + 4 * (size_t)(K - 1) + 2 * kMaxT + fused_work(K, L, T);
}

__device__ Shared carve(float* smem, int K, int L, int T, int h_smem) {
  const int Km1 = K - 1;
  Shared sh;
  sh.red = smem;
  sh.f = sh.red + 32;
  sh.eta = sh.f + 32;
  sh.mu = sh.eta + Km1;
  sh.g = sh.mu + Km1;
  sh.p = sh.g + Km1;
  sh.ts = sh.p + Km1;
  sh.fs = sh.ts + kMaxT;
  sh.work = sh.fs + kMaxT;
  sh.H = sh.work + fused_work(K, L, T);
  sh.sig = sh.H + (h_smem ? (size_t)Km1 * Km1 : 0);
  return sh;
}

struct FusedPlan {
  size_t bytes;
  int h_smem, sig_smem, ok;
};

// H in shared memory when it fits, then siginv when it fits too.
inline FusedPlan fused_plan(int K, int L, int T) {
  const size_t sq = (size_t)(K - 1) * (K - 1);
  const size_t base = fused_base(K, L, T);
  const size_t optin = (size_t)max_optin_smem() / sizeof(float);
  FusedPlan plan;
  plan.ok = base <= optin;
  plan.h_smem = base + sq <= optin;
  const size_t with_h = base + (plan.h_smem ? sq : 0);
  plan.sig_smem = with_h + sq <= optin;
  plan.bytes = sizeof(float) * (with_h + (plan.sig_smem ? sq : 0));
  return plan;
}

// eta, mu, ts (and siginv when sig_smem) into shared memory; returns the
// siginv every body reads.  Ends with a barrier.
__device__ const float* load_doc(const Shared& sh, const float* siginv, const float* ts,
                                 const float* eta_d, const float* mu_d, int Km1, int T,
                                 int sig_smem) {
  for (int i = threadIdx.x; i < Km1; i += kThreads) {
    sh.eta[i] = eta_d[i];
    sh.mu[i] = mu_d[i];
  }
  if ((int)threadIdx.x < T) sh.ts[threadIdx.x] = ts[threadIdx.x];
  if (sig_smem) {
    for (int idx = threadIdx.x; idx < Km1 * Km1; idx += kThreads) sh.sig[idx] = siginv[idx];
  }
  __syncthreads();
  return sig_smem ? sh.sig : siginv;
}

// One damped-Newton iteration of a document that is not done: the body
// of ops/estep.py::_batched_newton for one document.  Updates sh.eta in
// place and returns (done, advance), the same in every thread.
__device__ int2 newton_step(const Shared& sh, const float* sig, const float* __restrict__ beta_d,
                            const float* __restrict__ cnt_d, float* H, int K, int L, int T,
                            float grad_tol, int cg_iters, int bf16) {
  const int Km1 = K - 1;
  const int tid = threadIdx.x;

  doc_fgh(sig, sh.eta, sh.mu, beta_d, cnt_d, sh.f, sh.g, H, K, L, bf16, sh.work);
  __syncthreads();

  // convergence: max|g| <= grad_tol (a NaN in g is not converged, as in
  // torch.amax, which propagates it)
  float gm = 0.f;
  for (int i = tid; i < Km1; i += kThreads) {
    const float a = fabsf(sh.g[i]);
    gm = isnan(a) ? INFINITY : fmaxf(gm, a);
  }
  if (block_max(gm, sh.red) <= grad_tol) return make_int2(1, 0);

  doc_cg(H, H, bf16, sh.g, sh.p, Km1, cg_iters, sh.work);
  __syncthreads();

  // a direction that does not descend falls back to -g
  float part = 0.f;
  for (int i = tid; i < Km1; i += kThreads) part += sh.g[i] * sh.p[i];
  float gTp = block_sum(part, sh.red);
  if (gTp >= 0.f) {
    part = 0.f;
    for (int i = tid; i < Km1; i += kThreads) {
      const float gi = sh.g[i];
      sh.p[i] = -gi;
      part += gi * gi;
    }
    gTp = -block_sum(part, sh.red);  // also publishes p
  }

  doc_sweep(sig, sh.ts, sh.eta, sh.p, sh.mu, beta_d, cnt_d, sh.fs, K, L, T, sh.work);
  __syncthreads();

  // the first (largest) step size that passes the Armijo test
  const float f = *sh.f;
  float t = 0.f;
  bool any_ok = false;
  for (int k = 0; k < T; ++k) {
    const float rhs = __fadd_rn(f, __fmul_rn(__fmul_rn(1e-4f, sh.ts[k]), gTp));
    if (sh.fs[k] <= rhs) {
      any_ok = true;
      t = fmaxf(t, sh.ts[k]);
    }
  }
  if (any_ok) {
    for (int i = tid; i < Km1; i += kThreads) sh.eta[i] = __fadd_rn(sh.eta[i], __fmul_rn(t, sh.p[i]));
  }
  return make_int2(any_ok ? 0 : 1, 1);
}

// B4: one iteration of document blockIdx.x.  A done document keeps its eta.
__global__ void __launch_bounds__(kThreads)
iter_kernel(const float* __restrict__ siginv, const float* __restrict__ ts,
            const float* __restrict__ eta, const float* __restrict__ mu,
            const uint8_t* __restrict__ done, const float* __restrict__ beta_doc,
            const float* __restrict__ counts, float* __restrict__ H_scratch,
            float* __restrict__ eta_out, uint8_t* __restrict__ done_out,
            uint8_t* __restrict__ adv_out, int K, int L, int T, float grad_tol, int cg_iters,
            int bf16, int h_smem, int sig_smem) {
  extern __shared__ float smem[];
  const int Km1 = K - 1;
  const size_t d = blockIdx.x;
  const float* eta_d = eta + d * Km1;
  float* out_d = eta_out + d * Km1;
  if (done[d]) {
    for (int i = threadIdx.x; i < Km1; i += kThreads) out_d[i] = eta_d[i];
    if (threadIdx.x == 0) {
      done_out[d] = 1;
      adv_out[d] = 0;
    }
    return;
  }
  const Shared sh = carve(smem, K, L, T, h_smem);
  const float* sig = load_doc(sh, siginv, ts, eta_d, mu + d * Km1, Km1, T, sig_smem);
  float* H = h_smem ? sh.H : H_scratch + d * Km1 * Km1;
  const int2 r = newton_step(sh, sig, beta_doc + d * K * L, counts + d * L, H, K, L, T,
                             grad_tol, cg_iters, bf16);
  __syncthreads();
  for (int i = threadIdx.x; i < Km1; i += kThreads) out_d[i] = sh.eta[i];
  if (threadIdx.x == 0) {
    done_out[d] = (uint8_t)r.x;
    adv_out[d] = (uint8_t)r.y;
  }
}

// B5: the Newton loop of document blockIdx.x from eta0.  The block leaves
// the loop once its document is done: a done document is frozen and
// counts no further iterations, so this equals running all max_iters.
__global__ void __launch_bounds__(kThreads)
newton_kernel(const float* __restrict__ siginv, const float* __restrict__ ts,
              const float* __restrict__ beta_doc, const float* __restrict__ counts,
              const float* __restrict__ mu, const float* __restrict__ eta0,
              float* __restrict__ H_scratch, float* __restrict__ eta_out,
              int* __restrict__ iters_out, int K, int L, int T, int max_iters,
              float grad_tol, int cg_iters, int bf16, int h_smem, int sig_smem) {
  extern __shared__ float smem[];
  const int Km1 = K - 1;
  const size_t d = blockIdx.x;
  const Shared sh = carve(smem, K, L, T, h_smem);
  const float* sig = load_doc(sh, siginv, ts, eta0 + d * Km1, mu + d * Km1, Km1, T, sig_smem);
  float* H = h_smem ? sh.H : H_scratch + d * Km1 * Km1;
  const float* beta_d = beta_doc + d * K * L;
  const float* cnt_d = counts + d * L;
  int n = 0;
  for (int it = 0; it < max_iters; ++it) {
    const int2 r = newton_step(sh, sig, beta_d, cnt_d, H, K, L, T, grad_tol, cg_iters, bf16);
    n += r.y;
    if (r.x) break;
    __syncthreads();  // eta is read whole by the next step
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Km1; i += kThreads) eta_out[d * Km1 + i] = sh.eta[i];
  if (threadIdx.x == 0) iters_out[d] = n;
}

// B6: one warp per output row.  An id outside [0, V) gives a row of NaN
// (the kernel cannot raise; reading past beta_T would be worse).
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const float* __restrict__ beta_T, const int* __restrict__ words,
                   float* __restrict__ out, int n_rows, int V, int K, int vec4) {
  const int lane = threadIdx.x & 31;
  const size_t row = (size_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (size_t)n_rows) return;
  const int w = words[row];
  float* dst = out + row * K;
  if (w < 0 || w >= V) {
    for (int j = lane; j < K; j += 32) dst[j] = NAN;
    return;
  }
  const float* src = beta_T + (size_t)w * K;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int j = lane; j < K / 4; j += 32) d4[j] = __ldg(s4 + j);
  } else {
    for (int j = lane; j < K; j += 32) dst[j] = __ldg(src + j);
  }
}

}  // namespace

extern "C" {

// 1 when the fused kernels keep H in a global scratch at this (K, L, T),
// which the caller then passes as a (B, K-1, K-1) float32 buffer; 0 when
// H stays in shared memory; -1 when even the base plan does not fit.
int stm_newton_h_global(int K, int L, int T) {
  const FusedPlan plan = fused_plan(K, L, T);
  return plan.ok ? !plan.h_smem : -1;
}

int stm_iter(const void* siginv, const void* ts, const void* eta, const void* mu,
             const void* done, const void* beta_doc, const void* counts, void* H_scratch,
             void* eta_out, void* done_out, void* adv_out, int B, int K, int L, int T,
             float grad_tol, int cg_iters, int bf16, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const FusedPlan plan = fused_plan(K, L, T);
  if (!plan.ok || (!plan.h_smem && H_scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(iter_kernel, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  iter_kernel<<<B, kThreads, plan.bytes, (cudaStream_t)stream>>>(
      (const float*)siginv, (const float*)ts, (const float*)eta, (const float*)mu,
      (const uint8_t*)done, (const float*)beta_doc, (const float*)counts, (float*)H_scratch,
      (float*)eta_out, (uint8_t*)done_out, (uint8_t*)adv_out, K, L, T, grad_tol, cg_iters,
      bf16, plan.h_smem, plan.sig_smem);
  return (int)cudaGetLastError();
}

int stm_newton(const void* siginv, const void* ts, const void* beta_doc, const void* counts,
               const void* mu, const void* eta0, void* H_scratch, void* eta_out,
               void* iters_out, int B, int K, int L, int T, int max_iters, float grad_tol,
               int cg_iters, int bf16, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const FusedPlan plan = fused_plan(K, L, T);
  if (!plan.ok || (!plan.h_smem && H_scratch == nullptr)) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(newton_kernel, plan.bytes);
  if (err != cudaSuccess) return (int)err;
  newton_kernel<<<B, kThreads, plan.bytes, (cudaStream_t)stream>>>(
      (const float*)siginv, (const float*)ts, (const float*)beta_doc, (const float*)counts,
      (const float*)mu, (const float*)eta0, (float*)H_scratch, (float*)eta_out,
      (int*)iters_out, K, L, T, max_iters, grad_tol, cg_iters, bf16, plan.h_smem,
      plan.sig_smem);
  return (int)cudaGetLastError();
}

int stm_gather_rows(const void* beta_T, const void* words, void* out, int n_rows, int V, int K,
                    void* stream) {
  if (n_rows == 0) return 0;
  const int vec4 = K % 4 == 0 && (uintptr_t)beta_T % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  gather_rows_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)beta_T, (const int*)words, (float*)out, n_rows, V, K, vec4);
  return (int)cudaGetLastError();
}

}  // extern "C"
