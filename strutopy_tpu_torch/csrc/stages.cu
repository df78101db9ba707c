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
// and the step's glue around them, which the JAX package leaves to XLA:
//
//   stm_newton_direction  between B2 and B3: the convergence test and
//            the direction's fallback to -g
//   stm_newton_accept     after B3: the step choice, the eta update, the
//            done/advance flags, the Newton counts and the chunk's
//            "all done" flag
//
// and the E-step finalize around its factor (factor.cu), which the JAX
// package leaves to XLA (strutopy_tpu/ops/estep.py::_finalize_chunk):
//
//   stm_finalize        Z: g, H, theta, phi and the bound's terms at the
//            converged eta, B1's float32 body with the finalize's outputs
//   stm_finalize_bound  after the factor: the det term, the weighted
//            bound and nu
//
// Every entry point has a plain C interface (loaded with ctypes): it
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so the caller sees a
// refused launch.
//
// Notation: K topics, Km1 = K - 1 free coordinates, L padded unique-term
// slots of the document, T step sizes.  All arrays are row-major,
// contiguous float32, but beta_doc, which stm_fgh and stm_ls also take as
// bf16 (beta_bf16 = 1: the Newton search under newton_bf16_beta):
//   siginv (Km1, Km1) symmetric; eta, mu, p, g (B, Km1);
//   beta_doc (B, K, L); counts (B, L); H (B, Km1, Km1); f (B,); fs (B, T).
//
// Arithmetic follows the plain PyTorch versions in
// strutopy_tpu_torch/ops/stages.py operation for operation (the same
// divisions, the same bf16 rounding points); only the order of the
// float32 sums differs.  expf/logf/sqrtf are the accurate versions (no
// fast-math).  Every output of a document depends only on that
// document's inputs, in a fixed order: no atomics, nothing that depends
// on B or on the document's place in the chunk.
//
// Each kernel is a thin wrapper around its per-document body in
// newton_doc.cuh (fgh_body, cg_body, ls_body; the glue: grad_converged,
// descent_direction, armijo_step), the bodies the fused kernel of
// newton.cu (B4, B5) runs too.
//
// A bf16 beta_doc's slabs are half the bytes of float32 ones, and B3 gives
// them a plan of its own (kBetaLs below, chosen by timing the candidates).

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "newton_doc.cuh"

namespace {

// B1: one block per document and tile group (blockIdx.y); H assembled in
// the free ring and written in whole rows where one group covers it.
template <int W, int STAGES, bool BF16, typename TB>
__global__ void __launch_bounds__(kThreads, 2)
fgh_kernel(const float* __restrict__ siginv, const float* __restrict__ eta,
           const float* __restrict__ mu, const TB* __restrict__ beta_doc,
           const float* __restrict__ counts, float* __restrict__ f_out,
           float* __restrict__ g_out, float* __restrict__ H_out, int K, int L, int vec16) {
  extern __shared__ __align__(16) float smem[];
  const size_t d = blockIdx.x;
  HOut hout{};
  hout.glob = H_out;
  fgh_body<W, STAGES, BF16, false, false, TB>(siginv, false, eta + d * (K - 1), mu,
                                              beta_doc + d * K * L, counts + d * L, f_out, g_out,
                                              hout, d, K, L, vec16, blockIdx.y, smem);
}

// Z, the E-step finalize: B1's float32 body with the finalize's outputs
// (newton_doc.cuh, FINAL), one block per document and tile group.
template <int W, int STAGES>
__global__ void __launch_bounds__(kThreads, 2)
finalize_kernel(const float* __restrict__ siginv, const float* __restrict__ eta,
                const float* __restrict__ mu, const float* __restrict__ beta_doc,
                const float* __restrict__ counts, const float* __restrict__ Nd,
                const float* __restrict__ doc_w, float* __restrict__ g_out,
                float* __restrict__ H_out, float* __restrict__ theta, float* __restrict__ phi,
                float* __restrict__ terms, int K, int L, int vec16, int stage) {
  extern __shared__ __align__(16) float smem[];
  const size_t d = blockIdx.x;
  HOut hout{};
  hout.glob = H_out;
  const FinOut fin{Nd, doc_w, theta, phi, terms, stage};
  fgh_body<W, STAGES, false, false, false, float, true>(
      siginv, false, eta + d * (K - 1), mu, beta_doc + d * K * L, counts + d * L, nullptr,
      g_out, hout, d, K, L, vec16, blockIdx.y, smem, fin);
}

// The finalize's epilogue after F (factor.cu), one block per document:
// bound_d = w·(((loglik + det) - quad) - sigmaentropy) with det = -Σ_i log
// L_ii, the plain version's order of operations, and nu_d ·= w in place.
// Lt is F's Lᵀ (its diagonal is L's).
__global__ void __launch_bounds__(kThreads)
finalize_bound_kernel(const float* __restrict__ Lt, float* __restrict__ nu,
                      const float* __restrict__ terms, const float* __restrict__ sigmaentropy,
                      const float* __restrict__ doc_w, float* __restrict__ bound, int P) {
  __shared__ float red[kWarps];
  const size_t d = blockIdx.x, PP = (size_t)P * P;
  const float w = doc_w[d];
  float part = 0.f;
  for (int i = threadIdx.x; i < P; i += kThreads) part += logf(Lt[d * PP + (size_t)i * (P + 1)]);
  const float det = -block_sum(part, red);
  if (threadIdx.x == 0)
    bound[d] = __fmul_rn(w, __fsub_rn(__fsub_rn(__fadd_rn(terms[2 * d], det), terms[2 * d + 1]),
                                      *sigmaentropy));
  float* nu_d = nu + d * PP;
  for (size_t i = threadIdx.x; i < PP; i += kThreads) nu_d[i] = __fmul_rn(w, nu_d[i]);
}

// B3: one block per document.
template <int W, int STAGES, typename TB>
__global__ void __launch_bounds__(kThreads)
ls_kernel(const float* __restrict__ siginv, const float* __restrict__ ts,
          const float* __restrict__ eta, const float* __restrict__ pdir,
          const float* __restrict__ mu, const TB* __restrict__ beta_doc,
          const float* __restrict__ counts, float* __restrict__ fs, int K, int L, int T,
          int vec16) {
  extern __shared__ __align__(16) float smem[];
  const size_t d = blockIdx.x;
  ls_body<W, STAGES, false, TB>(siginv, false, ts, T, eta, pdir, mu, beta_doc + d * K * L,
                                counts + d * L, fs, d, K, L, vec16, smem);
}

// B2: one block per document.  Shared memory: g[Km1] | diag[Km1] | cg
// scratch | H (HSMEM: rows of cg_ld(Km1), bf16 in bf16 mode, else
// float32).  H comes in with coalesced loads, all of a thread's share in
// flight at once up to K ~100 (one round trip), g and the unrounded
// diagonal beside them, and is stored as the values the matvec uses.
// Without HSMEM (bf16 H above K ~330, float32 H above K ~230) the matvecs
// read H from device memory (L2) and round it as they read.
__host__ __device__ inline size_t cg_h_offset(int Km1) {
  return 2 * round4(Km1) + round4(cg_scratch(Km1));
}

template <int NP, bool BF16, bool HSMEM>
__global__ void __launch_bounds__(kThreads, NP <= 4 ? 2 : 1)
cg_kernel(const float* __restrict__ H, const float* __restrict__ g,
          float* __restrict__ x_out, int Km1, int iters) {
  extern __shared__ __align__(16) float smem[];
  const size_t d = blockIdx.x;
  const int tid = threadIdx.x, ld = cg_ld(Km1);
  const float* H_d = H + d * Km1 * Km1;
  float* gs = smem;
  float* diag = smem + round4(Km1);
  float* scratch = smem + 2 * round4(Km1);
  void* Hs = smem + cg_h_offset(Km1);
  // g and the diagonal (K-1 <= 512: two a thread)
  float gv[2], dv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + r * kThreads;
    gv[r] = i < Km1 ? g[d * Km1 + i] : 0.f;
    dv[r] = i < Km1 ? H_d[(size_t)i * (Km1 + 1)] : 0.f;
  }
  if (HSMEM) {
    // thread tid takes the flat indices tid + kThreads·b, which step by
    // (di, dj) in (row, column)
    const int n = Km1 * Km1;
    const int di = kThreads / Km1, dj = kThreads - di * Km1;
    constexpr int kBatch = 40;
    for (int f0 = tid; f0 < n; f0 += kBatch * kThreads) {
      float v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int f = f0 + b * kThreads;
        v[b] = f < n ? __ldg(H_d + f) : 0.f;
      }
      int i = f0 / Km1, j = f0 - i * Km1;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (f0 + b * kThreads < n) {
          if (BF16)
            static_cast<__nv_bfloat16*>(Hs)[i * ld + j] = __float2bfloat16(v[b]);
          else
            static_cast<float*>(Hs)[i * ld + j] = v[b];
        }
        i += di;
        j += dj;
        if (j >= Km1) {
          j -= Km1;
          ++i;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = tid + r * kThreads;
    if (i < Km1) {
      gs[i] = gv[r];
      diag[i] = dv[r];
    }
  }
  __syncthreads();
  if (HSMEM)
    cg_body<NP>(HShared<BF16>{Hs, ld}, diag, gs, x_out + d * Km1, Km1, iters, scratch);
  else
    cg_body<NP>(HGlobal<BF16>{H_d, Km1}, diag, gs, x_out + d * Km1, Km1, iters, scratch);
}

// The direction's glue, between B2 and B3: one block per document.
// conv[d] = max|g| <= grad_tol; p and gTp from CG's x, -g where x does not
// descend (newton_doc.cuh::descent_direction).
__global__ void __launch_bounds__(kThreads)
step_direction_kernel(const float* __restrict__ g, const float* __restrict__ x,
                      float* __restrict__ p, float* __restrict__ gTp_out,
                      uint8_t* __restrict__ conv_out, int Km1, float grad_tol) {
  __shared__ float red[kWarps];
  const size_t d = blockIdx.x;
  const float* g_d = g + d * Km1;
  const bool conv = grad_converged(g_d, Km1, grad_tol, red);
  const float gTp = descent_direction(g_d, x + d * Km1, p + d * Km1, Km1, red);
  if (threadIdx.x == 0) {
    gTp_out[d] = gTp;
    conv_out[d] = conv;
  }
}

// The step's glue after B3: block d < B takes document d's Armijo step
// (newton_doc.cuh::armijo_step) and writes its eta, done, advance and
// any_ok flags, and adds advance to n_iters[d] (when given); block B
// computes every document's new done flag again, in the same way, and
// writes their AND to *all_done (__syncthreads_and: an order-free
// boolean reduction, no atomics and no second launch).
__global__ void __launch_bounds__(kThreads)
step_accept_kernel(const float* __restrict__ eta, const float* __restrict__ p,
                   const float* __restrict__ fs, const float* __restrict__ f,
                   const float* __restrict__ gTp, const float* __restrict__ ts,
                   const uint8_t* __restrict__ done, const uint8_t* __restrict__ conv,
                   float* __restrict__ eta_out, uint8_t* __restrict__ done_out,
                   uint8_t* __restrict__ adv_out, uint8_t* __restrict__ any_ok_out,
                   int* __restrict__ n_iters, uint8_t* __restrict__ all_done, int B, int Km1,
                   int T) {
  __shared__ float ts_s[kMaxT];
  if ((int)threadIdx.x < T) ts_s[threadIdx.x] = ts[threadIdx.x];
  __syncthreads();
  bool any_ok;
  if ((int)blockIdx.x == B) {
    bool all = true;
    for (int d = threadIdx.x; d < B; d += kThreads) {
      armijo_step(fs + (size_t)d * T, ts_s, T, f[d], gTp[d], &any_ok);
      all = all && (done[d] || conv[d] || !any_ok);
    }
    all = __syncthreads_and(all);
    if (threadIdx.x == 0) *all_done = all;
    return;
  }
  const size_t d = blockIdx.x;
  const float t = armijo_step(fs + d * T, ts_s, T, f[d], gTp[d], &any_ok);
  const bool advance = !done[d] && !conv[d];
  const bool step = advance && any_ok;
  for (int i = threadIdx.x; i < Km1; i += kThreads) {
    const float e = eta[d * Km1 + i];
    eta_out[d * Km1 + i] = step ? __fadd_rn(e, __fmul_rn(t, p[d * Km1 + i])) : e;
  }
  if (threadIdx.x == 0) {
    done_out[d] = done[d] || conv[d] || !any_ok;
    adv_out[d] = advance;
    any_ok_out[d] = any_ok;
    if (n_iters != nullptr) n_iters[d] += advance;
  }
}

// A stage kernel's plan: W-slot slabs `stages` deep, how many blocks an SM
// it is planned for, its bytes a block.
struct StagePlan {
  int W, stages, blocks_per_sm;
  size_t bytes;
};

// B1's ring, {W, stages, blocks an SM}: 64-slot slabs three deep where two
// blocks fit an SM, then 32-slot slabs three deep, then 32-slot slabs two
// deep up to the whole opt-in shared memory; the first that fits is taken.
// A bf16 beta_doc's slabs take half the bytes of float32 ones and keep
// this list: no other shape was faster on the bench chunk (K=100, B=256;
// kernel_diag.py ablate times each candidate alone, PERF.md section 6).
constexpr int kFghPlans[][3] = {{64, 3, 2}, {32, 3, 2}, {32, 2, 1}};
// B3's ring with bf16 slabs: 128-slot slabs two deep were the fastest on
// the bench chunk (the same measurement), then 64-slot ones two deep; one
// block an SM where two do not fit.
constexpr int kBetaLs[][3] = {{128, 2, 2}, {64, 2, 2}, {64, 2, 1}};
constexpr int kNFghPlans = sizeof(kFghPlans) / sizeof(kFghPlans[0]);
constexpr int kNBetaLs = sizeof(kBetaLs) / sizeof(kBetaLs[0]);

template <int N, typename Bytes>
inline StagePlan first_fit(const int (&cand)[N][3], Bytes bytes_of) {
  const size_t optin = (size_t)max_optin_smem();
  for (const auto& c : cand) {
    const size_t bytes = bytes_of(c[0], c[1]);
    if (bytes <= optin / c[2]) return {c[0], c[1], c[2], bytes};
  }
  return {0, 0, 0, 0};
}

inline StagePlan fgh_plan(int K, int bf16, int beta_bytes) {
  return first_fit(kFghPlans, [&](int W, int stages) {
    return sizeof(float) * fgh_layout(K, W, stages, bf16, beta_bytes).floats;
  });
}

// Z's plan: B1's float32 candidates with the finalize's buffers and the
// phi stage (stage = 1) where one of them holds it, else without the stage
// (phi stored element by element; K above ~428), up to K ~561: past the
// largest K of B1's default mode (~481), the E-step's Newton limit.
struct FinPlan {
  StagePlan plan;
  int stage;
};

inline FinPlan fin_plan(int K) {
  for (const int final : {2, 1}) {
    const StagePlan plan = first_fit(kFghPlans, [&](int W, int stages) {
      return sizeof(float) * fgh_layout(K, W, stages, 0, sizeof(float), final).floats;
    });
    if (plan.W) return {plan, final == 2 ? 1 : 0};
  }
  return {{0, 0, 0, 0}, 0};
}

// B3's ring, float32 slabs: 64 slots by three slabs where two blocks fit
// an SM, then 64 by two, 32 by three and 32 by two; the first that fits
// is taken.  bf16 slabs: kBetaLs.
inline StagePlan ls_plan(int K, int beta_bytes) {
  if (beta_bytes == 2)
    return first_fit(kBetaLs, [&](int W, int stages) {
      return sizeof(float) * ls_layout(K, W, stages, 2).floats;
    });
  const size_t optin = (size_t)max_optin_smem();
  const int cand[4][2] = {{64, 3}, {64, 2}, {32, 3}, {32, 2}};
  for (const size_t limit : {optin / 2, optin}) {
    for (const auto& c : cand) {
      const size_t bytes = sizeof(float) * ls_layout(K, c[0], c[1], beta_bytes).floats;
      if (bytes <= limit) return {c[0], c[1], limit == optin ? 1 : 2, bytes};
    }
  }
  return {0, 0, 0, 0};
}

// Where a plan's prior term reads siginv: 0 device memory (L2), 1 the
// ring's spare slabs.
inline int sig_on_chip(const StagePlan& plan, int K, int beta_bytes) {
  const size_t Km1 = K - 1;
  return Km1 * Km1 <= beta_floats((size_t)(plan.stages - 1) * K * plan.W, beta_bytes) ? 1 : 0;
}

// beta_doc's element size, and whether a block may copy it in 16-byte
// chunks: each row of L elements a whole number of chunks, the array
// 16-byte aligned.
inline int beta_bytes_of(int beta_bf16) { return beta_bf16 ? 2 : 4; }
inline int beta_vec16(const void* beta_doc, int L, int beta_bytes) {
  return L % (16 / beta_bytes) == 0 && (uintptr_t)beta_doc % 16 == 0;
}

// f(W, stages) with the plan's values as compile-time constants, for each
// of the N candidates of C (candidates of one shape share an instance).
template <const int (*C)[3], int N, int I = 0, typename F>
cudaError_t plan_shapes(const StagePlan& plan, F&& f) {
  if constexpr (I == N) {
    return cudaErrorInvalidValue;
  } else {
    constexpr int W = C[I][0], ST = C[I][1];
    if (plan.W == W && plan.stages == ST)
      return f(std::integral_constant<int, W>(), std::integral_constant<int, ST>());
    return plan_shapes<C, N, I + 1>(plan, static_cast<F&&>(f));
  }
}

template <typename TB>
cudaError_t launch_fgh(const StagePlan& plan, int bf16, dim3 grid, void* stream,
                       const void* siginv, const void* eta, const void* mu, const void* beta_doc,
                       const void* counts, void* f, void* g, void* H, int K, int L) {
  const int vec16 = beta_vec16(beta_doc, L, sizeof(TB));
  auto args = [&](auto kernel) {
    return launch(kernel, grid, plan.bytes, stream, (const float*)siginv, (const float*)eta,
                  (const float*)mu, (const TB*)beta_doc, (const float*)counts, (float*)f,
                  (float*)g, (float*)H, K, L, vec16);
  };
  return plan_shapes<kFghPlans, kNFghPlans>(plan, [&](auto w, auto st) {
    constexpr int W = decltype(w)::value, ST = decltype(st)::value;
    return bf16 ? args(fgh_kernel<W, ST, true, TB>) : args(fgh_kernel<W, ST, false, TB>);
  });
}

template <typename TB>
cudaError_t launch_ls(const StagePlan& plan, int B, void* stream, const void* siginv,
                      const void* ts, const void* eta, const void* p, const void* mu,
                      const void* beta_doc, const void* counts, void* fs, int K, int L, int T) {
  const int vec16 = beta_vec16(beta_doc, L, sizeof(TB));
  auto args = [&](auto kernel) {
    return launch(kernel, dim3(B), plan.bytes, stream, (const float*)siginv, (const float*)ts,
                  (const float*)eta, (const float*)p, (const float*)mu, (const TB*)beta_doc,
                  (const float*)counts, (float*)fs, K, L, T, vec16);
  };
  if constexpr (std::is_same<TB, float>::value) {
    if (plan.W == 64)
      return plan.stages == 3 ? args(ls_kernel<64, 3, TB>) : args(ls_kernel<64, 2, TB>);
    return plan.stages == 3 ? args(ls_kernel<32, 3, TB>) : args(ls_kernel<32, 2, TB>);
  } else {
    return plan_shapes<kBetaLs, kNBetaLs>(plan, [&](auto w, auto st) {
      return args(ls_kernel<decltype(w)::value, decltype(st)::value, TB>);
    });
  }
}

cudaError_t launch_finalize(const FinPlan& fp, dim3 grid, void* stream, const void* siginv,
                            const void* eta, const void* mu, const void* beta_doc,
                            const void* counts, const void* Nd, const void* doc_w, void* g,
                            void* H, void* theta, void* phi, void* terms, int K, int L) {
  const int vec16 = beta_vec16(beta_doc, L, sizeof(float));
  return plan_shapes<kFghPlans, kNFghPlans>(fp.plan, [&](auto w, auto st) {
    return launch(finalize_kernel<decltype(w)::value, decltype(st)::value>, grid, fp.plan.bytes,
                  stream, (const float*)siginv, (const float*)eta, (const float*)mu,
                  (const float*)beta_doc, (const float*)counts, (const float*)Nd,
                  (const float*)doc_w, (float*)g, (float*)H, (float*)theta, (float*)phi,
                  (float*)terms, K, L, vec16, fp.stage);
  });
}

// B2's plan: its bytes a block, and whether H sits in shared memory beside
// the scratch (else the matvecs read it from L2).
struct CgPlan {
  size_t bytes;
  bool h_smem;
};

inline CgPlan cg_plan(int Km1, int bf16) {
  const size_t base = sizeof(float) * cg_h_offset(Km1);
  const size_t with_h =
      base + (size_t)Km1 * cg_ld(Km1) * (bf16 ? sizeof(__nv_bfloat16) : sizeof(float));
  const bool h_smem = with_h <= (size_t)max_optin_smem();
  return {h_smem ? with_h : base, h_smem};
}

}  // namespace

extern "C" {

const char* stm_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// Shared-memory bytes of one block of stm_fgh or stm_ls at K (they do not
// depend on L); -1 where no plan fits.
int stm_fgh_smem(int K, int bf16, int beta_bf16) {
  const StagePlan plan = fgh_plan(K, bf16, beta_bytes_of(beta_bf16));
  return plan.W ? (int)plan.bytes : -1;
}

// The plan of stm_fgh (which = 0) or stm_ls (1) at K into out[5]: bytes a
// block, W, ring depth, blocks an SM, where the prior term reads siginv (0
// L2, 1 the ring's spare slabs); -1 where no plan fits.
int stm_stage_plan(int which, int K, int bf16, int beta_bf16, int* out) {
  const int bb = beta_bytes_of(beta_bf16);
  const StagePlan plan = which == 0 ? fgh_plan(K, bf16, bb) : ls_plan(K, bb);
  if (!plan.W) return -1;
  const int v[5] = {(int)plan.bytes, plan.W, plan.stages, plan.blocks_per_sm,
                    sig_on_chip(plan, K, bb)};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

int stm_fgh(const void* siginv, const void* eta, const void* mu, const void* beta_doc,
            const void* counts, void* f, void* g, void* H, int B, int K, int L, int bf16,
            int beta_bf16, void* stream) {
  if (B == 0) return 0;
  const StagePlan plan = fgh_plan(K, bf16, beta_bytes_of(beta_bf16));
  if (!plan.W || L < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(B, fgh_groups(K));
  const cudaError_t err =
      beta_bf16 ? launch_fgh<__nv_bfloat16>(plan, bf16, grid, stream, siginv, eta, mu, beta_doc,
                                            counts, f, g, H, K, L)
                : launch_fgh<float>(plan, bf16, grid, stream, siginv, eta, mu, beta_doc, counts,
                                    f, g, H, K, L);
  return (int)err;
}

// B2's plan at K-1 into out[2]: shared-memory bytes a block, 1 where H sits
// in shared memory (else the matvecs read it from L2); -1 for K-1 outside
// 1..512.
int stm_cg_plan(int Km1, int bf16, int* out) {
  if (Km1 < 1 || Km1 > 512) return -1;
  const CgPlan plan = cg_plan(Km1, bf16);
  out[0] = (int)plan.bytes;
  out[1] = plan.h_smem;
  return 0;
}

// B2: H in shared memory where it fits beside the scratch; K-1 up to 512.
int stm_cg(const void* H, const void* g, void* x, int B, int Km1, int iters, int bf16,
           void* stream) {
  if (B == 0) return 0;
  if (Km1 < 1 || Km1 > 512) return (int)cudaErrorInvalidValue;
  const CgPlan plan = cg_plan(Km1, bf16);
  auto args = [&](auto kernel) {
    return launch(kernel, dim3(B), plan.bytes, stream, (const float*)H, (const float*)g,
                  (float*)x, Km1, iters);
  };
  auto pick = [&](auto np) {
    constexpr int NP = decltype(np)::value;
    if (plan.h_smem)
      return bf16 ? args(cg_kernel<NP, true, true>) : args(cg_kernel<NP, false, true>);
    return bf16 ? args(cg_kernel<NP, true, false>) : args(cg_kernel<NP, false, false>);
  };
  cudaError_t err;
  if (Km1 <= 128)
    err = pick(std::integral_constant<int, 2>());
  else if (Km1 <= 256)
    err = pick(std::integral_constant<int, 4>());
  else
    err = pick(std::integral_constant<int, 8>());
  return (int)err;
}

int stm_ls_smem(int K, int beta_bf16) {
  const StagePlan plan = ls_plan(K, beta_bytes_of(beta_bf16));
  return plan.W ? (int)plan.bytes : -1;
}

int stm_ls(const void* siginv, const void* ts, const void* eta, const void* p,
           const void* mu, const void* beta_doc, const void* counts, void* fs, int B, int K,
           int L, int T, int beta_bf16, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT) return (int)cudaErrorInvalidValue;
  const StagePlan plan = ls_plan(K, beta_bytes_of(beta_bf16));
  if (!plan.W || L < 1) return (int)cudaErrorInvalidValue;
  const cudaError_t err =
      beta_bf16 ? launch_ls<__nv_bfloat16>(plan, B, stream, siginv, ts, eta, p, mu, beta_doc,
                                           counts, fs, K, L, T)
                : launch_ls<float>(plan, B, stream, siginv, ts, eta, p, mu, beta_doc, counts,
                                   fs, K, L, T);
  return (int)err;
}

// The direction's glue: p, gTp, conv from g and CG's x (B, Km1).
int stm_newton_direction(const void* g, const void* x, void* p, void* gTp, void* conv, int B,
                         int Km1, float grad_tol, void* stream) {
  if (B == 0) return 0;
  if (Km1 < 1) return (int)cudaErrorInvalidValue;
  step_direction_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g, (const float*)x, (float*)p, (float*)gTp, (uint8_t*)conv, Km1, grad_tol);
  return (int)cudaGetLastError();
}

// The step's glue after the sweep: B + 1 blocks, so *all_done is written
// for B = 0 too.  n_iters may be null.
int stm_newton_accept(const void* eta, const void* p, const void* fs, const void* f,
                      const void* gTp, const void* ts, const void* done, const void* conv,
                      void* eta_out, void* done_out, void* adv_out, void* any_ok, void* n_iters,
                      void* all_done, int B, int Km1, int T, void* stream) {
  if (T < 1 || T > kMaxT || Km1 < 1) return (int)cudaErrorInvalidValue;
  step_accept_kernel<<<B + 1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)eta, (const float*)p, (const float*)fs, (const float*)f, (const float*)gTp,
      (const float*)ts, (const uint8_t*)done, (const uint8_t*)conv, (float*)eta_out,
      (uint8_t*)done_out, (uint8_t*)adv_out, (uint8_t*)any_ok, (int*)n_iters,
      (uint8_t*)all_done, B, Km1, T);
  return (int)cudaGetLastError();
}

// Z's plan at K into out[5]: bytes a block, W, ring depth, blocks an SM, 1
// where a slab's phi is staged in shared memory; -1 where no plan fits.
int stm_finalize_plan(int K, int* out) {
  if (K < 2) return -1;
  const FinPlan fp = fin_plan(K);
  if (!fp.plan.W) return -1;
  const int v[5] = {(int)fp.plan.bytes, fp.plan.W, fp.plan.stages, fp.plan.blocks_per_sm,
                    fp.stage};
  for (int i = 0; i < 5; ++i) out[i] = v[i];
  return 0;
}

// Z: siginv (Km1, Km1), eta/mu (B, Km1), beta_doc (B, K, L), counts (B, L),
// Nd/doc_w (B,) -> g (B, Km1), H (B, Km1, Km1), theta (B, K), phi (B, L,
// K), terms (B, 2) = (loglik, quad).
int stm_finalize(const void* siginv, const void* eta, const void* mu, const void* beta_doc,
                 const void* counts, const void* Nd, const void* doc_w, void* g, void* H,
                 void* theta, void* phi, void* terms, int B, int K, int L, void* stream) {
  if (B == 0) return 0;
  const FinPlan fp = K >= 2 ? fin_plan(K) : FinPlan{{0, 0, 0, 0}, 0};
  if (!fp.plan.W || L < 1) return (int)cudaErrorInvalidValue;
  return (int)launch_finalize(fp, dim3(B, fgh_groups(K)), stream, siginv, eta, mu, beta_doc,
                              counts, Nd, doc_w, g, H, theta, phi, terms, K, L);
}

// The finalize's epilogue: Lt (B, P, P) from stm_chol_pd_inverse, nu (B,
// P, P) weighted in place, terms (B, 2) from stm_finalize, sigmaentropy a
// scalar, doc_w (B,) -> bound (B,).
int stm_finalize_bound(const void* Lt, void* nu, const void* terms, const void* sigmaentropy,
                       const void* doc_w, void* bound, int B, int P, void* stream) {
  if (B == 0) return 0;
  if (P < 1) return (int)cudaErrorInvalidValue;
  finalize_bound_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)Lt, (float*)nu, (const float*)terms, (const float*)sigmaentropy,
      (const float*)doc_w, (float*)bound, P);
  return (int)cudaGetLastError();
}

}  // extern "C"
