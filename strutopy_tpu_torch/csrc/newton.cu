// Hand-written Hopper (sm_90a) kernels for the fused damped-Newton
// E-step and the beta row gather.
//
//   stm_iter     ONE Newton iteration per document: f/g/H, the CG
//                direction, the -g fallback, the Armijo sweep, the step
//                choice and the eta update, with done/advance flags out
//                (replaces strutopy_tpu/ops/pallas_stages.py::_iter_kernel)
//   stm_newton   the WHOLE Newton loop per document: the same step in a
//                loop of at most max_iters steps that the block leaves
//                when its document is done; eta and the Newton count out
//                (replaces strutopy_tpu/ops/pallas_estep.py::_newton_kernel)
//   stm_gather_rows  out[r, :] = beta_T[words[r], :]
//                (replaces strutopy_tpu/ops/pallas_stages.py::_gather_rows_kernel)
//
// Both Newton entry points launch newton_kernel, whose step runs the
// per-document bodies of newton_doc.cuh that the stage kernels B1, B2 and
// B3 run (fgh_body, cg_body, ls_body), so a fused step computes f, g, H,
// the direction and the sweep bit for bit as the stage path does.  The
// convergence test, the direction's fallback and the step choice are
// newton_doc.cuh's step glue, which the stage path's glue kernels
// (stages.cu) run too; the update follows newton_accept_plain of
// strutopy_tpu_torch/ops/stages.py operation for operation, with
// __fmul_rn/__fadd_rn so that nvcc does not contract them into FMAs that
// PyTorch's elementwise kernels do not use.
//
// What bounds them on the H100, and what the design does about it:
//   * newton: a loop is bound by its longest chain: a chunk costs about
//     its slowest document's Newton count times the time of one step of
//     one block (on an H100 at 700 W, 2.3 ms for the bench chunk's 24
//     steps: ~95 us a step).
//     One block per document keeps the document's state (eta, mu, g, the
//     direction, H) in shared memory and leaves the loop when its document
//     is done, with no host synchronisation.  For the loop at K ~80 to
//     ~100 (K=100, L=384 in bf16: 215 KB) the document's whole beta_doc
//     stays in shared memory (the resident plan, one block an SM): it is
//     read from device memory once, and each step's B1 and B3 run on it
//     without streaming.  Otherwise, and for B4's single step, B1 and B3
//     stream beta_doc through one cp.async ring that both use in turn, at
//     two blocks an SM; H is then assembled where B1 assembles it, in the
//     ring once the stream is done (bf16 values, the float32 diagonal
//     apart), CG reads it there, and it is dead before B3 refills the
//     ring.  Above K ~115 B1's tile groups run in turn, each re-streaming
//     the document, and H goes to a shared region of its own, or, where it
//     does not fit (K above ~250), to a (B, K-1, K-1) global scratch the
//     caller allocates.  siginv stays in shared memory where the plan has
//     room, else the bodies bring it in beside their first slab (stream)
//     or read it from L2 (resident).
//   * gather_rows: a pure copy, bound by device-memory bandwidth (B·L·K·4
//     bytes written, about as many read from the L2-resident beta_T).
//     One warp per output row, 16-byte loads and stores where K % 4 == 0.
//
// stm_iter also takes a bf16 beta_doc (beta_bf16 = 1, the Newton search
// under newton_bf16_beta): the streaming plans then ring bf16 slabs, half
// the bytes.  stm_newton (and the resident plan) takes float32 only: the
// whole-loop path reads the float32 beta_doc whatever the option, as in
// the JAX package.
//
// Plain C interface (loaded with ctypes): each entry point launches on
// the stream it is given, allocates nothing, does not synchronise, and
// returns cudaGetLastError().  Booleans are 1-byte (torch.bool).

#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "newton_doc.cuh"

namespace {

// Where the fused kernel keeps H.
enum HWhere { kHRing = 0, kHShared = 1, kHGlobal = 2 };

// Shared-memory plan of newton_kernel, offsets in floats.  [0, body) is
// the bodies' region (B1's and B3's layouts overlap there; CG's scratch
// and, for kHRing, H lie in its first lay.e floats once B1's stream is
// done); then the document's state; then H (kHShared), CG's scratch
// (resident) and siginv (sig_smem).  resident: the ring holds all of the
// document's slabs (one block an SM), loaded once before the first step.
struct NewtonPlan {
  int W, stages, blocks_per_sm, groups, h_where, sig_smem, resident, ok;
  size_t h, cg, red, f, eta, mu, g, p, diag, ts, fs, sig, floats;
};

// CG's column pairs a lane (cg_body's NP) on a plan of W-slot slabs
// `stages` deep: K-1 is at most 64 times that.
__host__ __device__ constexpr int newton_np(int W, int stages) {
  return W == 64 ? 2 : stages == 3 ? 4 : 8;
}

inline NewtonPlan newton_layout(int K, int L, int bf16, int W, int stages, int bps,
                                int resident, int beta_bytes) {
  const int Km1 = K - 1;
  NewtonPlan o{};
  o.W = W;
  o.stages = stages;
  o.blocks_per_sm = bps;
  o.resident = resident;
  o.groups = fgh_groups(K);
  const int ring = resident ? (L + W - 1) / W : stages;
  const FghLayout fl = fgh_layout(K, W, ring, bf16, beta_bytes);
  const LsLayout ll = ls_layout(K, W, ring, beta_bytes);
  size_t at = round4(fl.floats > ll.floats ? fl.floats : ll.floats);
  for (size_t* v : {&o.red, &o.f}) {
    *v = at;
    at += 32;
  }
  for (size_t* v : {&o.eta, &o.mu, &o.g, &o.p, &o.diag}) {
    *v = at;
    at = round4(at + Km1);
  }
  o.ts = at;
  at += kMaxT;
  o.fs = at;
  at += kMaxT;
  const size_t h_floats =
      round4(bf16 ? ((size_t)Km1 * cg_ld(Km1) + 1) / 2 : (size_t)Km1 * cg_ld(Km1));
  const size_t cgs = round4(cg_scratch(Km1));
  const size_t limit = (size_t)max_optin_smem() / sizeof(float) / bps;
  if (!resident && o.groups == 1 && h_floats + cgs <= fl.e) {
    o.h_where = kHRing;
    o.h = 0;
    o.cg = h_floats;
  } else {
    o.cg = 0;
    if (resident) {
      o.cg = at;
      at += cgs;
    }
    o.h_where = at + h_floats <= limit ? kHShared : kHGlobal;
    if (o.h_where == kHShared) {
      o.h = at;
      at += h_floats;
    }
  }
  o.sig_smem = at + (size_t)Km1 * Km1 <= limit;
  o.sig = at;
  if (o.sig_smem) at += round4((size_t)Km1 * Km1);
  o.floats = at;
  // the resident plan keeps the whole step on chip, H included
  o.ok = at <= limit && (resident ? o.h_where == kHShared : cgs <= fl.e) &&
         Km1 <= 64 * newton_np(W, stages);
  return o;
}

// STM_NEWTON_PLAN (a build flag of kernel_diag.py plans): 0 the first
// plan that fits, 1 the streaming plans only, 2 the resident plan only.
#ifndef STM_NEWTON_PLAN
#define STM_NEWTON_PLAN 0
#endif

// The first plan that fits, in this order: 64-slot slabs streamed three
// deep at two blocks an SM with siginv in shared memory (K up to ~80);
// for a loop (B5), beta_doc resident in 64-slot slabs at one block an SM,
// read from device memory once instead of twice a step (K up to ~100 at
// L=384); then 64-slot slabs streamed three deep at two blocks an SM,
// 32-slot slabs three deep at two, 32-slot slabs two deep at one.  On the
// bench recipe (kernel_diag.py plans, H100 at 700 W) the resident plan
// took 2.08 ms against 2.37 at K=100, the streaming one 0.91 against 1.03
// at K=50, where it keeps siginv on chip.  A bf16 beta_doc (beta_bytes 2)
// takes the streaming plans only.
inline NewtonPlan newton_plan(int K, int L, int bf16, int loop, int beta_bytes) {
  const int cand[5][5] = {  // W, stages, blocks an SM, resident, siginv in shared memory
      {64, 3, 2, 0, 1}, {64, 3, 1, 1, 0}, {64, 3, 2, 0, 0}, {32, 3, 2, 0, 0}, {32, 2, 1, 0, 0}};
  for (const auto& c : cand) {
    if (c[3] && (!loop || beta_bytes != (int)sizeof(float))) continue;
    if ((STM_NEWTON_PLAN == 1 && c[3]) || (STM_NEWTON_PLAN == 2 && !c[3])) continue;
    const NewtonPlan plan = newton_layout(K, L, bf16, c[0], c[1], c[2], c[3], beta_bytes);
    if (plan.ok && (plan.sig_smem || !c[4])) return plan;
  }
  return NewtonPlan{};
}

template <int W, int STAGES, bool RESIDENT>
struct NewtonShape {
  static constexpr int kNP = newton_np(W, STAGES);
  static constexpr int kBlocksPerSM = !RESIDENT && STAGES == 3 ? 2 : 1;
};

// One damped-Newton iteration of a document that is not done: the body
// of ops/estep.py::_batched_newton for one document.  Updates eta in
// shared memory in place and returns (done, advance), the same in every
// thread.  TB: beta_doc's element type.
template <int W, int STAGES, bool BF16, bool RESIDENT, typename TB>
__device__ __forceinline__ int2 newton_step(const NewtonPlan& pl, float* smem, const float* sig,
                                            bool sig_shared, const TB* __restrict__ beta_d,
                                            const float* __restrict__ cnt_d, float* H_glob,
                                            int K, int L, int T, int vec16, float grad_tol,
                                            int cg_iters) {
  const int Km1 = K - 1;
  const int tid = threadIdx.x;
  float* red = smem + pl.red;
  float* f = smem + pl.f;
  float* eta = smem + pl.eta;
  float* mu = smem + pl.mu;
  float* g = smem + pl.g;
  float* p = smem + pl.p;
  float* diag = smem + pl.diag;
  float* ts = smem + pl.ts;
  float* fs = smem + pl.fs;

  HOut hout{};
  hout.diag = diag;
  hout.ld = cg_ld(Km1);
  if (pl.h_where == kHGlobal)
    hout.glob = H_glob;
  else
    hout.sm = smem + pl.h;
  for (int grp = 0; grp < pl.groups; ++grp) {
    if (grp > 0) __syncthreads();  // the previous group's epilogue is done
    fgh_body<W, STAGES, BF16, true, RESIDENT, TB>(sig, sig_shared, eta, mu, beta_d, cnt_d, f, g,
                                              hout, 0, K, L, vec16, grp, smem);
  }
  __syncthreads();

  if (grad_converged(g, Km1, grad_tol, red)) return make_int2(1, 0);

  constexpr int NP = NewtonShape<W, STAGES, RESIDENT>::kNP;
  if (pl.h_where == kHGlobal)
    cg_body<NP>(HGlobal<BF16>{H_glob, Km1}, diag, g, p, Km1, cg_iters, smem + pl.cg);
  else
    cg_body<NP>(HShared<BF16>{smem + pl.h, hout.ld}, diag, g, p, Km1, cg_iters, smem + pl.cg);
  __syncthreads();

  // a direction that does not descend falls back to -g (in place)
  const float gTp = descent_direction(g, p, p, Km1, red);

  ls_body<W, STAGES, RESIDENT, TB>(sig, sig_shared, ts, T, eta, p, mu, beta_d, cnt_d, fs, 0, K, L,
                               vec16, smem);
  __syncthreads();

  bool any_ok;
  const float t = armijo_step(fs, ts, T, *f, gTp, &any_ok);
  if (any_ok) {
    for (int i = tid; i < Km1; i += kThreads) eta[i] = __fadd_rn(eta[i], __fmul_rn(t, p[i]));
  }
  return make_int2(any_ok ? 0 : 1, 1);
}

// B4 and B5: at most max_iters Newton steps of document blockIdx.x from
// eta0; the block leaves the loop once its document is done (a done
// document is frozen and counts no further iterations, so this equals
// running all max_iters).  B4 (max_iters = 1) passes done_in, whose done
// documents keep their eta, and takes the done/advance flags; B5 takes
// the Newton count.  The resident plan rings float32 slabs only.
template <int W, int STAGES, bool BF16, bool RESIDENT, typename TB>
__global__ void __launch_bounds__(kThreads, (NewtonShape<W, STAGES, RESIDENT>::kBlocksPerSM))
newton_kernel(const float* __restrict__ siginv, const float* __restrict__ ts,
              const TB* __restrict__ beta_doc, const float* __restrict__ counts,
              const float* __restrict__ mu, const float* __restrict__ eta0,
              const uint8_t* __restrict__ done_in, float* H_scratch,
              float* __restrict__ eta_out, int* __restrict__ iters_out,
              uint8_t* __restrict__ done_out, uint8_t* __restrict__ adv_out, int K, int L,
              int T, int max_iters, float grad_tol, int cg_iters, int vec16, NewtonPlan pl) {
  static_assert(!RESIDENT || std::is_same<TB, float>::value, "resident slabs are float32");
  extern __shared__ __align__(16) float smem[];
  const int Km1 = K - 1;
  const size_t d = blockIdx.x;
  const float* eta_d = eta0 + d * Km1;
  float* out_d = eta_out + d * Km1;
  if (done_in != nullptr && done_in[d]) {
    for (int i = threadIdx.x; i < Km1; i += kThreads) out_d[i] = eta_d[i];
    if (threadIdx.x == 0) {
      done_out[d] = 1;
      adv_out[d] = 0;
    }
    return;
  }
  float* eta = smem + pl.eta;
  for (int i = threadIdx.x; i < Km1; i += kThreads) {
    eta[i] = eta_d[i];
    smem[pl.mu + i] = mu[d * Km1 + i];
  }
  if ((int)threadIdx.x < T) smem[pl.ts + threadIdx.x] = ts[threadIdx.x];
  if (pl.sig_smem) {
    for (int i = threadIdx.x; i < Km1 * Km1; i += kThreads) smem[pl.sig + i] = siginv[i];
  }
  const TB* beta_d = beta_doc + d * K * L;
  const float* cnt_d = counts + d * L;
  if (RESIDENT) {  // every slab of the document, once for the whole loop
    for (int s = 0; s * W < L; ++s)
      load_slab<W>(reinterpret_cast<TB*>(smem) + (size_t)s * K * W, beta_d, K, L, s * W, vec16);
    cp_async_commit();
    cp_async_wait<0>();
  }
  __syncthreads();
  const float* sig = pl.sig_smem ? smem + pl.sig : siginv;
  float* H_glob = pl.h_where == kHGlobal ? H_scratch + d * Km1 * Km1 : nullptr;
  int n = 0, done = 0;
  for (int it = 0; it < max_iters; ++it) {
    const int2 r = newton_step<W, STAGES, BF16, RESIDENT, TB>(pl, smem, sig, pl.sig_smem, beta_d,
                                                          cnt_d, H_glob, K, L, T, vec16,
                                                          grad_tol, cg_iters);
    n += r.y;
    if (r.x) {
      done = 1;
      break;
    }
    __syncthreads();  // eta is read whole by the next step
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Km1; i += kThreads) out_d[i] = eta[i];
  if (threadIdx.x == 0) {
    if (iters_out != nullptr) iters_out[d] = n;
    if (done_out != nullptr) {
      done_out[d] = (uint8_t)done;
      adv_out[d] = (uint8_t)n;
    }
  }
}

// Launch newton_kernel on the plan's instantiation for a beta_doc of TB
// (16-byte copies where each row is a whole number of 16-byte chunks).
template <typename TB>
cudaError_t launch_newton(const NewtonPlan& pl, int bf16, int B, void* stream,
                          const float* siginv, const float* ts, const TB* beta_doc,
                          const float* counts, const float* mu, const float* eta0,
                          const uint8_t* done_in, float* H_scratch, float* eta_out,
                          int* iters_out, uint8_t* done_out, uint8_t* adv_out, int K, int L,
                          int T, int max_iters, float grad_tol, int cg_iters) {
  const int vec16 = L % (16 / sizeof(TB)) == 0 && (uintptr_t)beta_doc % 16 == 0;
  auto args = [&](auto kernel) {
    return launch(kernel, dim3(B), sizeof(float) * pl.floats, stream, siginv, ts, beta_doc,
                  counts, mu, eta0, done_in, H_scratch, eta_out, iters_out, done_out, adv_out,
                  K, L, T, max_iters, grad_tol, cg_iters, vec16, pl);
  };
  if constexpr (std::is_same<TB, float>::value) {
    if (pl.resident)
      return bf16 ? args(newton_kernel<64, 3, true, true, TB>)
                  : args(newton_kernel<64, 3, false, true, TB>);
  } else {
    if (pl.resident) return cudaErrorInvalidValue;
  }
  if (pl.W == 64)
    return bf16 ? args(newton_kernel<64, 3, true, false, TB>)
                : args(newton_kernel<64, 3, false, false, TB>);
  if (pl.stages == 3)
    return bf16 ? args(newton_kernel<32, 3, true, false, TB>)
                : args(newton_kernel<32, 3, false, false, TB>);
  return bf16 ? args(newton_kernel<32, 2, true, false, TB>)
              : args(newton_kernel<32, 2, false, false, TB>);
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

// The fused kernel's plan at (K, L, bf16) for a beta_doc of float32
// (beta_bf16 = 0) or bf16, for a loop (B5, loop = 1) or one step (B4,
// loop = 0) into out[8]: shared-memory bytes
// a block, W, ring depth, blocks an SM, tile groups, where H lives (0 the
// ring, 1 a shared region, 2 a (B, K-1, K-1) float32 global scratch the
// caller passes), siginv in shared memory (1) or not, beta_doc resident
// (1) or streamed.  Returns -1 where no plan fits.
int stm_newton_plan(int K, int L, int bf16, int beta_bf16, int loop, int* out) {
  const NewtonPlan pl = newton_plan(K, L, bf16, loop, beta_bf16 ? 2 : 4);
  if (!pl.ok) return -1;
  const int v[8] = {(int)(sizeof(float) * pl.floats), pl.W, pl.stages, pl.blocks_per_sm,
                    pl.groups, pl.h_where, pl.sig_smem, pl.resident};
  for (int i = 0; i < 8; ++i) out[i] = v[i];
  return 0;
}

int stm_iter(const void* siginv, const void* ts, const void* eta, const void* mu,
             const void* done, const void* beta_doc, const void* counts, void* H_scratch,
             void* eta_out, void* done_out, void* adv_out, int B, int K, int L, int T,
             float grad_tol, int cg_iters, int bf16, int beta_bf16, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT || L < 1) return (int)cudaErrorInvalidValue;
  const NewtonPlan pl = newton_plan(K, L, bf16, 0, beta_bf16 ? 2 : 4);
  if (!pl.ok || (pl.h_where == kHGlobal && H_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  auto go = [&](const auto* beta) {
    return (int)launch_newton(pl, bf16, B, stream, (const float*)siginv, (const float*)ts, beta,
                              (const float*)counts, (const float*)mu, (const float*)eta,
                              (const uint8_t*)done, (float*)H_scratch, (float*)eta_out, nullptr,
                              (uint8_t*)done_out, (uint8_t*)adv_out, K, L, T, 1, grad_tol,
                              cg_iters);
  };
  return beta_bf16 ? go((const __nv_bfloat16*)beta_doc) : go((const float*)beta_doc);
}

int stm_newton(const void* siginv, const void* ts, const void* beta_doc, const void* counts,
               const void* mu, const void* eta0, void* H_scratch, void* eta_out,
               void* iters_out, int B, int K, int L, int T, int max_iters, float grad_tol,
               int cg_iters, int bf16, void* stream) {
  if (B == 0) return 0;
  if (T < 1 || T > kMaxT || L < 1) return (int)cudaErrorInvalidValue;
  const NewtonPlan pl = newton_plan(K, L, bf16, max_iters > 1, sizeof(float));
  if (!pl.ok || (pl.h_where == kHGlobal && H_scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_newton(pl, bf16, B, stream, (const float*)siginv, (const float*)ts,
                            (const float*)beta_doc, (const float*)counts, (const float*)mu,
                            (const float*)eta0, nullptr, (float*)H_scratch, (float*)eta_out,
                            (int*)iters_out, nullptr, nullptr, K, L, T, max_iters, grad_tol,
                            cg_iters);
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
