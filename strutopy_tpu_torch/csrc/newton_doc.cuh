// Per-document bodies of the damped-Newton E-step, as __device__
// functions that one thread block (kThreads threads) runs for one
// document.  The fused kernels (newton.cu: B4 iter, B5 newton) chain
// them inside one block; the stage kernel B2 (stages.cu cg_kernel) wraps
// doc_cg.  The stage kernels B1 and B3 (stages.cu fgh_kernel, ls_kernel)
// have their own slab-streaming designs and compute the same functions
// with float32 sums in another order, so the fused kernels' results
// match the stage path's to rounding, not bit for bit.
//
// Every body takes its inputs and outputs as generic pointers (global
// or shared memory alike) and its scratch as a pointer into the block's
// dynamic shared memory.  A body starts by writing its own scratch and
// ends without a barrier: the caller places a __syncthreads() before it
// reads a body's outputs or reuses its scratch.
//
// Notation: K topics, Km1 = K - 1 free coordinates, L padded word slots,
// T step sizes; row-major float32 throughout.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // H output tile edge and L depth per step
constexpr int kTilePad = kTile + 1;
constexpr int kMaxT = 16;        // most step sizes the sweep takes
constexpr float kTiny = 1e-35f;  // floor of the per-word mixture s_l

// Scratch (floats of shared memory) each body needs.
__host__ __device__ inline size_t fgh_scratch(int K, int L) {
  return (size_t)K + 3 * (size_t)(K - 1) + 2 * (size_t)L + 2 * kTile * kTilePad + 32;
}
__host__ __device__ inline size_t cg_scratch(int Km1) { return 32 + 6 * (size_t)Km1; }
__host__ __device__ inline size_t sweep_scratch(int K, int T) {
  return 32 + 3 * kMaxT + kWarps * kMaxT + 3 * (size_t)(K - 1) + (size_t)T * K +
         (size_t)T * (K - 1);
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum over the block, returned to every thread.  `red` holds kWarps
// floats; the leading barrier lets consecutive calls reuse it, and the
// barriers also publish shared-memory writes made before the call.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_sum(lane < kWarps ? red[lane] : 0.f);
}

__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  return warp_max(lane < kWarps ? red[lane] : -INFINITY);
}

// ---------------------------------------------------------------------------
// f, g, H of one document (B4's and B5's; B1 has its own design)
// ---------------------------------------------------------------------------
//
// Scratch (fgh_scratch floats): e[K] | diff[Km1] | sdiff[Km1] | q[Km1] |
// s[L] | c[L] | A[kTile*kTilePad] | Bt[kTile*kTilePad] | red[32].
//
// H's likelihood term is Bmat·Bmatᵀ with Bmat[k,l] = phi_hat[k,l]·sqrt(c_l):
// it is accumulated one 32x32 output tile at a time (upper triangle,
// mirrored), walking L in steps of 32.  Bmat is rebuilt from beta_doc for
// each tile rather than stored, so the scratch does not grow with K or L
// beyond the O(K + L) vectors; the document's beta_doc block (K·L·4 bytes)
// is re-read from L2 once per tile row.
__device__ void doc_fgh(const float* siginv, const float* eta_d, const float* mu_d,
                        const float* __restrict__ beta_d, const float* __restrict__ cnt_d,
                        float* f_d, float* g_d, float* H_d, int K, int L, int bf16,
                        float* sm) {
  const int Km1 = K - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float* e = sm;
  float* diff = e + K;
  float* sdiff = diff + Km1;
  float* q = sdiff + Km1;
  float* s = q + Km1;
  float* c = s + L;
  float* At = c + L;
  float* Bt = At + kTile * kTilePad;
  float* red = Bt + kTile * kTilePad;

  // softmax of the padded eta (last coordinate pinned to 0)
  float mloc = -INFINITY;
  for (int k = tid; k < K; k += kThreads) {
    const float v = k < Km1 ? eta_d[k] : 0.f;
    e[k] = v;
    mloc = fmaxf(mloc, v);
  }
  const float m = block_max(mloc, red);
  float se = 0.f;
  for (int k = tid; k < K; k += kThreads) {
    const float v = expf(e[k] - m);
    e[k] = v;
    se += v;
  }
  const float sum_e = block_sum(se, red);

  float nd = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    const float v = cnt_d[l];
    c[l] = v;
    nd += v;
  }
  for (int i = tid; i < Km1; i += kThreads) diff[i] = eta_d[i] - mu_d[i];
  const float Nd = block_sum(nd, red);  // its barriers publish c and diff

  // prior term: sdiff = diff · siginv, quad = ½ diffᵀ siginv diff
  float qd = 0.f;
  for (int j = tid; j < Km1; j += kThreads) {
    float acc = 0.f;
    for (int i = 0; i < Km1; ++i) acc += diff[i] * siginv[(size_t)i * Km1 + j];
    sdiff[j] = acc;
    qd += diff[j] * acc;
  }
  const float quad = 0.5f * block_sum(qd, red);

  // per-word mixture s_l = Σ_k e_k β_kl and the log-likelihood
  float llp = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    float acc = 0.f;
    for (int k = 0; k < K; ++k) acc += e[k] * beta_d[(size_t)k * L + l];
    acc = fmaxf(acc, kTiny);
    s[l] = acc;
    if (c[l] > 0.f) llp += c[l] * (logf(acc) + m);
  }
  const float ll = block_sum(llp, red);  // publishes s

  // q_k = Σ_l phi_hat[k,l] c_l, one warp per topic
  for (int k = warp; k < Km1; k += kWarps) {
    float acc = 0.f;
    for (int l = lane; l < L; l += 32) {
      if (c[l] > 0.f) acc += (e[k] * beta_d[(size_t)k * L + l] / s[l]) * c[l];
    }
    acc = warp_sum(acc);
    if (lane == 0) q[k] = acc;
  }
  __syncthreads();

  for (int i = tid; i < Km1; i += kThreads) {
    const float th = e[i] / sum_e;
    g_d[i] = sdiff[i] + (Nd * th - q[i]);
  }
  if (tid == 0) *f_d = quad - ll + Nd * (m + logf(sum_e));

  // Hessian tiles
  const int tx = tid & 31, ty = tid >> 5;  // ty in [0, 8): rows ty + 8r
  const int nT = (Km1 + kTile - 1) / kTile;
  for (int ti = 0; ti < nT; ++ti) {
    for (int tj = ti; tj < nT; ++tj) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int l0 = 0; l0 < L; l0 += kTile) {
        __syncthreads();  // the previous step's tiles are consumed
        const int l = l0 + tx;
        const float cl = l < L ? c[l] : 0.f;
        const bool live = cl > 0.f;
        const float sl = live ? s[l] : 1.f;
        const float rc = live ? sqrtf(cl) : 0.f;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = ty + 8 * r;
          const int i = ti * kTile + row, j = tj * kTile + row;
          float va = 0.f, vb = 0.f;
          if (live && i < Km1) va = (e[i] * beta_d[(size_t)i * L + l] / sl) * rc;
          if (live && j < Km1) vb = (e[j] * beta_d[(size_t)j * L + l] / sl) * rc;
          if (bf16) {
            va = bf16_round(va);
            vb = bf16_round(vb);
          }
          At[tx * kTilePad + row] = va;
          Bt[tx * kTilePad + row] = vb;
        }
        __syncthreads();
#pragma unroll 8
        for (int ll2 = 0; ll2 < kTile; ++ll2) {
          const float bv = Bt[ll2 * kTilePad + tx];
#pragma unroll
          for (int r = 0; r < 4; ++r) acc[r] += At[ll2 * kTilePad + ty + 8 * r] * bv;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ti * kTile + ty + 8 * r, j = tj * kTile + tx;
        if (i < Km1 && j < Km1) {
          const float thi = e[i] / sum_e, thj = e[j] / sum_e;
          float h = acc[r] - (Nd * thi) * thj;
          if (i == j) h += Nd * thi - q[i];
          h += siginv[(size_t)i * Km1 + j];
          H_d[(size_t)i * Km1 + j] = h;
          if (ti != tj) H_d[(size_t)j * Km1 + i] = h;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Steihaug CG of one document (B2's, B4's and B5's body)
// ---------------------------------------------------------------------------
//
// Scratch (cg_scratch floats): red[32] | p | r | z | x | dinv | Ap (Km1
// each).  The Jacobi preconditioner comes from the unrounded diagonal
// of H_d; the matvecs read Hm, rounding each entry to bf16 as it is read
// when round_load (Hm may be H_d itself, or a copy rounded beforehand).
// The recurrences run in float32 with p unrounded, as in the TPU kernel.
// Each document freezes at its first direction with pᵀHp <= 1e-30.
__device__ void doc_cg(const float* H_d, const float* Hm, int round_load, const float* g_d,
                       float* x_out, int Km1, int iters, float* sm) {
  const int tid = threadIdx.x;
  float* red = sm;
  float* p = red + 32;
  float* r = p + Km1;
  float* z = r + Km1;
  float* x = z + Km1;
  float* dinv = x + Km1;
  float* Ap = dinv + Km1;

  float part = 0.f;
  for (int i = tid; i < Km1; i += kThreads) {
    dinv[i] = 1.f / fmaxf(fabsf(H_d[(size_t)i * Km1 + i]), 1e-20f);
    const float ri = -g_d[i];
    r[i] = ri;
    const float zi = dinv[i] * ri;
    z[i] = zi;
    p[i] = zi;
    x[i] = 0.f;
    part += ri * zi;
  }
  float rz = block_sum(part, red);  // also publishes p
  bool active = true;

  for (int it = 0; it < iters; ++it) {
    // Ap = p · H (H symmetric), one output coordinate per thread
    part = 0.f;
    for (int j = tid; j < Km1; j += kThreads) {
      float acc = 0.f;
      for (int i = 0; i < Km1; ++i) {
        float h = Hm[(size_t)i * Km1 + j];
        if (round_load) h = bf16_round(h);
        acc += p[i] * h;
      }
      Ap[j] = acc;
      part += p[j] * acc;
    }
    const float pAp = block_sum(part, red);
    active = active && (pAp > 1e-30f);
    const float alpha = rz / (pAp > 1e-30f ? pAp : 1.f);
    part = 0.f;
    for (int i = tid; i < Km1; i += kThreads) {
      if (active) {
        x[i] += alpha * p[i];
        r[i] -= alpha * Ap[i];
      }
      z[i] = dinv[i] * r[i];
      part += r[i] * z[i];
    }
    const float rz_new = block_sum(part, red);
    const float beta = rz_new / fmaxf(rz, 1e-30f);
    if (active) {
      for (int i = tid; i < Km1; i += kThreads) p[i] = z[i] + beta * p[i];
      rz = rz_new;
    }
    __syncthreads();  // p is read whole by the next matvec
  }
  for (int i = tid; i < Km1; i += kThreads) x_out[i] = x[i];
}

// ---------------------------------------------------------------------------
// Armijo sweep of one document (B4's and B5's; B3 has its own design)
// ---------------------------------------------------------------------------
//
// fs_d[t] = f(eta + ts[t] p) for t < T (T <= kMaxT).  `sig` is siginv in
// global or shared memory; the caller fills a shared copy before the
// call (the body's first barrier publishes it).
//
// Scratch (sweep_scratch floats): red[32] | m[kMaxT] | lse[kMaxT] |
// llw[kWarps*kMaxT] | ts[kMaxT] | eta | p | mu (Km1 each) | et[T*K] |
// dq[T*Km1].  beta_doc is read once: one thread per word slot l forms all
// T candidate mixtures s[t,l] = Σ_k e[t,k] β_kl in registers.
__device__ void doc_sweep(const float* sig, const float* ts, const float* eta_d,
                          const float* p_d, const float* mu_d,
                          const float* __restrict__ beta_d, const float* __restrict__ cnt_d,
                          float* fs_d, int K, int L, int T, float* sm) {
  const int Km1 = K - 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  float* red = sm;
  float* mt = red + 32;
  float* lse = mt + kMaxT;
  float* llw = lse + kMaxT;
  float* tsv = llw + kWarps * kMaxT;
  float* eta_s = tsv + kMaxT;
  float* p_s = eta_s + Km1;
  float* mu_s = p_s + Km1;
  float* et = mu_s + Km1;
  float* dq = et + T * K;

  for (int i = tid; i < Km1; i += kThreads) {
    eta_s[i] = eta_d[i];
    p_s[i] = p_d[i];
    mu_s[i] = mu_d[i];
  }
  if (tid < T) tsv[tid] = ts[tid];
  __syncthreads();

  // candidates (padded with the pinned 0) and their softmax numerators
  for (int idx = tid; idx < T * K; idx += kThreads) {
    const int t = idx / K, k = idx - t * K;
    et[idx] = k < Km1 ? eta_s[k] + tsv[t] * p_s[k] : 0.f;
  }
  __syncthreads();
  for (int t = warp; t < T; t += kWarps) {
    float mx = -INFINITY;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, et[t * K + k]);
    mx = warp_max(mx);
    float se = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = expf(et[t * K + k] - mx);
      et[t * K + k] = v;
      se += v;
    }
    se = warp_sum(se);
    if (lane == 0) {
      mt[t] = mx;
      lse[t] = mx + logf(se);
    }
  }

  // prior term of every candidate: dq[t, j] = diff_j · (diff · siginv)_j
  for (int idx = tid; idx < T * Km1; idx += kThreads) {
    const int t = idx / Km1, j = idx - t * Km1;
    const float step = tsv[t];
    float acc = 0.f;
    for (int i = 0; i < Km1; ++i) {
      const float di = (eta_s[i] + step * p_s[i]) - mu_s[i];
      acc += di * sig[(size_t)i * Km1 + j];
    }
    dq[idx] = ((eta_s[j] + step * p_s[j]) - mu_s[j]) * acc;
  }

  float nd = 0.f;
  for (int l = tid; l < L; l += kThreads) nd += cnt_d[l];
  const float Nd = block_sum(nd, red);  // publishes et, mt, lse, dq

  float llp[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) llp[t] = 0.f;
  for (int l = tid; l < L; l += kThreads) {
    float acc[kMaxT];
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[t] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float b = beta_d[(size_t)k * L + l];
#pragma unroll
      for (int t = 0; t < kMaxT; ++t)
        if (t < T) acc[t] += et[t * K + k] * b;
    }
    const float cl = cnt_d[l];
    if (cl > 0.f) {
#pragma unroll
      for (int t = 0; t < kMaxT; ++t)
        if (t < T) llp[t] += cl * (logf(fmaxf(acc[t], kTiny)) + mt[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const float v = warp_sum(llp[t]);
    if (lane == 0) llw[warp * kMaxT + t] = v;
  }
  __syncthreads();

  for (int t = warp; t < T; t += kWarps) {
    float qs = 0.f;
    for (int j = lane; j < Km1; j += 32) qs += dq[t * Km1 + j];
    qs = warp_sum(qs);
    if (lane == 0) {
      float ll = 0.f;
      for (int w = 0; w < kWarps; ++w) ll += llw[w * kMaxT + t];
      fs_d[t] = 0.5f * qs - ll + Nd * lse[t];
    }
  }
}

// ---------------------------------------------------------------------------
// host helpers
// ---------------------------------------------------------------------------

inline int max_optin_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace
