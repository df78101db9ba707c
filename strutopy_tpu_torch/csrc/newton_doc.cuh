// Per-document bodies of the damped-Newton E-step, as __device__
// functions that one thread block (kThreads threads) runs for one
// document.  Each function has this one definition: the stage kernels of
// stages.cu (B1 fgh, B2 cg, B3 ls) are thin wrappers around them, and the
// fused kernel of newton.cu (B4 one iteration, B5 the whole loop) runs the
// same three bodies in turn inside one block, so every path computes f,
// g, H, the CG direction and the sweep with the same float32 operations
// in the same order.
//
//   fgh_body  f, g, H of a document (B1): beta_doc streamed once in slabs
//             through a cp.async ring, B·Bᵀ on the tensor cores; with
//             FINAL, the E-step finalize's g, H, theta, phi and bound terms
//             in float32 from the same stream (Z)
//   cg_body   Jacobi-preconditioned Steihaug CG (B2) from H in shared
//             memory (or, at large K, in device memory)
//   ls_body   the Armijo sweep f(eta + t p) for T step sizes (B3), the
//             same slab stream
//   grad_converged, descent_direction, armijo_step
//             the step's glue around them (B4, B5, and the stage path's
//             two glue kernels in stages.cu)
//
// Every body takes its per-document inputs and outputs as generic
// pointers (device or shared memory alike) and its scratch in the block's
// dynamic shared memory.  A body ends without a barrier: the caller
// places a __syncthreads() before it reads a body's outputs or reuses its
// scratch.
//
// Arithmetic follows the plain PyTorch versions in
// strutopy_tpu_torch/ops/stages.py operation for operation (the same
// divisions, the same bf16 rounding points); only the order of the
// float32 sums differs.  expf/logf/sqrtf are the accurate versions (no
// fast-math).  No atomics: a document's outputs depend only on its own
// inputs, in a fixed order.
//
// beta_doc's element type TB is float32, or bf16 for the Newton search
// under newton_bf16_beta: the ring then holds bf16 slabs (half the bytes),
// and every read of the ring converts to float32 (ldf, ld4), so all the
// arithmetic after that read is the float32 path's, on the rounded values.
// With bf16 slabs B1 forms B·Bᵀ's tiles in pairs that share their
// fragment loads (kPaired below), B3's prior term keeps more loads of
// siginv in flight, and B3 takes a plan of its own (stages.cu).
//
// Notation: K topics, Km1 = K - 1 free coordinates, L padded word slots,
// T step sizes, W word slots a slab; row-major float32 throughout but
// beta_doc.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 16;        // most step sizes the sweep takes
constexpr float kTiny = 1e-35f;  // floor of the per-word mixture s_l

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// One slot of a beta_doc slab as float32 (exact for bf16).
__device__ __forceinline__ float ldf(const float* p) { return *p; }
__device__ __forceinline__ float ldf(const __nv_bfloat16* p) { return __bfloat162float(*p); }

// Four consecutive slots as float32: one 16-byte shared-memory read of
// float32, one 8-byte read of bf16 (p aligned to that size).
struct __align__(8) Bf16x4 {
  __nv_bfloat162 lo, hi;
};
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const Bf16x4 v = *reinterpret_cast<const Bf16x4*>(p);
  const float2 a = __bfloat1622float2(v.lo), b = __bfloat1622float2(v.hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

// Floats of shared memory that n beta_doc elements of TB take (n even).
__host__ __device__ inline size_t beta_floats(size_t n, int beta_bytes) {
  return n * beta_bytes / sizeof(float);
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

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }
__host__ __device__ inline size_t round4(size_t x) { return (x + 3) & ~(size_t)3; }

// ---------------------------------------------------------------------------
// cp.async and the tensor-core product
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Slab [K, W] of a document's beta_doc block (K rows of stride L) from
// word slot l0, into dst (row stride W).  Slots at or past L are filled
// with zeros.  vec16: L a multiple of the slots in 16 bytes (4 float32, 8
// bf16) and the block 16-byte aligned, so each 16-byte chunk is wholly in
// or out.  Else float32 slots go one 4-byte cp.async each, and bf16 slots
// (2 bytes, below cp.async's smallest copy) by plain loads and stores,
// which the barrier that publishes the cp.async groups publishes too.
template <int W, typename TB>
__device__ __forceinline__ void load_slab(TB* dst, const TB* __restrict__ src, int K, int L,
                                          int l0, int vec16) {
  constexpr int kPer = 16 / sizeof(TB);  // slots a 16-byte chunk
  if (vec16) {
    constexpr int kChunks = W / kPer;
    for (int idx = threadIdx.x; idx < K * kChunks; idx += kThreads) {
      const int k = idx / kChunks, c = idx - k * kChunks;
      const int l = l0 + kPer * c;
      const bool in = l < L;
      cp_async16(dst + k * W + kPer * c, in ? src + (size_t)k * L + l : src, in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < K * W; idx += kThreads) {
      const int k = idx / W, c = idx - k * W;
      const int l = l0 + c;
      const bool in = l < L;
      if constexpr (sizeof(TB) == sizeof(float))
        cp_async4(dst + k * W + c, in ? src + (size_t)k * L + l : src, in ? 4 : 0);
      else
        dst[k * W + c] = in ? src[(size_t)k * L + l] : __float2bfloat16(0.f);
    }
  }
}

// siginv (n = (K-1)² floats, in device memory) into shared memory with cp.async.
__device__ __forceinline__ void load_siginv(float* dst, const float* __restrict__ siginv, int n) {
  const int n4 = (uintptr_t)siginv % 16 == 0 ? n / 4 : 0;
  for (int c = threadIdx.x; c < n4; c += kThreads) cp_async16(dst + 4 * c, siginv + 4 * c, 16);
  for (int i = 4 * n4 + threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, siginv + i, 4);
}

// d += a·b on the tensor cores: one m16n8k16 tile, bf16 in, float32 out.
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The A (16x16) and B (16x8) fragments of one m16n8k16 tile from bf16 rows
// of shared memory: A from rows r0 .. r0+15, B from rows c0 .. c0+7 (the
// operand transposed), both at depth k0 .. k0+15.
__device__ __forceinline__ void ldmatrix_a(uint32_t* a, const __nv_bfloat16* op, int stride,
                                           int r0, int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = op + (r0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride + k0 +
                           (lane >> 4) * 8;
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(s));
}

__device__ __forceinline__ void ldmatrix_b(uint32_t* b, const __nv_bfloat16* op, int stride,
                                           int c0, int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p = op + (c0 + (lane & 7)) * stride + k0 + ((lane >> 3) & 1) * 8;
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(s));
}

// The B fragments of two 16x8 tiles side by side (columns c0 .. c0+15):
// b[0..1] for columns c0 .. c0+7, b[2..3] for c0+8 .. c0+15.
__device__ __forceinline__ void ldmatrix_b2(uint32_t* b, const __nv_bfloat16* op, int stride,
                                            int c0, int k0) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* p =
      op + (c0 + (lane & 7) + ((lane >> 4) & 1) * 8) * stride + k0 + ((lane >> 3) & 1) * 8;
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(s));
}

// ---------------------------------------------------------------------------
// B1: f, g, H
// ---------------------------------------------------------------------------
//
// Bound on the H100 by device memory: per document it reads beta_doc
// (K·L·4 bytes, 2 in bf16) and writes H ((K-1)²·4 bytes); the B·Bᵀ product is
// 2·(K-1)²·L flops, ~0.04 flop a byte in bf16.  Design: one block per
// document (times a tile group, below) streams beta_doc once, in slabs of
// W word slots (64 where two blocks with a three-slab ring fit an SM,
// else 32).  Each slab gives its s_l = Σ_k e_k β_kl (per-warp partial
// sums over k ≡ warp, added in warp order), its log-likelihood and q
// terms, and its B·Bᵀ operand Bmat[k,l] = (e_k β_kl / s_l)·sqrt(c_l) for
// k < K-1, rounded to bf16 (bf16 mode) into shared memory; rows K-1 ..
// Kp-1 (Kp = K-1 rounded up to 16) stay zero.  H += Bmat·Bmatᵀ then runs
// on the tensor cores (ldmatrix fragments, mma.sync m16n8k16, float32
// accumulators held in registers across slabs), upper triangle only: the
// output is cut into 16x8 tiles (ti, tj) with tj >= 2 ti, eight a warp,
// 64 a block.  Above K ~115 the tiles split into ceil(tiles / 64) tile
// groups (grp), each re-streaming its document, and group 0 alone writes
// f and g.  Where the ring can hold it, siginv comes in by cp.async
// beside the first slab, so the prior term reads shared memory.  bf16 = 0
// keeps the operand in float32 and forms the same tiles with float32
// FMAs on the CUDA cores.
//
// Z (FINAL: the float32 mode with the finalize's outputs, FinOut below)
// adds per slab the mixture t_l = Σ_k θ_k e_k β_kl beside s_l (the same
// loads, the same order), its log-likelihood terms, and phi for all K
// topics, staged in shared memory and written out as the slab's contiguous
// run of (B, L, K) memory while the product runs.  It sums q a slab at a
// time (a warp sum a topic, added in slab order) and so holds no per-lane
// partials: the ~32·K floats this frees keep Z's largest K above B1's
// default mode's (bf16 operand), the E-step's Newton limit.  Per document it reads
// beta_doc once and writes phi and H: ~89 MB at B=256, K=100, L=384, so
// it is bound by bytes (~27 µs) ahead of its float32 product (~15 µs).
//
// bf16 slabs (kPaired): a warp takes its tiles in pairs side by side in
// one row tile (each row tile holds an even number of tiles), with one A
// and one B load for the two products; each tile's sums are the unpaired
// order's.
//
// Operand row strides: bf16 rows of W + 8 (80 or 144 bytes: a warp's
// ldmatrix rows hit distinct banks), float32 rows of W + 1.
__host__ __device__ constexpr int op_stride_bf(int W) { return W + 8; }
__host__ __device__ constexpr int op_stride_f(int W) { return W + 1; }
constexpr int kTilesPerWarp = 8;
constexpr int kTilesPerGroup = kTilesPerWarp * kWarps;

// Row stride of Z's phi stage (below): K rounded up to odd, so a warp's 32
// word slots of one topic hit 32 distinct banks.
__host__ __device__ inline int fin_stage_ld(int K) { return K | 1; }

// Shared-memory layout of B1, in floats; the ring holds `stages` slabs of
// beta_doc elements of beta_bytes (4 or 2) each.  `final` adds the
// finalize's buffers (Z, below) in place of the per-lane q partials: 1
// its mixture coefficients and partial sums, 2 those and the phi stage of
// a slab; 0 none.
struct FghLayout {
  size_t ring, part, qpart, te, tpart, stage, e, diff, sdiff, q, red, op, floats;
};

__host__ __device__ inline FghLayout fgh_layout(int K, int W, int stages, int bf16,
                                                int beta_bytes, int final = 0) {
  const int Km1 = K - 1, Kp = round16(Km1);
  FghLayout o;
  size_t at = 0;
  o.ring = at;   at += beta_floats((size_t)stages * K * W, beta_bytes);  // the slabs
  o.part = at;   at += (size_t)kWarps * W;       // per-warp partial s_l
  o.qpart = at;  at += final ? 0 : (size_t)Km1 * 32;  // per-lane partial q_k
  o.te = at;     at += final ? K : 0;            // Z: θ_k e_k
  o.tpart = at;  at += final ? (size_t)kWarps * W : 0;  // Z: per-warp partial t_l
  o.stage = at;  at += final == 2 ? (size_t)W * fin_stage_ld(K) : 0;  // Z: a slab's phi
  o.e = at;      at += K;
  o.diff = at;   at += Km1;
  o.sdiff = at;  at += Km1;
  o.q = at;      at += Km1;
  o.red = at;    at += 32;
  at = (at + 3) & ~(size_t)3;
  o.op = at;
  at += bf16 ? (size_t)Kp * op_stride_bf(W) / 2 : (size_t)Kp * op_stride_f(W);
  o.floats = at;
  return o;
}

__host__ __device__ inline int fgh_tiles(int K) {
  const int n16 = round16(K - 1) / 16;
  return n16 * (n16 + 1);  // Σ over row tiles ti of the 16x8 tiles tj >= 2 ti
}

__host__ __device__ inline int fgh_groups(int K) {
  return (fgh_tiles(K) + kTilesPerGroup - 1) / kTilesPerGroup;
}

// Where B1 writes H.  The stage kernel (FUSED = false) writes document
// d's float32 (Km1, Km1) block of `glob` in device memory: assembled in
// the free ring and written in whole rows where one group covers H and it
// fits before e (scattered tile stores had cost half the kernel's time),
// else entry by entry.  The fused kernel (FUSED = true) writes H where CG
// reads it: rows of `ld` in shared memory (`sm`, bf16 values in bf16
// mode, else float32), or, where that does not fit, float32 into `glob`;
// and in both cases the unrounded float32 diagonal into `diag`, from
// which CG builds its preconditioner.
struct HOut {
  float* glob;
  void* sm;
  float* diag;
  int ld;
};

// Z, the E-step finalize (FINAL = true, float32 operand, stages.cu's
// finalize_kernel): besides g and H at the converged eta, each document's
// theta, phi = phi_hat·c_l·doc_w for all K topics, and the bound's terms
// at theta (the reference's lower bound): loglik = Σ_l c_l (log t_l + m)
// with the mixture t_l = Σ_k θ_k e_k β_kl, and quad = ½ dᵀΣ⁻¹d.  Nd is
// read, as the plain version takes it.  phi goes to (B, L, K) memory, one
// slot's K values contiguous: where the plan has room (stage), a slab's
// phi is staged in shared memory and written as one contiguous run of
// W·K floats, else stored element by element.  Group 0 alone writes
// these.  Document d's are Nd[d], doc_w[d], theta[d·K ..], phi from
// d·L·K and terms[2d], terms[2d + 1] (loglik, quad).
struct FinOut {
  const float* Nd;
  const float* doc_w;
  float* theta;
  float* phi;
  float* terms;
  int stage;
};

// Document d's outputs are f_out[d], g_out[d·Km1 ..] and H's block d; its
// mu is mu[d·Km1 ..].  They are addressed where they are used, so that no
// pointer stays live in a register across the stream.  RESIDENT: the ring
// holds all of the document's slabs already (the fused kernel loads them
// once for the whole Newton loop), so nothing is streamed.  TB: beta_doc's
// element type.  FINAL: Z (FinOut above; f is not written).
template <int W, int STAGES, bool BF16, bool FUSED, bool RESIDENT = false, typename TB = float,
          bool FINAL = false>
__device__ __forceinline__ void fgh_body(
    const float* __restrict__ siginv, bool sig_shared, const float* eta_d, const float* mu,
    const TB* __restrict__ beta_d, const float* __restrict__ cnt_d, float* f_out,
    float* g_out, const HOut& hout, size_t d, int K, int L, int vec16, int grp, float* smem,
    const FinOut& fin = FinOut{}) {
  static_assert(!FINAL || (!BF16 && !FUSED && !RESIDENT && sizeof(TB) == 4),
                "the finalize runs the float32 stage body");
  constexpr bool kPaired = sizeof(TB) == 2;  // bf16 slabs: the tiles in pairs
  constexpr int kOpStrideBf = op_stride_bf(W), kOpStrideF = op_stride_f(W);
  constexpr int kCols = W / 32;  // word slots of a lane in a slab
  const int Km1 = K - 1, Kp = round16(Km1);
  const int n_slabs = (L + W - 1) / W;
  const FghLayout lay = fgh_layout(K, W, RESIDENT ? n_slabs : STAGES, BF16, sizeof(TB),
                                   FINAL ? 1 + (fin.stage != 0) : 0);
  TB* ring = reinterpret_cast<TB*>(smem + lay.ring);
  float* sig_buf = reinterpret_cast<float*>(ring + K * W);  // the ring's buffers 1 ..
  float* part = smem + lay.part;
  float* qpart = smem + lay.qpart;
  float* te = smem + lay.te;
  float* tpart = smem + lay.tpart;
  float* stage = smem + lay.stage;
  const int sld = fin_stage_ld(K);
  const bool fin_out = FINAL && grp == 0;  // this block writes Z's outputs
  float* e = smem + lay.e;
  float* diff = smem + lay.diff;
  float* sdiff = smem + lay.sdiff;
  float* q = smem + lay.q;
  float* red = smem + lay.red;
  __nv_bfloat16* op_b = reinterpret_cast<__nv_bfloat16*>(smem + lay.op);
  float* op_f = smem + lay.op;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // The first slabs load while the block does the per-document set-up.
  // Where the ring's other buffers hold siginv (and it is not in shared
  // memory already), it comes in first, for the prior term to read from
  // shared memory; the later slabs follow it.
  const bool sig_ring = !RESIDENT && !sig_shared && grp == 0 &&
                        (size_t)Km1 * Km1 <= beta_floats((size_t)(STAGES - 1) * K * W, sizeof(TB));
  if (sig_ring) {
    load_siginv(sig_buf, siginv, Km1 * Km1);
    cp_async_commit();
  }
  for (int s = 0; !RESIDENT && s < (sig_ring ? 1 : STAGES - 1); ++s) {
    if (s < n_slabs) load_slab<W>(ring + (size_t)s * K * W, beta_d, K, L, s * W, vec16);
    cp_async_commit();
  }

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
  if constexpr (FINAL) {
    // theta, and the mixture's coefficients θ_k·e_k rounded as theta * e
    for (int k = tid; k < K; k += kThreads) {
      const float th = e[k] / sum_e;
      te[k] = __fmul_rn(th, e[k]);
      if (fin_out) fin.theta[d * K + k] = th;
    }
  }

  float nd = 0.f;
  for (int l = tid; l < L; l += kThreads) nd += cnt_d[l];
  for (int i = tid; i < Km1; i += kThreads) diff[i] = eta_d[i] - mu[d * Km1 + i];
  for (int i = tid; !FINAL && i < Km1 * 32; i += kThreads) qpart[i] = 0.f;
  // operand rows Km1 .. Kp-1 are zero for the whole stream
  if (BF16) {
    for (int i = Km1 * kOpStrideBf + tid; i < Kp * kOpStrideBf; i += kThreads)
      op_b[i] = __float2bfloat16(0.f);
  } else {
    for (int i = Km1 * kOpStrideF + tid; i < Kp * kOpStrideF; i += kThreads) op_f[i] = 0.f;
  }
  float Nd = block_sum(nd, red);  // its barriers publish the above
  if constexpr (FINAL) Nd = fin.Nd[d];  // the finalize's Nd, as the plain version's

  // prior term (group 0 writes f and g): sdiff_j = Σ_i diff_i siginv[i, j],
  // each column's two halves of i summed by two threads (the upper half
  // into q, free until the stream ends), then added
  float quad = 0.f;
  if (grp == 0) {
    if (sig_ring) {
      cp_async_wait<1>();  // siginv has landed (slab 0 may not have)
      __syncthreads();
    }
    const float* sig = sig_ring ? sig_buf : siginv;
    const int half = Km1 / 2;
    for (int idx = tid; idx < 2 * Km1; idx += kThreads) {
      const int h = idx >= Km1, j = idx - h * Km1;
      float acc = 0.f;
#pragma unroll 8
      for (int i = h * half; i < (h ? Km1 : half); ++i) acc += diff[i] * sig[(size_t)i * Km1 + j];
      (h ? q : sdiff)[j] = acc;
    }
    __syncthreads();  // also: siginv's buffers are free for the slabs
    if (sig_ring) {
      for (int s = 1; s < STAGES - 1; ++s) {
        if (s < n_slabs) load_slab<W>(ring + (size_t)s * K * W, beta_d, K, L, s * W, vec16);
        cp_async_commit();
      }
    }
    float qd = 0.f;
    for (int j = tid; j < Km1; j += kThreads) {
      const float acc = sdiff[j] + q[j];
      sdiff[j] = acc;
      qd += diff[j] * acc;
    }
    quad = 0.5f * block_sum(qd, red);
  }
  // Z: q is summed in place from here (its barriers and the stream's first
  // publish the zeros)
  for (int i = tid; FINAL && i < Km1; i += kThreads) q[i] = 0.f;

  // this warp's accumulator tiles: rows i0 .. i0+15, columns j0 .. j0+7;
  // bf16 slabs: pairs of tiles, pair warp + kWarps j of the group
  const int n16 = Kp / 16, n_tiles = fgh_tiles(K);
  int ti0[kTilesPerWarp], tj0[kTilesPerWarp];
  int my_tiles = 0;
#pragma unroll
  for (int r = 0; r < kTilesPerWarp; ++r) {
    int t = grp * kTilesPerGroup + warp + kWarps * r;
    if (kPaired) t = grp * kTilesPerGroup + 2 * (warp + kWarps * (r >> 1)) + (r & 1);
    ti0[r] = 0;
    tj0[r] = 0;
    if (t < n_tiles) {
      int ti = 0;
      while (t >= 2 * (n16 - ti)) {
        t -= 2 * (n16 - ti);
        ++ti;
      }
      ti0[r] = 16 * ti;
      tj0[r] = 8 * (2 * ti + t);
      my_tiles = r + 1;
    }
  }
  float acc[kTilesPerWarp][4];
#pragma unroll
  for (int r = 0; r < kTilesPerWarp; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;

  const int g8 = lane >> 2, t4 = lane & 3;
  float llp = 0.f;  // warp 0: its lane's word slots' log-likelihood terms
  float llt = 0.f;  // Z, warp 0: the same terms at the mixture t_l
  const float w_d = FINAL ? fin.doc_w[d] : 0.f;
  for (int s = 0; s < n_slabs; ++s) {
    if (!RESIDENT) cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab s has landed; slab s-1's buffer is free
    if (!RESIDENT) {
      const int sn = s + STAGES - 1;
      if (sn < n_slabs)
        load_slab<W>(ring + (size_t)(sn % STAGES) * K * W, beta_d, K, L, sn * W, vec16);
      cp_async_commit();
    }
    const TB* slab = ring + (size_t)(RESIDENT ? s : s % STAGES) * K * W;

    // s_l: warp w sums the topics k ≡ w (mod kWarps) of its lane's slots
    // (Z: t_l beside it, in the same order)
    float ps[kCols], pt[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) ps[u] = pt[u] = 0.f;
#pragma unroll 4
    for (int k = warp; k < K; k += kWarps) {
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        ps[u] += e[k] * ldf(slab + k * W + lane + 32 * u);
        if constexpr (FINAL) pt[u] += te[k] * ldf(slab + k * W + lane + 32 * u);
      }
    }
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      part[warp * W + lane + 32 * u] = ps[u];
      if constexpr (FINAL) tpart[warp * W + lane + 32 * u] = pt[u];
    }
    __syncthreads();
    float sl[kCols], cl[kCols], rc[kCols];
    bool live[kCols];
#pragma unroll
    for (int u = 0; u < kCols; ++u) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w * W + lane + 32 * u];
      sl[u] = fmaxf(v, kTiny);
      const int l = s * W + lane + 32 * u;
      cl[u] = l < L ? cnt_d[l] : 0.f;
      live[u] = cl[u] > 0.f;
      if (warp == 0 && live[u]) llp += cl[u] * (logf(sl[u]) + m);
      rc[u] = live[u] ? sqrtf(cl[u]) : 0.f;
      if constexpr (FINAL) {
        if (warp == 0 && live[u]) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) t += tpart[w * W + lane + 32 * u];
          llt += cl[u] * (logf(fmaxf(t, kTiny)) + m);
        }
      }
    }

    // phi_hat, its q terms and the B·Bᵀ operand, rows k < Km1 (Z: and the
    // phi of every topic, the last one's too)
#pragma unroll 4
    for (int k = warp; k < (FINAL ? K : Km1); k += kWarps) {
      const bool free_k = !FINAL || k < Km1;
      float qv = FINAL ? 0.f : qpart[k * 32 + lane];
#pragma unroll
      for (int u = 0; u < kCols; ++u) {
        const int col = lane + 32 * u;
        const float ph = live[u] ? e[k] * ldf(slab + k * W + col) / sl[u] : 0.f;
        qv += ph * cl[u];
        const float v = ph * rc[u];
        if (BF16) {
          op_b[k * kOpStrideBf + col] = __float2bfloat16(v);
        } else if (free_k) {
          op_f[k * kOpStrideF + col] = v;
        }
        if constexpr (FINAL) {
          if (fin_out) {  // phi_hat · c · doc_w, rounded as the plain version rounds it
            const float p = __fmul_rn(__fmul_rn(ph, cl[u]), w_d);
            if (fin.stage)
              stage[col * sld + k] = p;
            else if (s * W + col < L)
              fin.phi[((size_t)d * L + s * W + col) * K + k] = p;
          }
        }
      }
      if constexpr (FINAL) {
        if (free_k) {  // this slab's q terms of topic k, added in slab order
          const float v = warp_sum(qv);
          if (lane == 0) q[k] += v;
        }
      } else {
        qpart[k * 32 + lane] = qv;
      }
    }
    __syncthreads();  // the operand is complete
    if constexpr (FINAL) {
      // the slab's phi: its slots' K values, one contiguous run (the next
      // slab writes the stage after its first barrier)
      if (fin_out && fin.stage) {
        const int n = min(W, L - s * W);
        float* out = fin.phi + ((size_t)d * L + s * W) * K;
        for (int l = warp; l < n; l += kWarps)
          for (int k = lane; k < K; k += 32) out[l * K + k] = stage[l * sld + k];
      }
    }

    if (BF16) {
#pragma unroll
      for (int kk = 0; kk < W; kk += 16) {
        if constexpr (kPaired) {
#pragma unroll
          for (int j = 0; j < kTilesPerWarp / 2; ++j) {
            if (2 * j < my_tiles) {
              uint32_t a[4], b[4];
              ldmatrix_a(a, op_b, kOpStrideBf, ti0[2 * j], kk);
              ldmatrix_b2(b, op_b, kOpStrideBf, tj0[2 * j], kk);
              mma_bf16(acc[2 * j], a, b);
              mma_bf16(acc[2 * j + 1], a, b + 2);
            }
          }
        } else {
#pragma unroll
          for (int r = 0; r < kTilesPerWarp; ++r) {
            if (r < my_tiles) {
              uint32_t a[4], b[2];
              ldmatrix_a(a, op_b, kOpStrideBf, ti0[r], kk);
              ldmatrix_b(b, op_b, kOpStrideBf, tj0[r], kk);
              mma_bf16(acc[r], a, b);
            }
          }
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < kTilesPerWarp; ++r) {
        if (r < my_tiles) {
          const float* ra = op_f + (ti0[r] + g8) * kOpStrideF;
          const float* rb = op_f + (tj0[r] + 2 * t4) * kOpStrideF;
#pragma unroll 8
          for (int ll = 0; ll < W; ++ll) {
            const float a0 = ra[ll], a1 = ra[8 * kOpStrideF + ll];
            const float b0 = rb[ll], b1 = rb[kOpStrideF + ll];
            acc[r][0] += a0 * b0;
            acc[r][1] += a0 * b1;
            acc[r][2] += a1 * b0;
            acc[r][3] += a1 * b1;
          }
        }
      }
    }
  }

  // q_k: the per-lane partials, one warp per topic (Z has summed it)
  for (int k = warp; !FINAL && k < Km1; k += kWarps) {
    const float v = warp_sum(qpart[k * 32 + lane]);
    if (lane == 0) q[k] = v;
  }
  const float ll = warp_sum(llp);  // meaningful in warp 0
  const float ll_t = FINAL ? warp_sum(llt) : 0.f;  // likewise
  cp_async_wait<0>();  // (only empty groups are pending)
  __syncthreads();  // publishes q; the ring, part and qpart are free

  if (grp == 0) {
    for (int i = tid; i < Km1; i += kThreads) {
      const float th = e[i] / sum_e;
      g_out[d * Km1 + i] = sdiff[i] + (Nd * th - q[i]);
    }
    if (tid == 0) {
      if constexpr (FINAL) {
        fin.terms[2 * d] = ll_t;
        fin.terms[2 * d + 1] = quad;
      } else {
        f_out[d] = quad - ll + Nd * (m + logf(sum_e));
      }
    }
  }

  // H = B·Bᵀ - Nd θθᵀ + diag(Nd θ - q) + Σ⁻¹; each upper entry and its
  // mirror, into the place hout names
  const bool staged = !FUSED && gridDim.y == 1 && (size_t)Km1 * Km1 <= lay.e;
  float* H_d = staged ? smem : hout.glob + d * Km1 * Km1;
#pragma unroll
  for (int r = 0; r < kTilesPerWarp; ++r) {
    if (r < my_tiles) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ti0[r] + g8 + (c >= 2 ? 8 : 0);
        const int j = tj0[r] + 2 * t4 + (c & 1);
        if (i <= j && j < Km1) {
          const float thi = e[i] / sum_e, thj = e[j] / sum_e;
          float h = acc[r][c] - (Nd * thi) * thj;
          if (i == j) h += Nd * thi - q[i];
          h += siginv[(size_t)i * Km1 + j];
          if (FUSED && hout.sm != nullptr) {
            if (BF16) {
              __nv_bfloat16* Hb = static_cast<__nv_bfloat16*>(hout.sm);
              Hb[i * hout.ld + j] = Hb[j * hout.ld + i] = __float2bfloat16(h);
            } else {
              float* Hf = static_cast<float*>(hout.sm);
              Hf[i * hout.ld + j] = Hf[j * hout.ld + i] = h;
            }
          } else {
            H_d[(size_t)i * Km1 + j] = h;
            if (i != j) H_d[(size_t)j * Km1 + i] = h;
          }
          if (FUSED && i == j) hout.diag[i] = h;
        }
      }
    }
  }
  if (staged) {
    __syncthreads();
    // whole rows: a scalar head up to a 16-byte boundary, then 16-byte stores
    const int n = Km1 * Km1;
    float* out = hout.glob + d * n;
    const int head = min(n, (int)((16 - (uintptr_t)out % 16) % 16 / 4));
    if (tid < head) out[tid] = smem[tid];
    float4* out4 = reinterpret_cast<float4*>(out + head);
    const int n4 = (n - head) / 4;
    for (int c = tid; c < n4; c += kThreads) {
      const float* v = smem + head + 4 * c;
      out4[c] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int idx = head + 4 * n4 + tid; idx < n; idx += kThreads) out[idx] = smem[idx];
  }
}

// ---------------------------------------------------------------------------
// B2: Steihaug CG
// ---------------------------------------------------------------------------
//
// Bound on the H100 by reading H once ((K-1)²·4 bytes a document); the
// matvecs are 2·(K-1)² flops a step, from shared memory.  What limits it
// is latency: a few µs of dependent steps.  Design: one block per
// document; H is held in shared memory as the values the matvec uses
// (bf16 in bf16 mode, half the bytes of float32), the unrounded float32
// diagonal apart for the Jacobi preconditioner.  Each matvec Ap = p·H
// (H symmetric) uses all eight warps: warp w takes the rows i of its
// slice, lane t the column pairs (2t + 64u, 2t + 64u + 1), read as
// bf16x2 (or float2), and the eight per-warp partial rows are added in
// warp order.  Every warp then holds the whole of Ap and runs the
// recurrences redundantly, in registers, with warp shuffles for pᵀAp and
// rᵀz: the same operations in the same order in every warp, so they
// agree bit for bit.  One barrier a step (the partial rows, double
// buffered); each warp keeps its own slice of p in shared memory for its
// next matvec.  The products are float32 with p unrounded, so the bf16
// rounding point is exactly cg_plain's (H only).  Each document freezes at
// its first direction with pᵀHp <= 1e-30.  NP: column pairs a lane holds,
// so K-1 <= 64·NP.

// The matvec operand, H[i, c] and H[i, c+1] (c even, c < Km1) as float32.
template <bool BF16>
struct HShared {  // rows of ld (even) in shared memory, as the matvec uses them
  static constexpr bool kShared = true;
  const void* h;
  int ld;
  // the pair at pair index `at` = (i·ld + c) / 2
  __device__ __forceinline__ float2 pair_at(int at) const {
    if (BF16)
      return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(h)[at]);
    return reinterpret_cast<const float2*>(h)[at];
  }
};

template <bool BF16>
struct HGlobal {  // float32 rows of Km1 in device memory, rounded as they are read
  static constexpr bool kShared = false;
  const float* h;
  int Km1;
  __device__ __forceinline__ float2 pair(int i, int c) const {
    const float* row = h + (size_t)i * Km1 + c;
    float a = row[0], b = c + 1 < Km1 ? row[1] : 0.f;
    if (BF16) {
      a = bf16_round(a);
      b = bf16_round(b);
    }
    return make_float2(a, b);
  }
};

// Row stride of H in shared memory (elements): K-1 rounded up to even.
__host__ __device__ inline int cg_ld(int Km1) { return (Km1 + 1) & ~1; }

// Scratch of cg_body (floats): part[2][kWarps][ld] | p[ld].
__host__ __device__ inline size_t cg_scratch(int Km1) {
  return (2 * kWarps + 1) * (size_t)cg_ld(Km1);
}

template <int NP, class HM>
__device__ __forceinline__ void cg_body(const HM hm, const float* diag, const float* g_d,
                                        float* x_d, int Km1, int iters, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ld = cg_ld(Km1);
  float* part = scratch;
  float* ps = scratch + 2 * kWarps * ld;
  const int rows = (Km1 + kWarps - 1) / kWarps;
  const int i0 = warp * rows, i1 = min(Km1, i0 + rows);

  // lane's coordinates: c = 2 lane + 64 u + h, for u < NP, h < 2; col[u]
  // the pair index of c in a row (0 for a lane past K-1)
  int col[NP];
#pragma unroll
  for (int u = 0; u < NP; ++u) col[u] = 2 * lane + 64 * u < Km1 ? lane + 32 * u : 0;
  float p[NP][2], r[NP][2], x[NP][2], dinv[NP][2];
  float part_rz = 0.f;
#pragma unroll
  for (int u = 0; u < NP; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 2 * lane + 64 * u + h;
      const bool in = c < Km1;
      dinv[u][h] = in ? 1.f / fmaxf(fabsf(diag[c]), 1e-20f) : 0.f;
      r[u][h] = in ? -g_d[c] : 0.f;
      const float z = dinv[u][h] * r[u][h];
      p[u][h] = z;
      x[u][h] = 0.f;
      part_rz += r[u][h] * z;
    }
  float rz = warp_sum(part_rz);
  bool active = true;

  for (int it = 0; it < iters; ++it) {
    // this warp's rows of p, for its matvec
#pragma unroll
    for (int u = 0; u < NP; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * lane + 64 * u + h;
        if (c >= i0 && c < i1) ps[c] = p[u][h];
      }
    __syncwarp();
    // partial Ap over this warp's rows
    float acc[NP][2];
#pragma unroll
    for (int u = 0; u < NP; ++u) acc[u][0] = acc[u][1] = 0.f;
    if constexpr (HM::kShared) {
      // branch-free: a lane past K-1 reads column 0 and its sums are dropped
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float pi = ps[i];
#pragma unroll
        for (int u = 0; u < NP; ++u) {
          const float2 hv = hm.pair_at(i * (ld / 2) + col[u]);
          acc[u][0] += pi * hv.x;
          acc[u][1] += pi * hv.y;
        }
      }
    } else {
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        const float pi = ps[i];
#pragma unroll
        for (int u = 0; u < NP; ++u) {
          const int c = 2 * lane + 64 * u;
          if (c < Km1) {
            const float2 hv = hm.pair(i, c);
            acc[u][0] += pi * hv.x;
            acc[u][1] += pi * hv.y;
          }
        }
      }
    }
    float* pb = part + (it & 1) * kWarps * ld;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int c = 2 * lane + 64 * u;
      if (c < Km1)
        reinterpret_cast<float2*>(pb + warp * ld)[c / 2] = make_float2(acc[u][0], acc[u][1]);
    }
    __syncthreads();  // every warp's partial rows are in pb

    // Ap, the partial rows added in warp order; pᵀAp
    float Ap[NP][2];
    float part_pAp = 0.f;
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int c = 2 * lane + 64 * u;
      float2 s = make_float2(0.f, 0.f);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float2 v = reinterpret_cast<const float2*>(pb + w * ld)[col[u]];
        s.x += v.x;
        s.y += v.y;
      }
      Ap[u][0] = c < Km1 ? s.x : 0.f;
      Ap[u][1] = c + 1 < Km1 ? s.y : 0.f;
      part_pAp += p[u][0] * Ap[u][0] + p[u][1] * Ap[u][1];
    }
    const float pAp = warp_sum(part_pAp);
    active = active && (pAp > 1e-30f);
    const float alpha = rz / (pAp > 1e-30f ? pAp : 1.f);
    float part_rzn = 0.f;
    float z[NP][2];
#pragma unroll
    for (int u = 0; u < NP; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (active) {
          x[u][h] += alpha * p[u][h];
          r[u][h] -= alpha * Ap[u][h];
        }
        z[u][h] = dinv[u][h] * r[u][h];
        part_rzn += r[u][h] * z[u][h];
      }
    const float rz_new = warp_sum(part_rzn);
    const float beta = rz_new / fmaxf(rz, 1e-30f);
    if (active) {
#pragma unroll
      for (int u = 0; u < NP; ++u)
#pragma unroll
        for (int h = 0; h < 2; ++h) p[u][h] = z[u][h] + beta * p[u][h];
      rz = rz_new;
    }
  }
  if (warp == 0) {
#pragma unroll
    for (int u = 0; u < NP; ++u)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = 2 * lane + 64 * u + h;
        if (c < Km1) x_d[c] = x[u][h];
      }
  }
}

// ---------------------------------------------------------------------------
// B3: the Armijo sweep
// ---------------------------------------------------------------------------
//
// Bound on the H100 by reading beta_doc once (K·L·4 bytes a document, 2
// in bf16); the T mixtures are 2·T·K·L flops, far below the float32 peak
// at that byte count.  Design: one block per document; slabs of W word
// slots (64, or 32 where K is large) stream through a cp.async ring.
// Thread (ks, tg, cg) forms the partial mixtures of 4 step sizes (tg) by 4
// slots (cg) over the topics k ≡ ks (mod KS) in float32 FMAs, from 16-byte
// shared-memory reads of the slab (8-byte of a bf16 slab) and of the transposed candidate rows
// etT[k][t]; the KS partials of each s[t,l] are added in ks order, and
// each (t, l) thread keeps its own log-likelihood sum across slabs.  The
// prior term ½ dᵀΣ⁻¹d of each candidate is computed as before, once per
// (t, j), with each thread reading a column of siginv once for 4 step
// sizes, from shared memory where the ring holds siginv (as in B1).  Sums
// over warps are added in warp order.  bf16 slabs take the plan of their
// own that stages.cu gives them (wider slabs), and their prior term, which
// reads siginv from L2 where the ring cannot hold it, keeps sixteen loads
// a thread in flight.
template <int W>
struct LsShape {
  static constexpr int kCG = W / 4;                       // slot groups of 4
  static constexpr int kKS = kThreads / (kCG * 4);        // topic splits
};

struct LsLayout {
  size_t ring, part, etT, dT, eta, p, mu, ts, mt, lse, llw, qw, red, floats;
};

__host__ __device__ inline LsLayout ls_layout(int K, int W, int stages, int beta_bytes) {
  const int Km1 = K - 1;
  LsLayout o;
  size_t at = 0;
  o.ring = at;  at += beta_floats((size_t)stages * K * W, beta_bytes);
  o.part = at;  at += (size_t)(kThreads / W) * kMaxT * W;  // KS x kMaxT x W
  o.etT = at;   at += (size_t)K * kMaxT;
  o.dT = at;    at += (size_t)Km1 * kMaxT;
  o.eta = at;   at += Km1;
  o.p = at;     at += Km1;
  o.mu = at;    at += Km1;
  o.ts = at;    at += kMaxT;
  o.mt = at;    at += kMaxT;
  o.lse = at;   at += kMaxT;
  o.llw = at;   at += kMaxT * kWarps;
  o.qw = at;    at += kMaxT * kWarps;
  o.red = at;   at += 32;
  o.floats = at;
  return o;
}

// Document d's eta, p and mu are rows d of `eta`, `pdir` and `mu`, its
// sweep values row d of `fs` (addressed where they are used, as in
// fgh_body).  RESIDENT and TB as in fgh_body.
template <int W, int STAGES, bool RESIDENT = false, typename TB = float>
__device__ __forceinline__ void ls_body(
    const float* __restrict__ siginv, bool sig_shared, const float* ts, int T, const float* eta,
    const float* pdir, const float* mu, const TB* __restrict__ beta_d,
    const float* __restrict__ cnt_d, float* fs, size_t d, int K, int L, int vec16,
    float* smem) {
  using S = LsShape<W>;
  const int Km1 = K - 1;
  const int n_slabs = (L + W - 1) / W;
  const LsLayout lay = ls_layout(K, W, RESIDENT ? n_slabs : STAGES, sizeof(TB));
  TB* ring = reinterpret_cast<TB*>(smem + lay.ring);
  float* sig_buf = reinterpret_cast<float*>(ring + K * W);  // the ring's buffers 1 ..
  float* part = smem + lay.part;
  float* etT = smem + lay.etT;
  float* dT = smem + lay.dT;
  float* eta_s = smem + lay.eta;
  float* p_s = smem + lay.p;
  float* mu_s = smem + lay.mu;
  float* tsv = smem + lay.ts;
  float* mt = smem + lay.mt;
  float* lse = smem + lay.lse;
  float* llw = smem + lay.llw;
  float* qw = smem + lay.qw;
  float* red = smem + lay.red;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // as in fgh: siginv first where the ring's other buffers hold it
  const bool sig_ring = !RESIDENT && !sig_shared &&
                        (size_t)Km1 * Km1 <= beta_floats((size_t)(STAGES - 1) * K * W, sizeof(TB));
  if (sig_ring) {
    load_siginv(sig_buf, siginv, Km1 * Km1);
    cp_async_commit();
  }
  for (int s = 0; !RESIDENT && s < (sig_ring ? 1 : STAGES - 1); ++s) {
    if (s < n_slabs) load_slab<W>(ring + (size_t)s * K * W, beta_d, K, L, s * W, vec16);
    cp_async_commit();
  }

  for (int i = tid; i < Km1; i += kThreads) {
    eta_s[i] = eta[d * Km1 + i];
    p_s[i] = pdir[d * Km1 + i];
    mu_s[i] = mu[d * Km1 + i];
  }
  if (tid < kMaxT) tsv[tid] = tid < T ? ts[tid] : 0.f;
  for (int i = tid; i < 2 * kMaxT * kWarps; i += kThreads) llw[i] = 0.f;  // llw, qw
  __syncthreads();

  // candidates (padded with the pinned 0), step sizes past T zero; the
  // offsets d = cand - mu of the prior term
  for (int idx = tid; idx < K * kMaxT; idx += kThreads) {
    const int k = idx / kMaxT, t = idx - k * kMaxT;
    etT[idx] = (t < T && k < Km1) ? eta_s[k] + tsv[t] * p_s[k] : 0.f;
    if (k < Km1) dT[idx] = t < T ? (eta_s[k] + tsv[t] * p_s[k]) - mu_s[k] : 0.f;
  }
  __syncthreads();
  for (int t = warp; t < T; t += kWarps) {
    float mx = -INFINITY;
    for (int k = lane; k < K; k += 32) mx = fmaxf(mx, etT[k * kMaxT + t]);
    mx = warp_max(mx);
    float se = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float v = expf(etT[k * kMaxT + t] - mx);
      etT[k * kMaxT + t] = v;
      se += v;
    }
    se = warp_sum(se);
    if (lane == 0) {
      mt[t] = mx;
      lse[t] = mx + logf(se);
    }
  }

  // prior term: dq[t, j] = d_tj · (d_t · siginv)_j, summed over j per t.
  // Thread (tg, jj) takes step sizes 4 tg .. 4 tg + 3 and columns j ≡ jj (mod 64).
  if (sig_ring) {
    cp_async_wait<1>();  // siginv has landed (slab 0 may not have)
    __syncthreads();
  }
  {
    const float* sig = sig_ring ? sig_buf : siginv;
    const int tg = tid >> 6, jj = tid & 63;
    // bf16 slabs' plans read siginv from L2 (the ring's spare slabs rarely
    // hold it): twice the loads in flight
    constexpr int kSigUnroll = sizeof(TB) == 2 ? 16 : 8;
    float qs[4] = {0.f, 0.f, 0.f, 0.f};
    if (4 * tg < T) {
      for (int j = jj; j < Km1; j += 64) {
        float a[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll(kSigUnroll)
        for (int i = 0; i < Km1; ++i) {
          const float sv = sig[(size_t)i * Km1 + j];
          const float4 di = *reinterpret_cast<const float4*>(dT + i * kMaxT + 4 * tg);
          a[0] += di.x * sv;
          a[1] += di.y * sv;
          a[2] += di.z * sv;
          a[3] += di.w * sv;
        }
        const float4 dj = *reinterpret_cast<const float4*>(dT + j * kMaxT + 4 * tg);
        qs[0] += dj.x * a[0];
        qs[1] += dj.y * a[1];
        qs[2] += dj.z * a[2];
        qs[3] += dj.w * a[3];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float v = warp_sum(qs[u]);
      if (lane == 0 && 4 * tg + u < T) qw[(4 * tg + u) * kWarps + warp] = v;
    }
  }
  if (sig_ring) {
    __syncthreads();  // siginv's buffers are free for the slabs
    for (int s = 1; s < STAGES - 1; ++s) {
      if (s < n_slabs) load_slab<W>(ring + (size_t)s * K * W, beta_d, K, L, s * W, vec16);
      cp_async_commit();
    }
  }

  float nd = 0.f;
  for (int l = tid; l < L; l += kThreads) nd += cnt_d[l];
  const float Nd = block_sum(nd, red);  // publishes etT, mt, lse, qw

  // thread (ks, tg, cg) of the mixtures; (t, l) pairs of the finalize
  const int cg = tid % S::kCG, tg = (tid / S::kCG) & 3, ks = tid / (4 * S::kCG);
  constexpr int kPairs = kMaxT * W / kThreads;  // (t, l) pairs a thread finalizes
  float llp[kPairs];
#pragma unroll
  for (int r = 0; r < kPairs; ++r) llp[r] = 0.f;

  for (int s = 0; s < n_slabs; ++s) {
    if (!RESIDENT) cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab s has landed; slab s-1's buffer and part are free
    if (!RESIDENT) {
      const int sn = s + STAGES - 1;
      if (sn < n_slabs)
        load_slab<W>(ring + (size_t)(sn % STAGES) * K * W, beta_d, K, L, sn * W, vec16);
      cp_async_commit();
    }
    const TB* slab = ring + (size_t)(RESIDENT ? s : s % STAGES) * K * W;

    if (4 * tg < T) {
      float a[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) a[u][v] = 0.f;
      for (int k = ks; k < K; k += S::kKS) {
        const float4 b = ld4(slab + k * W + 4 * cg);
        const float4 ev = *reinterpret_cast<const float4*>(etT + k * kMaxT + 4 * tg);
        const float ea[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          a[u][0] += ea[u] * b.x;
          a[u][1] += ea[u] * b.y;
          a[u][2] += ea[u] * b.z;
          a[u][3] += ea[u] * b.w;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        *reinterpret_cast<float4*>(part + ((size_t)ks * kMaxT + 4 * tg + u) * W + 4 * cg) =
            make_float4(a[u][0], a[u][1], a[u][2], a[u][3]);
    }
    __syncthreads();

#pragma unroll
    for (int r = 0; r < kPairs; ++r) {
      const int idx = tid + kThreads * r;
      const int t = idx / W, lw = idx - t * W;
      const int l = s * W + lw;
      if (t < T && l < L) {
        const float cl = cnt_d[l];
        if (cl > 0.f) {
          float sm = 0.f;
#pragma unroll
          for (int k2 = 0; k2 < S::kKS; ++k2) sm += part[((size_t)k2 * kMaxT + t) * W + lw];
          llp[r] += cl * (logf(fmaxf(sm, kTiny)) + mt[t]);
        }
      }
    }
  }

  // each warp's (t, l) pairs share one t per r
#pragma unroll
  for (int r = 0; r < kPairs; ++r) {
    const int t = (tid + kThreads * r) / W;
    const float v = warp_sum(llp[r]);
    if (lane == 0 && t < T) llw[t * kWarps + warp] = v;
  }
  __syncthreads();
  if (tid < T) {
    float qsum = 0.f, ll = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      qsum += qw[tid * kWarps + w];
      ll += llw[tid * kWarps + w];
    }
    fs[d * T + tid] = 0.5f * qsum - ll + Nd * lse[tid];
  }
}

// ---------------------------------------------------------------------------
// the step glue: convergence, the direction's fallback, the step choice
// ---------------------------------------------------------------------------
//
// What ops/stages.py::newton_direction_plain and newton_accept_plain do for
// one document, shared by the fused step (newton.cu) and the stage path's
// glue kernels (stages.cu), so both take the same float32 operations in the
// same order.  max|g| and the step are exact; the two dot products sum in
// the block's fixed order (a thread's strided terms, then warp_sum /
// block_sum), not torch's.

// max|g| <= grad_tol, the same in every thread (a NaN in g is not
// converged, as in torch.amax, which propagates it).
__device__ __forceinline__ bool grad_converged(const float* g, int Km1, float grad_tol,
                                               float* red) {
  float gm = 0.f;
  for (int i = threadIdx.x; i < Km1; i += kThreads) {
    const float a = fabsf(g[i]);
    gm = isnan(a) ? INFINITY : fmaxf(gm, a);
  }
  return block_max(gm, red) <= grad_tol;
}

// The search direction from CG's x: p = -g with gᵀp = -gᵀg where gᵀx >= 0
// (x does not descend), else p = x (a NaN gᵀx keeps x, as the plain version
// does).  Returns gᵀp in every thread.  p may be x itself (the fused step's
// shared copy); in the fallback the closing block_sum's barriers publish p.
__device__ __forceinline__ float descent_direction(const float* g, const float* x, float* p,
                                                   int Km1, float* red) {
  float part = 0.f;
  for (int i = threadIdx.x; i < Km1; i += kThreads) part += g[i] * x[i];
  float gTp = block_sum(part, red);
  if (gTp >= 0.f) {
    part = 0.f;
    for (int i = threadIdx.x; i < Km1; i += kThreads) {
      const float gi = g[i];
      p[i] = -gi;
      part += gi * gi;
    }
    gTp = -block_sum(part, red);
  } else if (p != x) {
    for (int i = threadIdx.x; i < Km1; i += kThreads) p[i] = x[i];
  }
  return gTp;
}

// The first (largest) of the T step sizes whose sweep value passes the
// Armijo test fs <= f + 1e-4·t·gTp, rounded as PyTorch rounds it (no FMA
// contraction), 0 where none passes; *any_ok: whether one passes.
__device__ __forceinline__ float armijo_step(const float* fs, const float* ts, int T, float f0,
                                             float gTp, bool* any_ok) {
  float t = 0.f;
  bool ok = false;
  for (int k = 0; k < T; ++k) {
    const float rhs = __fadd_rn(f0, __fmul_rn(__fmul_rn(1e-4f, ts[k]), gTp));
    if (fs[k] <= rhs) {
      ok = true;
      t = fmaxf(t, ts[k]);
    }
  }
  *any_ok = ok;
  return t;
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

// Launch `kernel` with `bytes` of dynamic shared memory (opted in above
// the 48 KB default).
template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, dim3 grid, size_t bytes, void* stream, Args... args) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

}  // namespace
