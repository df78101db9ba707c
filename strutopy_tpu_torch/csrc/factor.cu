// Hand-written Hopper (sm_90a) kernel: the E-step finalize's factor, repair
// and inverse of every document's Hessian, in one launch a chunk,
//
//   rung_d = the first rung of the PD-repair ladder whose Cholesky factor
//            exists: 1 H_d, 2 make_pd(H_d), 3 rung 2 + jitter·I,
//            4 rung 2 + rel_jitter·max|rung 2|·I
//   L_d    = that factor (lower, zeros above), NaN where all four fail
//   nu_d   = (L_d L_dᵀ)⁻¹ = L_d⁻ᵀ L_d⁻¹
//
// (replaces no TPU kernel: its JAX twin is the finalize's factor in
// strutopy_tpu/ops/estep.py::_finalize_chunk, _chol_pd_batched and
// cho_inverse, XLA's Cholesky and triangular solves; it takes the place of
// PyTorch's cholesky_ex ladder and cholesky_inverse, which read each rung's
// verdict and cholesky_inverse's info to the host, twice a chunk).
//
// The ladder is exactly the plain version's (strutopy_tpu_torch/ops/
// stages.py::chol_pd_plain): the factor reads H's lower triangle, as LAPACK
// and cuSOLVER do; a rung fails where a pivot is not > 0 or not finite
// (info != 0, or a factor that is not finite: a non-finite entry of L below
// the diagonal reaches a later pivot); make_pd's diagonal is max(H_ii,
// Σ_j |H_ij| - |H_ii|) over the whole row, NaN where either is NaN, as
// torch.maximum gives it.
//
// Bound: latency.  At B=256, P=99 it reads H once and writes L and nu,
// ~30 MB (9 µs at 3.35 TB/s), and does ~P³/2 multiply-adds a document in
// float32 (4 µs at 67 TFLOP/s); each document's P pivots form a chain.
// Design: one block a document, two packed lower triangles (P(P+1)/2
// floats each, 39.6 KB at P=99) in shared memory, so a chunk's documents
// are resident in one wave: Hs, the rung's matrix, and A, the running sums.
// One right-looking pass factors and inverts in place: at step k every
// thread reads the pivot Hs_kk + A_kk, the same shared value after a
// barrier, so the rung's test is uniform with no vote; v[i] = L_ik for
// i > k and v[m] = (L⁻¹)_km for m <= k, then one rank-1 update of the rows
// below k,
//
//   A_ic -= v_i·v_c     (c > k: the trailing Cholesky sums -Σ_p L_ip L_cp;
//                        c <= k: the forward substitution of L X = I),
//
// so each row of A holds X = L⁻¹ to the left of the step and the sums to
// its right, two barriers a step.  Each sum starts from 0, not from H, so
// its roundings are relative to the sum and not to H: on an H100, nu's
// error against float64 on a K=100 fit's chunk is then 2.4e-7 against the
// cuSOLVER pair's 3.3e-7; updated from H, as a textbook right-looking
// factor runs, it read 1.75x the pair's on random SPD matrices.  Column k
// of L is written as row k of Lᵀ (coalesced); the wrapper returns the
// transposed view.  Then nu_ij = nu_ji = Σ_{k >= i} X_ki X_kj (i >= j) by
// one thread, in ascending k, written to both triangles.  Every sum has a
// fixed order and there are no atomics: the outputs are a function of H
// alone.  Where the triangles do not fit a block's shared memory (P above
// ~240) they live in a global scratch; the code is the same.  Factor-only
// mode (no nu) skips the substitution.
//
// Every entry point has a plain C interface (loaded with ctypes): it
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxP = 512;
constexpr int kRed = 32;  // floats of the block reduction's scratch

// (i, c), c <= i, of a packed lower triangle, rows in order
__device__ __forceinline__ int tri(int i, int c) { return i * (i + 1) / 2 + c; }

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// make_pd's diagonal into dg (P) and the largest |entry| of the repaired
// matrix, both from H's whole rows in device memory (rungs 2-4 only).
__device__ float make_pd_diag(const float* __restrict__ Hd, float* dg, float* red, int P) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float amax = 0.f;
  for (int i = warp; i < P; i += nw) {
    const float* row = Hd + (size_t)i * P;
    float s = 0.f, off = 0.f;
    for (int c = lane; c < P; c += 32) {
      const float a = fabsf(row[c]);
      s += a;
      if (c != i) off = nan_max(off, a);
    }
    s = warp_sum(s);
    off = warp_max(off);
    const float d = row[i];
    const float nd = nan_max(d, s - fabsf(d));
    if (lane == 0) dg[i] = nd;
    amax = nan_max(amax, nan_max(off, fabsf(nd)));
  }
  amax = warp_max(amax);
  if (lane == 0) red[warp] = amax;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red[0];
    for (int w = 1; w < nw; ++w) m = nan_max(m, red[w]);
    red[kRed - 1] = m;
  }
  __syncthreads();
  return red[kRed - 1];
}

// One block a document.  H (B, P, P); Lt (B, P, P) receives Lᵀ; nu (B, P,
// P) (INVERSE only); rung (B,) int8.  Two packed triangles: Hs, the rung's
// matrix, and A, the running sums (SMEM_TRI: in shared memory after v, dg
// and the reduction scratch; else scratch's slice of P(P+1) floats).
template <bool INVERSE, bool SMEM_TRI>
__global__ void cholesky_pd_inverse_kernel(const float* __restrict__ H, float* __restrict__ Lt,
                                           float* __restrict__ nu, int8_t* __restrict__ rung_out,
                                           float* __restrict__ scratch, int P, float jitter,
                                           float rel_jitter) {
  extern __shared__ float smem[];
  const size_t d = blockIdx.x;
  const size_t PP = (size_t)P * P;
  const int n_tri = P * (P + 1) / 2;
  float* v = smem;
  float* dg = smem + P;
  float* red = smem + 2 * P;
  float* Hs = SMEM_TRI ? smem + 2 * P + kRed : scratch + d * 2 * n_tri;
  float* A = Hs + n_tri;
  const float* Hd = H + d * PP;
  float* Ld = Lt + d * PP;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nw = nt >> 5;

  float shift = 0.f;
  bool ok = false;
  int rung = 1;
  for (; rung <= 4 && !ok; ++rung) {
    __syncthreads();  // every thread has read the failed rung's last pivot
    if (rung == 2) shift = make_pd_diag(Hd, dg, red, P);  // max|H2|, for rung 4
    const float add = rung == 3 ? jitter : rung == 4 ? rel_jitter * shift : 0.f;
    for (int i = warp; i < P; i += nw) {
      const float* row = Hd + (size_t)i * P;
      const int r = tri(i, 0);
      for (int c = lane; c <= i; c += 32) {
        Hs[r + c] = c < i ? row[c] : rung == 1 ? row[c] : dg[i] + add;
        A[r + c] = 0.f;
      }
    }
    __syncthreads();

    // A_ic holds -Σ_{p<k} L_ip L_cp right of the step (the pivot and column
    // k are Hs + A: each sum starts from 0, not from H, so its roundings are
    // relative to the sum) and the rows of L⁻¹ so far left of it.
    ok = true;
    for (int k = 0; k < P; ++k) {
      const int kk = tri(k, k);
      const float piv = Hs[kk] + A[kk];
      if (!(piv > 0.f) || !isfinite(piv)) {  // the same value in every thread
        ok = false;
        break;
      }
      const float lkk = sqrtf(piv);
      float* lt_row = Ld + (size_t)k * P;  // column k of L
      for (int t = tid; t < P; t += nt) {
        if (t > k) {
          const int e = tri(t, k);
          const float l = (Hs[e] + A[e]) / lkk;
          v[t] = l;
          lt_row[t] = l;
        } else {
          lt_row[t] = t == k ? lkk : 0.f;
          if (INVERSE) v[t] = (t < k ? A[tri(k, t)] : 1.f) / lkk;  // row k of L⁻¹
        }
      }
      __syncthreads();
      // row k takes its row of L⁻¹; each row below, the rank-1 update
      for (int i = k + (INVERSE ? 0 : 1) + warp; i < P; i += nw) {
        float* row = A + tri(i, 0);
        if (INVERSE && i == k) {
          for (int c = lane; c <= k; c += 32) row[c] = v[c];
          continue;
        }
        const float vi = v[i];
#pragma unroll 4
        for (int c = (INVERSE ? 0 : k + 1) + lane; c <= i; c += 32)
          row[c] = (c == k ? 0.f : row[c]) - vi * v[c];
      }
      __syncthreads();
    }
  }
  rung -= 1;

  if (!ok) {  // every rung failed: a NaN factor, as the plain ladder gives
    for (int e = tid; e < (int)PP; e += nt) {
      Ld[e] = nanf("");
      if (INVERSE) nu[d * PP + e] = nanf("");
    }
  } else if (INVERSE) {
    // nu_ij = nu_ji = Σ_{k >= i} X_ki X_kj for i >= j, by one thread
    float* nud = nu + d * PP;
    for (int i = warp; i < P; i += nw) {
      for (int j = lane; j <= i; j += 32) {
        int base = tri(i, 0);
        float acc = 0.f;
        for (int k = i; k < P; ++k) {
          acc += A[base + i] * A[base + j];
          base += k + 1;
        }
        nud[(size_t)i * P + j] = acc;
        nud[(size_t)j * P + i] = acc;
      }
    }
  }
  if (tid == 0) rung_out[d] = (int8_t)rung;
}

int max_optin_smem() {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return v;
}

// Threads a block at P: the rows below a step go to the warps in turn.
int factor_threads(int P) { return P <= 32 ? 256 : 512; }

// Shared-memory bytes a block: v, dg, the reduction scratch and, where they
// fit, the two triangles.
size_t smem_bytes(int P, bool tri_in_smem) {
  return sizeof(float) * ((size_t)2 * P + kRed + (tri_in_smem ? (size_t)P * (P + 1) : 0));
}

template <bool INVERSE, bool SMEM_TRI>
cudaError_t launch(int B, int P, int threads, void* stream, const void* H, void* Lt, void* nu,
                   void* rung, void* scratch, float jitter, float rel_jitter) {
  const size_t bytes = smem_bytes(P, SMEM_TRI);
  auto kernel = cholesky_pd_inverse_kernel<INVERSE, SMEM_TRI>;
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(
      (const float*)H, (float*)Lt, (float*)nu, (int8_t*)rung, (float*)scratch, P, jitter,
      rel_jitter);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan at P into out[3]: threads a block, shared-memory bytes a block,
// 1 where the triangles sit in shared memory (else the caller passes a
// scratch of B·P(P+1) floats); -1 for P outside 1..512.
int stm_factor_plan(int P, int* out) {
  if (P < 1 || P > kMaxP) return -1;
  const bool in_smem = smem_bytes(P, true) <= (size_t)max_optin_smem();
  out[0] = factor_threads(P);
  out[1] = (int)smem_bytes(P, in_smem);
  out[2] = in_smem;
  return 0;
}

// H (B, P, P) float32 -> Lt (B, P, P) = Lᵀ, nu (B, P, P) (with inverse;
// else nu may be null), rung (B,) int8.  scratch: B·P(P+1) floats where
// stm_factor_plan says the triangles do not fit, else unused.
int stm_chol_pd_inverse(const void* H, void* Lt, void* nu, void* rung, void* scratch, int B,
                        int P, int inverse, float jitter, float rel_jitter, void* stream) {
  if (B == 0) return 0;
  if (P < 1 || P > kMaxP) return (int)cudaErrorInvalidValue;
  const int threads = factor_threads(P);
  const bool in_smem = smem_bytes(P, true) <= 48 * 1024 ||
                       smem_bytes(P, true) <= (size_t)max_optin_smem();
  if ((!in_smem && !scratch) || (inverse && !nu)) return (int)cudaErrorInvalidValue;
  if (inverse)
    return in_smem ? (int)launch<true, true>(B, P, threads, stream, H, Lt, nu, rung, scratch,
                                             jitter, rel_jitter)
                   : (int)launch<true, false>(B, P, threads, stream, H, Lt, nu, rung, scratch,
                                              jitter, rel_jitter);
  return in_smem ? (int)launch<false, true>(B, P, threads, stream, H, Lt, nu, rung, scratch,
                                            jitter, rel_jitter)
                 : (int)launch<false, false>(B, P, threads, stream, H, Lt, nu, rung, scratch,
                                             jitter, rel_jitter);
}

}  // extern "C"
