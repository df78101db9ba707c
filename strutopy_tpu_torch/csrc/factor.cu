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
// torch.maximum gives it.  Every pivot is read by every thread after a
// barrier (or a warp's shuffle), so each rung's test is uniform with no
// vote, and a failed rung reloads H and retries on the device.
//
// Numerics, both plans: every sum is float32 on the CUDA cores (FFMA), starts
// from 0 and not from H (H is added where a pivot or an entry of L is formed,
// so its roundings are relative to the sum: on an H100, nu's error against
// float64 on a K=100 fit's chunk is 2.4e-7 against the cuSOLVER pair's
// 3.3e-7; updated from H, as a textbook factor runs, it read 1.75x the
// pair's on random SPD matrices) and takes its terms in ascending order:
//
//   L_ic = (H_ic + S_ic) / L_cc,  S_ic = -Σ_{p<c} L_ip L_cp
//   X_ic = T_ic / L_ii (c < i), 1 / L_ii (c = i),  T_ic = -Σ_{c<=p<i} L_ip X_pc
//   nu_ij = nu_ji = Σ_{k>=i} X_ki X_kj   (i >= j, X = L⁻¹)
//
// (the blocked plan sums each chunk of kKC = 16 terms from 0 and adds the
// chunks' sums in ascending order, below), with no atomics, so every output
// is a function of H alone, and nu is symmetric bit for bit.
//
// The smem plan (P up to ~240; 39.6 KB a block at P=99).  Bound: latency.
// At B=256, P=99 it reads H once and writes L and nu, ~30 MB (9 µs at 3.35
// TB/s), and does ~P³/2 multiply-adds a document in float32 (4 µs at 67
// TFLOP/s); each document's P pivots form a chain.  One block a document
// holds two packed lower triangles in shared memory, so a chunk's documents
// are resident in one wave: Hs, the rung's matrix, and A, the running sums.
// One right-looking pass factors and inverts in place: at step k v[i] = L_ik
// for i > k and v[m] = (L⁻¹)_km for m <= k, then one rank-1 update of the
// rows below k, A_ic -= v_i·v_c (c > k: S; c <= k: T), two barriers a step.
// Then each entry of nu is summed by one thread.
//
// The blocked plan (P above ~240, where the two triangles, P(P+1) floats,
// outgrow a block's shared memory; 638 KB at P=399).  Bound: operations.  At
// B=256, P=399 it reads H and writes L and nu (490 MB, 0.15 ms) against P³
// float32 operations a document (16.3 GFLOP, 0.243 ms).  The rank-1 steps
// above would stream the triangles through device memory at every pivot
// (~170 MB a document, 43 GB a chunk).  Instead one block of 256 threads a
// document makes three left-looking passes over panels of kNB = 32, each
// reading the rows above the panel once (~P³/(6·32) floats a pass, ~4 MB a
// document at P=399), X in the scratch (P² of its P(P+1) floats a
// document) and L in Lᵀ itself:
//
//   factor   panel J of 32 columns: each warp sums S for 32 rows i >= J's
//            first as a register tile (staged_sums), the block staging the
//            rows of Lᵀ above J a chunk of kKC at a time; warp 0 factors J's
//            diagonal block (lane r its row, pivots and L's columns passed by
//            shuffles, no block barrier a pivot), then every row below
//            solves against it in its own registers;
//   inverse  panel I of 32 rows: each warp takes one or two groups of 32
//            columns of X (the longest sums paired with the shortest), sums
//            T for them over the rows of X above I as a tile, then each lane
//            finishes its column's 32 entries of I by forward substitution;
//   nu       the 32 x 32 tiles of rows >= columns: the warps take them in
//            turn, longest sums first, each summing over k >= the tile's
//            first row, and write both triangles from the one sum.
//
// A tile is 32 q (rows or columns) by 32 w: lane (qg, wg) sums the 4 x 8
// block q = 4qg.., w = 8wg.. from one float4 of W and two of Y a row, read
// from shared memory, where the group (block or warp) stages chunks of both
// by cp.async, two buffers, so the next chunk's copies run while the lanes
// sum the current one.  A lane sums each chunk's 16 terms from 0 and adds
// that sum to its tile (a lane skips only chunks where X's zeros would add
// +0); the terms of a panel's own rows follow one at a time.  One running
// sum of ~400 terms, as the rank-1 steps take them, read nu's error against
// float64 2.6x the cuSOLVER pair's on an H100 on a K=400 chunk at its
// Newton optimum (3.7e-7); a chunk at a time it reads 0.94x (1.35e-7).
// Shared memory: the staging, the diagonal block, H's diagonal block and
// the repair's diagonal (75.6 KB at P=399), so two blocks an SM are
// resident and a chunk of 256 documents runs in one wave.  Factor-only mode
// (no nu) skips the substitution, both plans.
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
constexpr int kNB = 32;   // the blocked plan's panel: columns of L, rows of X and nu
constexpr int kKC = 16;   // rows of W and Y a staged chunk (staged_sums)
constexpr int kBlockedThreads = 256;
constexpr int kWarps = kBlockedThreads / 32;
// floats of the staging region: the block's buffers in the factor pass, or
// each warp's own in the inverse and nu passes
constexpr int kStageFloats = kWarps * 4 * kKC * kNB;
constexpr unsigned kFull = 0xffffffffu;

// (i, c), c <= i, of a packed lower triangle, rows in order
__device__ __forceinline__ int tri(int i, int c) { return i * (i + 1) / 2 + c; }

// torch.maximum: NaN if either is NaN
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nanf("") : fmaxf(a, b);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = nan_max(x, __shfl_xor_sync(kFull, x, o));
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

// The smem plan: one block a document.  H (B, P, P); Lt (B, P, P) receives
// Lᵀ; nu (B, P, P) (INVERSE only); rung (B,) int8.  Two packed triangles in
// shared memory after v, dg and the reduction scratch: Hs, the rung's
// matrix, and A, the running sums.
template <bool INVERSE>
__global__ void cholesky_pd_inverse_kernel(const float* __restrict__ H, float* __restrict__ Lt,
                                           float* __restrict__ nu, int8_t* __restrict__ rung_out,
                                           int P, float jitter, float rel_jitter) {
  extern __shared__ float smem[];
  const size_t d = blockIdx.x;
  const size_t PP = (size_t)P * P;
  const int n_tri = P * (P + 1) / 2;
  float* v = smem;
  float* dg = smem + P;
  float* red = smem + 2 * P;
  float* Hs = smem + 2 * P + kRed;
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

// Copies of 4 bytes from device to shared memory that run while the thread
// goes on (cp.async); a copy with valid false writes a 0 and reads nothing.
__device__ __forceinline__ void copy_async(float* dst, const float* src, bool valid) {
  const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(to), "l"(src),
               "r"(valid ? 4 : 0));
}

// The group that shares a staged chunk: the whole block (NT = its threads)
// or one warp (NT = 32).
template <int NT>
__device__ __forceinline__ void group_sync() {
  if (NT == 32)
    __syncwarp();
  else
    __syncthreads();
}

// One chunk of rows [pc, pc + kKC) into ws (kKC x NT: thread t of the group
// copies W's column q0 + t, 0 at or past qlim) and ys (kKC x kNB: Y's columns
// y0 .. y0 + ny, 0 past ny); rows at or past p_hi as 0.
template <int NT>
__device__ __forceinline__ void stage_chunk(const float* W, const float* Y, int P, int y0, int ny,
                                            int q0, int qlim, int pc, int p_hi, float* ws,
                                            float* ys) {
  const int t = threadIdx.x % NT, np = min(kKC, p_hi - pc);
  const bool col = q0 + t < qlim;
  const float* w_row = W + (size_t)pc * P + q0 + (col ? t : 0);
#pragma unroll
  for (int j = 0; j < kKC; ++j) {
    const bool in = col && j < np;
    copy_async(ws + j * NT + t, in ? w_row + (size_t)j * P : W, in);
  }
  const float* y_row = Y + (size_t)pc * P + y0;
#pragma unroll
  for (int u = 0; u < kKC * kNB / NT; ++u) {
    const int e = t + u * NT, j = e / kNB, w = e % kNB;
    const bool in = j < np && w < ny;
    copy_async(ys + e, in ? y_row + (size_t)j * P + w : Y, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The blocked plan's one product, for one tile of 32 q by kNB w a warp:
// S[q][w] = s·Σ_p W[p·P + q]·Y[p·P + y0 + w] over p in [p_lo, p_hi) (s = -1
// where NEG), for the warp's q = q0 + 32·(its warp in the group) + 0..31:
// each chunk of kKC rows summed from 0 in ascending p, each product fused
// into its sum, and the chunks' sums added to acc in ascending order.  Lane
// (qg, wg) = (lane / 4, lane % 4) sums the 4 x 8 block q = 4qg.., w = 8wg..
// from one float4 of W and two of Y a row, shared-memory broadcasts.  The
// group (the block, NT = its threads, or one warp, NT = 32) stages a chunk
// of kKC rows of both by cp.async, two buffers, one group barrier a chunk:
// the next chunk's copies run while the lanes sum the current one.  Every
// thread of the group calls it with the same y0, ny, q0, qlim, p_lo and
// p_hi, after the writes it reads are visible to the group.  Where skip, a
// lane passes a chunk that ends at or before its first q (its W entries
// there are X's zeros above the diagonal, which would add +0).
template <int NT, bool NEG>
__device__ __forceinline__ void staged_sums(const float* W, const float* Y, int P, int y0, int ny,
                                            int q0, int qlim, bool skip, int p_lo, int p_hi,
                                            float* Ws, float* Ys, float (&acc)[4][8]) {
  if (p_lo >= p_hi) return;
  const int lane = threadIdx.x & 31, qg = lane >> 2, wg = lane & 3;
  const int q_off = (threadIdx.x % NT) - lane + 4 * qg;  // this lane's first q, less q0
  const int q_from = skip ? q0 + q_off : 0;
  group_sync<NT>();  // the last call's buffers have been read
  stage_chunk<NT>(W, Y, P, y0, ny, q0, qlim, p_lo, p_hi, Ws, Ys);
  for (int pc = p_lo, buf = 0; pc < p_hi; pc += kKC, buf ^= 1) {
    asm volatile("cp.async.wait_group 0;\n" ::);
    group_sync<NT>();  // this chunk has landed; the other buffers' readers are done
    if (pc + kKC < p_hi)
      stage_chunk<NT>(W, Y, P, y0, ny, q0, qlim, pc + kKC, p_hi, Ws + (buf ^ 1) * kKC * NT,
                      Ys + (buf ^ 1) * kKC * kNB);
    if (pc + min(kKC, p_hi - pc) > q_from) {
      const float* ws = Ws + buf * kKC * NT + q_off;
      const float* ys = Ys + buf * kKC * kNB + 8 * wg;
      float part[4][8] = {};
#pragma unroll
      for (int j = 0; j < kKC; ++j) {
        float4 a = *reinterpret_cast<const float4*>(ws + j * NT);
        if (NEG) a = make_float4(-a.x, -a.y, -a.z, -a.w);
        const float4 b0 = *reinterpret_cast<const float4*>(ys + j * kNB);
        const float4 b1 = *reinterpret_cast<const float4*>(ys + j * kNB + 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 8; ++y) part[x][y] = fmaf(av[x], bv[y], part[x][y]);
      }
#pragma unroll
      for (int x = 0; x < 4; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] += part[x][y];
    }
  }
}

// A warp's tile acc (as staged_sums leaves it) into row[w] = S[lane][w]:
// through T (32 x 33 floats of shared memory the warp alone uses).
__device__ __forceinline__ void tile_to_lanes(const float (&acc)[4][8], float* T,
                                              float (&row)[kNB]) {
  const int lane = threadIdx.x & 31, qg = lane >> 2, wg = lane & 3;
  __syncwarp();
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) T[(4 * qg + x) * (kNB + 1) + 8 * wg + y] = acc[x][y];
  __syncwarp();
#pragma unroll
  for (int w = 0; w < kNB; ++w) row[w] = T[lane * (kNB + 1) + w];
}

// The blocked plan: one block of kBlockedThreads a document.  Arguments as
// the smem plan's, and scratch, whose first P² floats of the document's
// slice hold X = L⁻¹ (INVERSE only).
template <bool INVERSE>
__global__ void __launch_bounds__(kBlockedThreads, 2)
    blocked_cholesky_pd_inverse_kernel(const float* __restrict__ H, float* __restrict__ Lt,
                                       float* __restrict__ nu, int8_t* __restrict__ rung_out,
                                       float* __restrict__ scratch, int P, float jitter,
                                       float rel_jitter) {
  extern __shared__ __align__(16) float smem[];
  float* Dt = smem + kStageFloats;    // kNB x kNB: a panel's diagonal block of Lᵀ
  float* Hb = Dt + kNB * kNB;         // kNB x (kNB + 1): the diagonal block of the rung's matrix
  float* red = Hb + kNB * (kNB + 1);  // the reduction scratch
  int* failed = reinterpret_cast<int*>(red + kRed);
  float* dg = red + kRed + 4;         // P: make_pd's diagonal
  const size_t d = blockIdx.x;
  const size_t PP = (size_t)P * P;
  const float* Hd = H + d * PP;
  float* Ld = Lt + d * PP;
  float* X = scratch + d * (size_t)P * (P + 1);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  float* Ws = smem;                                // the block's staging ...
  float* Ys = smem + 2 * kKC * kBlockedThreads;
  float* wWs = smem + warp * 4 * kKC * kNB;        // ... and this warp's
  float* wYs = wWs + 2 * kKC * kNB;

  float shift = 0.f;
  bool ok = false;
  int rung = 1;
  for (; rung <= 4 && !ok; ++rung) {
    __syncthreads();  // every thread has read the failed rung's verdict
    if (rung == 2) shift = make_pd_diag(Hd, dg, red, P);  // max|H2|, for rung 4
    const float add = rung == 3 ? jitter : rung == 4 ? rel_jitter * shift : 0.f;
    ok = true;
    for (int k0 = 0; k0 < P && ok; k0 += kNB) {
      const int nb = min(kNB, P - k0);
      // the rung's diagonal block, loaded while the panel's sums run
      constexpr int kHb = kNB * kNB / kBlockedThreads;
      float hb[kHb];
#pragma unroll
      for (int u = 0; u < kHb; ++u) {
        const int e = tid + u * kBlockedThreads, r = e / kNB, k = e % kNB;
        hb[u] = k > r || r >= nb ? 0.f
                : k < r || rung == 1 ? Hd[(size_t)(k0 + r) * P + k0 + k] : dg[k0 + r] + add;
      }
      for (int r0 = k0; r0 < P; r0 += nt) {
        const int i = r0 + tid;  // this thread's row
        // S_ic = -Σ_{p<k0} L_ip L_cp for the panel's columns c, a warp's 32
        // rows a tile; then row i's sums to its thread
        float tile[4][8] = {}, acc[kNB];
        staged_sums<kBlockedThreads, true>(Ld, Ld, P, k0, nb, r0, P, false, 0, k0, Ws, Ys, tile);
        __syncthreads();  // the staging buffers are read
        tile_to_lanes(tile, wWs, acc);
        const bool below = i < P && i >= k0 + nb;
        float hv[kNB];  // a row below: its H entries, loaded while the block is factored
#pragma unroll
        for (int p = 0; p < kNB; ++p) hv[p] = below && p < nb ? Hd[(size_t)i * P + k0 + p] : 0.f;
        if (r0 == k0) {
#pragma unroll
          for (int u = 0; u < kHb; ++u) {
            const int e = tid + u * kBlockedThreads;
            Hb[(e / kNB) * (kNB + 1) + e % kNB] = hb[u];
          }
          __syncthreads();
          if (warp == 0) {  // the diagonal block: lane r is row k0 + r
            const float* hrow = Hb + lane * (kNB + 1);
            int fail = 0;
#pragma unroll
            for (int k = 0; k < kNB; ++k) {
              if (k < nb) {
                const float skk = __shfl_sync(kFull, acc[k], k);
                const float piv = Hb[k * (kNB + 1) + k] + skk;
                if (!(piv > 0.f) || !isfinite(piv)) {  // the same value in every lane
                  fail = 1;
                  break;
                }
                const float lkk = sqrtf(piv);
                float l = lane == k ? lkk : 0.f;
                if (lane > k && lane < nb) l = (hrow[k] + acc[k]) / lkk;
                Dt[k * kNB + lane] = l;
                if (lane < nb) Ld[(size_t)(k0 + k) * P + k0 + lane] = l;
#pragma unroll
                for (int c = k + 1; c < kNB; ++c) {
                  const float lc = __shfl_sync(kFull, l, c);
                  if (lane >= c) acc[c] = fmaf(-l, lc, acc[c]);
                }
              }
            }
            if (lane == 0) *failed = fail;
          }
          __syncthreads();
          if (*failed) {
            ok = false;
            break;
          }
        }
        if (below) {  // a row below the block solves against it
#pragma unroll
          for (int p = 0; p < kNB; ++p) {
            if (p < nb) {
              const float l = (hv[p] + acc[p]) / Dt[p * kNB + p];
              Ld[(size_t)(k0 + p) * P + i] = l;
#pragma unroll
              for (int c = p + 1; c < kNB; ++c) acc[c] = fmaf(-l, Dt[p * kNB + c], acc[c]);
            }
          }
        }
      }
      if (ok)  // the panel's columns of L are zero above the block
        for (int e = tid; e < nb * k0; e += nt) Ld[(size_t)(k0 + e / k0) * P + e % k0] = 0.f;
    }
  }
  rung -= 1;

  if (!ok) {  // every rung failed: a NaN factor, as the plain ladder gives
    for (int e = tid; e < (int)PP; e += nt) {
      Ld[e] = nanf("");
      if (INVERSE) nu[d * PP + e] = nanf("");
    }
  } else if (INVERSE) {
    // X = L⁻¹ a panel of kNB rows at a time; each warp owns one or two
    // groups of 32 columns (a lane its column c), the longest sums paired
    // with the shortest
    const int ng = (P + kNB - 1) / kNB;
    for (int k0 = 0; k0 < P; k0 += kNB) {
      const int nb = min(kNB, P - k0);
      __syncthreads();  // the last panel's X rows are written and its Dt read
      for (int e = tid; e < kNB * kNB; e += nt) {
        const int a = e / kNB, b = e % kNB;
        Dt[e] = (a < nb && b < nb) ? Ld[(size_t)(k0 + a) * P + k0 + b] : 0.f;
      }
      __syncthreads();
      for (int h = 0; h < 2; ++h) {
        const int g = h == 0 ? warp : ng - 1 - warp;
        if (g >= ng || (h == 1 && g < kWarps)) continue;
        const int c = g * kNB + lane;
        // T_ic = -Σ_{c<=p<k0} L_ip X_pc for the panel's rows i; then column
        // c's sums to its lane
        float tile[4][8] = {}, acc[kNB];
        staged_sums<32, true>(X, Ld, P, k0, nb, g * kNB, P, true, g * kNB, k0, wWs, wYs, tile);
        tile_to_lanes(tile, wWs, acc);
        if (c < P) {
#pragma unroll
          for (int r = 0; r < kNB; ++r) {
            if (r < nb) {
              const int i = k0 + r;
              const float lii = Dt[r * kNB + r];
              const float x = c < i ? acc[r] / lii : c == i ? 1.f / lii : 0.f;
              X[(size_t)i * P + c] = x;
#pragma unroll
              for (int s = r + 1; s < kNB; ++s) acc[s] = fmaf(-Dt[r * kNB + s], x, acc[s]);
            }
          }
        }
      }
    }
    // nu = XᵀX a tile of 32 x 32 at a time (rows block bi >= columns block
    // bj); the warps take the tiles in turn, longest sums first, a lane its
    // column j
    __syncthreads();  // X is written
    float* nud = nu + d * PP;
    for (int bi = 0, t = 0; bi < ng; ++bi) {
      for (int bj = 0; bj <= bi; ++bj, ++t) {
        const int round = t / kWarps, pos = t % kWarps;
        if ((round & 1 ? kWarps - 1 - pos : pos) != warp) continue;
        const int i0 = bi * kNB, nb = min(kNB, P - i0);
        float tile[4][8] = {};
        staged_sums<32, false>(X, X, P, i0, nb, bj * kNB, P, true, i0, P, wWs, wYs, tile);
        const int qg = lane >> 2, wg = lane & 3;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
#pragma unroll
          for (int y = 0; y < 8; ++y) {
            const int j = bj * kNB + 4 * qg + x, i = i0 + 8 * wg + y;
            if (j < P && i < P && i >= j) {
              nud[(size_t)i * P + j] = tile[x][y];
              nud[(size_t)j * P + i] = tile[x][y];
            }
          }
        }
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

// Shared-memory bytes of the smem plan a block: v, dg, the reduction
// scratch and the two triangles.
size_t smem_bytes(int P) { return sizeof(float) * ((size_t)2 * P + kRed + (size_t)P * (P + 1)); }

// ... and of the blocked plan: a staged chunk, the diagonal block, the
// reduction scratch with the failure flag, and dg.
size_t blocked_bytes(int P) {
  return sizeof(float) * ((size_t)kStageFloats + kNB * kNB + kNB * (kNB + 1) + kRed + 4 + P);
}

bool tri_in_smem(int P) {
  return smem_bytes(P) <= 48 * 1024 || smem_bytes(P) <= (size_t)max_optin_smem();
}

// Threads a block at P: the smem plan's rows below a step go to the warps
// in turn; the blocked plan's threads each own a row or a column.
int factor_threads(int P, bool in_smem) {
  return !in_smem ? kBlockedThreads : P <= 32 ? 256 : 512;
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, int threads, size_t bytes, void* stream, Args... args) {
  if (bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, bytes, (cudaStream_t)stream>>>(args...);
  return cudaGetLastError();
}

template <bool INVERSE>
cudaError_t launch_plan(int B, int P, void* stream, const void* H, void* Lt, void* nu, void* rung,
                        void* scratch, float jitter, float rel_jitter) {
  const float* h = (const float*)H;
  float *lt = (float*)Lt, *n = (float*)nu;
  int8_t* r = (int8_t*)rung;
  if (tri_in_smem(P))
    return launch(cholesky_pd_inverse_kernel<INVERSE>, B, factor_threads(P, true), smem_bytes(P),
                  stream, h, lt, n, r, P, jitter, rel_jitter);
  return launch(blocked_cholesky_pd_inverse_kernel<INVERSE>, B, kBlockedThreads,
                blocked_bytes(P), stream, h, lt, n, r, (float*)scratch, P, jitter, rel_jitter);
}

}  // namespace

extern "C" {

// The plan at P into out[3]: threads a block, shared-memory bytes a block,
// 1 where the triangles sit in shared memory (the smem plan; else the
// blocked plan, and the caller passes a scratch of B·P(P+1) floats); -1 for
// P outside 1..512.
int stm_factor_plan(int P, int* out) {
  if (P < 1 || P > kMaxP) return -1;
  const bool in_smem = tri_in_smem(P);
  out[0] = factor_threads(P, in_smem);
  out[1] = (int)(in_smem ? smem_bytes(P) : blocked_bytes(P));
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
  if ((!tri_in_smem(P) && !scratch) || (inverse && !nu)) return (int)cudaErrorInvalidValue;
  return inverse ? (int)launch_plan<true>(B, P, stream, H, Lt, nu, rung, scratch, jitter,
                                          rel_jitter)
                 : (int)launch_plan<false>(B, P, stream, H, Lt, nu, rung, scratch, jitter,
                                           rel_jitter);
}

}  // extern "C"
