// Hand-written Hopper (sm_90a) kernel: the E-step's ordered phi scatter,
//
//   beta_ss[(a,) k, w] += phi[entry, k] for every entry with key (a,) w
//
// (replaces the XLA scatter of strutopy_tpu/ops/estep.py::_scatter_phi,
// beta_ss.at[:, idx].add(phi), which adds in a fixed order on the TPU and
// the CPU).  It takes the place of index_add_, which on the card adds with
// atomics in no fixed order, so that the E-step's statistics, and with them
// the whole fit, are a function of its inputs.
//
// The contract.  An entry is a slot (b, l) of the chunk, at flat position
// b·L + l, with a key: the word (beta_ss (K, V)), aspect·V + word (the
// content model's (A, K, V)), or the local word id under a vocab axis.
// Each element beta_ss[(a,) k, w] takes its entries' phi one at a time, in
// ascending flat position, in float32: the XLA scatter's order, and that of
// index_add_ on the CPU, so the bits are theirs.  No two threads write one
// element: no atomics.
//
// The plan (strutopy_tpu_torch/ops/stages.py::scatter_plan, PyTorch ops on
// the device, no host sync) is a stable sort of the keys:
//   perm (n_entries,) int32   the flat positions, by key, ascending within one
//   offsets (n_keys + 1,) int32   key j's entries are perm[offsets[j] .. offsets[j+1])
// Entries that carry phi = +0 by construction (padding slots, words another
// vocab rank owns) sit after offsets[n_keys] and are never read: adding +0
// changes no bit of a sum of non-negative terms.
//
// Layout: phi rows (n_entries, K), entry-major (the finalize writes phi in
// that layout), so one entry's K values are one contiguous row; beta_ss is
// read and written in its own layout, element (key, k) at
// (key / V)·K·V + k·V + key % V.
//
// Bound: bytes.  The live entries' rows are read once (n_live·K·4) and the
// touched columns of beta_ss read and written once; at the bench chunk
// (B=256, K=100, L=384, ~250 live slots a document) ~26 MB + ~6 MB.
// Design: one warp per key and K tile of 128 (four values a lane), so a
// row read is 128-byte coalesced loads; the warp issues the loads of
// kUnroll entries before it adds them in order, so a deep key (a word in
// every document: up to B entries) is not one load latency an entry.  The
// block's kKeys columns of beta_ss come in and go out through shared
// memory, a 32-byte sector (kKeys floats) of a row at a time, and the
// running sums stay in registers in between.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kKeys = kWarps;   // one warp a key
constexpr int kKTile = 128;     // k values a block: four a lane
constexpr int kUnroll = 8;      // entries whose loads are in flight at once

__global__ void __launch_bounds__(kThreads)
scatter_phi_kernel(const float* __restrict__ phi, const int* __restrict__ perm,
                   const int* __restrict__ offsets, float* __restrict__ beta_ss, int n_keys,
                   int K, int V) {
  __shared__ float tile[kKTile][kKeys + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int key0 = blockIdx.x * kKeys;
  const int k0 = blockIdx.y * kKTile;

  // thread t moves column c = t % kKeys of rows t / kKeys, + kThreads / kKeys, ...
  const int c = threadIdx.x % kKeys;
  const int col_key = key0 + c;
  const bool col_hit = col_key < n_keys && offsets[col_key + 1] > offsets[col_key];
  float* col = beta_ss + (col_hit ? (size_t)(col_key / V) * K * V + col_key % V : 0);
  if (col_hit)
    for (int r = threadIdx.x / kKeys; r < kKTile && k0 + r < K; r += kThreads / kKeys)
      tile[r][c] = col[(size_t)(k0 + r) * V];
  __syncthreads();

  const int key = key0 + warp;
  const int begin = key < n_keys ? offsets[key] : 0, end = key < n_keys ? offsets[key + 1] : 0;
  if (begin < end) {
    float acc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      acc[q] = k0 + lane + 32 * q < K ? tile[lane + 32 * q][warp] : 0.f;
    for (int j = begin; j < end; j += kUnroll) {
      float v[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < end) {
          const float* row = phi + (size_t)perm[j + u] * K + k0 + lane;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            v[u][q] = k0 + lane + 32 * q < K ? __ldg(row + 32 * q) : 0.f;
        }
      }
      // in ascending flat position: entry j, j+1, ... (the plan's order)
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j + u < end) {
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] += v[u][q];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) tile[lane + 32 * q][warp] = acc[q];
  }
  __syncthreads();

  if (col_hit)
    for (int r = threadIdx.x / kKeys; r < kKTile && k0 + r < K; r += kThreads / kKeys)
      col[(size_t)(k0 + r) * V] = tile[r][c];
}

}  // namespace

extern "C" {

// beta_ss[...] += phi's rows, each element's in the plan's order (see the
// top of the file).  phi (n_entries, K), perm (n_entries,) and offsets
// (n_keys + 1,) int32, beta_ss of n_keys·K floats with V keys an aspect
// block.  Launches on ``stream``; returns cudaGetLastError().
int stm_scatter_phi(const void* phi, const void* perm, const void* offsets, void* beta_ss,
                    int n_keys, int K, int V, void* stream) {
  if (n_keys == 0 || K == 0) return 0;
  if (V < 1 || n_keys % V != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((n_keys + kKeys - 1) / kKeys, (K + kKTile - 1) / kKTile);
  scatter_phi_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)phi, (const int*)perm, (const int*)offsets, (float*)beta_ss, n_keys, K, V);
  return (int)cudaGetLastError();
}

}  // extern "C"
