// Fused score + rank count for entity-ranking evaluation, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel kge_tpu/ops/pallas/rank_count.py:_kernel (behind
// rank_counts there). For each query row b it counts, over the valid
// candidate rows c, the scores q[b] . cand[c] that are strictly greater
// than true[b] beyond the tie tolerance (rank) and those that tie (ties).
// The [B, C] score matrix is never stored. Tie semantics are those of
// _greater_close in that file: a NaN score counts as -inf; the tolerance
// atol + rtol * |t| applies to finite pairs only; equal infinities tie.
// The tolerance is formed in float32 with rounded, uncontracted operations
// (__fmul_rn, __fadd_rn, __fsub_rn), as the reference forms it, so counts
// at the tolerance boundary do not drift.
//
// Design. The TPU kernel walks candidate tiles in order and carries the
// per-row sums in VMEM from one grid step to the next. Here blocks run in
// parallel: one block takes a tile of TB query rows and TC candidate rows,
// stages both in shared memory KD columns at a time, and each thread forms
// full fp32 dot products (fmaf over k = 0..D-1 in order; no TF32, no
// tensor cores) for RPT x CPT (row, candidate) pairs. Each warp owns RPT
// rows of the tile; it reduces its counts with a warp reduction and adds
// them with one integer atomicAdd per row into the zeroed outputs. Integer
// atomics are exact and order-free, so the counts are deterministic. The
// candidate axis is split across blocks (at B = 100 the rows alone would
// fill 4 of the card's 132 SMs), and the row tiles of one candidate tile
// are neighbouring block indices, so a candidate tile read from device
// memory is served from L2 to the other row tiles. cand is read in place
// (it may be a leading-row view of a padded table); the ragged tail of
// rows c >= C is masked, as are rows with cand_valid[c] == 0.
//
// What bounds it on an H100 SXM. At the evaluation shape (B = 100,
// C = 14,541, D = 128) a launch does 2*B*C*D = 0.372 GFLOP of fp32 FMA,
// about 5.6 us at the fp32 non-tensor peak (about 67 TFLOP/s, data
// sheet), and reads 7.4 MB of candidates, about 2.2 us at 3.35 TB/s: the
// launch is bound by operations, and the table stays in the 50 MB L2 from
// one launch to the next. At C = 4,818,679 (Wikidata5M) and B = 100 it is
// about 123 GFLOP (about 1.8 ms) against 2.47 GB (about 0.74 ms). Faster
// forms (3xTF32 split products on the tensor cores, TMA candidate
// streaming) are left for later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int TB = 32;         // query rows per block
constexpr int TC = 128;        // candidate rows per block
constexpr int KD = 32;         // depth staged in shared memory per step
constexpr int THREADS = 256;   // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPT = TB / WARPS;  // rows per thread: warp w owns w + 8 i
constexpr int CPT = TC / 32;     // candidates per thread: lane l owns l + 32 j

__device__ __forceinline__ void greater_close(float s, float t, float tol,
                                              bool& greater, bool& close) {
  if (isnan(s)) s = -INFINITY;
  const bool finite = isfinite(s) && isfinite(t);
  close = (s == t) || (finite && fabsf(__fsub_rn(s, t)) <= tol);
  greater = (s > t) && !close;
}

__global__ void __launch_bounds__(THREADS)
rank_count_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                  const float* __restrict__ true_score,
                  const float* __restrict__ cand_valid,
                  int* __restrict__ rank, int* __restrict__ ties, int B,
                  int C, int D, int row_tiles, float atol, float rtol) {
  // +1 column: the transposed stores below hit 32 distinct banks
  __shared__ float qs[KD][TB + 1];
  __shared__ float cs[KD][TC + 1];

  const int row_tile = blockIdx.x % row_tiles;
  const long long c0 = (long long)(blockIdx.x / row_tiles) * TC;
  const int r0 = row_tile * TB;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += KD) {
    // consecutive threads read consecutive k of one row: coalesced
    for (int idx = threadIdx.x; idx < TB * KD; idx += THREADS) {
      const int r = idx / KD, k = idx % KD;
      const int gr = r0 + r, gk = k0 + k;
      qs[k][r] = (gr < B && gk < D) ? q[(size_t)gr * D + gk] : 0.f;
    }
    for (int idx = threadIdx.x; idx < TC * KD; idx += THREADS) {
      const int c = idx / KD, k = idx % KD;
      const long long gc = c0 + c;
      const int gk = k0 + k;
      cs[k][c] = (gc < C && gk < D) ? cand[(size_t)gc * D + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      float a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) a[i] = qs[k][warp + WARPS * i];
#pragma unroll
      for (int j = 0; j < CPT; ++j) b[j] = cs[k][lane + 32 * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  bool counted[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) {
    const long long c = c0 + lane + 32 * j;
    counted[j] = c < C && cand_valid[c] > 0.f;
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = r0 + warp + WARPS * i;  // the same for the whole warp
    if (r >= B) continue;
    const float t = true_score[r];
    const float tol = __fadd_rn(atol, __fmul_rn(rtol, fabsf(t)));
    int n_greater = 0, n_close = 0;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      bool greater, close;
      greater_close(acc[i][j], t, tol, greater, close);
      n_greater += counted[j] && greater;
      n_close += counted[j] && close;
    }
    n_greater = __reduce_add_sync(0xffffffffu, n_greater);
    n_close = __reduce_add_sync(0xffffffffu, n_close);
    if (lane == 0) {
      if (n_greater) atomicAdd(rank + r, n_greater);
      if (n_close) atomicAdd(ties + r, n_close);
    }
  }
}

}  // namespace

// Adds the counts of q @ cand^T against true into rank and ties ([B]
// int32, zeroed by the caller) on the given stream. All arrays are
// contiguous device memory; q [B, D], cand [C, D], true_score [B] and
// cand_valid [C] are float32. Returns the launch's cudaError_t.
extern "C" int kge_rank_counts(const float* q, const float* cand,
                               const float* true_score,
                               const float* cand_valid, int* rank, int* ties,
                               int B, int C, int D, float atol, float rtol,
                               void* stream) {
  if (B <= 0 || C <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int row_tiles = (B + TB - 1) / TB;
  const long long blocks =
      (((long long)C + TC - 1) / TC) * (long long)row_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  rank_count_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      q, cand, true_score, cand_valid, rank, ties, B, C, D, row_tiles, atol,
      rtol);
  return (int)cudaGetLastError();
}
