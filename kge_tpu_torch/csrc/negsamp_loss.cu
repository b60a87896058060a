// Fused shared-negative cross-entropy loss for Hopper (sm_90a).
//
// Replaces the TPU kernel kge_tpu/ops/pallas/negsamp_loss.py:_kernel
// (behind shared_ce_loss there). For each query row b, over the shared
// candidate rows n with scores s[b, n] = q[b] . cand[n]:
//
//   s_masked = counts > 0 ? s : -inf
//   m        = max(max_n s_masked, pos[b])
//   z        = exp(pos[b] - m) + sum_n counts[b, n] * exp(s_masked - m)
//   lse[b]   = m + log(z)
//   loss     = sum_b w[b] * (lse[b] - pos[b])
//
// It writes the per-row lse (the backward's residual) and the scalar loss.
// The [B, N] score matrix is never stored.
//
// Design. The TPU kernel pads the batch to 256-row tiles and the
// candidates to 128, and carries the loss in VMEM across a sequential
// grid. Here blocks run in parallel and in no order. One block takes TB
// query rows (RPW rows per warp) and walks the candidates in chunks of NC,
// staging q and the chunk in shared memory KD columns at a time; each lane
// forms full fp32 dot products (fmaf over k = 0..D-1 in order; no TF32, no
// tensor cores) for its RPW x CPL (row, candidate) pairs. After a chunk,
// each row's running max m and sum z (relative to m) absorb it, an online
// logsumexp: the chunk's masked max (a warp max that propagates NaN, which
// fmaxf alone would drop), the rescale of z by exp(m_old - m_new), and the
// count-weighted exponentials (a warp sum). Special values follow the
// two-pass formula above: a masked column adds counts * 0 (NaN for a NaN
// count, as counts * exp(-inf - m) does there), a row whose final max is
// NaN or infinite gets lse NaN (the formula forms inf - inf or NaN there),
// and a row with no drawn candidate gets lse = pos. The ragged edges
// (b >= B, n >= N) are masked in the kernel; the inputs are not padded.
// The loss is deterministic: each block sums its rows' terms in row order
// into one partial, and a second one-block launch sums the partials in a
// fixed order (no float atomics), so the same inputs give the same bits.
//
// What bounds it on an H100 SXM. At the training shape (B = 1024 rows,
// N = 129 candidates, D = 128) a launch does 2*B*N*D = 33.8 MFLOP of fp32
// FMA, 0.505 us at the fp32 non-tensor peak (about 67 TFLOP/s, data
// sheet), and moves (B*D + N*D + B*N + 3*B)*4 B = 1.13 MB, 0.338 us at
// 3.35 TB/s: operations bound it, and at half a microsecond of work the
// launch latency (two launches) dominates. The 64 blocks of that shape
// fill half the card's SMs. Faster forms (both slots in one launch, the
// products on the tensor cores as 3xTF32 splits, the count expansion fused
// into the kernel) are left for later work.

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int RPW = 2;           // query rows per warp
constexpr int TB = WARPS * RPW;  // query rows per block
constexpr int NC = 64;           // candidates per chunk
constexpr int CPL = NC / 32;     // candidates per lane: lane l owns l + 32 j
constexpr int KD = 32;           // depth staged in shared memory per step

__device__ __forceinline__ float nan_value() { return __int_as_float(0x7fc00000); }

// max that propagates NaN (fmaxf returns the other operand)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? nan_value() : fmaxf(a, b);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, offset));
  return v;  // the same in every lane: max is exact
}

// fixed-order tree sum; the total is valid in lane 0
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  return v;
}

__global__ void __launch_bounds__(THREADS)
shared_ce_lse_kernel(const float* __restrict__ q,
                     const float* __restrict__ cand,
                     const float* __restrict__ pos,
                     const float* __restrict__ counts,
                     const float* __restrict__ w, float* __restrict__ lse,
                     float* __restrict__ partials, int B, int N, int D) {
  // +1 column: the transposed stores below hit distinct banks
  __shared__ float qs[KD][TB + 1];
  __shared__ float cs[KD][NC + 1];
  __shared__ float terms[TB];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = blockIdx.x * TB;

  // running max and sum of each row of this warp; the pos term starts
  // them: exp(pos - pos) = 1
  float m[RPW], z[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp * RPW + i;
    m[i] = r < B ? pos[r] : 0.f;
    z[i] = 1.f;
  }

  for (int c0 = 0; c0 < N; c0 += NC) {
    float acc[RPW][CPL];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
      for (int j = 0; j < CPL; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KD) {
      // consecutive threads read consecutive k of one row: coalesced
      for (int idx = threadIdx.x; idx < TB * KD; idx += THREADS) {
        const int r = idx / KD, k = idx % KD;
        const int gr = r0 + r, gk = k0 + k;
        qs[k][r] = (gr < B && gk < D) ? q[(size_t)gr * D + gk] : 0.f;
      }
      for (int idx = threadIdx.x; idx < NC * KD; idx += THREADS) {
        const int c = idx / KD, k = idx % KD;
        const int gc = c0 + c, gk = k0 + k;
        cs[k][c] = (gc < N && gk < D) ? cand[(size_t)gc * D + gk] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KD; ++k) {
        float a[RPW], b[CPL];
#pragma unroll
        for (int i = 0; i < RPW; ++i) a[i] = qs[k][warp * RPW + i];
#pragma unroll
        for (int j = 0; j < CPL; ++j) b[j] = cs[k][lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RPW; ++i)
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold this chunk into each row's (m, z); the row is the same for the
    // whole warp, so the branch and the shuffles are warp-uniform
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + warp * RPW + i;
      if (r >= B) continue;
      float cnt[CPL];
      bool live[CPL];
      float chunk_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const int c = c0 + lane + 32 * j;
        cnt[j] = c < N ? counts[(size_t)r * N + c] : 0.f;
        live[j] = c < N && cnt[j] > 0.f;
        if (live[j]) chunk_max = nan_max(chunk_max, acc[i][j]);
      }
      const float m_new = nan_max(m[i], warp_max(chunk_max));
      // equal maxima (also both -inf) leave z as it is
      const float scale = m_new == m[i] ? 1.f : expf(m[i] - m_new);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < CPL; ++j) {
        const bool term = live[j] && acc[i][j] != -INFINITY;
        part += term ? cnt[j] * expf(acc[i][j] - m_new) : cnt[j] * 0.f;
      }
      z[i] = z[i] * scale + warp_sum(part);
      m[i] = m_new;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < RPW; ++i) {
      const int r = r0 + warp * RPW + i;
      float term = 0.f;
      if (r < B) {
        const float l = isfinite(m[i]) ? m[i] + logf(z[i]) : nan_value();
        lse[r] = l;
        term = w[r] * (l - pos[r]);
      }
      terms[warp * RPW + i] = term;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int t = 0; t < TB; ++t) sum += terms[t];  // rows in order
    partials[blockIdx.x] = sum;
  }
}

// one block: the loss as a fixed-order sum of the block partials
__global__ void __launch_bounds__(THREADS)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ loss) {
  __shared__ float buf[THREADS];
  float sum = 0.f;
  for (int i = threadIdx.x; i < n; i += THREADS) sum += partials[i];
  buf[threadIdx.x] = sum;
  __syncthreads();
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) buf[threadIdx.x] += buf[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) *loss = buf[0];
}

}  // namespace

// Number of block partials kge_shared_ce_loss needs for B rows.
extern "C" int kge_shared_ce_loss_blocks(int B) { return (B + TB - 1) / TB; }

// Writes lse [B] and the scalar loss on the given stream. All arrays are
// contiguous float32 device memory: q [B, D], cand [N, D], pos [B],
// counts [B, N], w [B], lse [B], partials [kge_shared_ce_loss_blocks(B)],
// loss [1]. Returns the launches' cudaError_t.
extern "C" int kge_shared_ce_loss(const float* q, const float* cand,
                                  const float* pos, const float* counts,
                                  const float* w, float* lse, float* partials,
                                  float* loss, int B, int N, int D,
                                  void* stream) {
  if (B <= 0 || N < 0 || D < 0) return (int)cudaErrorInvalidValue;
  const int blocks = kge_shared_ce_loss_blocks(B);
  cudaStream_t s = (cudaStream_t)stream;
  shared_ce_lse_kernel<<<blocks, THREADS, 0, s>>>(q, cand, pos, counts, w,
                                                   lse, partials, B, N, D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, THREADS, 0, s>>>(partials, blocks, loss);
  return (int)cudaGetLastError();
}
