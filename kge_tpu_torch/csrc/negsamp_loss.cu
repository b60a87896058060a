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
// The [B, N] score matrix is never stored in device memory.
//
// What bounds it on an H100 SXM. At the training shape (B = 1024 rows,
// N = 129 candidates, D = 128) a launch does 2*B*N*D = 33.8 MFLOP of fp32
// FMA, 0.505 us at the fp32 non-tensor peak (about 67 TFLOP/s, data
// sheet), and moves (B*D + N*D + B*N + 3*B)*4 B = 1.13 MB, 0.338 us at
// 3.35 TB/s. Half a microsecond of work is less than one launch's latency,
// so what bounds it is latency: how many SMs work at once, how many round
// trips to memory a block waits for, how long the dependent FMA chains of
// a thread are, and how many launches a call makes. The design:
//
// - Enough blocks. A block takes TB = 8 query rows (one warp per row in
//   the reductions): 128 blocks at B = 1024, for the card's 132 SMs.
// - Stage once. Each block copies its q rows and the whole candidate
//   block into dynamic shared memory with cp.async
//   (16-byte copies when D % 4 == 0 and both row bases are 16-byte
//   aligned, else 4-byte copies), all started at once: the candidates in
//   SLICES depth slices of one copy group each, so the FMAs of a slice
//   start as soon as it lands (one wait and one __syncthreads a slice). At
//   N = 129, D = 128 that is 66 KB of candidates. Shared rows are padded to
//   round_up(D, 8) + 4 floats, so the candidate rows 8 neighbouring
//   threads read fall on distinct banks.
// - Scores. Two threads own a candidate column, 4 rows each, so 288
//   threads score 144 columns at once: fmaf over k = 0..D-1 in order from
//   0.f (full fp32, no TF32, no tensor cores), one depth at a time over
//   the rows (4 independent chains), the candidate row read as float4 and
//   the q rows broadcast. The columns are not padded: at N = 129 the 129th
//   column is two more threads, not a chunk of its own. The scores go to
//   shared memory; each row's counts go from device memory to the
//   registers of its warp while the copies land.
// - Two exact passes. While the candidates fit in shared memory, each warp
//   forms its row's masked max (a max that propagates NaN, which fmaxf
//   alone would drop) and then the count-weighted sum of exponentials
//   over all N scores: the formula above. Special values follow it: a
//   masked column adds counts * 0 (NaN for a NaN count, as counts *
//   exp(-inf - m) does there), a row whose max is NaN or infinite gets lse
//   NaN (the formula forms inf - inf or NaN there), and a row with no
//   drawn candidate gets lse = pos. Larger N (more than 144, or more than
//   fit) keeps the online form: chunks stream through a double-buffered
//   ring (the next chunk in flight while this one is scored), and each
//   chunk's max and sum fold into the row's (m, z), rescaling z by
//   exp(m_old - m_new). With one chunk the fold is the two-pass formula
//   exactly.
// - One launch, deterministic. Each block sums its rows' terms in row
//   order into its partial; a ticket (__threadfence, then an integer
//   atomicAdd on a counter that the C entry point zeroes on the stream
//   before the launch) finds the last block, which sums the partials in a
//   fixed order and writes the loss. No float atomics: the same inputs
//   give the same bits.
//
// Faster forms (both slots in one launch, the count expansion fused into
// the kernel) are left for later work.

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

namespace {

// cp.async (sm_80 and later). A copy with src_bytes 0 reads nothing and
// writes zeros, so the ragged edge of a tile (rows past the end, depth
// past D) is filled by the instruction that stages the live part; its
// source must still be a valid address, so callers pass the array's base.
__device__ __forceinline__ unsigned shared_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes, L2 only; both addresses 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(live ? 16 : 0));
}

// 4 bytes, for rows that are not 16-byte aligned or a depth D % 4 != 0
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_address(dst)),
               "l"(src), "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (0..7) of this thread's committed groups
// are in flight; wait_group takes only a constant
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

constexpr int TB = 8;             // query rows per block, one warp each
constexpr int THREADS = 288;      // 9 warps: a column for every 2 threads
constexpr int RPT = 4;            // rows per thread in the scores
constexpr int MAX_NC = THREADS * RPT / TB;  // candidates per chunk: 144
constexpr int CPL = (MAX_NC + 31) / 32;     // counts a lane holds: 5
constexpr int SLICES = 4;         // depth slices of a staged chunk
// bytes of dynamic shared memory a block may use (232,448) less the static
// flag of the last block
constexpr int MAX_SMEM = 232448 - 16;

__host__ __device__ __forceinline__ int row_stride(int D) {
  return (D + 7) / 8 * 8 + 4;
}

// depth of one slice: D padded to a multiple of 4, cut in SLICES
__host__ __device__ __forceinline__ int slice_depth(int D) {
  const int depth = (D + 3) / 4 * 4;
  return ((depth + SLICES - 1) / SLICES + 3) / 4 * 4;
}

// floats of shared memory for chunks of nc candidates: the row terms, q,
// the candidate buffers (two when one chunk does not hold every
// candidate) and the scores
__host__ __device__ __forceinline__ long long shared_floats(int D, int N,
                                                             int nc) {
  const int stages = nc < N ? 2 : 1;
  return TB + (long long)row_stride(D) * (TB + stages * nc) +
         (long long)TB * nc;
}

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

// Stages rows [row0, row0 + rows) x depth [k_lo, k_hi) of src ([*, D])
// into dst ([rows][row_stride(D)]); depth past D (up to a multiple of 4)
// and rows at or past n are zeros.
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           long long row0, int rows,
                                           long long n, int D, int k_lo,
                                           int k_hi, bool vec) {
  const int stride = row_stride(D);
  const int per_row = vec ? (k_hi - k_lo) / 4 : k_hi - k_lo;
  if (per_row <= 0) return;
  for (int idx = threadIdx.x; idx < rows * per_row; idx += THREADS) {
    const int r = idx / per_row;
    const long long g = row0 + r;
    if (vec) {
      const int k = k_lo + 4 * (idx - r * per_row);
      const bool live = g < n;
      cp_async16(dst + r * stride + k, live ? src + g * D + k : src, live);
    } else {
      const int k = k_lo + idx - r * per_row;
      const bool live = g < n && k < D;
      cp_async4(dst + r * stride + k, live ? src + g * D + k : src, live);
    }
  }
}

// out: lse [B], loss [1], ticket [1] (an unsigned int, zeroed), partials
// [gridDim.x]
__global__ void __launch_bounds__(THREADS)
shared_ce_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                 const float* __restrict__ pos,
                 const float* __restrict__ counts,
                 const float* __restrict__ w, float* __restrict__ out, int B,
                 int N, int D, int nc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ bool last;
  const int stride = row_stride(D), depth = (D + 3) / 4 * 4;
  const int ks = slice_depth(D);
  const int chunks = nc > 0 ? (N + nc - 1) / nc : 0;
  const int stages = chunks > 1 ? 2 : 1;
  float* terms = smem;                    // [TB]
  float* qs = smem + TB;                  // [TB][stride]
  float* ring = qs + TB * stride;         // [stages][nc][stride]
  float* scores = ring + stages * nc * stride;  // [TB][nc]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r0 = blockIdx.x * TB;
  // warps 0..TB-1 take a row each in the reductions; the last one only
  // scores
  const int row = r0 + warp;
  const bool reducer = warp < TB && row < B;
  // in the scores, thread tid takes column tid % MAX_NC of rows
  // RPT * (tid / MAX_NC) + i
  const int col = tid % MAX_NC, rows0 = RPT * (tid / MAX_NC);

  // a chunk: its candidate rows in SLICES depth slices, one copy group
  // each; the first chunk's first group also brings q
  auto copy_chunk = [&](int ch) {
    const int c0 = ch * nc, cols = min(nc, N - c0);
    float* cs = ring + (ch % stages) * nc * stride;
    for (int j = 0; j < SLICES; ++j) {
      const int k_lo = min(j * ks, depth), k_hi = min(k_lo + ks, depth);
      if (j == 0 && ch == 0) stage_rows(qs, q, r0, TB, B, D, 0, depth, vec);
      stage_rows(cs, cand, c0, cols, N, D, k_lo, k_hi, vec);
      cp_async_commit();
    }
  };

  // the row's running max and sum; the pos term starts them:
  // exp(pos - pos) = 1. z is kept in lane 0.
  const float p = reducer ? pos[row] : 0.f;
  const float weight = reducer ? w[row] : 0.f;
  float m = p, z = 1.f;

  if (chunks > 0) copy_chunk(0);
  for (int ch = 0; ch < chunks; ++ch) {
    int ahead = 0;  // copy groups of the next chunk in flight
    if (ch + 1 < chunks) {
      copy_chunk(ch + 1);
      ahead = SLICES;
    }
    const int c0 = ch * nc, cols = min(nc, N - c0);
    const float* cs = ring + (ch % stages) * nc * stride;
    // this row's counts of the chunk, in flight while the copies land
    float cnt[CPL];
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int c = lane + 32 * i;
      cnt[i] = reducer && c < cols
                   ? __ldg(counts + (long long)row * N + c0 + c) : 0.f;
    }

    // the scores of (rows0 .. rows0 + RPT - 1, col), slice by slice as
    // the copies land
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    for (int j = 0; j < SLICES; ++j) {
      cp_async_wait(ahead + SLICES - 1 - j);
      __syncthreads();
      if (col < cols) {
        const float* crow = cs + col * stride;
        const float* qrow = qs + rows0 * stride;
        const int k_hi = min((j + 1) * ks, depth);
        for (int k = min(j * ks, depth); k < k_hi; k += 4) {
          const float4 b = *reinterpret_cast<const float4*>(crow + k);
          float4 a[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            a[i] = *reinterpret_cast<const float4*>(qrow + i * stride + k);
          // one depth at a time over the rows: RPT independent chains
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a[i].x, b.x, acc[i]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a[i].y, b.y, acc[i]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a[i].z, b.z, acc[i]);
#pragma unroll
          for (int i = 0; i < RPT; ++i) acc[i] = fmaf(a[i].w, b.w, acc[i]);
        }
      }
    }
    if (col < cols) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) scores[(rows0 + i) * nc + col] = acc[i];
    }
    __syncthreads();

    // fold this chunk into the warp's row; the branch is warp-uniform
    if (reducer) {
      const float* s_row = scores + warp * nc;
      float chunk_max = -INFINITY;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < cols && cnt[i] > 0.f)
          chunk_max = nan_max(chunk_max, s_row[c]);
      }
      const float m_new = nan_max(m, warp_max(chunk_max));
      // equal maxima (also both -inf) leave z as it is
      const float scale = m_new == m ? 1.f : expf(m - m_new);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int c = lane + 32 * i;
        if (c < cols) {
          const float s = s_row[c];
          const bool term = cnt[i] > 0.f && s != -INFINITY;
          part += term ? cnt[i] * expf(s - m_new) : cnt[i] * 0.f;
        }
      }
      z = z * scale + warp_sum(part);
      m = m_new;
    }
    __syncthreads();  // the buffer and the scores are free again
  }

  if (lane == 0 && warp < TB) {
    float term = 0.f;
    if (row < B) {
      const float l = isfinite(m) ? m + logf(z) : nan_value();
      out[row] = l;
      term = weight * (l - p);
    }
    terms[warp] = term;
  }
  __syncthreads();

  float* loss = out + B;
  unsigned* ticket = reinterpret_cast<unsigned*>(out + B + 1);
  float* partials = out + B + 2;
  if (tid == 0) {
    float sum = 0.f;
    for (int i = 0; i < TB; ++i) sum += terms[i];  // rows in order
    partials[blockIdx.x] = sum;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || warp != 0) return;
  // the last block's first warp: every partial is written; sum them in a
  // fixed order (lane l takes l, l + 32, ...; then a fixed tree)
  float sum = 0.f;
  for (int i = lane; i < gridDim.x; i += 32) sum += __ldcg(partials + i);
  sum = warp_sum(sum);
  if (lane == 0) *loss = sum;
}

}  // namespace

// Floats of the output kge_shared_ce_loss writes for B rows: lse [B], the
// loss, a ticket counter, one partial per block.
extern "C" int kge_shared_ce_loss_out_size(int B) {
  return B + 2 + (B + TB - 1) / TB;
}

// Writes lse and the loss into out (kge_shared_ce_loss_out_size(B) floats:
// out[0:B] lse, out[B] the loss) on the given stream. q [B, D],
// cand [N, D], pos [B], counts [B, N] and w [B] are contiguous float32
// device memory. Returns the first failing call's cudaError_t. Not
// thread-safe (it caches the shared-memory limit per device).
extern "C" int kge_shared_ce_loss(const float* q, const float* cand,
                                  const float* pos, const float* counts,
                                  const float* w, float* out, int B, int N,
                                  int D, void* stream) {
  static int configured = -1;
  if (B <= 0 || N < 0 || D < 0) return (int)cudaErrorInvalidValue;
  // one chunk of every candidate if it fits (at most MAX_NC columns, two
  // threads each); else the widest chunk (a multiple of 32 where
  // possible) whose two buffers fit
  int nc = N;
  if (N > MAX_NC || shared_floats(D, N, N) * 4 > MAX_SMEM) {
    const long long room = MAX_SMEM / 4 - TB - (long long)row_stride(D) * TB;
    const long long fit = std::min<long long>(
        MAX_NC, room / (2LL * row_stride(D) + TB));
    if (fit < 1) return (int)cudaErrorInvalidValue;  // D too large
    nc = (int)(fit >= 32 ? fit / 32 * 32 : fit);
  }
  const int smem = (int)(shared_floats(D, N, nc) * 4);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device != configured) {
    err = cudaFuncSetAttribute(shared_ce_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return (int)err;
    configured = device;
  }
  if ((err = cudaMemsetAsync(out + B + 1, 0, sizeof(unsigned), s)) !=
      cudaSuccess)
    return (int)err;
  const bool vec = D % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)cand % 16 == 0;
  shared_ce_kernel<<<(B + TB - 1) / TB, THREADS, smem, s>>>(
      q, cand, pos, counts, w, out, B, N, D, nc, vec);
  return (int)cudaGetLastError();
}
