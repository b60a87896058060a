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
// at the tolerance boundary do not drift. Each score is fmaf over
// k = 0..D-1 in order from 0.f (then + 0 * 0 for the zero padding of the
// depth): full fp32, no TF32, no tensor cores, so the scores and counts do
// not depend on the tiling.
//
// What bounds it on an H100 SXM. A launch does 2*B*C*D fp32 operations
// against 4*(B + C)*D bytes of inputs: 0.372 GFLOP (5.6 us at the fp32
// non-tensor peak of about 67 TFLOP/s, data sheet) against 7.4 MB (2.2 us
// at 3.35 TB/s) at the evaluation shape (B = 100, C = 14,541, D = 128), and
// 1.26 TFLOP (18.9 ms) against 2.47 GB (0.74 ms) at the Wikidata5M table
// (B = 1024, C = 4,818,679). So it is bound by the fp32 FMA pipes, and the
// design is a register-blocked fp32 product whose other costs hide behind
// the FMAs:
//
// - Row tile. A block holds TB = 128 (Wide) or 112 (Narrow) query rows:
//   B = 100 is one row tile, so every candidate tile is read once per row
//   tile.
// - Persistent candidate loop. The grid is the row tiles times as many
//   candidate groups as fill the card's SMs at the occupancy the kernel
//   reaches; a block walks the candidate tiles of its group with a stride
//   of the grid. The row tiles of one group are neighbouring blocks, so a
//   candidate tile comes from device memory once and from L2 after.
// - Async ring. Depth slices of the candidate tiles stream into a ring of
//   shared memory with cp.async (16-byte copies when D % 4 == 0 and both
//   row bases are 16-byte aligned, else 4-byte copies: the same kernel,
//   the same layout), ahead of the compute and across tile boundaries; one
//   __syncthreads per slice. The q tile is staged once and stays (Wide),
//   or its depth slices ride in the ring (Narrow, which therefore also
//   takes any depth whose resident q tile would not fit, D > 400).
// - Micro-tile. Each thread owns RPT rows x CPT candidates and reads both
//   as float4 along the depth, at least 14 FMAs for each 16-byte shared load;
//   each step runs one depth over all its accumulators, so no FMA waits on
//   the one before it. Slice rows are padded to KD + 4 floats, so the
//   candidate rows a warp reads fall on distinct banks.
// - Two shapes (measured, PERF.md): Wide, 8 x 16 pairs a thread and 2
//   blocks of 4 warps an SM, for many tiles per block (its depth loop is
//   not unrolled, which keeps the FMA body in the instruction cache: the
//   unrolled one measured slower); Narrow, 7 x 7 pairs a thread and 8 warps
//   a block, for at most two block tiles an SM (the evaluation), where the
//   more warps share one tile the sooner it is done.
// - Counts. After each tile the greater and tie counts of a row are summed
//   over the lanes that share it (shuffles) into shared memory; at the end
//   each block adds them with one integer atomicAdd per row and count.
//   Integer atomics are exact and order-free: the counts are deterministic.
//   The C entry point zeroes the [2, B] output with cudaMemsetAsync.
//
// cand is read in place (it may be a leading-row view of a padded table);
// the ragged tail c >= C is zero-filled and masked, as are the rows with
// cand_valid[c] == 0. Faster forms (3xTF32 split products on the tensor
// cores) are left for later work: they change the scores.

#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
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

// wait until at most `pending` of this thread's committed groups are in
// flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending));
}

// Thread (ty, tx) owns the pairs of rows ty + TY * i (i < RPT) and
// candidates tx + TX * j (j < CPT) of a TB x TC block tile.
template <int THREADS_, int MIN_BLOCKS_, int TX_, int RPT_, int CPT_,
          int KD_, int STAGES_, bool UNROLL_, bool Q_IN_RING_>
struct Shape {
  static constexpr int THREADS = THREADS_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks an SM holds
  static constexpr int TX = TX_;                  // threads along candidates
  static constexpr int TY = THREADS / TX;         // threads along rows
  static constexpr int RPT = RPT_;                // rows per thread
  static constexpr int CPT = CPT_;                // candidates per thread
  static constexpr int TB = TY * RPT;             // query rows per block
  static constexpr int TC = TX * CPT;             // candidate rows per tile
  static constexpr int KD = KD_;                  // depth per ring slice
  static constexpr int STRIDE = KD + 4;           // floats per slice row
  static constexpr int STAGES = STAGES_;          // ring depth
  static constexpr bool UNROLL = UNROLL_;         // unroll a slice's depth
  static constexpr bool Q_IN_RING = Q_IN_RING_;   // q slices in the ring
};
// Many tiles per block (a table like Wikidata5M's): 8 x 16 pairs a
// thread, 2 blocks of 4 warps an SM, a two-slice ring, a depth loop that
// is not unrolled, so the 512 FMAs of a step stay in the instruction
// cache, and the q tile resident.
using Wide = Shape<128, 2, 8, 8, 16, 16, 2, false, false>;
// About one tile per block (the evaluation's 100 x 14,541): 112 x 112
// tiles of 7 x 7 pairs a thread, so 8 warps share a tile, 100 rows waste
// less of it and 14,541 candidates are 130 tiles for 132 SMs; q rides in
// the ring, so no block waits for a whole q tile before its first FMA.
using Narrow = Shape<256, 1, 16, 7, 7, 32, 3, true, true>;

constexpr int MAX_SMEM = 232448;  // bytes of shared memory a block may use

// D padded to whole slices (one slice of zeros for D = 0: scores 0)
template <class S>
__host__ __device__ __forceinline__ int padded_depth(int D) {
  return D > 0 ? (D + S::KD - 1) / S::KD * S::KD : S::KD;
}

// bytes of shared memory: t, tol, greater and tie counts of the block's
// rows, the resident q tile, the ring
template <class S>
long long shared_bytes(int D) {
  return 4 * S::TB * 4 +
         (S::Q_IN_RING ? 0 : S::TB * (padded_depth<S>(D) + 4LL) * 4) +
         S::STAGES * (S::Q_IN_RING ? S::TB + S::TC : S::TC) * S::STRIDE * 4;
}

__device__ __forceinline__ void greater_close(float s, float t, float tol,
                                              bool& greater, bool& close) {
  if (isnan(s)) s = -INFINITY;
  const bool finite = isfinite(s) && isfinite(t);
  close = (s == t) || (finite && fabsf(__fsub_rn(s, t)) <= tol);
  greater = (s > t) && !close;
}

// Stages rows [0, rows) x depth [k0, k0 + KD) of src ([n, D], rows from
// row0) into dst ([rows][STRIDE]); rows past n and depth past D are zeros.
template <class S, int rows>
__device__ __forceinline__ void stage_slice(float* dst,
                                            const float* __restrict__ src,
                                            long long row0, long long n,
                                            int D, int k0, bool vec) {
  constexpr int KD = S::KD, STRIDE = S::STRIDE;
  if (vec) {
    for (int idx = threadIdx.x; idx < rows * (KD / 4); idx += S::THREADS) {
      const int r = idx / (KD / 4), k = k0 + 4 * (idx % (KD / 4));
      const long long g = row0 + r;
      const bool live = g < n && k < D;
      cp_async16(dst + r * STRIDE + (k - k0),
                 live ? src + g * D + k : src, live);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * KD; idx += S::THREADS) {
      const int r = idx / KD, k = k0 + idx % KD;
      const long long g = row0 + r;
      const bool live = g < n && k < D;
      cp_async4(dst + r * STRIDE + (k - k0),
                live ? src + g * D + k : src, live);
    }
  }
}

template <class S>
__global__ void __launch_bounds__(S::THREADS, S::MIN_BLOCKS)
rank_count_kernel(const float* __restrict__ q, const float* __restrict__ cand,
                  const float* __restrict__ true_score,
                  const float* __restrict__ cand_valid, int* __restrict__ out,
                  int B, int C, int D, int row_tiles, int tiles, bool vec,
                  float atol, float rtol) {
  constexpr int TX = S::TX, TY = S::TY, RPT = S::RPT, CPT = S::CPT;
  constexpr int TB = S::TB, TC = S::TC;
  constexpr int KD = S::KD, STRIDE = S::STRIDE, STAGES = S::STAGES;
  constexpr bool q_in_ring = S::Q_IN_RING;
  extern __shared__ __align__(16) float smem[];
  float* t_s = smem;
  float* tol_s = smem + TB;
  int* counts_s = reinterpret_cast<int*>(smem + 2 * TB);  // greater, ties
  const int depth = padded_depth<S>(D);
  const int q_stride = depth + 4;
  float* qs = smem + 4 * TB;  // the resident q tile [TB][q_stride]
  float* ring = q_in_ring ? qs : qs + TB * q_stride;
  const int stage_floats = (q_in_ring ? TB + TC : TC) * STRIDE;

  const int tid = threadIdx.x;
  // a warp covers 32 / TX values of ty and every tx: the TX lanes that
  // share a row are neighbours in one warp
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = lane % TX, ty = warp * (32 / TX) + lane / TX;
  const int row_tile = blockIdx.x % row_tiles;
  const int group = blockIdx.x / row_tiles;
  const int groups = gridDim.x / row_tiles;
  const int r0 = row_tile * TB;
  const int nk = depth / KD;  // slices per candidate tile
  const int my_tiles = (tiles - group + groups - 1) / groups;
  const int slices = my_tiles * nk;

  for (int r = tid; r < TB; r += S::THREADS) {
    const float t = r0 + r < B ? true_score[r0 + r] : 0.f;
    t_s[r] = t;
    tol_s[r] = __fadd_rn(atol, __fmul_rn(rtol, fabsf(t)));
    counts_s[r] = 0;
    counts_s[TB + r] = 0;
  }

  // the q tile, once: it completes with the ring's first slice
  if constexpr (!q_in_ring) {
    const int quads = depth / 4;
    for (int idx = tid; idx < TB * (vec ? quads : depth);
         idx += S::THREADS) {
      if (vec) {
        const int r = idx / quads, k = 4 * (idx % quads);
        const bool live = r0 + r < B && k < D;
        cp_async16(qs + r * q_stride + k,
                   live ? q + (long long)(r0 + r) * D + k : q, live);
      } else {
        const int r = idx / depth, k = idx % depth;
        const bool live = r0 + r < B && k < D;
        cp_async4(qs + r * q_stride + k,
                  live ? q + (long long)(r0 + r) * D + k : q, live);
      }
    }
  }

  auto load = [&](int s) {
    if (s < slices) {
      float* dst = ring + (s % STAGES) * stage_floats;
      const long long c0 = (long long)(group + (s / nk) * groups) * TC;
      const int k0 = (s % nk) * KD;
      stage_slice<S, TC>(dst, cand, c0, C, D, k0, vec);
      if constexpr (q_in_ring)
        stage_slice<S, TB>(dst + TC * STRIDE, q, r0, B, D, k0, vec);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < slices; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(s + STAGES - 1);

    const float* cs = ring + (s % STAGES) * stage_floats;
    const int ks = s % nk;
    const float* qsrc = q_in_ring ? cs + TC * STRIDE : qs + ks * KD;
    const int qstr = q_in_ring ? STRIDE : q_stride;
    // four depths of every pair, one depth at a time over the pairs: the
    // RPT * CPT accumulators are independent chains, so no FMA waits on
    // the one before it
    auto step = [&](int kk) {
      float4 a[RPT], b[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        a[i] = *reinterpret_cast<const float4*>(qsrc + (ty + TY * i) * qstr +
                                                kk);
#pragma unroll
      for (int j = 0; j < CPT; ++j)
        b[j] = *reinterpret_cast<const float4*>(cs + (tx + TX * j) * STRIDE +
                                                kk);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    };
    if constexpr (S::UNROLL) {
#pragma unroll
      for (int kk = 0; kk < KD; kk += 4) step(kk);
    } else {
#pragma unroll 1
      for (int kk = 0; kk < KD; kk += 4) step(kk);
    }

    if (ks == nk - 1) {  // the tile's scores are complete: count them
      const long long c0 = (long long)(group + (s / nk) * groups) * TC;
      bool counted[CPT];
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const long long c = c0 + tx + TX * j;
        counted[j] = c < C && cand_valid[c] > 0.f;
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int row = ty + TY * i;
        const float t = t_s[row], tol = tol_s[row];
        int n = 0;  // greater in the low half, ties in the high half
        if (isfinite(t) && tol < INFINITY) {
          // the same rules, shorter: a non-finite or NaN score is never
          // within a finite tolerance of a finite t, nor (NaN) above it
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            const float s = acc[i][j];
            const bool close = s == t || fabsf(__fsub_rn(s, t)) <= tol;
            const bool greater = s > t && !close;
            n += (counted[j] && greater) + ((counted[j] && close) << 16);
          }
        } else {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            bool greater, close;
            greater_close(acc[i][j], t, tol, greater, close);
            n += (counted[j] && greater) + ((counted[j] && close) << 16);
          }
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
        // the TX lanes that share the row (at most TC counts each)
#pragma unroll
        for (int offset = TX / 2; offset > 0; offset >>= 1)
          n += __shfl_xor_sync(0xffffffffu, n, offset);
        if (tx == 0) {
          counts_s[row] += n & 0xffff;
          counts_s[TB + row] += n >> 16;
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int r = tid; r < TB && r0 + r < B; r += S::THREADS) {
    if (counts_s[r]) atomicAdd(out + r0 + r, counts_s[r]);
    if (counts_s[TB + r]) atomicAdd(out + B + r0 + r, counts_s[TB + r]);
  }
}

// Launches the kernel of shape S with as many candidate groups per row
// tile as fill the card at the occupancy S reaches with this shared memory.
template <class S>
cudaError_t launch(const float* q, const float* cand, const float* true_score,
                   const float* cand_valid, int* out, int B, int C, int D,
                   float atol, float rtol, cudaStream_t stream, int device,
                   int sms) {
  // per shape: the device whose limit is raised, and the blocks an SM
  // holds at the last shared-memory size asked for
  static int configured = -1, occupancy_smem = -1, per_sm = 0;
  cudaError_t err;
  if (device != configured) {
    err = cudaFuncSetAttribute(rank_count_kernel<S>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM);
    if (err != cudaSuccess) return err;
    configured = device;
    occupancy_smem = -1;
  }
  const int smem = (int)shared_bytes<S>(D);
  if (smem != occupancy_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, rank_count_kernel<S>, S::THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    occupancy_smem = smem;
  }
  const int row_tiles = (B + S::TB - 1) / S::TB;
  const int tiles = (int)(((long long)C + S::TC - 1) / S::TC);
  const long long groups = std::max(
      1LL, std::min<long long>(tiles, (long long)sms * per_sm / row_tiles));
  const long long blocks = groups * row_tiles;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  const bool vec = D % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                   (uintptr_t)cand % 16 == 0;
  rank_count_kernel<S><<<(unsigned)blocks, S::THREADS, smem, stream>>>(
      q, cand, true_score, cand_valid, out, B, C, D, row_tiles, tiles, vec,
      atol, rtol);
  return cudaGetLastError();
}

}  // namespace

// Writes the counts of q @ cand^T against true into out ([2, B] int32:
// rank, then ties), which it zeroes first, on the given stream. q [B, D],
// cand [C, D], true_score [B] and cand_valid [C] are contiguous float32
// device memory. Takes the Narrow shape when the block tiles are at most
// two per SM or Wide's resident q tile would not fit in shared memory
// (D > 400), else the Wide one. Returns the first failing call's
// cudaError_t. Not thread-safe (it caches the launch configuration).
extern "C" int kge_rank_counts(const float* q, const float* cand,
                               const float* true_score,
                               const float* cand_valid, int* out, int B,
                               int C, int D, float atol, float rtol,
                               void* stream) {
  static int sm_device = -1, sms = 0;
  if (B <= 0 || C <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(out, 0, 2 * (size_t)B * sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  int device;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if (device != sm_device) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    sm_device = device;
  }
  const long long block_tiles = (long long)((B + Narrow::TB - 1) / Narrow::TB) *
                                (((long long)C + Narrow::TC - 1) / Narrow::TC);
  if (block_tiles <= 2LL * sms || shared_bytes<Wide>(D) > MAX_SMEM)
    err = launch<Narrow>(q, cand, true_score, cand_valid, out, B, C, D, atol,
                         rtol, s, device, sms);
  else
    err = launch<Wide>(q, cand, true_score, cand_valid, out, B, C, D, atol,
                       rtol, s, device, sms);
  return (int)err;
}
