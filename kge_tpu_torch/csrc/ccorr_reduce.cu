// CompGCN's circular-correlation messages, reduced by node in the
// spectral domain, for Hopper (sm_90a).
//
// Replaces no TPU kernel: kge_tpu leaves ccorr to XLA, edge by edge (two
// real FFTs, one inverse FFT and the mode weight's product on every edge,
// then a segment sum). The port instead moves the FFTs to the node and
// relation tables and the inverse FFT and the weight after the reduce
// (models/rgnn/layers.py, the spectral route), so that per edge there is
// left only a gather of two spectrum rows, a complex product, a scale and
// a sum by node. This file is that per-edge work, forward and backward.
//
// What it computes. A [rows_a, C] and B [rows_b, C] are tables of float4
// chunks, each chunk two complex bins (re, im, re, im): a spectrum row of
// K bins, padded to an even number, is C = ceil(K / 2) chunks. An order is
// a sequence of edges grouped by their output row; for output row r and
// its edges j in the order's sequence,
//
//   out[r] = sum_j s_j * op(A[ia_j], B[ib_j]),  s_j = scale[edge_j]
//
// (scale[j] where edge is null), with op(a, b) = conj(a) * b (CONJ) or
// a * b. The layer's three orders of one edge set (ops/ccorr_reduce.py):
// the forward by aggregation node (A the node spectra gathered at the
// neighbour, B the relation spectra at the type, CONJ); the gradient of
// the node spectra by neighbour (A the output's gradient at the
// aggregation node, B the relation spectra, CONJ); the gradient of the
// relation spectra by type (A the output's gradient, B the node spectra
// at the neighbour, a * b).
//
// What bounds it on an H100 SXM. Per edge the kernel reads two spectrum
// rows (416 bytes each at K = 51, d = 200) and 12 bytes of indices and
// scale, and does 10 flops a bin (a complex product and its scaled sum).
// At FB15k-237's 272,115 edges a half that is about 230 MB of gathers
// against 0.14 GFLOP: neither the flops nor device memory bound it, since
// the node table (5.9 MB) and the relation table (0.2 MB) stay in the
// 50 MB L2. The L2's bandwidth for scattered 16-byte loads, and the
// latency of those loads, bound it. The inputs read once and the output
// written once are about 17 MB.
//
// How the design meets that.
// - One warp per piece of at most 32 edges (the host cuts each row's run
//   of edges into such pieces, ops/ccorr_reduce.py:build_orders): enough
//   warps in flight to fill 132 SMs even for the order by type, whose
//   272k edges land on 475 rows, and a hub node's thousands of edges, or
//   a relation's tenth of all edges, spread over many warps.
// - A lane a chunk: lane c loads chunk c of both rows as one 16-byte load
//   each, so a warp reads a 416-byte row in one coalesced request; lanes
//   past C idle (6 of 32 at C = 26), and C > 32 takes a second round.
// - The lanes load the piece's indices and scales together, one edge a
//   lane, and pass them round by shuffles; four edges' rows are loaded
//   before the first is summed, so four pairs of loads are in flight a
//   lane.
// - No atomics: pass 1 writes each piece's partial sum to its own row of
//   a scratch table; pass 2 adds a row's pieces in their order, one warp a
//   row. A row of more than `heavy_pieces` pieces (a hub node, a frequent
//   relation: up to a thousand pieces) is left to a block of HEAVY_WARPS
//   warps instead, each warp summing one fixed sixteenth of the pieces in
//   order and warp 0 adding the sixteen sums in order. Each output element
//   is one fixed sequence of rounded operations, so the same inputs give
//   the same bits on every call.
// Rows without edges come out zero. The host checks the indices: the
// kernel does not range-check them.
//
// Measured (NVIDIA H100 80GB HBM3 at 700 W, a half of FB15k-237's edges
// on a Zipf-skewed graph with a node of 5,000 edges and a relation of 12%
// of them, Kp = 52): with pass 2 one warp a row whatever its pieces, the
// forward took 22 us (pass 1 18, pass 2 4), the reductions by neighbour
// and by relation 133 and 164 us, 111 and 145 of them in pass 2, where
// one warp added the heavy rows' 157 and about 1,000 pieces in sequence;
// hence the heavy rows' blocks. With them the three took 22, 35 and 33 us
// (the heavy rows' blocks 10 and 13 of it), 13-22% of the 5 us the bytes
// read and written once would take at 3.35 TB/s, the row gathers at 6-10
// TB/s.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int HEAVY_WARPS = 16;  // a heavy row's block in pass 2
constexpr int UNROLL = 4;  // edges whose rows are in flight at once
constexpr unsigned FULL = 0xffffffffu;

// s * op(a, b) added to acc, bin by bin: (x, y) and (z, w) are two bins
template <bool CONJ>
__device__ __forceinline__ void add_product(float4& acc, float4 a, float4 b,
                                            float s) {
  float re0, im0, re1, im1;
  if (CONJ) {
    re0 = a.x * b.x + a.y * b.y;
    im0 = a.x * b.y - a.y * b.x;
    re1 = a.z * b.z + a.w * b.w;
    im1 = a.z * b.w - a.w * b.z;
  } else {
    re0 = a.x * b.x - a.y * b.y;
    im0 = a.x * b.y + a.y * b.x;
    re1 = a.z * b.z - a.w * b.w;
    im1 = a.z * b.w + a.w * b.z;
  }
  acc.x = fmaf(s, re0, acc.x);
  acc.y = fmaf(s, im0, acc.y);
  acc.z = fmaf(s, re1, acc.z);
  acc.w = fmaf(s, im1, acc.w);
}

__device__ __forceinline__ void add(float4& acc, float4 v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// Pass 1: one warp a piece, its partial sum into partial[piece].
template <bool CONJ>
__global__ void __launch_bounds__(THREADS)
piece_sums(const float4* __restrict__ a, const float4* __restrict__ b,
           const int* __restrict__ ia, const int* __restrict__ ib,
           const int* __restrict__ edge, const float* __restrict__ scale,
           const int* __restrict__ piece_begin, float4* __restrict__ partial,
           long long pieces, int chunks) {
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (p >= pieces) return;  // the whole warp
  const int begin = piece_begin[p];
  const int end = piece_begin[p + 1];
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    const bool on = c < chunks;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int base = begin; base < end; base += 32) {
      const int n = min(32, end - base);
      // one edge a lane: its two rows and its scale
      int my_a = 0, my_b = 0;
      float my_s = 0.f;
      if (lane < n) {
        const int j = base + lane;
        my_a = ia[j];
        my_b = ib[j];
        my_s = scale[edge ? edge[j] : j];
      }
      int k = 0;
      for (; k + UNROLL <= n; k += UNROLL) {
        long long ra[UNROLL], rb[UNROLL];
        float s[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          ra[u] = __shfl_sync(FULL, my_a, k + u);
          rb[u] = __shfl_sync(FULL, my_b, k + u);
          s[u] = __shfl_sync(FULL, my_s, k + u);
        }
        if (on) {
          float4 va[UNROLL], vb[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            va[u] = __ldg(a + ra[u] * chunks + c);
            vb[u] = __ldg(b + rb[u] * chunks + c);
          }
#pragma unroll
          for (int u = 0; u < UNROLL; ++u)
            add_product<CONJ>(acc, va[u], vb[u], s[u]);
        }
      }
      for (; k < n; ++k) {
        const long long ra = __shfl_sync(FULL, my_a, k);
        const long long rb = __shfl_sync(FULL, my_b, k);
        const float s = __shfl_sync(FULL, my_s, k);
        if (on)
          add_product<CONJ>(acc, __ldg(a + ra * chunks + c),
                            __ldg(b + rb * chunks + c), s);
      }
    }
    if (on) partial[p * chunks + c] = acc;
  }
}

// The partial sums of pieces [first, last) at chunk c, added in order.
__device__ __forceinline__ float4 sum_pieces(
    const float4* __restrict__ partial, long long first, long long last,
    int chunks, int c) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  long long q = first;
  for (; q + UNROLL <= last; q += UNROLL) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = partial[(q + u) * chunks + c];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add(acc, v[u]);
  }
  for (; q < last; ++q) add(acc, partial[q * chunks + c]);
  return acc;
}

// Pass 2: one warp a row of at most heavy_pieces pieces, their partial
// sums added in order; heavier rows are heavy_row_sums'.
__global__ void __launch_bounds__(THREADS)
row_sums(const float4* __restrict__ partial,
         const int* __restrict__ row_pieces, float4* __restrict__ out,
         long long rows, int chunks, int heavy_pieces) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const long long first = row_pieces[r];
  const long long last = row_pieces[r + 1];
  if (last - first > heavy_pieces) return;
  for (int c = lane; c < chunks; c += 32)
    out[r * chunks + c] = sum_pieces(partial, first, last, chunks, c);
}

// Pass 2 of the heavy rows: one block a row, warp w adding the pieces of
// the w-th of HEAVY_WARPS fixed ranges, warp 0 the warps' sums in order.
__global__ void __launch_bounds__(HEAVY_WARPS * 32)
heavy_row_sums(const float4* __restrict__ partial,
               const int* __restrict__ row_pieces,
               const int* __restrict__ heavy_rows, float4* __restrict__ out,
               int chunks) {
  __shared__ float4 sums[HEAVY_WARPS][32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x / 32;
  const long long r = heavy_rows[blockIdx.x];
  const long long first = row_pieces[r];
  const long long n = row_pieces[r + 1] - first;
  const long long lo = first + n * warp / HEAVY_WARPS;
  const long long hi = first + n * (warp + 1) / HEAVY_WARPS;
  for (int c0 = 0; c0 < chunks; c0 += 32) {
    const int c = c0 + lane;
    sums[warp][lane] = c < chunks ? sum_pieces(partial, lo, hi, chunks, c)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    if (warp == 0 && c < chunks) {
      float4 acc = sums[0][lane];
      for (int w = 1; w < HEAVY_WARPS; ++w) add(acc, sums[w][lane]);
      out[r * chunks + c] = acc;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// out [rows, chunks] float4 (every row written) from the tables a and b
// ([*, chunks] float4), the order's per-edge ia, ib, edge (or null) and
// the scale (float32, indexed by edge position), its pieces (piece_begin
// [pieces + 1], each piece's first edge and, last, the edge count), rows
// (row_pieces [rows + 1], each row's first piece and, last, the piece
// count) and heavy rows (heavy_rows [heavy], every row of more than
// heavy_pieces pieces); partial [max(pieces, 1), chunks] float4 is
// scratch. Every pointer to float4 data is 16-byte aligned; all on CUDA
// device `device`, enqueued on `stream`. Returns cudaGetLastError() after
// the launches (0 on success), cudaErrorInvalidValue for sizes out of
// range.
int kge_ccorr_reduce(const void* a, const void* b, const int* ia,
                     const int* ib, const int* edge, const float* scale,
                     const int* piece_begin, const int* row_pieces,
                     const int* heavy_rows, void* partial, void* out,
                     long long pieces, long long rows, long long heavy,
                     int heavy_pieces, int chunks, int conj, int device,
                     void* stream) {
  if (chunks < 1 || pieces < 0 || rows < 0 || heavy < 0 || heavy > rows ||
      heavy_pieces < 0)
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* a4 = static_cast<const float4*>(a);
  const float4* b4 = static_cast<const float4*>(b);
  float4* part = static_cast<float4*>(partial);
  if (pieces > 0) {
    const unsigned blocks = (unsigned)((pieces + WARPS - 1) / WARPS);
    if (conj)
      piece_sums<true><<<blocks, THREADS, 0, s>>>(
          a4, b4, ia, ib, edge, scale, piece_begin, part, pieces, chunks);
    else
      piece_sums<false><<<blocks, THREADS, 0, s>>>(
          a4, b4, ia, ib, edge, scale, piece_begin, part, pieces, chunks);
  }
  float4* out4 = static_cast<float4*>(out);
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  row_sums<<<blocks, THREADS, 0, s>>>(part, row_pieces, out4, rows, chunks,
                                      heavy_pieces);
  if (heavy > 0)
    heavy_row_sums<<<(unsigned)heavy, HEAVY_WARPS * 32, 0, s>>>(
        part, row_pieces, heavy_rows, out4, chunks);
  const int err = (int)cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
