// Row-sparse Adagrad and SGD updates of an embedding table, in place, for
// Hopper (sm_90a).
//
// Replaces the TPU kernels kge_tpu/ops/pallas/row_update.py:_adagrad_kernel
// (behind adagrad_row_update there) and :_sgd_kernel (behind
// sgd_row_update). For each position i of the sorted row-id vector uniq,
// with the gradient row g = rows_g[i] and the table row id = uniq[i]:
//
//   Adagrad:  s = sum[id] + g*g;  sum[id] = s
//             u = g / (sqrt(s) + eps)
//             table[id] = table[id] + (-lr * u)
//   SGD:      table[id] = table[id] + (-lr * g)
//
// Rows that uniq does not name are neither read nor written.
//
// Duplicates. uniq is sorted; a run of equal ids carries its gradient only
// at its last position (the caller's contract: the batch payload remaps
// with searchsorted(side="right") - 1). A position whose successor holds
// the same id writes nothing, and the last position of the run computes
// from the row as it was before the update: the result of the reference's
// scatter-add, whose other positions add exactly zero. On the training
// path uniq holds distinct ids, so the rule never fires there.
//
// Rounding. Every operation is a rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn), so nvcc contracts nothing into an FMA, and the
// order is that of kge_tpu's default XLA form (optimizer.py
// sparse_row_update): the kernel gives the bits of the plain PyTorch
// version (ops/row_update.py), which runs the same separately rounded
// operations. Ids are not range-checked here; the host payload keeps them
// inside the table.
//
// Design. The Pallas kernel walks a sequential grid, one touched row per
// step, anchoring an 8-row block at uniq[i] // 8 and copying the whole
// block on the first visit of a run: that exists only for Mosaic's (8, 128)
// tiling and its revisit rule, and is dropped. Here one warp owns one
// position of uniq; its lanes stride over the row's D elements, four at a
// time as float4 where D % 4 == 0 and the three arrays are 16-byte aligned,
// one at a time otherwise. A block holds 8 warps. Positions are
// independent: nothing carries over between blocks and there are no
// atomics.
//
// What bounds it on an H100 SXM. The update moves, per touched row, the
// gradient (read), the table row (read, write) and for Adagrad the sum row
// (read, write), plus the id: 4*(5*R*D) + 8*R bytes for Adagrad, 4*(3*R*D)
// + 8*R for SGD. At the Wikidata5M training shape (R = 2,306, D = 128) that
// is 5.92 MB, 1.77 us at 3.35 TB/s; at the relation table (R = 832) 2.14 MB,
// 0.64 us. Bytes bound it, a few flops per element; at microseconds of work
// the launch itself dominates. Each warp issues its row's loads together
// (one 512-byte row per array, coalesced), and 290 blocks cover the 132 SMs
// at that shape.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;  // 8 warps, one position of uniq each
constexpr int WARPS = THREADS / 32;

template <typename Index>
__device__ __forceinline__ bool writes(const Index* uniq, long long i,
                                       long long R) {
  // only the last position of a run of equal ids writes
  return i + 1 >= R || uniq[i + 1] != uniq[i];
}

__device__ __forceinline__ void adagrad(float& t, float& s, float g,
                                        float neg_lr, float eps) {
  const float s2 = __fadd_rn(s, __fmul_rn(g, g));
  const float u = __fdiv_rn(g, __fadd_rn(__fsqrt_rn(s2), eps));
  s = s2;
  t = __fadd_rn(t, __fmul_rn(neg_lr, u));
}

__device__ __forceinline__ void sgd(float& t, float g, float neg_lr) {
  t = __fadd_rn(t, __fmul_rn(neg_lr, g));
}

template <typename Index, bool VEC>
__global__ void __launch_bounds__(THREADS)
adagrad_rows(float* __restrict__ table, float* __restrict__ sum,
             const Index* __restrict__ uniq, const float* __restrict__ g,
             long long R, int D, float neg_lr, float eps) {
  const long long i = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= R || !writes(uniq, i, R)) return;
  const long long row = (long long)uniq[i] * D;
  float* t = table + row;
  float* s = sum + row;
  const float* gr = g + i * D;
  if (VEC) {
    float4* t4 = reinterpret_cast<float4*>(t);
    float4* s4 = reinterpret_cast<float4*>(s);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    for (int k = lane; k < D / 4; k += 32) {
      const float4 gv = g4[k];
      float4 sv = s4[k];
      float4 tv = t4[k];
      adagrad(tv.x, sv.x, gv.x, neg_lr, eps);
      adagrad(tv.y, sv.y, gv.y, neg_lr, eps);
      adagrad(tv.z, sv.z, gv.z, neg_lr, eps);
      adagrad(tv.w, sv.w, gv.w, neg_lr, eps);
      s4[k] = sv;
      t4[k] = tv;
    }
  } else {
    for (int k = lane; k < D; k += 32) {
      float sv = s[k], tv = t[k];
      adagrad(tv, sv, gr[k], neg_lr, eps);
      s[k] = sv;
      t[k] = tv;
    }
  }
}

template <typename Index, bool VEC>
__global__ void __launch_bounds__(THREADS)
sgd_rows(float* __restrict__ table, const Index* __restrict__ uniq,
         const float* __restrict__ g, long long R, int D, float neg_lr) {
  const long long i = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (i >= R || !writes(uniq, i, R)) return;
  float* t = table + (long long)uniq[i] * D;
  const float* gr = g + i * D;
  if (VEC) {
    float4* t4 = reinterpret_cast<float4*>(t);
    const float4* g4 = reinterpret_cast<const float4*>(gr);
    for (int k = lane; k < D / 4; k += 32) {
      const float4 gv = g4[k];
      float4 tv = t4[k];
      sgd(tv.x, gv.x, neg_lr);
      sgd(tv.y, gv.y, neg_lr);
      sgd(tv.z, gv.z, neg_lr);
      sgd(tv.w, gv.w, neg_lr);
      t4[k] = tv;
    }
  } else {
    for (int k = lane; k < D; k += 32) {
      float tv = t[k];
      sgd(tv, gr[k], neg_lr);
      t[k] = tv;
    }
  }
}

bool vectorizable(int D, const void* a, const void* b, const void* c) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         reinterpret_cast<uintptr_t>(c);
  return D % 4 == 0 && bits % 16 == 0;
}

unsigned blocks(long long R) { return (unsigned)((R + WARPS - 1) / WARPS); }

}  // namespace

extern "C" {

// In place on table [V, D] and sum [V, D] at the R rows uniq names; g is
// [R, D], uniq int32 (index_bytes 4) or int64 (8). All float32, contiguous.
// Returns cudaGetLastError() after the launch (0 on success).
int kge_adagrad_row_update(float* table, float* sum, const void* uniq,
                           const float* g, long long R, int D,
                           int index_bytes, float neg_lr, float eps,
                           void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vectorizable(D, table, sum, g);
  if (index_bytes == 8) {
    auto* u = static_cast<const long long*>(uniq);
    if (vec)
      adagrad_rows<long long, true><<<blocks(R), THREADS, 0, s>>>(
          table, sum, u, g, R, D, neg_lr, eps);
    else
      adagrad_rows<long long, false><<<blocks(R), THREADS, 0, s>>>(
          table, sum, u, g, R, D, neg_lr, eps);
  } else {
    auto* u = static_cast<const int*>(uniq);
    if (vec)
      adagrad_rows<int, true><<<blocks(R), THREADS, 0, s>>>(
          table, sum, u, g, R, D, neg_lr, eps);
    else
      adagrad_rows<int, false><<<blocks(R), THREADS, 0, s>>>(
          table, sum, u, g, R, D, neg_lr, eps);
  }
  return (int)cudaGetLastError();
}

// In place on table [V, D] at the R rows uniq names; arguments as above.
int kge_sgd_row_update(float* table, const void* uniq, const float* g,
                       long long R, int D, int index_bytes, float neg_lr,
                       void* stream) {
  if (R <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = vectorizable(D, table, table, g);
  if (index_bytes == 8) {
    auto* u = static_cast<const long long*>(uniq);
    if (vec)
      sgd_rows<long long, true><<<blocks(R), THREADS, 0, s>>>(
          table, u, g, R, D, neg_lr);
    else
      sgd_rows<long long, false><<<blocks(R), THREADS, 0, s>>>(
          table, u, g, R, D, neg_lr);
  } else {
    auto* u = static_cast<const int*>(uniq);
    if (vec)
      sgd_rows<int, true><<<blocks(R), THREADS, 0, s>>>(
          table, u, g, R, D, neg_lr);
    else
      sgd_rows<int, false><<<blocks(R), THREADS, 0, s>>>(
          table, u, g, R, D, neg_lr);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
