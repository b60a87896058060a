// Row-sparse Adagrad and SGD updates of embedding tables, in place, for
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
// Rows that uniq does not name are not written.
//
// Groups. One launch updates up to MAX_GROUPS tables (a training step's
// entity and relation tables), each a group (table, sum, uniq, g, R, D,
// index width, lr, eps) of its own, passed by value in one
// __grid_constant__ parameter struct. The positions of all groups are laid
// end to end; a warp finds its group from the prefix offsets in the struct.
//
// Learning rate. A group carries a pointer to its learning rate, a float32
// scalar on the device, which each warp reads and negates (-lr is exact, so
// the bits are those of the float32 -lr a host would pass). A training
// step read into a CUDA graph thus takes the rate the trainer writes into
// its buffer before each epoch, and no value of it is baked into the
// graph. eps stays by value.
//
// Duplicates. uniq is sorted; a run of equal ids carries its gradient only
// at its last position (the caller's contract: the batch payload remaps
// with searchsorted(side="right") - 1). A position whose successor in its
// own group holds the same id writes nothing, and the last position of the
// run computes from the row as it was before the update: the result of the
// reference's scatter-add, whose other positions add exactly zero. The
// successor is read from memory, so a run may cross warps and blocks. On
// the training path uniq holds distinct ids, so the rule never fires there.
//
// Rounding. Every operation is a rounded intrinsic (__fmul_rn, __fadd_rn,
// __fsqrt_rn, __fdiv_rn), so nvcc contracts nothing into an FMA, and the
// order is that of kge_tpu's default XLA form (optimizer.py
// sparse_row_update): the kernel gives the bits of the plain PyTorch
// version (ops/row_update.py), which runs the same separately rounded
// operations. Ids are not range-checked here; the host payload keeps them
// inside the table.
//
// What bounds it on an H100 SXM. Per touched row the update reads the
// gradient, the table row and for Adagrad the sum row, writes the table
// and sum rows back, and reads the id: 4*(5*R*D) + 8*R bytes for Adagrad,
// 4*(3*R*D) + 8*R for SGD, a few flops per element. At the Wikidata5M
// training step (entity R = 2,306 and relation R = 832, D = 128) that is
// 5.92 + 2.14 MB for Adagrad, 1.77 + 0.64 us at 3.35 TB/s: bytes bound it,
// and at microseconds of work so do latency and the launch.
//
// What held the first design back (one warp per position, 8 warps a
// block, one launch and one host call per table; NVIDIA H100 80GB HBM3 at
// 700 W): Adagrad took 3.9-4.0 us of device time a launch at the entity
// shape against its 1.77 us bound, SGD 2.1 us against 1.06 us; a
// training step paid two launches (5.6-5.7 us for Adagrad's two tables)
// and two wrapper calls of 33-52 us of host time each, more than torch's
// index_add_ for SGD. Each warp reads its id and its successor before it
// can address its rows: two round trips in series, which none of the
// schedules measured below avoided.
//
// This design:
// - one launch for every table of a step (the groups above): one launch
//   and one host call instead of two, and the relation table's 832 rows
//   run beside the entity table's 2,306 in the same wave;
// - one wave of blocks: the host sizes the grid from the SM count and the
//   kernel's resident blocks an SM (each read once), one warp a position;
//   past one wave a warp loops to the next position a grid's worth on;
// - lane 0 reads the position's id and lane 1 its successor in one load;
//   then the warp issues its gradient, table and sum row loads together;
// - float4 lanes where D % 4 == 0 and the rows are 16-byte aligned, one
//   element a lane otherwise (any D, any row alignment).
//
// What was measured against it (one call, the same card): an empty launch
// of this kernel takes 0.93-1.0 us of device time, so the id round trip,
// the row round trip, the 5.9 MB of traffic and the Adagrad arithmetic
// share about 3 us: latency, not bandwidth, bounds one table, and the old
// and the new schedule land within a few percent of each other there
// (3.9 and 4.1 us). What the grouping saves is the second launch (4.1 us
// for both tables against 5.6). Variants that measured slower: 2 or 4
// positions a warp, their ids in one coalesced load and all their row
// loads issued before the first store (more registers, fewer resident
// blocks: up to +0.9 us at this step, +1.6 us at a batch of 4,096),
// the gradient row issued before the ids arrive (+0.08 us for SGD, the
// same for Adagrad), ld.global.nc.L1::no_allocate for the gradient rows
// (+0.2 us), selecting the group by static indices (+0.15 us), 128-,
// 512- and 1024-thread blocks (up to +0.3 us); a parameter struct of 2
// groups instead of 4 changed nothing. Programmatic dependent launch was
// not tried: the host enqueues this kernel 13-35 us after it enqueued the
// kernel before it, longer than that kernel runs, so there is no tail to
// overlap on the training path or in a loop of wrapper calls.

#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int MAX_GROUPS = 4;
constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_DEVICES = 64;

struct Group {
  float* table;
  float* sum;         // Adagrad's accumulator; unused by SGD
  const void* uniq;   // int32 or int64 ids
  const float* g;
  long long R;
  long long first;  // the group's first position, all groups end to end
  int D;
  int wide_ids;  // 1: int64 ids, 0: int32
  int vec;       // 1: float4 lanes
  const float* lr;  // a float32 scalar on the device
  float eps;
};

struct Params {
  Group group[MAX_GROUPS];  // unused ones start at `positions`
  long long positions;      // of all groups; one warp each
};

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

__device__ __forceinline__ void update(float4& t, float4& s, float4 g,
                                       float neg_lr, float eps) {
  adagrad(t.x, s.x, g.x, neg_lr, eps);
  adagrad(t.y, s.y, g.y, neg_lr, eps);
  adagrad(t.z, s.z, g.z, neg_lr, eps);
  adagrad(t.w, s.w, g.w, neg_lr, eps);
}

__device__ __forceinline__ void update(float& t, float& s, float g,
                                       float neg_lr, float eps) {
  adagrad(t, s, g, neg_lr, eps);
}

__device__ __forceinline__ void update(float4& t, float4 g, float neg_lr) {
  sgd(t.x, g.x, neg_lr);
  sgd(t.y, g.y, neg_lr);
  sgd(t.z, g.z, neg_lr);
  sgd(t.w, g.w, neg_lr);
}

__device__ __forceinline__ void update(float& t, float g, float neg_lr) {
  sgd(t, g, neg_lr);
}

// Row `id` of group gr from the gradient row of position i. V is float4
// (W = 4 floats a lane) or float (W = 1).
template <bool ADAGRAD, typename V>
__device__ __forceinline__ void update_row(const Group& gr, long long i,
                                           long long id, int lane,
                                           float neg_lr) {
  constexpr int W = sizeof(V) / sizeof(float);
  const int cols = gr.D / W;  // D % W == 0 where W == 4
  const V* g = reinterpret_cast<const V*>(gr.g) + i * cols;
  V* table = reinterpret_cast<V*>(gr.table);
  V* sum = reinterpret_cast<V*>(gr.sum);
  for (int c = lane; c < cols; c += 32) {
    const long long k = id * cols + c;
    const V gv = g[c];
    V tv = table[k];
    if (ADAGRAD) {
      V sv = sum[k];
      update(tv, sv, gv, neg_lr, gr.eps);
      sum[k] = sv;
    } else {
      update(tv, gv, neg_lr);
    }
    table[k] = tv;
  }
}

// One warp a position; past one wave of blocks a warp takes the next
// position a grid's worth of warps on.
template <bool ADAGRAD>
__device__ __forceinline__ void update_rows(const Params& p) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * WARPS;
  for (long long at = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
       at < p.positions; at += stride) {
    int k = 0;
    while (k + 1 < MAX_GROUPS && at >= p.group[k + 1].first) ++k;
    const Group& gr = p.group[k];
    const long long i = at - gr.first;
    const float neg_lr = -*gr.lr;
    // lane 0 reads the position's id, lane 1 its successor in the group
    // (-1 past the group's end), in one load
    long long id = -1;
    if (lane < 2 && i + lane < gr.R) {
      id = gr.wide_ids
               ? static_cast<const long long*>(gr.uniq)[i + lane]
               : (long long)static_cast<const int*>(gr.uniq)[i + lane];
    }
    const long long here = __shfl_sync(0xffffffffu, id, 0);
    // only the last position of a run of equal ids writes
    if (__shfl_sync(0xffffffffu, id, 1) == here) continue;
    if (gr.vec)
      update_row<ADAGRAD, float4>(gr, i, here, lane, neg_lr);
    else
      update_row<ADAGRAD, float>(gr, i, here, lane, neg_lr);
  }
}

__global__ void __launch_bounds__(THREADS)
adagrad_rows(const __grid_constant__ Params p) {
  update_rows<true>(p);
}

__global__ void __launch_bounds__(THREADS)
sgd_rows(const __grid_constant__ Params p) {
  update_rows<false>(p);
}

// resident blocks an SM of each kernel, read once (its registers bound it)
int blocks_per_sm(bool adagrad) {
  static int counts[2];
  int& n = counts[adagrad];
  if (n == 0) {
    if (adagrad)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, adagrad_rows,
                                                    THREADS, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, sgd_rows, THREADS, 0);
    if (n < 1) n = 1;
  }
  return n;
}

// SMs of `device`, read once for each of the first MAX_DEVICES devices
int sm_count(int device) {
  static int counts[MAX_DEVICES];
  int n = device < MAX_DEVICES ? counts[device] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device);
    if (n < 1) n = 1;
    if (device < MAX_DEVICES) counts[device] = n;
  }
  return n;
}

}  // namespace

// One group as the host packs it (Python: struct "<8qf4x", 72 bytes).
struct HostGroup {
  long long table, sum, uniq, g;  // device pointers; sum unused by SGD
  long long lr;                   // device pointer to a float32 scalar
  long long R, D, index_bytes;    // index_bytes 4 (int32 ids) or 8
  float eps;
  float unused;
};

extern "C" {

// In place, in one launch, on the n <= MAX_GROUPS (4) tables of `groups`:
// table [V, D], sum [V, D] (Adagrad), uniq [R] and g [R, D], float32 and
// contiguous, and lr a float32 scalar, on CUDA device `device`, enqueued on
// `stream`. Returns
// cudaGetLastError() after the launch (0 on success;
// cudaErrorInvalidValue for more groups than the kernel takes); no launch
// when every R is 0.
int kge_row_update(int adagrad, int n, const HostGroup* groups, int device,
                   void* stream) {
  if (n < 0 || n > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  Params p = {};
  int used = 0;
  for (int k = 0; k < n; ++k) {
    const HostGroup& h = groups[k];
    if (h.R <= 0) continue;
    Group& gr = p.group[used++];
    gr.table = reinterpret_cast<float*>(h.table);
    gr.sum = reinterpret_cast<float*>(h.sum);
    gr.uniq = reinterpret_cast<const void*>(h.uniq);
    gr.g = reinterpret_cast<const float*>(h.g);
    gr.R = h.R;
    gr.D = (int)h.D;
    gr.wide_ids = h.index_bytes == 8;
    gr.lr = reinterpret_cast<const float*>(h.lr);
    gr.eps = h.eps;
    const unsigned long long bits = (unsigned long long)(h.table | h.g |
                                                         (adagrad ? h.sum : 0));
    gr.vec = h.D % 4 == 0 && bits % 16 == 0;
    gr.first = p.positions;
    p.positions += h.R;
  }
  if (p.positions == 0) return 0;
  for (int k = used; k < MAX_GROUPS; ++k) p.group[k].first = p.positions;
  int current = device;
  cudaGetDevice(&current);
  if (current != device) cudaSetDevice(device);
  // one wave of blocks at most; past it the warps loop over the positions
  const long long wave = (long long)sm_count(device) * blocks_per_sm(adagrad);
  const long long blocks = std::min((p.positions + WARPS - 1) / WARPS, wave);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (adagrad)
    adagrad_rows<<<(unsigned)blocks, THREADS, 0, s>>>(p);
  else
    sgd_rows<<<(unsigned)blocks, THREADS, 0, s>>>(p);
  const int err = (int)cudaGetLastError();
  if (current != device) cudaSetDevice(current);
  return err;
}

}  // extern "C"
