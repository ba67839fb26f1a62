// Maximum-weight bipartite matching on the card: the shortest-augmenting-path
// solver of the JAX package's default matcher, for Hopper (sm_90a).
//
// Replaces rec_attend_tpu/ops/hungarian.py:_hungarian_square/_hungarian_rect
// (:38-141), the lax.while_loop solver that JAX runs under vmap in every
// train and eval step (matcher='jax').  It is not a Pallas kernel; JAX left
// it to XLA.  The kernel gives JAX's bits, ties included: the same float32
// operations in the same order, the same tie-breaking, the same iteration
// caps.
//
// Per problem, w [n_x, n_y] is zero-padded to n x n, n = max(n_x, n_y),
// and the minimum-cost assignment of cost = -w is solved with a sentinel
// row and column 0 (arrays of n + 1).  For each row i = 1..n:
//   Dijkstra (at most n + 2 iterations while p[j0] != 0):
//     used[j0] = true; i0 = p[j0]
//     cur = (cost[i0] - u[i0]) - v                two float32 subtractions
//     upd = cur < minv && !used;  minv, way = upd ? (cur, j0) : (minv, way)
//     mm = used ? INF : minv, mm[0] = INF;  j1 = argmin(mm)   first index,
//                                                              NaN smallest
//     delta = mm[j1]
//     u[p[j]] += used[j] ? delta : 0   for every column j, in column order
//     v -= used ? delta : 0;  minv = used ? minv : minv - delta;  j0 = j1
//   augmentation (at most n + 2 steps while j0 != 0):
//     j1 = way[j0]; p[j0] = p[j1]; j0 = j1
// then matching[r, c] = (p[c + 1] - 1 == r), c_x = -u[1:], c_y = -v[1:],
// cropped to [n_x, n_y].  Every addition and subtraction is an __fadd_rn /
// __fsub_rn, which nvcc never contracts into a fused multiply-add.
//
// Bound on the H100: the data is tiny (a [64,21,21] solve reads 113 KB and
// writes 119 KB: 0.07 us at 3.35 TB/s) and so are its operations (at most
// n (n + 2) Dijkstra steps of about 8 float operations per column: under
// 3 MFLOP at [64,21,21], 0.04 us at 67 TFLOP/s).  What bounds it is the
// serial chain: each Dijkstra step depends on the argmin of the one before,
// and each augmentation step on the one before.  The longest problem of a
// step-shaped batch takes 209-231 Dijkstra steps, so the time is that count
// times the latency of one step.  The first version of this kernel spent
// about 1 us a step (0.21-0.24 ms a solve on an H100 80GB HBM3 at 700 W),
// most of it in a serial loop of two shuffles a column for u.at[p].add and
// in a ten-shuffle butterfly for the argmin.  This design takes 160-163 ns
// a step, fixed costs included (0.034-0.037 ms a solve at the step shapes,
// the same card): what is left is the chain of two __fsub_rn, the key,
// redux.sync, a ballot, two shuffles and the next row's shared load.
//
// Design: one block of one warp per problem; the problems of a batch run on
// separate SMs at once.  Lane l holds, in registers, the entries j = l,
// l + 32, ... (CPL of them, CPL = 1, 2, 4 or 8 >= (n + 1) / 32) of the
// column arrays v, minv, way and p and of the row array u (lane r holds
// u[r]); at n + 1 <= 32 (every model of the repository: T <= 21) lane j
// holds entry j alone.  used is a bit mask of CPL words, the same in every
// lane.  Shared memory holds the cost of columns 1..n (column 0 of JAX's
// cost is never read: column 0 is used from the first step on) and rows
// 0..n, row 0 zeros (JAX's row 0 is never a step's row, i0 = p[j0] >= 1,
// but the load ahead below reads it when the argmin names an unmatched
// column, so that it needs no guard), and the inverse map q as bytes; at
// most 231,360 + 241 bytes, so n <= 240.  A step:
//
//   * The cost row of the step is loaded during the step before, as soon
//     as that step's argmin names it: each lane keeps a pointer to its
//     column, so the address is one multiply-add on p[j1]; u[i0] comes
//     from one shuffle.
//   * The argmin is one warp reduction.  Each lane maps mm to an order-
//     preserving uint32 key: NaN to 0 (first, as in jnp.argmin), -0.0 and
//     +0.0 to one key, every other value by the sign-flip map (negative:
//     all bits flipped; otherwise the sign bit set), a slot past column n
//     to 0xFFFFFFFF, all without a branch (x + 0.0 turns -0.0 into +0.0,
//     an arithmetic shift gives the sign-flip mask, an OR marks an empty
//     slot).  __reduce_min_sync (redux.sync) gives the least key;
//     at CPL = 1 the first lane of __ballot_sync(key == least) is j1, at
//     CPL > 1 each lane offers its own first slot at the least key and a
//     second __reduce_min_sync takes the smallest.  The key order is
//     jnp.argmin's order, so j1 is its index; delta = mm[j1] comes by one
//     shuffle, with mm[j1]'s own bits (the key merges -0 and +0).
//   * u.at[p].add without shuffles.  p does not change during a Dijkstra
//     phase, so once a row (after p[0] = i) the inverse map q is built in
//     shared memory: q[p[j]] = j for every column j.  A row r >= 1 named
//     by one column q[r] receives exactly one addition in JAX's scatter,
//     used[q[r]] ? delta : +0.0, so lane r makes it alone:
//     u[r] = __fadd_rn(u[r], used(q[r]) ? delta : 0.0f), the +0.0 included
//     (it turns -0.0 into +0.0, as JAX's does); a row no column names
//     receives nothing.  Row 0 is named only by columns with p = 0, which
//     are never used (a column is used only while p[j0] != 0), so its
//     additions are all +0.0, and x + 0 + 0 has the bits of x + 0: one
//     addition is the same.  No row r >= 1 is named by two columns, in
//     which case JAX would add a sum in column order: p starts at zeros,
//     p[0] = i names the one row not yet matched, and the augmentation
//     shifts p along way, a chain of distinct columns, each used before
//     the next, back to column 0, shorter than the iteration cap, so each
//     row stays named once (tests/test_torch_hungarian.py's lane-level
//     model asserts it on every state of its sets).
//   * The augmentation walks way with two dependent shuffles a step, p in
//     registers; a walk by one lane over shared copies of p and way was
//     0.3-0.9 % faster (PERF.md), too little for its two arrays and two
//     barriers a row.
//
// The C entry point takes raw device pointers and a cudaStream_t, launches
// on that stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;        // JAX's _INF, as float32
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kEmpty = 0xffffffffu;  // the key of a slot past column n
constexpr int kNone = 255;           // q of a row that no column names
constexpr int kMaxSmemBytes = 232448;
constexpr int kFillRows = 8;         // rows of w in flight in the fill

// Dynamic shared memory of an n x n problem: the cost of rows 0..n and
// columns 1..n, then q as n + 1 bytes.
size_t smem_bytes(int n) {
  return (size_t)(n + 1) * n * sizeof(float) + (size_t)(n + 1);
}

// mm's place in jnp.argmin's order as an unsigned key: NaN first, -0 == +0.
__device__ __forceinline__ unsigned order_key(float x) {
  const unsigned b = __float_as_uint(__fadd_rn(x, 0.0f));  // -0.0 -> +0.0
  const unsigned k = b ^ ((unsigned)((int)b >> 31) | 0x80000000u);
  return isnan(x) ? 0u : k;
}

// a[c] for a slot number c, kept in registers.
template <int CPL, typename T>
__device__ __forceinline__ T pick(const T (&a)[CPL], int c) {
  T r = a[0];
#pragma unroll
  for (int k = 1; k < CPL; ++k)
    if (k == c) r = a[k];
  return r;
}

// Entry j of an array held as a[c] = entry lane + 32 c, in every lane.
template <int CPL, typename T>
__device__ __forceinline__ T entry(const T (&a)[CPL], int j) {
  return __shfl_sync(kFull, pick(a, j >> 5), j & 31);
}

// Entry j = value, in the lane that holds it.
template <int CPL, typename T>
__device__ __forceinline__ void set_entry(T (&a)[CPL], int j, T value,
                                          int lane) {
  if (lane != (j & 31)) return;
#pragma unroll
  for (int k = 0; k < CPL; ++k)
    if (k == (j >> 5)) a[k] = value;
}

// Bit j of a mask of CPL words.
template <int CPL>
__device__ __forceinline__ bool bit(const unsigned (&m)[CPL], int j) {
  return (pick(m, j >> 5) >> (j & 31)) & 1u;
}

template <int CPL>
__global__ void __launch_bounds__(32)
hungarian_kernel(const float* __restrict__ w, int n_x, int n_y,
                 float* __restrict__ match, float* __restrict__ c_x,
                 float* __restrict__ c_y) {
  extern __shared__ float cost[];  // [n + 1][n]: rows 0..n, columns 1..n
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n = n_x > n_y ? n_x : n_y;
  const int n1 = n + 1;
  unsigned char* q_sh = reinterpret_cast<unsigned char*>(cost + n1 * n);
  const float* wb = w + (size_t)b * n_x * n_y;
  // cost = -(w zero-padded), -0.0 in the padding: row by row, the lanes
  // on a row's columns, kFillRows rows of loads in flight; row 0 zeros.
  for (int r0 = 0; r0 < n; r0 += kFillRows)
    for (int c = lane; c < n; c += 32) {
      float x[kFillRows];
#pragma unroll
      for (int k = 0; k < kFillRows; ++k)
        x[k] = (r0 + k < n_x && c < n_y) ? wb[(r0 + k) * n_y + c] : 0.0f;
#pragma unroll
      for (int k = 0; k < kFillRows; ++k)
        if (r0 + k < n) cost[(r0 + k + 1) * n + c] = -x[k];
    }
  for (int c = lane; c < n; c += 32) cost[c] = 0.0f;
  __syncwarp();

  float u[CPL], v[CPL], minv[CPL], mm[CPL], crow[CPL];
  int p[CPL], way[CPL], q[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    u[c] = 0.0f;
    v[c] = 0.0f;
    p[c] = 0;
  }
  // Each lane's column of the cost: row r of slot c at col[c][r * n].
  const float* col[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    col[c] = cost + (j >= 1 && j < n1 ? j - 1 : 0);
  }
  const int max_iter = n + 2;
  for (int i = 1; i <= n; ++i) {
    if (lane == 0) p[0] = i;
    // q[r]: the column that names row r (kNone if none; any one of the
    // unused columns with p = 0 for row 0).
    for (int k = lane; k < n1; k += 32) q_sh[k] = kNone;
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (lane + 32 * c < n1) q_sh[p[c]] = (unsigned char)(lane + 32 * c);
    __syncwarp();
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      q[c] = lane + 32 * c < n1 ? q_sh[lane + 32 * c] : kNone;
      minv[c] = kInf;
      way[c] = 0;
    }

    unsigned used[CPL];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      used[c] = 0u;
      crow[c] = col[c][i * n];
    }
    int j0 = 0, i0 = i;
    for (int it = 0; it < max_iter && i0 != 0; ++it) {
      const float ui0 = entry(u, i0);
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (c == (j0 >> 5)) used[c] |= 1u << (j0 & 31);
      unsigned best = kEmpty;
      int best_j = 0;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        const bool uj = (used[c] >> lane) & 1u;
        if (j >= 1) {
          const float cur = __fsub_rn(__fsub_rn(crow[c], ui0), v[c]);
          if (cur < minv[c] && !uj) {
            minv[c] = cur;
            way[c] = j0;
          }
        }
        mm[c] = (uj || j == 0) ? kInf : minv[c];
        const unsigned key = order_key(mm[c]) | (j < n1 ? 0u : kEmpty);
        if (key < best) {
          best = key;
          best_j = j;
        }
      }
      const unsigned least = __reduce_min_sync(kFull, best);
      int j1;
      if (CPL == 1)
        j1 = __ffs(__ballot_sync(kFull, best == least)) - 1;
      else
        j1 = (int)__reduce_min_sync(kFull, best == least ? (unsigned)best_j
                                                          : kEmpty);
      const float delta = entry(mm, j1);
      const int i1 = entry(p, j1);
      // The next step's cost row, while u is updated.
#pragma unroll
      for (int c = 0; c < CPL; ++c) crow[c] = col[c][i1 * n];
      // u.at[p].add(where(used, delta, 0)): one addition into each row
      // that a column names.
#pragma unroll
      for (int c = 0; c < CPL; ++c)
        if (q[c] != kNone)
          u[c] = __fadd_rn(u[c], bit(used, q[c]) ? delta : 0.0f);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const bool uj = (used[c] >> lane) & 1u;
        v[c] = __fsub_rn(v[c], uj ? delta : 0.0f);
        if (!uj) minv[c] = __fsub_rn(minv[c], delta);
      }
      j0 = j1;
      i0 = i1;
    }
    for (int it = 0; it < max_iter && j0 != 0; ++it) {
      const int j1 = entry(way, j0);
      set_entry(p, j0, entry(p, j1), lane);
      j0 = j1;
    }
  }

  // matching[r, c] = (p[c + 1] - 1 == r), consecutive lanes on consecutive
  // columns: lane l takes p of column l + 32 t + 1 from lane l + 1, lane
  // 31 from lane 0's next slot; c_x = -u[1:], c_y = -v[1:].
  float* mb = match + (size_t)b * n_x * n_y;
  int pc[CPL];
#pragma unroll
  for (int t = 0; t < CPL; ++t) {
    const int next = __shfl_sync(kFull, lane == 0 ? pick(p, t + 1) : p[t],
                                 (lane + 1) & 31);
    pc[t] = lane + 32 * t < n_y ? next - 1 : -1;
  }
  for (int r = 0; r < n_x; ++r) {
#pragma unroll
    for (int t = 0; t < CPL; ++t)
      if (lane + 32 * t < n_y)
        mb[r * n_y + lane + 32 * t] = pc[t] == r ? 1.0f : 0.0f;
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    if (j >= 1 && j <= n_y) c_y[(size_t)b * n_y + (j - 1)] = -v[c];
    if (j >= 1 && j <= n_x) c_x[(size_t)b * n_x + (j - 1)] = -u[c];
  }
}

template <int CPL>
cudaError_t launch(const float* w, int B, int n_x, int n_y, float* match,
                   float* c_x, float* c_y, size_t smem, cudaStream_t s) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        hungarian_kernel<CPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  hungarian_kernel<CPL><<<B, 32, smem, s>>>(w, n_x, n_y, match, c_x, c_y);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest n = max(n_x, n_y) the kernel takes: its cost matrix and q
// fill the shared memory of a block.
int hungarian_max_n() {
  int n = 1;
  while (smem_bytes(n + 1) <= kMaxSmemBytes) ++n;
  return n;
}

// w [B][n_x][n_y] -> match [B][n_x][n_y], c_x [B][n_x], c_y [B][n_y], all
// float32 on the card.
int hungarian_solve_cuda(const float* w, int B, int n_x, int n_y,
                         float* match, float* c_x, float* c_y, void* stream) {
  const int n = n_x > n_y ? n_x : n_y;
  if (B <= 0 || n <= 0 || n > hungarian_max_n())
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n);
  const cudaStream_t s = (cudaStream_t)stream;
  const int cpl = (n + 1 + 31) / 32;
  if (cpl == 1)
    return (int)launch<1>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  if (cpl == 2)
    return (int)launch<2>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  if (cpl <= 4)
    return (int)launch<4>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  return (int)launch<8>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
}

const char* hungarian_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
