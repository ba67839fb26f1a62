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
// a warp reduction of five shuffle rounds, and each augmentation step on
// the one before.  So it is bound by latency, not by bytes or operations.
//
// Design: one block of one warp per problem; the problems of a batch run on
// separate SMs at once.  Lane l holds, in registers, the entries j = l,
// l + 32, ... (CPL of them, CPL = ceil((n + 1) / 32)) of u, v, minv, used,
// way and p; at n + 1 <= 32 (every model of the repository: T <= 21) lane j
// holds entry j alone.  A value held by one lane reaches the others by
// __shfl_sync; the argmin is a butterfly of __shfl_xor_sync rounds over
// (value, index) pairs in argmin's total order, so every lane ends with the
// same (j1, delta).  The (n + 1)^2 cost matrix lies in shared memory (at
// most 232,448 bytes, so n + 1 <= 241).
//
// The C entry point takes raw device pointers and a cudaStream_t, launches
// on that stream, does not synchronise, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <climits>

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;      // JAX's _INF, as float32
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmemBytes = 232448;

// (a, ia) before (b, ib) in jnp.argmin's order: NaN below every number, then
// the smaller value (-0 == +0), then the smaller index; an index of INT_MAX
// marks an empty slot, after everything.
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (ia == INT_MAX) return false;
  if (ib == INT_MAX) return true;
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (!na && a != b) return a < b;
  return ia < ib;
}

// a[c] for a slot number c the same in every lane, kept in registers.
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

template <int CPL>
__global__ void __launch_bounds__(32)
hungarian_kernel(const float* __restrict__ w, int n_x, int n_y,
                 float* __restrict__ match, float* __restrict__ c_x,
                 float* __restrict__ c_y) {
  extern __shared__ float cost[];  // [n + 1][n + 1]
  const int lane = threadIdx.x;
  const int b = blockIdx.x;
  const int n = n_x > n_y ? n_x : n_y;
  const int n1 = n + 1;
  const float* wb = w + (size_t)b * n_x * n_y;
  // cost = zeros, then cost[1:, 1:] = -(w zero-padded): -0.0 in the padding.
  for (int k = lane; k < n1 * n1; k += 32) {
    const int i = k / n1, j = k - i * n1;
    float c = 0.0f;
    if (i > 0 && j > 0)
      c = -((i <= n_x && j <= n_y) ? wb[(i - 1) * n_y + (j - 1)] : 0.0f);
    cost[k] = c;
  }
  __syncwarp();

  float u[CPL], v[CPL], minv[CPL];
  int p[CPL], way[CPL], used[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    u[c] = 0.0f;
    v[c] = 0.0f;
    p[c] = 0;
  }
  const int max_iter = n + 2;
  for (int i = 1; i <= n; ++i) {
    set_entry(p, 0, i, lane);
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      minv[c] = kInf;
      used[c] = 0;
      way[c] = 0;
    }
    int j0 = 0;
    for (int it = 0; it < max_iter; ++it) {
      const int i0 = entry(p, j0);
      if (i0 == 0) break;
      set_entry(used, j0, 1, lane);
      const float ui0 = entry(u, i0);
      const float* row = cost + i0 * n1;
      float best = 0.0f;
      int best_j = INT_MAX;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int j = lane + 32 * c;
        if (j >= n1) continue;
        const float cur = __fsub_rn(__fsub_rn(row[j], ui0), v[c]);
        if (cur < minv[c] && !used[c]) {
          minv[c] = cur;
          way[c] = j0;
        }
        const float mm = (used[c] || j == 0) ? kInf : minv[c];
        if (before(mm, j, best, best_j)) {
          best = mm;
          best_j = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, best_j, off);
        if (before(o, oj, best, best_j)) {
          best = o;
          best_j = oj;
        }
      }
      const float delta = best;
      // u.at[p].add(where(used, delta, 0)): one addition per column, in
      // column order, into the entry of u that the column's p names.
      for (int j = 0; j < n1; ++j) {
        const int pj = entry(p, j);
        const float add = entry(used, j) ? delta : 0.0f;
        if (lane == (pj & 31)) {
#pragma unroll
          for (int k = 0; k < CPL; ++k)
            if (k == (pj >> 5)) u[k] = __fadd_rn(u[k], add);
        }
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        v[c] = __fsub_rn(v[c], used[c] ? delta : 0.0f);
        if (!used[c]) minv[c] = __fsub_rn(minv[c], delta);
      }
      j0 = best_j;
    }
    for (int it = 0; it < max_iter && j0 != 0; ++it) {
      const int j1 = entry(way, j0);
      set_entry(p, j0, entry(p, j1), lane);
      j0 = j1;
    }
  }

  // matching[r, c] = (p[c + 1] - 1 == r); c_x = -u[1:], c_y = -v[1:].
  float* mb = match + (size_t)b * n_x * n_y;
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    if (j >= 1 && j <= n_y) {
      const int row = p[c] - 1;
      for (int r = 0; r < n_x; ++r)
        mb[r * n_y + (j - 1)] = r == row ? 1.0f : 0.0f;
      c_y[(size_t)b * n_y + (j - 1)] = -v[c];
    }
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

// The largest n = max(n_x, n_y) the kernel takes: its cost matrix fills the
// shared memory of a block.
int hungarian_max_n() {
  int n1 = 1;
  while ((size_t)(n1 + 1) * (n1 + 1) * sizeof(float) <= kMaxSmemBytes) ++n1;
  return n1 - 1;
}

// w [B][n_x][n_y] -> match [B][n_x][n_y], c_x [B][n_x], c_y [B][n_y], all
// float32 on the card.
int hungarian_solve_cuda(const float* w, int B, int n_x, int n_y,
                         float* match, float* c_x, float* c_y, void* stream) {
  const int n = n_x > n_y ? n_x : n_y;
  if (B <= 0 || n <= 0 || n > hungarian_max_n())
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)(n + 1) * (n + 1) * sizeof(float);
  const cudaStream_t s = (cudaStream_t)stream;
  const int cpl = (n + 1 + 31) / 32;
  if (cpl == 1) return (int)launch<1>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  if (cpl == 2) return (int)launch<2>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  if (cpl <= 4) return (int)launch<4>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
  return (int)launch<8>(w, B, n_x, n_y, match, c_x, c_y, smem, s);
}

const char* hungarian_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
