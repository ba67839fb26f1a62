// Glimpse extract and mask paste: the two separable Gaussian-filter
// contractions of the recurrent-attention model, for Hopper (sm_90a).
//
// Both kernels take their tensors channels-last, as the model holds them:
//   extract  out[b,f,g,d] = sum_h sum_w f_y[b,h,f] * x[b,h,w,d] * f_x[b,w,g]
//            x [B,H,W,D], f_y [B,H,FH], f_x [B,W,FW] -> out [B,FH,FW,D]
//   paste    out[b,h,w,d] = sum_f sum_g f_y[b,h,f] * p[b,f,g,d] * f_x[b,w,g]
//            p [B,FH,FW,D], f_y [B,H,FH], f_x [B,W,FW] -> out [B,H,W,D]
// (extract's tiled route writes its out as [B,FH,D,FW] in memory instead).
// All arithmetic is float32 on the CUDA cores with float32 accumulation,
// as the TPU kernels accumulate in float32.
//
// The C entry points take raw device pointers and a cudaStream_t, launch on
// that stream, do not synchronise, allocate nothing, and return
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// glimpse_extract, general route: extract_kernel_general
//
// Replaces rec_attend_tpu/ops/pallas/glimpse.py:_extract_call/_extract_kernel
// at every shape that extract_tiled_kernel (below) does not take: see
// extract_route for the rule.
// The TPU kernel reads x channels-major, so every call brackets it with
// full-tensor [B,H,W,D] <-> [B,D,H,W] transposes in device memory; this
// kernel reads x channels-last where it lies, and needs no transpose.
//
// Bound on the H100: at the main path's shapes (b128, 224x224, D=4, 48x48)
// the call reads x (102.8 MB) and both filter banks and writes the patch,
// about 118 MB, which is 35 us at 3.35 TB/s; the separable contraction is
// 3.0 GFLOP, which is 45 us at 67 TFLOP/s of float32 on the CUDA cores.
// So it is bound by operations, at about 45 us.
//
// Design: one block per (image, tile of kExFT output rows f).  A loop inside
// the block walks x in strips of WS columns w (all D channels of a strip are
// contiguous, kExCols floats), which takes the place of the TPU's sequential
// grid dimension, so no sum crosses blocks:
//   stage 1  tmp[f, w*D+d] = sum_h f_y[h,f] * x[h,w,d], x staged in shared
//            memory kExHC rows at a time, each thread keeping kExRowsPerThread
//            sums of one column in registers; the next chunk is loaded into
//            registers while the current one is summed;
//   stage 2  acc[f,g,d] += sum_w tmp[f, w*D+d] * f_x[w,g], acc in shared
//            memory, each element owned by one thread.
// Ragged edges (H, W, FH not multiples of the tiles, any D <= kExCols) are
// masked with zero fill.  The [FH, W, D] intermediate never reaches device
// memory, and x of one image is read once per row tile (FH/16 = 3 times at
// FH=48, neighbouring blocks, so mostly from L2).
// ---------------------------------------------------------------------------

constexpr int kExFT = 16;
constexpr int kExCols = 128;
constexpr int kExHC = 32;
constexpr int kExRowsPerThread = kExFT / (kThreads / kExCols);
constexpr int kExXLoads = kExHC * kExCols / kThreads;   // per thread, chunk
constexpr int kExFyLoads = kExHC * kExFT / kThreads;
static_assert(kExRowsPerThread == 8, "stage 1 reads its f_y rows as 2 float4");
static_assert(kExXLoads * kThreads == kExHC * kExCols, "x chunk split");
static_assert(kExFyLoads * kThreads == kExHC * kExFT, "f_y chunk split");

size_t extract_smem_floats(int D, int FW, int WS) {
  return (size_t)kExHC * kExCols + (size_t)kExHC * kExFT +
         (size_t)kExFT * kExCols + (size_t)WS * FW + (size_t)kExFT * FW * D;
}

__global__ void __launch_bounds__(kThreads, 2)
extract_kernel_general(const float* __restrict__ x,
                       const float* __restrict__ fy,
                       const float* __restrict__ fx, float* __restrict__ out,
                       int H, int W, int D, int FH, int FW, int WS) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [kExHC][kExCols]
  float* fys = xs + kExHC * kExCols;       // [kExHC][kExFT]
  float* tmp = fys + kExHC * kExFT;        // [kExFT][kExCols]
  float* fxs = tmp + kExFT * kExCols;      // [WS][FW]
  float* acc = fxs + WS * FW;              // [kExFT][FW][D]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kExFT;
  const int tid = threadIdx.x;
  const int col = tid % kExCols;
  const int frow = (tid / kExCols) * kExRowsPerThread;
  const int gd = FW * D;
  const int nacc = kExFT * gd;
  const float* xb = x + (size_t)b * H * W * D;
  const float* fyb = fy + (size_t)b * H * FH;
  const float* fxb = fx + (size_t)b * W * FW;

  // The next chunk of x and f_y is loaded into registers while the current
  // one is summed, so the loads' latency hides behind the arithmetic.
  float xr[kExXLoads], fyr[kExFyLoads];
  // Thread tid loads rows 2k + tid/kExCols (k < kExXLoads) of column col.
  const int row_stride = W * D;
  const int xrow = tid / kExCols;
  auto fetch = [&](int w0, int h0) {
    const int cols = min(WS, W - w0) * D;
    const int hn = min(kExHC, H - h0);
    const float* src = xb + ((size_t)(h0 + xrow) * W + w0) * D + col;
#pragma unroll
    for (int k = 0; k < kExXLoads; ++k) {
      const int hh = xrow + k * (kThreads / kExCols);
      xr[k] = (hh < hn && col < cols)
                  ? __ldg(src + (size_t)k * (kThreads / kExCols) * row_stride)
                  : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kExFyLoads; ++k) {
      const int i = tid + k * kThreads;
      const int hh = i / kExFT, f = i % kExFT;
      fyr[k] = (hh < hn && f0 + f < FH)
                   ? __ldg(fyb + (size_t)(h0 + hh) * FH + f0 + f) : 0.f;
    }
  };

  for (int i = tid; i < nacc; i += kThreads) acc[i] = 0.f;
  fetch(0, 0);

  for (int w0 = 0; w0 < W; w0 += WS) {
    const int wn = min(WS, W - w0);
#pragma unroll 4
    for (int i = tid; i < WS * FW; i += kThreads) {
      fxs[i] = (i < wn * FW) ? __ldg(fxb + (size_t)w0 * FW + i) : 0.f;
    }
    float r[kExRowsPerThread];
#pragma unroll
    for (int i = 0; i < kExRowsPerThread; ++i) r[i] = 0.f;

    for (int h0 = 0; h0 < H; h0 += kExHC) {
      const int hn = min(kExHC, H - h0);
#pragma unroll
      for (int k = 0; k < kExXLoads; ++k) xs[tid + k * kThreads] = xr[k];
#pragma unroll
      for (int k = 0; k < kExFyLoads; ++k) fys[tid + k * kThreads] = fyr[k];
      __syncthreads();
      if (h0 + kExHC < H) {
        fetch(w0, h0 + kExHC);
      } else if (w0 + WS < W) {
        fetch(w0 + WS, 0);
      }
#pragma unroll 8
      for (int hh = 0; hh < hn; ++hh) {
        const float xv = xs[hh * kExCols + col];
        const float4* fr =
            reinterpret_cast<const float4*>(fys + hh * kExFT + frow);
        const float4 a = fr[0], c = fr[1];
        r[0] += a.x * xv; r[1] += a.y * xv; r[2] += a.z * xv;
        r[3] += a.w * xv; r[4] += c.x * xv; r[5] += c.y * xv;
        r[6] += c.z * xv; r[7] += c.w * xv;
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kExRowsPerThread; ++i)
      tmp[(frow + i) * kExCols + col] = r[i];
    __syncthreads();

    for (int i = tid; i < nacc; i += kThreads) {
      const int f = i / gd, rem = i - f * gd;
      const int g = rem / D, d = rem - g * D;
      const float* t = tmp + f * kExCols + d;
      float s = 0.f;
#pragma unroll 4
      for (int w = 0; w < wn; ++w) s += t[w * D] * fxs[w * FW + g];
      acc[i] += s;
    }
    __syncthreads();
  }

  const int fn = min(kExFT, FH - f0);
  float* ob = out + ((size_t)b * FH + f0) * gd;
  for (int i = tid; i < fn * gd; i += kThreads) ob[i] = acc[i];
}

// ---------------------------------------------------------------------------
// glimpse_paste
//
// Replaces rec_attend_tpu/ops/pallas/glimpse.py:_paste_call/_paste_kernel,
// which also brackets the call with channels-major transposes; this kernel
// writes the channels-last output directly.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores): at
// the main path's shapes (b128, 48x48 patch, D=1, 224x224 output) the call
// writes 25.7 MB and reads 12.2 MB (patch and filter banks), 37.9 MB, 11.3
// us; the separable contraction is 0.75 GFLOP (stage 1 0.13, stage 2
// 0.62), 11.2 us.  Both limits meet near 11 us, so the design has to keep
// the FMA pipes fed from shared memory and the stores streaming.
//
// Design: the blocks run in one wave, two to an SM.  A block owns one
// image, RT row tiles of BM = NTY*TM rows and Wt output columns (at every
// shape of the repo's configs the whole row, so no stage-1 work is
// repeated across blocks).
//   staging  cp.async copies, no transposing stores: the block's f_x rows
//            [Wt][FW] as global memory holds them, once for all its row
//            tiles, each row's 16-byte chunks XOR-swizzled so that stage 2's
//            float4 reads hit 8 bank groups; f_y rows and, per channel
//            chunk, p.  f_x (the largest) is a group of its own that lands
//            while stage 1 runs; the next group's f_y lands during stage 2.
//   stage 1  tmp[h, g, dd] = sum_f f_y[h,f] * p[f,g,d0+dd] for GT row tiles
//            at once (all RT where two blocks still fit in an SM's shared
//            memory), DC channels at a time (DC = 4 where D is a multiple
//            of 4, else 1); an item is 4 rows x 4 columns in registers.
//   stage 2  out[h, w, d0+dd] = sum_g tmp[h,g,dd] * f_x[w,g]: an
//            outer-product SGEMM per channel.  A warp is 4 x 8 threads,
//            each with TM rows x 4 columns x DC channels in registers; per
//            4 taps g a thread reads TM (DC=1) or 4*TM (DC=4) float4 of tmp
//            (4 addresses a warp) and 4 float4 of f_x (8 addresses a warp),
//            for 16*TM*DC FMAs: 10.2 FMAs a load at TM=7, DC=1.
//   store    16-byte stores: D=1 with W a multiple of 4 writes 4 columns as
//            one float4, D a multiple of 4 writes 4 channels as one float4,
//            neighbouring threads on neighbouring addresses; other shapes
//            store scalars.
// Sums run over f, then over g, each ascending, as the plain version's
// two einsums associate them; padded taps add exact zeros.  No split over
// f or g, no atomics.
// The host picks TM = 7 or 2 at DC=1 (TM = 1 at DC=4), the one whose
// busiest block has the fewest rows once the tiles are spread over one
// wave: b128 D=1 takes TM=7, 2 blocks an image of 4 tiles of 28 rows (256
// blocks); b8 takes TM=2, 224 blocks of 8 rows; b32 D=4 TM=1, 256 blocks.
// TM=7 fits 224 rows (8 tiles of 28), TM=2 gives the most blocks; no shape
// of the repo's configs needs another instance.  It splits
// a row into column tiles only where the staged f_x would not fit in shared
// memory (no shape of the repo's configs).  Stage 1 costs FH/Wt of stage
// 2's operations per column tile at any D (0.21 at a whole 224-column row,
// FH=48), so each extra tile would add that much again, at D=1 and D=4.
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): registers a thread 109 and
// 105 at TM = 7, 2 (DC=1), 107 at TM = 1 (DC=4); no spills, no static
// shared memory.
// ---------------------------------------------------------------------------

constexpr int kPaMaxNTX = 64;   // column quads a pass (stage 2 threads in x)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared-memory geometry of one paste block, in floats.  Every region and
// row is a multiple of 4 floats, so float4 accesses stay aligned.
struct PasteGeom {
  int Cg;    // 16-byte tap chunks of a row: ceil(FW/4)
  int RS;    // f_x row stride: Cg rounded up to 8 chunks (the swizzle)
  int FHr;   // f_y row stride and p rows: FH rounded up to 4
  int BMr;   // stage-1 rows, rounded up to 4 (stage 1 takes 4 at a time)
  int PS;    // p row stride: 4*Cg*DC
  int TS;    // tmp row stride: PS padded to an odd number of chunks, so
             // that 4 neighbouring rows lie in 4 bank groups
  __host__ __device__ PasteGeom(int FH, int FW, int BM, int DC) {
    Cg = (FW + 3) / 4;
    RS = 4 * ((Cg + 7) / 8 * 8);
    FHr = (FH + 3) / 4 * 4;
    BMr = (BM + 3) / 4 * 4;
    PS = 4 * Cg * DC;
    TS = PS + ((PS / 4) % 2 ? 8 : 4);
  }
  __host__ __device__ size_t floats(int Wt) const {
    return (size_t)Wt * RS + (size_t)BMr * FHr + (size_t)FHr * PS +
           (size_t)BMr * TS;
  }
};

// Which 16-byte chunk column row r of the staged f_x XORs its chunks with.
// Thread t of a pass reads 4 rows: with quad, rows 4t..4t+3 (4 neighbouring
// output columns, one float4 store at D=1), else rows t, t+NTX, t+2NTX,
// t+3NTX (neighbouring threads on neighbouring columns: coalesced stores at
// any D).  NTX is a multiple of 8, so all 4 rows XOR with t mod 8, and the 8
// threads of a warp that read distinct rows read 8 different bank groups.
__device__ __forceinline__ int paste_swizzle(int r, bool quad) {
  return quad ? (r >> 2) & 7 : r & 7;
}

__device__ __forceinline__ void zero4(float* dst) {
  *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Calls f(r, c) for every (row, column) of a rows x cols grid that thread
// tid owns, row-major, kThreads apart, with one division in all.
template <class F>
__device__ __forceinline__ void for_each_cell(int rows, int cols, int tid,
                                              F f) {
  int r = tid / cols, c = tid - r * cols;
  const int dr = kThreads / cols, dc = kThreads - dr * cols;
  while (r < rows) {
    f(r, c);
    r += dr;
    c += dc;
    if (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// Copies p[f, g, d0 .. d0+DC) of one image into ps[f][g*DC + dd], zero
// beyond FH and FW.
template <int DC>
__device__ __forceinline__ void paste_stage_p(
    float* ps, const float* pb, int d0, int D, int FH, int FW,
    const PasteGeom& G, bool vec, int tid) {
  for_each_cell(G.FHr, G.PS / 4, tid, [&](int f, int c) {
    float* dst = ps + f * G.PS + 4 * c;
    if constexpr (DC == 4) {   // one chunk is the 4 channels of tap g = c
      if (f < FH && c < FW) {
        cp_async16(dst, pb + ((size_t)f * FW + c) * D + d0);
      } else {
        zero4(dst);
      }
    } else if (f >= FH) {
      zero4(dst);
    } else if (vec && D == 1 && (FW & 3) == 0) {
      cp_async16(dst, pb + (size_t)f * FW + 4 * c);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int g = 4 * c + e;
        if (g < FW) {
          cp_async4(dst + e, pb + ((size_t)f * FW + g) * D + d0);
        } else {
          dst[e] = 0.f;
        }
      }
    }
  });
}

// Copies f_y rows h0 .. h0+BM of one image into fys[r][f], zero beyond H,
// BM and FH.
__device__ __forceinline__ void paste_stage_fy(
    float* fys, const float* fyb, int h0, int BM, int H, int FH,
    const PasteGeom& G, bool vec, int tid) {
  for_each_cell(G.BMr, G.FHr / 4, tid, [&](int r, int c) {
    const int h = h0 + r;
    float* dst = fys + r * G.FHr + 4 * c;
    const float* src = fyb + (size_t)h * FH + 4 * c;
    if (r >= BM || h >= H) {
      zero4(dst);
    } else if (vec && (FH & 3) == 0) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e < FH) cp_async4(dst + e, src + e); else dst[e] = 0.f;
      }
    }
  });
}

template <int TM, int DC>
__global__ void __launch_bounds__(kThreads, 2)
paste_kernel(const float* __restrict__ p, const float* __restrict__ fy,
             const float* __restrict__ fx, float* __restrict__ out,
             int H, int W, int D, int FH, int FW, int NTX, int NTY, int Wt,
             int RT, int GT, bool vec, bool quad) {
  extern __shared__ __align__(16) float smem[];
  const int BM = NTY * TM;
  // Stage 1 runs for a group of GT row tiles at once (GT*BM rows).
  const PasteGeom G(FH, FW, GT * BM, DC);
  float* fxs = smem;                       // [Wt][RS], swizzled chunks
  float* fys = fxs + (size_t)Wt * G.RS;    // [BMr][FHr]
  float* ps = fys + G.BMr * G.FHr;         // [FHr][PS]
  float* tmp = ps + G.FHr * G.PS;          // [BMr][TS]

  const int b = blockIdx.z;
  const int wb = blockIdx.x * Wt;
  // The block's row tiles: RT tiles of BM rows from t0, within H.
  const int t0 = blockIdx.y * RT;
  const int t1 = min(t0 + RT, (H + BM - 1) / BM);
  const int tid = threadIdx.x;
  const float* pb = p + (size_t)b * FH * FW * D;
  const float* fyb = fy + (size_t)b * H * FH;
  const float* fxb = fx + (size_t)b * W * FW;

  // Group 1: the first tile group's f_y rows and the first channel chunk
  // of p.
  paste_stage_fy(fys, fyb, t0 * BM, GT * BM, H, FH, G, vec, tid);
  paste_stage_p<DC>(ps, pb, 0, D, FH, FW, G, vec, tid);
  cp_async_commit();
  // Group 2: the f_x rows of the tile's columns, once for all row tiles;
  // chunk c of row r at chunk c ^ paste_swizzle(r).  Chunks past Cg are
  // never read.
  for_each_cell(Wt, G.Cg, tid, [&](int r, int c) {
    const int w = wb + r;
    float* dst = fxs + r * G.RS + 4 * (c ^ paste_swizzle(r, quad));
    const float* src = fxb + (size_t)w * FW + 4 * c;
    if (w >= W) {
      zero4(dst);
    } else if (vec && (FW & 3) == 0) {
      cp_async16(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * c + e < FW) cp_async4(dst + e, src + e); else dst[e] = 0.f;
      }
    }
  });
  cp_async_commit();

  // Stage-2 threads: warp (wx, wy) of NTX/8 x 8/(NTX/8), lane (lane%8,
  // lane/8) within it; thread rows wy*4*TM + 4*i + lane/8 (i < TM), so the
  // 4 rows a tmp read serves are neighbours.
  const int warp = tid >> 5, lane = tid & 31;
  const int wx = warp % (NTX / 8), wy = warp / (NTX / 8);
  const int tx = wx * 8 + (lane & 7);
  const int row0 = wy * 4 * TM + (lane >> 3);
  const int sw = lane & 7;   // paste_swizzle of every row the thread reads
  const int rstep = quad ? 1 : NTX;
  const int passes = Wt / (4 * NTX);
  bool first = true;
  for (int tg = t0; tg < t1; tg += GT) {
    const int tn = min(GT, t1 - tg);   // tiles in this group
    for (int d0 = 0; d0 < D; d0 += DC) {
      if (first) cp_async_wait<1>(); else cp_async_wait<0>();
      __syncthreads();

      // Stage 1: 4 rows x 4 columns an item, f ascending; per 4 taps f it
      // reads 4 float4 of f_y and 4 of p for 64 FMAs.
      for_each_cell(G.BMr / 4, G.PS / 4, tid, [&](int rq, int c4) {
        const int c = 4 * c4;
        const float* y = fys + 4 * rq * G.FHr;
        float s[4][4] = {};
#pragma unroll 2
        for (int f0 = 0; f0 < G.FHr; f0 += 4) {
          float a[4][4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float4 v =
                *reinterpret_cast<const float4*>(y + r * G.FHr + f0);
            a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float4 v =
                *reinterpret_cast<const float4*>(ps + (f0 + k) * G.PS + c);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              s[r][0] += a[r][k] * v.x; s[r][1] += a[r][k] * v.y;
              s[r][2] += a[r][k] * v.z; s[r][3] += a[r][k] * v.w;
            }
          }
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          *reinterpret_cast<float4*>(tmp + (4 * rq + r) * G.TS + c) =
              make_float4(s[r][0], s[r][1], s[r][2], s[r][3]);
        }
      });
      __syncthreads();
      // f_y and p are free: what the next stage 1 reads lands during
      // stage 2 (the next channel chunk, else the next group's rows).
      bool more = true;
      if (d0 + DC < D) {
        paste_stage_p<DC>(ps, pb, d0 + DC, D, FH, FW, G, vec, tid);
      } else if (tg + GT < t1) {
        paste_stage_fy(fys, fyb, (tg + GT) * BM, GT * BM, H, FH, G, vec,
                       tid);
        if (D > DC) paste_stage_p<DC>(ps, pb, 0, D, FH, FW, G, vec, tid);
      } else {
        more = false;
      }
      if (more) cp_async_commit();
      if (first) {
        if (more) cp_async_wait<1>(); else cp_async_wait<0>();
        __syncthreads();
        first = false;
      }

      // Stage 2: TM rows x 4 columns x DC channels a thread, g ascending.
      // A warp is 4 thread rows x 8 thread columns, so a float4 read of tmp
      // serves 4 addresses and one of f_x 8 (one bank wavefront each).
      if (wy < NTY / 4) {
        for (int tp = 0; tp < tn * passes; ++tp) {
          const int tile = tp / passes, pass = tp - tile * passes;
          const int h0 = (tg + tile) * BM;
          const float* trow = tmp + (tile * BM + row0) * G.TS;
          // The thread's f_x rows (output columns) r0 + j * rstep.
          const int r0 = pass * 4 * NTX + (quad ? 4 * tx : tx);
          const float* frow = fxs + r0 * G.RS;
          float acc[TM][4][DC];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int dd = 0; dd < DC; ++dd) acc[i][j][dd] = 0.f;
          // Two tap chunks in flight where the registers allow (TM <= 4).
#pragma unroll(TM <= 4 ? 2 : 1)
          for (int c = 0; c < G.Cg; ++c) {
            const int cs = 4 * (c ^ sw);
            float bv[4][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float4 v = *reinterpret_cast<const float4*>(
                  frow + j * rstep * G.RS + cs);
              bv[j][0] = v.x; bv[j][1] = v.y; bv[j][2] = v.z; bv[j][3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i) {
              if constexpr (DC == 1) {
                const float4 a = *reinterpret_cast<const float4*>(
                    trow + 4 * i * G.TS + 4 * c);
                const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                for (int k = 0; k < 4; ++k)
#pragma unroll
                  for (int j = 0; j < 4; ++j) acc[i][j][0] += av[k] * bv[j][k];
              } else {
#pragma unroll
                for (int k = 0; k < 4; ++k) {
                  const float4 a = *reinterpret_cast<const float4*>(
                      trow + 4 * i * G.TS + (4 * c + k) * DC);
                  const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
                  for (int j = 0; j < 4; ++j)
#pragma unroll
                    for (int dd = 0; dd < DC; ++dd)
                      acc[i][j][dd] += av[dd] * bv[j][k];
                }
              }
            }
          }
#pragma unroll
          for (int i = 0; i < TM; ++i) {
            const int h = h0 + row0 + 4 * i;
            if (h >= H) continue;
            float* orow = out + ((size_t)b * H + h) * W * D;
            if (quad) {
              if (wb + r0 < W) {
                *reinterpret_cast<float4*>(orow + wb + r0) =
                    make_float4(acc[i][0][0], acc[i][1][0], acc[i][2][0],
                                acc[i][3][0]);
              }
              continue;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int w = wb + r0 + j * rstep;
              if (w >= W) continue;
              if constexpr (DC == 4) {
                *reinterpret_cast<float4*>(orow + (size_t)w * D + d0) =
                    make_float4(acc[i][j][0], acc[i][j][1], acc[i][j][2],
                                acc[i][j][3]);
              } else {
                orow[(size_t)w * D + d0] = acc[i][j][0];
              }
            }
          }
        }
      }
    }
  }
}

// Dynamic shared memory above 48 KB must be asked for per kernel.
cudaError_t allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

constexpr size_t kMaxSmemBytes = 227 * 1024;

// The paste launch that the host settles on: TM rows a thread, DC channels
// a pass, NTX x NTY stage-2 threads, Wt columns a block, CT column tiles.
struct PastePlan {
  int TM = 0, DC = 1, NTX = 1, NTY = 1, Wt = 0, CT = 1, RT = 1, GT = 1;
  size_t smem = 0;
};

int multiprocessors() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                               dev) != cudaSuccess)
      count = 132;
  }
  return count;
}

// The blocks run in one wave, two to an SM: a block takes RT row tiles of
// BM = NTY*TM rows (staging f_x once for them all), with RT as even across
// an image's tiles as the wave allows, and runs stage 1 for GT of them at
// a time (all RT where two blocks still fit in an SM's shared memory).
// Among the TM that fit, the one whose busiest block has the fewest rows
// (RT*BM) wins, the larger TM on a tie.
// Only where nothing fits in shared memory: column tiles, then fewer thread
// rows, then narrower passes.  NTX is a multiple of 8 (a warp spans 8
// thread columns) and NTY of 4.
bool paste_plan(int B, int H, int W, int D, int FH, int FW, bool vec,
                PastePlan* plan) {
  static const int kTM1[] = {7, 2}, kTM4[] = {1};
  const int DC = (vec && D % 4 == 0) ? 4 : 1;
  const int* tms = DC == 4 ? kTM4 : kTM1;
  const int ntm = DC == 4 ? 1 : 2;
  const int quads = (W + 3) / 4;
  const int passes = (quads + kPaMaxNTX - 1) / kPaMaxNTX;
  const long slots = 2L * multiprocessors();
  for (int wxs = ((quads + passes - 1) / passes + 7) / 8; wxs >= 1;
       wxs = wxs > 1 ? (wxs + 1) / 2 : 0) {
    const int ntx = 8 * wxs;
    const int chunks = (quads + ntx - 1) / ntx;
    for (int split = 1; split <= chunks; ++split) {
      const int Wt = 4 * ntx * ((chunks + split - 1) / split);
      const int CT = (W + Wt - 1) / Wt;
      for (int wys = kThreads / 32 / wxs; wys >= 1; wys /= 2) {
        long best = -1;
        for (int k = 0; k < ntm; ++k) {
          const int TM = tms[k];
          const int NTY = 4 * min(wys, (H + 4 * TM - 1) / (4 * TM));
          const int BM = NTY * TM;
          const int nt = (H + BM - 1) / BM;
          const long rt0 = ((long)B * nt * CT + slots - 1) / slots;
          const int per_image = (int)((nt + rt0 - 1) / rt0);
          const int RT = (nt + per_image - 1) / per_image;
          if ((nt + RT - 1) / RT > 65535) continue;
          // Stage 1 for all RT tiles at once where two blocks still fit
          // on an SM, else for fewer.
          int GT = RT;
          size_t smem = PasteGeom(FH, FW, GT * BM, DC).floats(Wt) * 4;
          while (GT > 1 && smem > kMaxSmemBytes / 2) {
            --GT;
            smem = PasteGeom(FH, FW, GT * BM, DC).floats(Wt) * 4;
          }
          if (smem > kMaxSmemBytes) continue;
          if (best < 0 || (long)RT * BM < best) {
            best = (long)RT * BM;
            *plan = PastePlan{TM, DC, ntx, NTY, Wt, CT, RT, GT, smem};
          }
        }
        if (best >= 0) return true;
      }
    }
  }
  return false;
}

template <int TM, int DC>
cudaError_t launch_paste(const float* p, const float* fy, const float* fx,
                         float* out, int B, int H, int W, int D, int FH,
                         int FW, const PastePlan& plan, bool vec,
                         cudaStream_t stream) {
  cudaError_t err = allow_smem((const void*)paste_kernel<TM, DC>, plan.smem);
  if (err != cudaSuccess) return err;
  const int BM = plan.NTY * TM;
  const int tiles = (H + BM - 1) / BM;
  const dim3 grid(plan.CT, (tiles + plan.RT - 1) / plan.RT, B);
  paste_kernel<TM, DC><<<grid, kThreads, plan.smem, stream>>>(
      p, fy, fx, out, H, W, D, FH, FW, plan.NTX, plan.NTY, plan.Wt, plan.RT,
      plan.GT, vec, vec && D == 1 && W % 4 == 0);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// glimpse_extract at the main path's shapes: extract_tiled_kernel<FT,TF,TC,KC>
//
// Replaces rec_attend_tpu/ops/pallas/glimpse.py:62 _extract_kernel (called
// by _extract_call, :86) where the image is 224x224, the glimpse 48x48, D
// is 1 or 4 and all four pointers are 16-byte aligned: the flagship's
// forward (x [B,224,224,4]) and its d_p in paste's backward (g
// [B,224,224,1]).  extract_route sends every other shape to
// extract_kernel_general; the route depends on the shape and the pointers'
// alignment alone.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s float32 on the CUDA cores): at
// b128 D=4 the call moves 118 MB (x 102.8 MB, the filter banks, the patch),
// 35 us, and does 3.0 GFLOP (stage 1 2.47, stage 2 0.53), 45 us: bound by
// operations.  As d_p at b32 D=1 it reads 6.4 MB of g, about 2.8 us, and
// does 0.19 GFLOP: bound by bytes.
//
// Design: a block owns one image and FT output rows f, so no sum crosses
// blocks (no split over h or w, no atomics).  It walks x in strips of
// kTxCols = 224 contiguous floats of each row (the whole row at D=1, 56
// columns w at D=4) and each strip in chunks of KC rows h (32 at FT=48,
// 56 at the smaller FT, where shared memory holds them):
//   staging  cp.async 16-byte copies into kTxStages = 3 buffers: chunk k+1
//            of x (KC rows of the strip) and of f_y (its [KC x FT] rows)
//            lands while chunk k is summed, into the buffer that chunk k-2
//            left, so one barrier an iteration suffices; a strip's
//            f_x rows [WS x 48] come with its first chunk, into one of two
//            buffers, as global memory holds them (all lanes of a warp read
//            one f_x row in stage 2, so a swizzle would change no bank).
//            No scalar staging stores, no transposing stores.
//   stage 1  tmp[f, c] = sum_h f_y[h,f] * x[h,c], c = w*D+d of the strip: a
//            register-tiled SGEMM, TF rows f x TC columns a thread, the
//            sums in registers over the whole strip.  Per h a thread reads
//            TF/4 float4 of f_y and one float4 (TC = 4) or one float (TC =
//            1) of x: 12 FMAs a load at FT=48, where a warp is 8 column
//            quads x 4 row groups (one bank wavefront a load).
//   stage 2  acc[f, g, d] += sum_w tmp[f, w*D+d] * f_x[w, g], tmp in shared
//            memory (rows padded to kTxTS = 228 floats, so that the rows a
//            warp reads lie in distinct banks), acc in registers for the
//            whole walk over w: SF rows f x 4 taps g x D channels a thread.
//            Per w it reads SF float4 of tmp and one float4 of f_x (D=4:
//            12 FMAs a load at SF=3); per 4 w, SF + 4 float4 (D=1).
//   store    the patch goes out as [B][FH][D][FW] in memory, the layout in
//            which the plain version (two einsums) returns it, so that the
//            layers after the glimpse run the same cuDNN algorithms, and
//            round the same way, on the kernel path and the plain one; a
//            patch row f is 48*D contiguous floats, and a thread writes its
//            4 taps of each channel as one float4.
// Summation order: each tmp element sums over h ascending in one chain;
// each acc element sums over w ascending in one chain across the strips.
// The [FH, W, D] intermediate never reaches device memory.
//
// Route and tiles: the host takes the largest FT of {48, 12} whose grid
// (B * 48/FT blocks) has at least kTxMinBlocks = 96 blocks (about three
// quarters of the H100's 132 SMs), else FT = 4.  b128 takes FT=48 (128
// blocks; x of each image is read once from device memory), b32 FT=12
// (128 blocks), b8 FT=4 (96 blocks).  A smaller FT reads x of an image once
// per f-tile, from L2 where the image's blocks run together: FT=12 four
// times (at b32 D=1, 25.7 MB of L2 reads for 6.4 MB of x), FT=4 twelve
// times (at b8 D=4, 77 MB for 6.4 MB).  The smaller FT stage 56 rows a
// chunk, which fits once in an SM's shared memory (208 KB at FT=12 D=1), so
// a grid past 132 blocks takes more than one wave there.
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8): registers a thread 164 at
// <48,12,4,32> (one block of 7 warps an SM), 112 at <12,12,1,56> and 104 at
// <4,4,1,56>; no spills, no static shared memory.  On one H100 80GB HBM3 at
// 700 W the output equals the two-einsum plain version's to the bit at the
// main path's shapes (cuBLAS sums in the same order there).
// ---------------------------------------------------------------------------

constexpr int kTxSize = 224;        // image rows and columns taken
constexpr int kTxTaps = 48;         // glimpse rows and columns taken
constexpr int kTxThreads = 224;     // 7 warps
constexpr int kTxCols = 224;        // floats of an x row a strip holds
constexpr int kTxStages = 3;        // chunk buffers
constexpr int kTxTS = kTxCols + 4;  // tmp row stride
constexpr int kTxGQ = kTxTaps / 4;  // tap quads of a patch row
constexpr int kTxMinBlocks = 96;

// Shared memory of one block, in floats: kTxStages chunks of x and f_y,
// f_x of a strip (two buffers where there are two strips or more), tmp.
size_t extract_tiled_smem_floats(int FT, int KC, int D) {
  const int WS = kTxSize / D;
  return (size_t)kTxStages * KC * (kTxCols + FT) +
         (size_t)(D > 1 ? 2 : 1) * WS * kTxTaps + (size_t)FT * kTxTS;
}

// The extract route: FT (48, 12 or 4) for extract_tiled_kernel, 0 for
// extract_kernel_general, -1 where neither takes the shape.
int extract_route(int B, int H, int W, int D, int FH, int FW, bool aligned) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || FH < 1 || FW < 1 || B > 65535 ||
      D > kExCols)
    return -1;
  if (aligned && H == kTxSize && W == kTxSize && FH == kTxTaps &&
      FW == kTxTaps && (D == 1 || D == 4)) {
    for (int ft : {48, 12}) {
      if ((long)B * (kTxTaps / ft) >= kTxMinBlocks) return ft;
    }
    return 4;
  }
  const size_t smem = extract_smem_floats(D, FW, kExCols / D) * sizeof(float);
  return smem > kMaxSmemBytes ? -1 : 0;
}

template <int FT, int TF, int TC, int KC>
__global__ void __launch_bounds__(kTxThreads, 1)
extract_tiled_kernel(const float* __restrict__ x,
                     const float* __restrict__ fy,
                     const float* __restrict__ fx, float* __restrict__ out,
                     int D) {
  constexpr int NFG = FT / TF;           // stage-1 row groups
  constexpr int LPG = 32 / NFG;          // lanes of a warp in a row group
  constexpr int SF = FT >= 48 ? 3 : 1;   // stage-2 rows a thread
  constexpr int FS = FT / SF;            // stage-2 row stride
  constexpr int NT2 = FS * kTxGQ;        // stage-2 threads
  constexpr int NH = kTxSize / KC;       // chunks a strip
  constexpr int XQ = kTxCols / 4;        // 16-byte copies of an x row
  static_assert(NFG * (kTxCols / TC) == kTxThreads, "stage-1 threads");
  static_assert(TF % 4 == 0 && (TC == 1 || TC == 4), "stage-1 tile");
  static_assert(NT2 <= kTxThreads, "stage-2 threads");
  static_assert(kTxSize % KC == 0 && KC * XQ % kTxThreads == 0, "chunks");
  extern __shared__ __align__(16) float smem[];
  const int WS = kTxSize / D;                         // columns w a strip
  float* xs = smem;                             // [kTxStages][KC][kTxCols]
  float* fys = xs + kTxStages * KC * kTxCols;     // [kTxStages][KC][FT]
  float* fxs = fys + kTxStages * KC * FT;         // [1 or 2][WS][48]
  float* tmp = fxs + (D > 1 ? 2 : 1) * WS * kTxTaps;  // [FT][kTxTS]

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)kTxSize * D;   // floats of an x row
  const float* xb = x + (size_t)b * kTxSize * row;
  const float* fyb = fy + (size_t)b * kTxSize * kTxTaps + f0;
  const float* fxb = fx + (size_t)b * kTxSize * kTxTaps;
  const int nk = D * NH;                    // chunks in all

  // Chunk k: rows h0 .. h0+KC of strip s, one commit group.  Thread tid
  // copies the 16 bytes at column quad tid%XQ of rows tid/XQ +
  // j*(kTxThreads/XQ).
  const int xr0 = tid / XQ, xc = tid % XQ;
  auto issue = [&](int k) {
    const int s = k / NH, h0 = (k - s * NH) * KC;
    float* xd = xs + (k % kTxStages) * KC * kTxCols;
    const float* xsrc = xb + (size_t)h0 * row + s * kTxCols + 4 * xc;
#pragma unroll
    for (int j = 0; j < KC * XQ / kTxThreads; ++j) {
      const int r = xr0 + j * (kTxThreads / XQ);
      cp_async16(xd + r * kTxCols + 4 * xc, xsrc + r * row);
    }
    float* yd = fys + (k % kTxStages) * KC * FT;
    for (int i = tid; i < KC * FT / 4; i += kTxThreads) {
      const int r = i / (FT / 4), c = i - r * (FT / 4);
      cp_async16(yd + r * FT + 4 * c,
                 fyb + (size_t)(h0 + r) * kTxTaps + 4 * c);
    }
    if (h0 == 0) {
      float* fd = fxs + (s & 1) * WS * kTxTaps;
      const float* fsrc = fxb + (size_t)s * WS * kTxTaps;
      for (int i = tid; i < WS * kTxTaps / 4; i += kTxThreads)
        cp_async16(fd + 4 * i, fsrc + 4 * i);
    }
    cp_async_commit();
  };

  // Stage-1 thread: rows fg*TF .. of its row group, columns TC*cg ...
  const int fg = lane / LPG;
  const int cg = warp * LPG + lane % LPG;
  // Stage-2 thread (tid < NT2): rows ft + i*FS, taps 4*gq ...
  const int gq = tid % kTxGQ, ft = tid / kTxGQ;
  float acc1[TF][TC];
  float acc2[SF][4][4];
#pragma unroll
  for (int i = 0; i < TF; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc1[i][j] = 0.f;
#pragma unroll
  for (int i = 0; i < SF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int d = 0; d < 4; ++d) acc2[i][j][d] = 0.f;

  // One barrier an iteration: chunk k+1 lands in the buffer of chunk k-2,
  // which every thread left before it reached iteration k-1's barrier; tmp
  // and a strip's f_x buffer are written again only strips later.
  issue(0);
  for (int k = 0; k < nk; ++k) {
    if (k + 1 < nk) {
      issue(k + 1);
      cp_async_wait<1>();   // chunk k has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // Stage 1, h ascending.
    const float* xk = xs + (k % kTxStages) * KC * kTxCols + TC * cg;
    const float* yk = fys + (k % kTxStages) * KC * FT + fg * TF;
#pragma unroll
    for (int hh = 0; hh < KC; ++hh) {
      float a[TF];
#pragma unroll
      for (int q = 0; q < TF / 4; ++q) {
        const float4 v =
            *reinterpret_cast<const float4*>(yk + hh * FT + 4 * q);
        a[4 * q] = v.x; a[4 * q + 1] = v.y; a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      float v[TC];
      if constexpr (TC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(xk + hh * kTxCols);
        v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
      } else {
        v[0] = xk[hh * kTxCols];
      }
#pragma unroll
      for (int i = 0; i < TF; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc1[i][j] += a[i] * v[j];
    }

    const int s = k / NH;
    if (k - s * NH == NH - 1) {
      // The strip is summed: its tmp, then stage 2 over its columns w.
#pragma unroll
      for (int i = 0; i < TF; ++i) {
        float* t = tmp + (fg * TF + i) * kTxTS + TC * cg;
        if constexpr (TC == 4) {
          *reinterpret_cast<float4*>(t) =
              make_float4(acc1[i][0], acc1[i][1], acc1[i][2], acc1[i][3]);
        } else {
          t[0] = acc1[i][0];
        }
#pragma unroll
        for (int j = 0; j < TC; ++j) acc1[i][j] = 0.f;
      }
      __syncthreads();
      if (tid < NT2) {
        const float* fk = fxs + (s & 1) * WS * kTxTaps + 4 * gq;
        const float* tk = tmp + ft * kTxTS;
        if (D == 4) {
#pragma unroll 8
          for (int w = 0; w < WS; ++w) {
            const float4 f =
                *reinterpret_cast<const float4*>(fk + w * kTxTaps);
            const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
            for (int i = 0; i < SF; ++i) {
              const float4 t = *reinterpret_cast<const float4*>(
                  tk + i * FS * kTxTS + 4 * w);
              const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
              for (int j = 0; j < 4; ++j)
#pragma unroll
                for (int d = 0; d < 4; ++d) acc2[i][j][d] += tv[d] * fv[j];
            }
          }
        } else {
#pragma unroll 2
          for (int w = 0; w < WS; w += 4) {
            float fv[4][4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float4 f =
                  *reinterpret_cast<const float4*>(fk + (w + e) * kTxTaps);
              fv[e][0] = f.x; fv[e][1] = f.y; fv[e][2] = f.z; fv[e][3] = f.w;
            }
#pragma unroll
            for (int i = 0; i < SF; ++i) {
              const float4 t = *reinterpret_cast<const float4*>(
                  tk + i * FS * kTxTS + w);
              const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc2[i][j][0] += tv[e] * fv[e][j];
            }
          }
        }
      }
    }
  }

  // out is [B][FH][D][FW] in memory: channel d of row f at o + d*48.
  if (tid < NT2) {
#pragma unroll
    for (int i = 0; i < SF; ++i) {
      float* o = out + ((size_t)b * kTxTaps + f0 + ft + i * FS) * D * kTxTaps +
                 4 * gq;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (d < D) {
          *reinterpret_cast<float4*>(o + d * kTxTaps) = make_float4(
              acc2[i][0][d], acc2[i][1][d], acc2[i][2][d], acc2[i][3][d]);
        }
      }
    }
  }
}

template <int FT, int TF, int TC, int KC>
cudaError_t launch_extract_tiled(const float* x, const float* fy,
                                 const float* fx, float* out, int B, int D,
                                 cudaStream_t stream) {
  const size_t smem = extract_tiled_smem_floats(FT, KC, D) * sizeof(float);
  cudaError_t err =
      allow_smem((const void*)extract_tiled_kernel<FT, TF, TC, KC>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(kTxTaps / FT, B);
  extract_tiled_kernel<FT, TF, TC, KC><<<grid, kTxThreads, smem, stream>>>(
      x, fy, fx, out, D);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int glimpse_extract_route(int B, int H, int W, int D, int FH, int FW,
                          int aligned) {
  return extract_route(B, H, W, D, FH, FW, aligned != 0);
}

// out is [B][FH][FW][D] in memory on the general route and [B][FH][D][FW]
// (the plain version's layout) on the tiled route: glimpse_extract_route
// tells them apart.
int glimpse_extract(const float* x, const float* fy, const float* fx,
                    float* out, int B, int H, int W, int D, int FH, int FW,
                    void* stream) {
  const bool aligned = ((uintptr_t)x | (uintptr_t)fy | (uintptr_t)fx |
                        (uintptr_t)out) % 16 == 0;
  const int route = extract_route(B, H, W, D, FH, FW, aligned);
  const cudaStream_t s = (cudaStream_t)stream;
#define EXTRACT_CASE(ft, tf, tc, kc)                                        \
  case ft:                                                                  \
    return (int)launch_extract_tiled<ft, tf, tc, kc>(x, fy, fx, out, B, D, s);
  switch (route) {
    EXTRACT_CASE(48, 12, 4, 32) EXTRACT_CASE(12, 12, 1, 56)
    EXTRACT_CASE(4, 4, 1, 56)
#undef EXTRACT_CASE
    case 0: break;
    default: return (int)cudaErrorInvalidValue;
  }
  const int WS = kExCols / D;
  const size_t smem = extract_smem_floats(D, FW, WS) * sizeof(float);
  cudaError_t err = allow_smem((const void*)extract_kernel_general, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((FH + kExFT - 1) / kExFT, B);
  extract_kernel_general<<<grid, kThreads, smem, s>>>(
      x, fy, fx, out, H, W, D, FH, FW, WS);
  return (int)cudaGetLastError();
}


int glimpse_paste(const float* p, const float* fy, const float* fx,
                  float* out, int B, int H, int W, int D, int FH, int FW,
                  void* stream) {
  if (B < 1 || H < 1 || W < 1 || D < 1 || FH < 1 || FW < 1 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const bool vec = ((uintptr_t)p | (uintptr_t)fy | (uintptr_t)fx |
                    (uintptr_t)out) % 16 == 0;
  PastePlan plan;
  if (!paste_plan(B, H, W, D, FH, FW, vec, &plan))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define PASTE_CASE(tm, dc)                                                  \
  if (plan.TM == tm && plan.DC == dc)                                       \
    return (int)launch_paste<tm, dc>(p, fy, fx, out, B, H, W, D, FH, FW,    \
                                     plan, vec, s);
  PASTE_CASE(7, 1) PASTE_CASE(2, 1) PASTE_CASE(1, 4)
#undef PASTE_CASE
  return (int)cudaErrorInvalidValue;
}

const char* glimpse_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
