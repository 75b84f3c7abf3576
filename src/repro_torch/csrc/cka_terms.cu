// CKA Gram terms for Hopper (sm_90a), fp32-accurate, by hand: two routes.
//
// Replaces: src/repro/kernels/cka/kernel.py, cka_terms_pallas (kernel body
// _cka_kernel), the Pallas TPU kernel behind every SimFreeze freeze and
// unfreeze decision under `use_kernel`. Same function: for centered
// X [n, dx] and Y [n, dy] it returns hsic = <XX^T, YY^T>_F,
// kk = ||XX^T||_F^2 and ll = ||YY^T||_F^2. The wrapper picks the route
// with less work: the feature form when dx + dy <= n (every SimFreeze
// probe of a ViT layer), the example form otherwise (n << d).
//
// Feature form (cka_gram_kernel, cka_fold_kernel, cka_sum_kernel). By
// hsic = ||Y^T X||^2, kk = ||X^T X||^2, ll = ||Y^T Y||^2 the terms are the
// squared entries of one Gram G = Z^T Z, Z = [X | Y] of D = dx + dy
// columns, sorted by block. What bounds it: operations. At the DeiT-tiny
// main-path shape (n = 3152, dx = dy = 192) the upper triangle of G is
// 2n * D(D+1)/2 = 0.466 GFLOP against 4.8 MB of input; as 3xTF32 products
// (tf32x3.cuh) at the published 495 TFLOP/s that is 2.8 us, the bytes
// 1.4 us at 3.35 TB/s. The parity tolerance (rtol 1e-4) and the 1% freeze
// threshold it guards need fp32 accuracy, which 3xTF32 keeps.
// Design: X and Y are read through two pointers as the columns of Z;
// nothing is concatenated. One block (4 warps, 2 x 2, each a 32 x 32
// corner) owns one 64 x 64 tile (i <= j) of G over one of `splits` fixed
// row ranges of n (split-K), so the main shape runs 21 tiles x 25 splits.
// A diagonal tile (i = j) stages its columns once and reads both
// operands from them.
// Rows are staged 32 at a time by cp.async into two buffers (the next
// chunk's copy is issued before this chunk's products), with a row pitch
// of 72 words: the fragment loads (rows t, columns g) fall on 32 banks.
// The products are 3xTF32 mma.sync m16n8k8 with A = Z_i^T, B = Z_j. Each
// block writes its partial tile to scratch the wrapper allocates. A
// second pass (8 blocks per tile, so that enough loads are in flight)
// sums the splits of each entry in a fixed order, squares it, sorts it
// by its two column indices into XX, YY or mixed, and weights an
// off-diagonal tile 2 (its mirror is not computed) and a diagonal tile 1;
// the mixed sum counts every Y^T X entry twice, so it is halved into
// hsic. cka_sum_kernel then reduces the per-block terms in double in a
// fixed order. The splits and the tile
// count depend on the shape only (kernels/cka/ops.py::feature_plan).
//
// Example form (cka_tiles_kernel, cka_sum_kernel), for n < dx + dy: tiles
// of the two n x n Grams, never written to memory, fp32 FMAs on the CUDA
// cores. Each block owns one 64x64 tile pair (i <= j) of the upper
// triangle, loops over the feature dim in 32-wide chunks staged in shared
// memory and accumulates its K_ij = X_i X_j^T and L_ij = Y_i Y_j^T tiles
// in registers (a 4x4 register tile per thread), chunk by chunk with
// Kahan-compensated sums of the chunks (`gram_tile`). From the two tiles it
// reduces sum K*L, sum K^2 and sum L^2 with warp shuffles and a fixed
// order across warps, counts an off-diagonal tile twice (K_ji = K_ij^T),
// and writes three partials for cka_sum_kernel. Rows past n and features
// past d are loaded as zeros, which leave every Gram entry unchanged.
//
// Neither route uses float atomics, so two launches on the same inputs
// agree bit for bit and a freeze decision replays exactly.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int TILE = 64;      // examples per tile side
constexpr int DK = 32;        // features staged per step
constexpr int LD = DK + 1;    // padded pitch: conflict-free column reads
constexpr int THREADS = 256;  // 16 x 16, a 4x4 register tile each
constexpr int SUM_THREADS = 256;

// tile pair (i, j), i <= j, of block p, row-major over the upper
// triangle of tiles x tiles (kernels/cka/ops.py::FeaturePlan.pair)
__device__ void tile_pair(int p, int tiles, int& i, int& j) {
  i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  j = i + p;
}

__device__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                      int row0, int n, int d, int c0) {
  for (int i = threadIdx.x; i < TILE * DK; i += THREADS) {
    const int r = i / DK, c = i % DK;
    const int gr = row0 + r, gc = c0 + c;
    dst[r * LD + c] = (gr < n && gc < d)
                          ? src[static_cast<long long>(gr) * d + gc] : 0.f;
  }
}

// acc[r][s] = sum_c src[i0 + 4*ty + r][c] * src[j0 + tx + 16*s][c]
//
// Each staged chunk of DK features is summed on its own, and the chunk
// sums are added with Kahan compensation. One fp32 chain over all d
// features loses accuracy as d grows: at n = 16, d = 262144 (ResNet50's
// first stage at 128x128) its hsic was 1.15e-4 off the plain version,
// past the 1e-4 tolerance.
__device__ void gram_tile(float (&acc)[4][4], const float* __restrict__ src,
                          int n, int d, int i0, int j0, float* As,
                          float* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float comp[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[r][s] = comp[r][s] = 0.f;
  for (int c0 = 0; c0 < d; c0 += DK) {
    __syncthreads();  // the previous chunk is no longer read
    stage(As, src, i0, n, d, c0);
    stage(Bs, src, j0, n, d, c0);
    __syncthreads();
    float part[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) part[r][s] = 0.f;
#pragma unroll 8
    for (int c = 0; c < DK; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = As[(4 * ty + r) * LD + c];
#pragma unroll
      for (int s = 0; s < 4; ++s) b[s] = Bs[(tx + 16 * s) * LD + c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int s = 0; s < 4; ++s)
          part[r][s] = fmaf(a[r], b[s], part[r][s]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int s = 0; s < 4; ++s) {  // Kahan: acc += part
        const float y = part[r][s] - comp[r][s];
        const float t = acc[r][s] + y;
        comp[r][s] = (t - acc[r][s]) - y;
        acc[r][s] = t;
      }
  }
}

__device__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__global__ void __launch_bounds__(THREADS)
cka_tiles_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 int n, int dx, int dy, int tiles,
                 float* __restrict__ partials) {
  __shared__ float As[TILE * LD];
  __shared__ float Bs[TILE * LD];
  __shared__ float red[3][THREADS / 32];

  int i, j;
  tile_pair(blockIdx.x, tiles, i, j);

  float K[4][4], L[4][4];
  gram_tile(K, x, n, dx, i * TILE, j * TILE, As, Bs);
  gram_tile(L, y, n, dy, i * TILE, j * TILE, As, Bs);

  float kl = 0.f, kk = 0.f, ll = 0.f;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      kl = fmaf(K[r][s], L[r][s], kl);
      kk = fmaf(K[r][s], K[r][s], kk);
      ll = fmaf(L[r][s], L[r][s], ll);
    }
  kl = warp_sum(kl);
  kk = warp_sum(kk);
  ll = warp_sum(ll);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = kl;
    red[1][warp] = kk;
    red[2][warp] = ll;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
      c += red[2][w];
    }
    const float weight = i == j ? 1.f : 2.f;
    partials[3 * blockIdx.x + 0] = weight * a;
    partials[3 * blockIdx.x + 1] = weight * b;
    partials[3 * blockIdx.x + 2] = weight * c;
  }
}

__global__ void __launch_bounds__(SUM_THREADS)
cka_sum_kernel(const float* __restrict__ partials, int count,
               float* __restrict__ out) {
  __shared__ double buf[3][SUM_THREADS];
  double a = 0.0, b = 0.0, c = 0.0;
  for (int p = threadIdx.x; p < count; p += SUM_THREADS) {
    a += partials[3 * p + 0];
    b += partials[3 * p + 1];
    c += partials[3 * p + 2];
  }
  buf[0][threadIdx.x] = a;
  buf[1][threadIdx.x] = b;
  buf[2][threadIdx.x] = c;
  __syncthreads();
  for (int s = SUM_THREADS / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      buf[0][threadIdx.x] += buf[0][threadIdx.x + s];
      buf[1][threadIdx.x] += buf[1][threadIdx.x + s];
      buf[2][threadIdx.x] += buf[2][threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    out[0] = static_cast<float>(buf[0][0]);
    out[1] = static_cast<float>(buf[1][0]);
    out[2] = static_cast<float>(buf[2][0]);
  }
}

// ---------------------------------------------------------------------------
// feature form

constexpr int FT = 64;          // G tile side (columns of Z)
constexpr int FR = 32;          // rows of Z staged per step
constexpr int FLD = FT + 8;     // pitch: fragment loads fall on 32 banks
constexpr int FTHREADS = 128;   // 4 warps, 2 x 2, a 32 x 32 corner each
constexpr int FOLD_PARTS = 8;   // fold blocks per tile (ops.py FOLD_PARTS)
constexpr int FOLD_THREADS = 256;
constexpr int FOLD_EPT = FT * FT / (FOLD_PARTS * FOLD_THREADS);  // entries

// rows [r0, r0 + FR) of Z's columns [c0, c0 + FT) into dst (pitch FLD),
// zeros past r_end and past column dx + dy. VEC: 4 columns per 16-byte
// copy (dx and dy multiples of 4, x and y 16-byte aligned, so a group of
// 4 never straddles X and Y); else one column per 4-byte copy.
template <bool VEC>
__device__ void stage_z(float* __restrict__ dst, const float* __restrict__ x,
                        const float* __restrict__ y, int r0, int r_end,
                        int dx, int dy, int c0) {
  constexpr int W = VEC ? 4 : 1;
  for (int e = threadIdx.x; e < FR * FT / W; e += FTHREADS) {
    const int r = e / (FT / W), c = W * (e % (FT / W));
    const int gr = r0 + r, gc = c0 + c;
    const bool in = gr < r_end && gc < dx + dy;
    const float* src = x;  // read only when `in`
    if (in)
      src = gc < dx ? x + static_cast<long long>(gr) * dx + gc
                    : y + static_cast<long long>(gr) * dy + (gc - dx);
    tf32x3::cp_async<4 * W>(dst + r * FLD + c, src, in);
  }
}

// gram[split][pair] = Z[rows of split, cols of tile i]^T Z[..., tile j],
// a 64 x 64 row-major partial tile per block
template <bool VEC>
__global__ void __launch_bounds__(FTHREADS)
cka_gram_kernel(const float* __restrict__ x, const float* __restrict__ y,
                int n, int dx, int dy, int tiles, int rows,
                float* __restrict__ gram) {
  using namespace tf32x3;
  __shared__ __align__(16) float Zi[2][FR * FLD];
  __shared__ __align__(16) float Zj[2][FR * FLD];
  int i, j;
  tile_pair(blockIdx.x, tiles, i, j);
  const int r_begin = blockIdx.y * rows;
  const int r_end = min(n, r_begin + rows);
  const int warp = threadIdx.x / 32;
  const int wm = 32 * (warp >> 1), wn = 32 * (warp & 1);  // warp's corner

  float acc[2][4][4];  // 2 x 4 accumulator tiles of 16 x 8
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  auto stage = [&](int step, int buf) {
    const int r0 = r_begin + step * FR;
    stage_z<VEC>(Zi[buf], x, y, r0, r_end, dx, dy, i * FT);
    if (i != j) stage_z<VEC>(Zj[buf], x, y, r0, r_end, dx, dy, j * FT);
    cp_async_commit();
  };
  const int steps = (r_end - r_begin + FR - 1) / FR;
  stage(0, 0);
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    if (step + 1 < steps) {
      stage(step + 1, buf ^ 1);  // in flight while this chunk is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this chunk of rows is in shared memory
    const float* Zis = Zi[buf];
    const float* Zjs = i == j ? Zis : Zj[buf];
#pragma unroll
    for (int kr = 0; kr < FR / 8; ++kr) {  // 8 rows of Z per product
      // A[m][k] = Z[8kr + k][i*FT + wm + 16mt + m], B[k][n] likewise in j
      uint32_t abig[2][4], asmall[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(Zis[(8 * kr + a_col(e)) * FLD + wm + 16 * mt + a_row(e)],
                abig[mt][e], asmall[mt][e]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        uint32_t bbig[2], bsmall[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          split(Zjs[(8 * kr + b_row(e)) * FLD + wn + 8 * nt + b_col()],
                bbig[e], bsmall[e]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          mma3(acc[mt][nt], abig[mt], asmall[mt], bbig, bsmall);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

  float* out = gram + (static_cast<long long>(blockIdx.y) * gridDim.x +
                       blockIdx.x) * FT * FT;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int a = wm + 16 * mt + c_row(2 * r);
        const int b = wn + 8 * nt + c_col(2 * r);
        *reinterpret_cast<float2*>(out + a * FT + b) =
            make_float2(acc[mt][nt][2 * r], acc[mt][nt][2 * r + 1]);
      }
}

// FOLD_PARTS blocks per tile pair, FOLD_EPT entries of G a thread: each
// entry summed over the splits in order (the loads of a step are
// independent, so they are in flight together), squared and sorted into
// (hsic, kk, ll) partials of the block
__global__ void __launch_bounds__(FOLD_THREADS)
cka_fold_kernel(const float* __restrict__ gram, int tiles, int splits,
                int dx, int dy, float* __restrict__ partials) {
  __shared__ float red[3][FOLD_THREADS / 32];
  const int p = blockIdx.x / FOLD_PARTS;
  const int pairs = gridDim.x / FOLD_PARTS;
  const int e0 = (blockIdx.x % FOLD_PARTS) * FOLD_EPT * FOLD_THREADS +
                 threadIdx.x;  // this thread's entries: e0 + k*FOLD_THREADS
  int i, j;
  tile_pair(p, tiles, i, j);
  const float* src = gram + static_cast<long long>(p) * FT * FT + e0;
  const long long split_stride = static_cast<long long>(pairs) * FT * FT;
  float g[FOLD_EPT];
#pragma unroll
  for (int k = 0; k < FOLD_EPT; ++k) g[k] = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s)
#pragma unroll
    for (int k = 0; k < FOLD_EPT; ++k)
      g[k] += src[s * split_stride + k * FOLD_THREADS];
  float mixed = 0.f, xx = 0.f, yy = 0.f;
#pragma unroll
  for (int k = 0; k < FOLD_EPT; ++k) {
    const int e = e0 + k * FOLD_THREADS;
    const int a = i * FT + e / FT, b = j * FT + e % FT;  // columns of Z
    if (a >= dx + dy || b >= dx + dy) continue;
    const float sq = g[k] * g[k];
    if (a < dx && b < dx)
      xx += sq;
    else if (a >= dx && b >= dx)
      yy += sq;
    else
      mixed += sq;
  }
  mixed = warp_sum(mixed);
  xx = warp_sum(xx);
  yy = warp_sum(yy);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    red[0][warp] = mixed;
    red[1][warp] = xx;
    red[2][warp] = yy;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, b = 0.f, c = 0.f;
    for (int w = 0; w < FOLD_THREADS / 32; ++w) {
      a += red[0][w];
      b += red[1][w];
      c += red[2][w];
    }
    // an off-diagonal tile stands for its mirror too; every Y^T X entry
    // is in G twice, so the mixed sum is halved into hsic
    const float weight = i == j ? 1.f : 2.f;
    partials[3 * blockIdx.x + 0] = 0.5f * weight * a;
    partials[3 * blockIdx.x + 1] = weight * b;
    partials[3 * blockIdx.x + 2] = weight * c;
  }
}

}  // namespace

// x [n, dx], y [n, dy]: centered fp32, row-major contiguous. partials
// holds 3 floats per tile pair, 3 * T(T+1)/2 with T = ceil(n / 64);
// out receives (hsic, kk, ll). Returns a cudaError_t (0 = launched).
extern "C" int cka_terms_fwd(const float* x, const float* y, int n, int dx,
                             int dy, float* partials, float* out,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (n + TILE - 1) / TILE;
  const int blocks = tiles * (tiles + 1) / 2;
  cka_tiles_kernel<<<blocks, THREADS, 0, st>>>(x, y, n, dx, dy, tiles,
                                               partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cka_sum_kernel<<<1, SUM_THREADS, 0, st>>>(partials, blocks, out);
  return cudaGetLastError();
}

// The feature form. x [n, dx], y [n, dy]: centered fp32, row-major
// contiguous; tiles = ceil((dx + dy) / 64), splits row ranges of `rows`
// rows each (kernels/cka/ops.py::feature_plan). With P = tiles(tiles+1)/2
// pairs, gram holds splits * P * 64 * 64 floats, partials 3 * P * 8
// (FOLD_PARTS); out receives (hsic, kk, ll). Returns a cudaError_t (0 =
// launched).
extern "C" int cka_terms_feature_fwd(const float* x, const float* y, int n,
                                     int dx, int dy, int tiles, int splits,
                                     int rows, float* gram, float* partials,
                                     float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = tiles * (tiles + 1) / 2;
  const dim3 grid(pairs, splits);
  const bool vec = dx % 4 == 0 && dy % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  if (vec)
    cka_gram_kernel<true><<<grid, FTHREADS, 0, st>>>(x, y, n, dx, dy, tiles,
                                                      rows, gram);
  else
    cka_gram_kernel<false><<<grid, FTHREADS, 0, st>>>(x, y, n, dx, dy, tiles,
                                                       rows, gram);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cka_fold_kernel<<<pairs * FOLD_PARTS, FOLD_THREADS, 0, st>>>(
      gram, tiles, splits, dx, dy, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cka_sum_kernel<<<1, SUM_THREADS, 0, st>>>(partials, pairs * FOLD_PARTS,
                                            out);
  return cudaGetLastError();
}
