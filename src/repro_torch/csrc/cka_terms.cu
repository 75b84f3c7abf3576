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
// Example form (cka_example_gram_kernel, cka_example_fold_kernel,
// cka_sum_kernel), for n < dx + dy: the two n x n Grams K = X X^T and
// L = Y Y^T, never whole in memory. It replaces a first design of one
// block per 64 x 64 tile pair that walked all of d alone: at a CNN probe
// (n = 16) one block for the whole card, 48 of its 64 rows empty, 17 ms
// at d = 131072 on an H100. What bounds it: bytes. At n = 16, d = 131072
// the inputs are 16.8 MB, 5.0 us at 3.35 TB/s; the products are 134
// MFLOP, 0.8 us as 3xTF32. So the design spreads the reading over every
// SM and keeps each byte read once:
// - Split over features first (kernels/cka/ops.py::example_plan): a block
//   is one tile pair (i <= j) of 16-row tiles and one range of `width`
//   features, enough ranges for ~2 blocks an SM at d = 131072, fewer
//   where d is small. At n <= 16 one tile pair is the whole Gram: no row
//   is wasted.
// - A warp takes 32-feature steps of the block's range in turn. A lane
//   (g, t) reads rows g and g + 8 of its tile, features 4t..4t+3 and
//   16+4t..16+4t+3 of the step: 16-byte loads (d % 4 == 0 and 16-byte
//   aligned rows), four lanes on 64 contiguous bytes of a row, else scalar
//   loads. Every load of a step is issued before its products, and eight
//   warps a block keep enough bytes in flight; nothing is staged.
// - Those registers are an m16n8k8 A fragment as they stand (k runs over
//   the step's features in any order, so feature 4t+c is column t and
//   16+4t+c column t+4 of the c-th product), and since B = X_j^T, B's
//   fragments are the same registers of tile j: for i = j, A's own. The
//   products are 3xTF32 mma.sync (tf32x3.cuh), fp32-accurate; fp32 FMAs
//   would need the 16 x 16 entries spread over threads and the operands
//   through shared memory. Each warp keeps a 16 x 16 K and L partial, 16
//   registers, adding each product to it in fp32 (`gram_step`); the warps
//   add theirs in shared memory in warp order and the block writes one K
//   and one L tile to scratch.
// - Centering fused: where the plan has one row tile (n <= 16, every CNN
//   probe), the kernel takes the raw rows and centers each column before
//   the products: the n values summed in a fixed order (rows g and g + 8,
//   then lanes g ^ 4, g ^ 2, g ^ 1 by shuffles), divided by n,
//   subtracted; rows past n stay zero. With more tiles the wrapper centers
//   in torch first.
// - cka_example_fold_kernel sums each entry of K and L over the splits in
//   double, in a fixed order (8 warps a block take every 8th split, then
//   warp order), and only then forms K*L, K^2 and L^2, weighting an
//   off-diagonal tile pair 2 (its mirror is not computed);
//   cka_sum_kernel reduces the blocks' terms in double.
// Rows past n and features past d are loaded as zeros, which leave every
// Gram entry unchanged.
//
// Neither route uses float atomics, so two launches on the same inputs
// agree bit for bit and a freeze decision replays exactly.

#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

constexpr int SUM_THREADS = 256;

// tile pair (i, j), i <= j, of block p, row-major over the upper
// triangle of tiles x tiles (kernels/cka/ops.py::_tile_pair)
__device__ void tile_pair(int p, int tiles, int& i, int& j) {
  i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  j = i + p;
}

__device__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ double warp_sum(double x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// (hsic, kk, ll) of `count` blocks' partials, summed in double in a fixed
// order
template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
cka_sum_kernel(const T* __restrict__ partials, int count,
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
// example form

constexpr int ER = 16;           // rows of a row tile (ops.py EXAMPLE_ROWS)
constexpr int EE = ER * ER;      // entries of a K or L tile
constexpr int ESTEP = 32;        // features of a warp's step (EXAMPLE_STEP)
constexpr int EWARPS = 8;        // warps of a gram block (EXAMPLE_WARPS)
constexpr int EFOLD_PARTS = 8;   // fold blocks a pair (EXAMPLE_FOLD_PARTS)
constexpr int EFOLD_WARPS = 8;   // split groups of a fold block
static_assert(EFOLD_PARTS * 32 == EE, "a fold block takes 32 entries");

// A lane's values of one step: v[e][c] = M[row0 + g + 8(e & 1)]
// [f + 4t + 16(e >> 1) + c], zero past row n and past column d. For each
// c, v[0..3][c] is the A fragment (a0..a3) of the step's c-th product.
template <bool VEC>
__device__ __forceinline__ void load_step(float (&v)[4][4],
                                          const float* __restrict__ m,
                                          int row0, int n, int d, int f) {
  const int g = tf32x3::lane_g(), t = tf32x3::lane_t();
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + g + 8 * (e & 1);
    const int c0 = f + 4 * t + 16 * (e >> 1);
    const float* src = m + static_cast<long long>(r) * d + c0;
    if (VEC) {  // d % 4 == 0: a group of 4 is all in or all out
      float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < n && c0 < d) q = __ldg(reinterpret_cast<const float4*>(src));
      v[e][0] = q.x;
      v[e][1] = q.y;
      v[e][2] = q.z;
      v[e][3] = q.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        v[e][c] = r < n && c0 + c < d ? __ldg(src + c) : 0.f;
    }
  }
}

// Center the step's columns of a one-tile plan (rows 0..15, n <= 16): each
// column's n values summed in a fixed order (rows g and g + 8 in a lane,
// then the lanes g ^ 4, g ^ 2, g ^ 1, which every lane adds in the same
// order up to commutation, so all hold the same sum), divided by n and
// subtracted; rows past n stay zero.
__device__ __forceinline__ void center_step(float (&v)[4][4], int n) {
  const int g = tf32x3::lane_g();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float s = v[2 * h][c] + v[2 * h + 1][c];
      s += __shfl_xor_sync(0xffffffffu, s, 16);
      s += __shfl_xor_sync(0xffffffffu, s, 8);
      s += __shfl_xor_sync(0xffffffffu, s, 4);
      const float mean = s / static_cast<float>(n);
      v[2 * h][c] = g < n ? v[2 * h][c] - mean : 0.f;
      v[2 * h + 1][c] = g + 8 < n ? v[2 * h + 1][c] - mean : 0.f;
    }
}

// acc[nt] += A B over one step: A the rows of tile i (`a`), B = tile j's
// rows transposed (`b`, the same array for i = j), as four 3xTF32
// m16n8k8 products; B's fragment of n-tile nt is (b[nt][c], b[nt + 2][c]).
// Each product starts from zero and is added to acc by an fp32 add, which
// rounds to nearest: the tensor cores' own accumulation truncates, and
// chained over a warp's steps it drifts below the sum (2.2e-6 of float64
// at n = 16, d = 262144 on an H100, where the plain version is 7.8e-8
// off), so each truncation stays within one product's 8 features.
__device__ __forceinline__ void gram_step(float (&acc)[2][4],
                                          const float (&a)[4][4],
                                          const float (&b)[4][4]) {
  using namespace tf32x3;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    uint32_t abig[4], asmall[4], bbig[4], bsmall[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      split(a[e][c], abig[e], asmall[e]);
      split(b[e][c], bbig[e], bsmall[e]);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const uint32_t bb[2] = {bbig[nt], bbig[nt + 2]};
      const uint32_t bs[2] = {bsmall[nt], bsmall[nt + 2]};
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma3(part, abig, asmall, bb, bs);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] += part[e];
    }
  }
}

// gram[b] for block b = pair * splits + split: the block's K_ij and L_ij
// partials over its features, 16 x 16 row-major each (K, then L)
template <bool VEC, bool CENTER>
__global__ void __launch_bounds__(32 * EWARPS, 2)
cka_example_gram_kernel(const float* __restrict__ x,
                        const float* __restrict__ y, int n, int dx, int dy,
                        int tiles, int splits, int width,
                        float* __restrict__ gram) {
  __shared__ float red[EWARPS][2 * EE];
  const int pair = blockIdx.x / splits, split = blockIdx.x % splits;
  int i, j;
  tile_pair(pair, tiles, i, j);
  const int warp = threadIdx.x / 32;
  const int f0 = split * width;
  const int steps = (min(width, max(dx, dy) - f0) + ESTEP - 1) / ESTEP;

  float K[2][4], L[2][4];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) K[nt][e] = L[nt][e] = 0.f;

#pragma unroll 2
  for (int k = warp; k < steps; k += EWARPS) {
    const int f = f0 + k * ESTEP;
    float xi[4][4], yi[4][4];
    load_step<VEC>(xi, x, i * ER, n, dx, f);
    load_step<VEC>(yi, y, i * ER, n, dy, f);
    if (i == j) {
      if (CENTER) {
        center_step(xi, n);
        center_step(yi, n);
      }
      gram_step(K, xi, xi);
      gram_step(L, yi, yi);
    } else {
      float xj[4][4], yj[4][4];
      load_step<VEC>(xj, x, j * ER, n, dx, f);
      load_step<VEC>(yj, y, j * ER, n, dy, f);
      gram_step(K, xi, xj);
      gram_step(L, yi, yj);
    }
  }

  using tf32x3::c_col;
  using tf32x3::c_row;
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int at = c_row(e) * ER + 8 * nt + c_col(e);
      red[warp][at] = K[nt][e];
      red[warp][EE + at] = L[nt][e];
    }
  __syncthreads();
  float* out = gram + static_cast<long long>(blockIdx.x) * 2 * EE;
  for (int at = threadIdx.x; at < 2 * EE; at += 32 * EWARPS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < EWARPS; ++w) s += red[w][at];
    out[at] = s;
  }
}

// EFOLD_PARTS blocks a tile pair, 32 entries of K and L each: warp w sums
// splits w, w + 8, ... of its lane's entry in double, the warps' sums are
// added in warp order, and only then are K*L, K^2 and L^2 formed and
// summed over the 32 entries, weighted 2 off the diagonal
__global__ void __launch_bounds__(32 * EFOLD_WARPS)
cka_example_fold_kernel(const float* __restrict__ gram, int tiles,
                        int splits, double* __restrict__ partials) {
  __shared__ double red[2][EFOLD_WARPS][32];
  const int pair = blockIdx.x / EFOLD_PARTS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int at = (blockIdx.x % EFOLD_PARTS) * 32 + lane;
  const float* src = gram + static_cast<long long>(pair) * splits * 2 * EE +
                     at;
  double k = 0.0, l = 0.0;
#pragma unroll 4
  for (int s = warp; s < splits; s += EFOLD_WARPS) {
    k += src[static_cast<long long>(s) * 2 * EE];
    l += src[static_cast<long long>(s) * 2 * EE + EE];
  }
  red[0][warp][lane] = k;
  red[1][warp][lane] = l;
  __syncthreads();
  if (warp) return;
  k = l = 0.0;
#pragma unroll
  for (int w = 0; w < EFOLD_WARPS; ++w) {
    k += red[0][w][lane];
    l += red[1][w][lane];
  }
  const double kl = warp_sum(k * l), kk = warp_sum(k * k),
               ll = warp_sum(l * l);
  if (lane == 0) {
    int i, j;
    tile_pair(pair, tiles, i, j);
    const double weight = i == j ? 1.0 : 2.0;
    partials[3 * blockIdx.x + 0] = weight * kl;
    partials[3 * blockIdx.x + 1] = weight * kk;
    partials[3 * blockIdx.x + 2] = weight * ll;
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

// The example form. x [n, dx], y [n, dy]: fp32, row-major contiguous,
// raw where `center` (the kernel centers the columns; only with tiles ==
// 1), else centered. tiles = ceil(n / 16) row tiles, splits feature ranges
// of `width` features each (kernels/cka/ops.py::example_plan). With
// P = tiles(tiles+1)/2 pairs, gram holds P * splits * 2 * 256 floats,
// partials 3 * P * 8 doubles (EFOLD_PARTS); out receives (hsic, kk, ll).
// Returns a cudaError_t (0 = launched).
extern "C" int cka_terms_example_fwd(const float* x, const float* y, int n,
                                     int dx, int dy, int tiles, int splits,
                                     int width, int center, float* gram,
                                     double* partials, float* out,
                                     void* stream) {
  if (center && tiles != 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = tiles * (tiles + 1) / 2;
  const int blocks = pairs * splits;
  const bool vec = dx % 4 == 0 && dy % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  auto gram_kernel = vec ? (center ? cka_example_gram_kernel<true, true>
                                   : cka_example_gram_kernel<true, false>)
                         : (center ? cka_example_gram_kernel<false, true>
                                   : cka_example_gram_kernel<false, false>);
  gram_kernel<<<blocks, 32 * EWARPS, 0, st>>>(x, y, n, dx, dy, tiles, splits,
                                              width, gram);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cka_example_fold_kernel<<<pairs * EFOLD_PARTS, 32 * EFOLD_WARPS, 0, st>>>(
      gram, tiles, splits, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cka_sum_kernel<double><<<1, SUM_THREADS, 0, st>>>(
      partials, pairs * EFOLD_PARTS, out);
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
  cka_sum_kernel<float><<<1, SUM_THREADS, 0, st>>>(
      partials, pairs * FOLD_PARTS, out);
  return cudaGetLastError();
}
