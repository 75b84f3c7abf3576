// CKA Gram terms for Hopper (sm_90a), fp32, by hand.
//
// Replaces: src/repro/kernels/cka/kernel.py, cka_terms_pallas (kernel body
// _cka_kernel), the Pallas TPU kernel behind every SimFreeze freeze and
// unfreeze decision under `use_kernel`. Same function: for centered
// X [n, dx] and Y [n, dy] it returns hsic = <XX^T, YY^T>_F,
// kk = ||XX^T||_F^2 and ll = ||YY^T||_F^2 from tiles of the example-form
// Gram matrices, never writing an n x n Gram to memory.
//
// What bounds it on this card: operations. At the DeiT-tiny main-path
// shape (n = 16*197 = 3152, d = 192) the function itself needs only the
// feature form, Y^T X plus the upper triangles of X^T X and Y^T Y:
// 2n(dx*dy + dx(dx+1)/2 + dy(dy+1)/2) = 0.47 GFLOP of fp32 FMAs, 7.0 us at
// the published 67 TFLOP/s fp32 peak, against 4.8 MB of input, 1.4 us at
// 3.35 TB/s. This kernel's example-form design does far more: the upper
// triangle of the two n x n Grams is n(n+1)/2 * 2 * (dx + dy) = 3.8 GFLOP,
// a limit of 57 us for this design only. The products stay fp32 (no
// TF32): a freeze decision compares CKA variations against a 1%
// threshold, and the parity tolerance (rtol 1e-4) depends on full
// precision.
//
// Design: the TPU kernel walks an (n/bn)^2 x (d/bk) grid in order and
// accumulates into one scalar; blocks on this card run in no order, so
// each block owns one 64x64 tile pair (i <= j) of the upper triangle.
// It loops over the feature dim in 32-wide chunks staged in shared memory
// and accumulates its K_ij = X_i X_j^T and L_ij = Y_i Y_j^T tiles in
// registers (a 4x4 register tile per thread, so every shared-memory load
// feeds four FMAs). From the two tiles it reduces sum K*L, sum K^2 and
// sum L^2 with warp shuffles and a fixed order across warps, counts an
// off-diagonal tile twice (K_ji = K_ij^T), and writes three partials. A
// second one-block kernel sums the partials in a fixed order, in double.
// No float atomics anywhere, so two launches on the same inputs agree bit
// for bit and a freeze decision replays exactly. Rows past n and
// features past d are loaded as zeros, which leave every Gram entry
// unchanged, so neither n nor d needs padding. Using the Gram's symmetry
// halves the work. The feature form (three d x d Grams, 0.47 GFLOP here
// with the same symmetry) would do 8x less than this kernel and 16x less
// than the full example form; it is the lead for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;      // examples per tile side
constexpr int DK = 32;        // features staged per step
constexpr int LD = DK + 1;    // padded pitch: conflict-free column reads
constexpr int THREADS = 256;  // 16 x 16, a 4x4 register tile each
constexpr int SUM_THREADS = 256;

__device__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                      int row0, int n, int d, int c0) {
  for (int i = threadIdx.x; i < TILE * DK; i += THREADS) {
    const int r = i / DK, c = i % DK;
    const int gr = row0 + r, gc = c0 + c;
    dst[r * LD + c] = (gr < n && gc < d)
                          ? src[static_cast<long long>(gr) * d + gc] : 0.f;
  }
}

// acc[r][s] += sum_c src[i0 + 4*ty + r][c] * src[j0 + tx + 16*s][c]
__device__ void gram_tile(float (&acc)[4][4], const float* __restrict__ src,
                          int n, int d, int i0, int j0, float* As,
                          float* Bs) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  for (int c0 = 0; c0 < d; c0 += DK) {
    __syncthreads();  // the previous chunk is no longer read
    stage(As, src, i0, n, d, c0);
    stage(Bs, src, j0, n, d, c0);
    __syncthreads();
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
        for (int s = 0; s < 4; ++s) acc[r][s] = fmaf(a[r], b[s], acc[r][s]);
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

  // blockIdx.x -> (i, j), i <= j, row-major over the upper triangle
  int p = blockIdx.x, i = 0;
  while (p >= tiles - i) {
    p -= tiles - i;
    ++i;
  }
  const int j = i + p;

  float K[4][4], L[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int s = 0; s < 4; ++s) K[r][s] = L[r][s] = 0.f;
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
