// WKV6 recurrence for Hopper (sm_90a), fp32, by hand.
//
// Replaces: src/repro/kernels/rwkv/kernel.py, wkv_pallas (kernel body
// _wkv_kernel), the Pallas TPU kernel for the exact RWKV6 recurrence. Same
// function, per (batch, head), with the state S [n, n] (key i, value j):
//   o_t[j] = sum_i r_t[i] (S[i][j] + u[i] k_t[i] v_t[j])
//   S[i][j] <- exp(logw_t[i]) S[i][j] + k_t[i] v_t[j]
// r, k, v, logw and o are [B, T, H, n] fp32 and u is [H, n]. It also
// writes the final state [B, H, n, n] (the decode cache of a prefill),
// which the Pallas kernel does not return, and starts from an optional
// s0 [B, H, n, n].
//
// What bounds it on this card: bytes, in principle. At the rwkv6-3b
// prefill shape (B=4, T=512, H=40, n=64) the function reads r, k, v, logw
// (84 MB) and writes o (21 MB) and the final state (2.6 MB): 32 us at
// 3.35 TB/s. Its ~5n^2 operations per token and head are 1.7 GFLOP, 25 us
// at the published 67 TFLOP/s fp32. In practice the time loop is
// sequential, and what bounds the kernel is how fast one SM steps a head's
// state through its tokens: the shared-memory loads that broadcast each
// token's r, k, w to the threads holding S, and the FMAs on S, at one to
// two blocks a SM (PERF.md).
//
// Design (wkv6_scan_kernel). One block owns one (b, h) and runs its whole
// sequence. Its consumer warps hold S in registers: thread (slot, lane l)
// holds J value columns of rows 4(l + G m) + e, so a token's r, k, w rows
// are read once for J columns, and o_t[j] is the G lanes' partial sums
// added by __shfl_xor in a fixed order (the first log2 J steps swap half
// the columns, so every lane ends with a whole column). The only chain
// carried from token to token is one FMA an entry of S. A tile's tokens
// are all stepped before their sums are taken, so the shuffles of a tile
// overlap. A producer warp keeps STAGES tiles of TILE tokens in flight by
// cp.async into shared memory, adds up r.u.k once a token for all columns,
// and hands each tile to the consumers over named barriers (FULL / EMPTY a
// slot), one tile ahead of them. exp(logw) is taken before the scan by
// wkv6_decay_kernel, at the accurate expf: that pass of its own made the
// scan faster than expf taken inside it by the producer warp (measured A/B,
// PERF.md; why is a hypothesis there). The value columns are not split
// across blocks, and time is not cut into segments: at the rwkv6-3b prefill
// shape both lost to whole heads and whole sequences (PERF.md).
//
// Everything is fp32 with the accurate expf (no fast math): the parity
// limit against the exact recurrence is rtol/atol 1e-4 for any logw <= 0.
// No atomics, and every sum in a fixed order: two launches on the same
// inputs agree bit for bit.

#include <cuda_runtime.h>

#include "tf32x3.cuh"  // the cp.async helpers

namespace {

using tf32x3::cp_async;
using tf32x3::cp_async_commit;
using tf32x3::cp_async_wait;

constexpr int TILE = 8;    // tokens per staged tile
constexpr int STAGES = 4;  // tiles in the ring
static_assert(TILE * 4 == 32, "r.u.k takes four lanes of a warp a token");

template <int N>
struct ScanTile {
  float r[TILE * N];
  float k[TILE * N];
  float w[TILE * N];  // exp(logw)
  float v[TILE * N];
  float ruk[TILE];    // sum_i r_i u_i k_i per token
};

// The block's place: (b, h) = bh. Consumer thread (column slot, lane l)
// holds columns j0 + jj (jj < J) of rows row(l, m, e) of S.
template <int N, int J, int G>
struct Place {
  static constexpr int NT = N / J * G, M = N / (4 * G);  // consumers, row quads
  static_assert(NT % 32 == 0 && M >= 1 && J <= G, "block shape");
  int bh, l, j0;
  __device__ Place() {
    bh = blockIdx.x;
    l = threadIdx.x % G;
    j0 = threadIdx.x / G * J;
  }
  __device__ static int row(int l, int m, int e) { return 4 * (l + G * m) + e; }
  // after lane_sums, the column (0 <= jj < J) lane l holds, and whether it
  // writes it (G / J lanes hold each)
  __device__ static int col(int l) {
    int jj = 0;
#pragma unroll
    for (int w = J, off = G / 2; w > 1; w /= 2, off /= 2)
      if (l & off) jj += w / 2;
    return jj;
  }
  __device__ static bool writes(int l) { return l % (G / J) == 0; }
};

__device__ __forceinline__ float part(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

// The G lanes of a column slot add their J partial sums of each of the
// TILE tokens, in a fixed order: each of the first log2(J) xor steps
// swaps half the columns, so a lane ends with one column (Place::col)
// summed over all G lanes. Every step runs over all tokens at once, so
// the shuffles' latencies overlap; x[t][0] holds the sums after.
template <int J, int G>
__device__ __forceinline__ void lane_sums(float (&x)[TILE][J], int l) {
#pragma unroll
  for (int w = J, off = G / 2; w > 1; w /= 2, off /= 2) {
    const bool hi = l & off;
#pragma unroll
    for (int q = 0; q < w / 2; ++q)
#pragma unroll
      for (int t = 0; t < TILE; ++t) {
        const float send = hi ? x[t][q] : x[t][q + w / 2];
        const float keep = hi ? x[t][q + w / 2] : x[t][q];
        x[t][q] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
  }
#pragma unroll
  for (int off = G / (2 * J); off > 0; off >>= 1)
#pragma unroll
    for (int t = 0; t < TILE; ++t)
      x[t][0] += __shfl_xor_sync(0xffffffffu, x[t][0], off);
}

// J consecutive floats of shared memory (at a multiple of J) into x
template <int J>
__device__ __forceinline__ void load_cols(float (&x)[J], const float* p) {
  static_assert(J == 1 || J % 4 == 0, "one float or whole float4s");
  if constexpr (J == 1) {
    x[0] = p[0];
  } else {
#pragma unroll
    for (int q = 0; q < J / 4; ++q) {
      const float4 a = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = a.x;
      x[4 * q + 1] = a.y;
      x[4 * q + 2] = a.z;
      x[4 * q + 3] = a.w;
    }
  }
}

// Named barriers between the producer warp and the consumer warps: tile
// slot s is FULL (staged and transformed) or EMPTY (consumed). Barrier 0
// is __syncthreads, which the kernel does not use.
__device__ __forceinline__ int full_bar(int slot) { return 1 + slot; }
__device__ __forceinline__ int empty_bar(int slot) { return 1 + STAGES + slot; }
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// cp.async, by the 32 lanes of the producer warp, one tile's rows of n
// floats (at `base`, stride `row` floats a token) into dst
template <int N>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long base, long long row,
                                           int nt, int lane) {
  constexpr int Q = N / 4;
#pragma unroll
  for (int it = 0; it < (TILE * Q + 31) / 32; ++it) {
    const int idx = lane + 32 * it;
    const int t = idx / Q, q = idx % Q;
    if (t < nt)
      cp_async<16>(dst + t * N + 4 * q, src + base + t * row + 4 * q, true);
  }
}

// The producer's loop: hand each tile to the consumers once it landed and
// `transform` ran on it, then refill the slot the consumers freed last, so
// STAGES - 1 tiles of copies stay in flight and the transform of tile
// kt + 1 overlaps the consumers' work on tile kt. The consumers arrive on
// a slot's EMPTY barrier only where the producer waits for it.
template <typename Stage, typename Transform>
__device__ __forceinline__ void produce(int ntiles, int count, Stage stage,
                                        Transform transform) {
#pragma unroll
  for (int kt = 0; kt < STAGES - 1; ++kt) {
    if (kt < ntiles) stage(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < ntiles; ++kt) {
    cp_async_wait<STAGES - 2>();  // this lane's copies of tile kt landed
    __syncwarp();                 // and every lane's
    transform(kt);
    bar_arrive(full_bar(kt % STAGES), count);
    const int next = kt + STAGES - 1;  // into the slot of tile kt - 1
    if (next < ntiles) {
      if (kt > 0) bar_sync(empty_bar(next % STAGES), count);
      stage(next);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
}

// The consumers' loop: wait for each tile, use it, free its slot.
template <typename Consume>
__device__ __forceinline__ void consume(int ntiles, int count,
                                        Consume use) {
  for (int kt = 0; kt < ntiles; ++kt) {
    bar_sync(full_bar(kt % STAGES), count);
    use(kt);
    if (kt + STAGES < ntiles) bar_arrive(empty_bar(kt % STAGES), count);
  }
}

// One staged tile of the recurrence: first the FMAs of every token,
// keeping each token's partial sums, then the lanes' sums of all tokens;
// o_t = sum + (r.u.k) v_t[j].
template <int N, int J, int G, bool FULL>
__device__ __forceinline__ void scan_tile(const ScanTile<N>& s,
                                          float (&S)[N / G][J], float* o,
                                          long long row, int nt,
                                          const Place<N, J, G>& at) {
  constexpr int M = N / (4 * G);
  const float4* r4 = reinterpret_cast<const float4*>(s.r);
  const float4* k4 = reinterpret_cast<const float4*>(s.k);
  const float4* w4 = reinterpret_cast<const float4*>(s.w);
  float acc[TILE][J] = {};
#pragma unroll
  for (int t = 0; t < TILE; ++t) {
    if (!FULL && t >= nt) break;
    float vj[J];
    load_cols<J>(vj, s.v + t * N + at.j0);
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int q = t * (N / 4) + at.l + G * m;
      const float4 rr = r4[q], kk = k4[q], ww = w4[q];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float ri = part(rr, e), ki = part(kk, e), wi = part(ww, e);
#pragma unroll
        for (int jj = 0; jj < J; ++jj) {
          float& x = S[4 * m + e][jj];
          acc[t][jj] = fmaf(ri, x, acc[t][jj]);
          x = fmaf(wi, x, ki * vj[jj]);
        }
      }
    }
  }
  lane_sums<J, G>(acc, at.l);  // every token's, tokens past nt add zeros
  if (at.writes(at.l)) {
    const int j = at.j0 + at.col(at.l);
#pragma unroll
    for (int t = 0; t < TILE; ++t)
      if (FULL || t < nt)
        o[t * row + j] = fmaf(s.ruk[t], s.v[t * N + j], acc[t][0]);
  }
}

// Where a block's tokens lie: the offset of (b, 0, h, 0) and the stride of
// a token.
struct Span {
  int h, len, ntiles;
  long long base, row;
  __device__ Span(int bh, int T, int H, int N) : len(T) {
    const int b = bh / H;
    h = bh % H;
    ntiles = (T + TILE - 1) / TILE;
    row = static_cast<long long>(H) * N;
    base = static_cast<long long>(b) * T * row + static_cast<long long>(h) * N;
  }
  __device__ int tokens(int kt) const { return min(TILE, len - kt * TILE); }
  __device__ long long at(int kt) const {
    return base + static_cast<long long>(kt) * TILE * row;
  }
};

// w = exp(logw), elementwise, before the scan (see the note above).
// `count` is a multiple of 4.
__global__ void __launch_bounds__(256)
wkv6_decay_kernel(const float4* __restrict__ logw, float4* __restrict__ w,
                  long long count) {
  for (long long i = blockIdx.x * 256LL + threadIdx.x; i < count / 4;
       i += static_cast<long long>(gridDim.x) * 256) {
    const float4 a = logw[i];
    w[i] = make_float4(expf(a.x), expf(a.y), expf(a.z), expf(a.w));
  }
}

template <int N, int J, int G>
__global__ void __launch_bounds__(N / J * G + 32)
wkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ w,
                 const float* __restrict__ u, const float* __restrict__ s0,
                 float* __restrict__ o, float* __restrict__ s_out, int T,
                 int H) {
  using At = Place<N, J, G>;
  constexpr int M = At::M, COUNT = At::NT + 32;
  extern __shared__ __align__(16) unsigned char smem[];
  auto* tiles = reinterpret_cast<ScanTile<N>*>(smem);
  const At at;
  const Span sp(at.bh, T, H, N);

  if (threadIdx.x >= At::NT) {  // the producer warp
    const int lane = threadIdx.x - At::NT;
    // r.u.k: lane (t, q) = (lane / 4, lane % 4) takes the float4 chunks
    // q + 4m of token t's row, the four lanes of a token add theirs
    constexpr int Q = N / 4, QL = Q / 4;
    float4 uq[QL];
#pragma unroll
    for (int m = 0; m < QL; ++m)
      uq[m] = reinterpret_cast<const float4*>(u + sp.h * N)[lane % 4 + 4 * m];
    produce(sp.ntiles, COUNT, [&](int kt) {
      ScanTile<N>& s = tiles[kt % STAGES];
      const int nt = sp.tokens(kt);
      stage_rows<N>(s.r, r, sp.at(kt), sp.row, nt, lane);
      stage_rows<N>(s.k, k, sp.at(kt), sp.row, nt, lane);
      stage_rows<N>(s.w, w, sp.at(kt), sp.row, nt, lane);
      stage_rows<N>(s.v, v, sp.at(kt), sp.row, nt, lane);
    }, [&](int kt) {
      ScanTile<N>& s = tiles[kt % STAGES];
      const int nt = sp.tokens(kt);
      const int t = lane / 4;
      float acc = 0.f;
      if (t < nt) {
        const float4* r4 = reinterpret_cast<const float4*>(s.r) + t * Q;
        const float4* k4 = reinterpret_cast<const float4*>(s.k) + t * Q;
#pragma unroll
        for (int m = 0; m < QL; ++m) {
          const float4 rr = r4[lane % 4 + 4 * m], kk = k4[lane % 4 + 4 * m];
          acc = fmaf(rr.x * uq[m].x, kk.x, acc);
          acc = fmaf(rr.y * uq[m].y, kk.y, acc);
          acc = fmaf(rr.z * uq[m].z, kk.z, acc);
          acc = fmaf(rr.w * uq[m].w, kk.w, acc);
        }
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (t < nt && lane % 4 == 0) s.ruk[t] = acc;
    });
    return;
  }

  const long long sb = static_cast<long long>(at.bh) * N * N;
  float S[N / G][J];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        S[4 * m + e][jj] =
            s0 ? s0[sb + at.row(at.l, m, e) * N + at.j0 + jj] : 0.f;
  consume(sp.ntiles, COUNT, [&](int kt) {
    const int nt = sp.tokens(kt);
    if (nt == TILE)
      scan_tile<N, J, G, true>(tiles[kt % STAGES], S, o + sp.at(kt), sp.row,
                               TILE, at);
    else
      scan_tile<N, J, G, false>(tiles[kt % STAGES], S, o + sp.at(kt),
                                sp.row, nt, at);
  });
  float* dst = s_out + sb;
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int jj = 0; jj < J; ++jj)
        dst[at.row(at.l, m, e) * N + at.j0 + jj] = S[4 * m + e][jj];
}

// J value columns a consumer thread, G lanes a column
template <int N, int J, int G>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s0,
                   float* o, float* s_out, float* w, int B, int T, int H,
                   cudaStream_t stream) {
  constexpr int NT = N / J * G + 32;
  constexpr size_t smem = STAGES * sizeof(ScanTile<N>);
  static_assert(smem <= 48 * 1024,
                "within the default limit of dynamic shared memory");
  const long long count = static_cast<long long>(B) * H * T * N;
  if (count > 0) {
    const long long blocks = (count / 4 + 255) / 256;
    wkv6_decay_kernel<<<static_cast<int>(blocks < 4096 ? blocks : 4096), 256,
                        0, stream>>>(reinterpret_cast<const float4*>(logw),
                                     reinterpret_cast<float4*>(w), count);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  wkv6_scan_kernel<N, J, G><<<B * H, NT, smem, stream>>>(r, k, v, w, u, s0, o,
                                                         s_out, T, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. All tensors fp32, contiguous and 16-byte
// aligned: r, k, v, logw and o [B, T, H, n]; u [H, n]; s0 (may be null)
// and s_out [B, H, n, n]; the scratch w [B, T, H, n]. Returns the CUDA
// error of the launches (0 on success); cudaErrorInvalidValue for an n
// other than 16, 32 or 64.
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* logw, const float* u, const float* s0,
                        float* o, float* s_out, float* w, int B, int T, int H,
                        int n, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0) return cudaErrorInvalidValue;
  switch (n) {
    case 16: return launch<16, 1, 4>(r, k, v, logw, u, s0, o, s_out, w, B, T,
                                     H, stream);
    case 32: return launch<32, 4, 8>(r, k, v, logw, u, s0, o, s_out, w, B, T,
                                     H, stream);
    case 64: return launch<64, 4, 8>(r, k, v, logw, u, s0, o, s_out, w, B, T,
                                     H, stream);
    default: return cudaErrorInvalidValue;
  }
}
