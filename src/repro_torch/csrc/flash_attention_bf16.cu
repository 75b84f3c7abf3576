// Flash-attention forward on bf16 q, k, v for Hopper (sm_90a), by hand.
//
// Replaces: src/repro/kernels/attention/kernel.py, flash_attention_pallas
// (kernel body _flash_kernel), on bf16 inputs: the instance that every LM
// main path runs (the gemma2-2b and qwen3-moe prefills, a train step's
// frozen prefix). The TPU kernel upcasts q, k, v to fp32 and keeps P in
// fp32 for P V; this kernel computes that function to the same tolerance
// (rtol 2e-4, atol 2e-5 against the fp32 plain version) on the bf16
// inputs read in place. fp32 inputs keep the 3xTF32 kernel
// (flash_attention.cu); the wrapper routes by dtype.
//
// What bounds it on this card: operations. At qwen3-moe's prefill shape
// q [4, 512, 32, 128], k/v [4, 512, 4, 128], causal, the 131,328 unmasked
// (query, key) pairs a head take 4 hd operations each, 8.6 GFLOP, 8.7 us
// at the dense bf16 peak (989 TFLOP/s), where q, k, v in bf16 and o out
// move 29-38 MB, 8.8-11.3 us at 3.35 TB/s; the design's own work is 1.5x
// those operations (P V runs twice, below).
//
// Arithmetic. A bf16 x bf16 product is exact in fp32, so S = Q K^T takes
// one bf16 tensor-core product with fp32 accumulation, where the fp32
// kernel issues three TF32 products and the splits. The online softmax is
// fp32 with the accurate expf, as in the fp32 kernel. P in [0, 1] is not
// bf16: rounded to one bf16 term P V misses the tolerance by 100x (a CPU
// emulation, tests/test_torch_kernels.py), so P is split into
// hi = rn_bf16(P) and lo = rn_bf16(P - hi), which hold P to about 2^-17 of
// itself, and O += lo V + hi V: two products over the exact bf16 V. The
// output is written once, in fp32 or in bf16 (rounded once from the fp32
// result with __float2bfloat16_rn), as the caller asks.
//
// Design: one block a (batch * q head, 64-row q tile), 4 warps of 16 query
// rows (one warpgroup), the order of tiles reversed so the causal blocks
// with the most kv tiles start first. K and V tiles of BK keys (64; 32 at
// hd 256, where 64 would leave room for one block an SM) go to shared
// memory by cp.async in two buffers, the next tile's copy issued before
// this tile's products; Q's 64 x hd tile is copied once.
// - hd 64, 128, 256 (`flash_bf16_wgmma_kernel`): both products are wgmma.
//   Tiles sit in shared memory in the 128-byte swizzle, as hd / 64 regions
//   of [rows][64]. S = Q K^T is m64n{BK}k16 with Q and K read from shared
//   memory (K-major); O += P V is m64n64k16 for each 64-wide region of d,
//   A = P's terms from registers, B = V read from shared memory MN-major.
//   No Q fragment is held in registers, which leaves hd 256's 128
//   accumulator registers room (211 registers, no spill; 2 blocks an SM).
// - hd 16 and 32 (`flash_bf16_kernel`), below wgmma's 64-wide swizzle
//   rows: mma.sync m16n8k16 from ldmatrix fragments, rows padded to hd + 8
//   elements (the 8 row addresses of an ldmatrix on 8 bank groups), Q's
//   fragments in registers, V by ldmatrix.trans.
// In both, P feeds O += P V straight from the S accumulators: two adjacent
// 8-key accumulator tiles are the A operand of one 16-key step (the
// m16n8k16 layout, which wgmma's register A shares warp by warp), so no
// shuffle and no shared memory lie between the two products. Row max
// and row sum are taken across the quad of lanes that share a row
// (__shfl_xor_sync 1, 2; the sum once, at the end). Masks: causal, window
// and the true Sk (keys past Sk are zero-filled by cp.async and masked),
// with NEG_INF = -1e30 as in the reference, applied only on tiles the
// block's indices say are cut; tiles masked whole are skipped. GQA reads
// kv head h / (Hq / Hkv). q, k, v are read through their [B, S, H, hd]
// strides (a fused qkv projection's views need no copy).
//
// Tried and not kept (PERF.md): the K/V ring filled by TMA with mbarrier
// completion, from a producer warp (its fifth warp's registers made hd 256
// spill) or from one thread of the warpgroup (faster at hd 128, slower at
// hd 256).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the reference's mask value
constexpr int NW = 4;              // warps per block, 16 query rows each
constexpr int BQ = 16 * NW;        // query rows per block

// keys per kv tile: 64, and 32 at hd 256, where two 64-key buffers of K
// and V beside Q would allow one block an SM
template <int HD>
__host__ __device__ constexpr int kv_tile() {
  return HD >= 256 ? 32 : 64;
}
// blocks an SM the register budget is sized for (ptxas holds a thread to
// 65536 / (128 x this) registers)
template <int HD>
__host__ __device__ constexpr int min_blocks() {
  return HD <= 32 ? 4 : HD <= 64 ? 3 : 2;
}
// hd >= 64 takes the wgmma kernel, hd 16 and 32 the mma.sync one
template <int HD>
constexpr bool uses_wgmma() {
  return HD >= 64;
}
template <int HD>
constexpr size_t smem_bytes() {
  // mma.sync: Q's [BQ][HD + 8], then [buf][K, V][BK][HD + 8]; wgmma: the
  // same without the padding, and 1024 bytes to align the swizzle
  return uses_wgmma<HD>()
             ? sizeof(bf16) * (BQ + 2 * 2 * kv_tile<HD>()) * HD + 1024
             : sizeof(bf16) * (BQ + 2 * 2 * kv_tile<HD>()) * (HD + 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i, and r[i] holds its rows lane/4, columns 2(lane%4), +1
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// the same, transposed: r[i] holds matrix i's rows 2(lane%4), +1 at
// column lane/4
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a b on the tensor cores, bf16 operands, fp32 accumulator. A 16 x 16
// (a0: row g, cols 2t, 2t+1; a1: row g+8; a2: row g, cols 2t+8, 2t+9; a3:
// row g+8, the same), B 16 x 8 (b0: rows 2t, 2t+1 at col g; b1: rows 2t+8,
// 2t+9), C 16 x 8 (c0, c1: row g, cols 2t, 2t+1; c2, c3: row g+8), with
// g = lane / 4, t = lane % 4 and the lower index in the low half
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) rounded to bf16, x in the low half
__device__ __forceinline__ uint32_t pack(float x, float y) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&r);
}

// P's two bf16 terms for an (x, y) pair: hi = rn(P), lo = rn(P - hi)
__device__ __forceinline__ void split(float x, float y, uint32_t& hi,
                                      uint32_t& lo) {
  hi = pack(x, y);
  lo = pack(x - __uint_as_float(hi << 16),
            y - __uint_as_float(hi & 0xffff0000u));
}

// copy 16 bytes global -> shared, or write zeros when `in` is false
__device__ __forceinline__ void cp16(bf16* dst, const bf16* src, bool in) {
  tf32x3::cp_async<16>(reinterpret_cast<float*>(dst),
                       reinterpret_cast<const float*>(src), in);
}

// kv tiles a block needs: the fp32 kernel's skip tests, on the block's
// indices, so every thread runs the same loop
__device__ __forceinline__ void kv_range(int q_lo, int Sk, int BK,
                                         int causal, int window,
                                         int& t_begin, int& t_end) {
  const int nk = (Sk + BK - 1) / BK;
  t_end = causal ? min(nk, (q_lo + BQ - 1) / BK + 1) : nk;
  t_begin = window ? max(q_lo - window + 1, 0) / BK : 0;
}

// The online softmax over one tile's S accumulators: this lane's rows
// row0 (c0, c1) and row0 + 8 (c2, c3), accumulator tile j at keys
// k_lo + 8j + 2t, +1. Scales, caps and (where the block's indices say a
// key of the tile is cut) masks the scores, updates the running max `m`
// and this lane's share of the row sums `l`, leaves exp(s - m) in `s`
// and the factor O must be rescaled by in `corr`.
template <int NS>
__device__ __forceinline__ void online_softmax(
    float (&s)[NS][4], float (&m)[2], float (&l)[2], float (&corr)[2],
    int row0, int t, int q_lo, int k_lo, int BK, int Sk, int causal,
    int window, float softcap, float scale) {
  const bool cut = k_lo + BK > Sk || (causal && k_lo + BK - 1 > q_lo) ||
                   (window && q_lo + BQ - 1 - k_lo >= window);
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float x = s[j][i] * scale;
      if (softcap != 0.f) x = softcap * tanhf(x / softcap);
      if (cut) {
        const int qp = row0 + 8 * (i >> 1);
        const int kp = k_lo + 8 * j + 2 * t + (i & 1);
        bool live = kp < Sk;
        if (causal) live = live && kp <= qp;
        if (window) live = live && (qp - kp) < window;
        x = live ? x : NEG_INF;
      }
      s[j][i] = x;
      mx[i >> 1] = fmaxf(mx[i >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 lanes of a quad (same g) hold one row between them
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = expf(m[r] - m_new);
    m[r] = m_new;
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[j][i] = expf(s[j][i] - m[i >> 1]);
      l[i >> 1] += s[j][i];
    }
}

// P's terms for the 16-key step kk: A of m16n8k16 (and of wgmma's k16,
// each warp its 16 rows) from S accumulator tiles 2kk and 2kk + 1
template <int NS>
__device__ __forceinline__ void p_terms(const float (&s)[NS][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
  split(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
  split(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
  split(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
}

// o's rows row0, row0 + 8 of this lane: O / l, written once in fp32 or
// bf16
template <int HD>
__device__ __forceinline__ void store_o(const float (&acc)[HD / 8][4],
                                        float (&l)[2], void* o, int b,
                                        int h, int Sq, int Hq, int row0,
                                        int t, int out_bf16) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = row0 + 8 * r;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
    const long long row = ((static_cast<long long>(b) * Sq + s) * Hq + h) *
                          HD + 2 * t;
    if (out_bf16) {
      bf16* orow = static_cast<bf16*>(o) + row;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * nd) =
            __floats2bfloat162_rn(acc[nd][2 * r] / denom,
                                  acc[nd][2 * r + 1] / denom);
    } else {
      float* orow = static_cast<float*>(o) + row;
#pragma unroll
      for (int nd = 0; nd < HD / 8; ++nd)
        *reinterpret_cast<float2*>(orow + 8 * nd) =
            make_float2(acc[nd][2 * r] / denom, acc[nd][2 * r + 1] / denom);
    }
  }
}

// ---------------------------------------------------------------------------
// hd 16 and 32: mma.sync m16n8k16 from ldmatrix fragments

template <int HD>
__global__ void __launch_bounds__(NW * 32, min_blocks<HD>())
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, void* __restrict__ o,
                  int Sq, int Sk, int Hq, int group,
                  long long qsb, long long qss, long long qsh,
                  long long ksb, long long kss, long long ksh,
                  long long vsb, long long vss, long long vsh,
                  int causal, int window, float softcap, float scale,
                  int out_bf16) {
  using tf32x3::cp_async_commit;
  using tf32x3::cp_async_wait;
  constexpr int BK = kv_tile<HD>();
  constexpr int LD = HD + 8;    // shared-memory row pitch, elements
  constexpr int KS = HD / 16;   // 16-wide steps over hd in S = Q K^T
  constexpr int NS = BK / 8;    // 8-key accumulator tiles of S
  constexpr int KP = BK / 16;   // 16-key steps of O += P V
  constexpr int ND = HD / 8;    // 8-wide accumulator tiles of O
  constexpr int THREADS = NW * 32;
  constexpr int CHUNKS = HD / 8;  // 16-byte units in a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [BQ][LD]
  bf16* KV = Qs + BQ * LD;                       // [2][K, V][BK][LD]

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int row0 = q_lo + 16 * warp + g;  // c0/c1 rows; c2/c3 row0 + 8
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + (h / group) * ksh;
  const bf16* vb = v + b * vsb + (h / group) * vsh;
  int t_begin, t_end;
  kv_range(q_lo, Sk, BK, causal, window, t_begin, t_end);

  auto stage = [&](int tile, int buf) {
    bf16* Ks = KV + buf * 2 * BK * LD;
    bf16* Vs = Ks + BK * LD;
    for (int c = threadIdx.x; c < BK * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
      const int s = tile * BK + r;
      const bool in = s < Sk;  // rows past Sk are zero-filled
      const long long sr = in ? s : 0;
      cp16(Ks + r * LD + col, kb + sr * kss + col, in);
      cp16(Vs + r * LD + col, vb + sr * vss + col, in);
    }
    cp_async_commit();
  };

  // this lane's ldmatrix addresses: A (Q) rows lane%8 + 8((lane/8)%2),
  // columns 8(lane/16); B of S (K) keys lane%8 + 8(lane/16), columns
  // 8((lane/8)%2); B of P V (V, transposed) keys lane%8 + 8((lane/8)%2),
  // columns 8(lane/16)
  const int lr = lane & 7, lh = (lane >> 3) & 1, lq = lane >> 4;
  const bf16* q_frag = Qs + (16 * warp + lr + 8 * lh) * LD + 8 * lq;
  const int k_frag = (lr + 8 * lq) * LD + 8 * lh;
  const int v_frag = (lr + 8 * lh) * LD + 8 * lq;

  float m[2] = {NEG_INF, NEG_INF};  // running max of rows row0, row0+8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float acc[ND][4];                 // O, 16 x hd, as ND accumulator tiles
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;
  uint32_t qf[KS][4];  // this warp's Q fragments

  if (t_begin < t_end) {
    // Q's tile (rows past Sq zero-filled), a group of its own
    for (int c = threadIdx.x; c < BQ * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
      const int s = q_lo + r;
      const bool in = s < Sq;
      const long long sr = in ? s : 0;
      cp16(Qs + r * LD + col, qb + sr * qss + col, in);
    }
    cp_async_commit();
    stage(t_begin, 0);
    cp_async_wait<1>();  // Q's group; the first kv tile may be in flight
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) ldsm_x4(qf[kk], q_frag + 16 * kk);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, buf ^ 1);  // in flight while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile's K and V are in shared memory
    const bf16* Ks = KV + buf * 2 * BK * LD;
    const bf16* Vs = Ks + BK * LD;

    // S = Q K^T: accumulator tile j covers keys 8j..8j+7
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];  // b0, b1 of tiles 2jp and 2jp + 1
        ldsm_x4(kf, Ks + k_frag + 16 * jp * LD + 16 * kk);
        mma(s[2 * jp], qf[kk], kf[0], kf[1]);
        mma(s[2 * jp + 1], qf[kk], kf[2], kf[3]);
      }

    float corr[2];
    online_softmax(s, m, l, corr, row0, t, q_lo, tile * BK, BK, Sk, causal,
                   window, softcap, scale);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= corr[i >> 1];

    // O += P V over 16-key steps, B = V read transposed
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) {
      uint32_t hi[4], lo[4];
      p_terms(s, kk, hi, lo);
#pragma unroll
      for (int np = 0; np < ND / 2; ++np) {
        uint32_t vf[4];  // b0, b1 of tiles 2np and 2np + 1
        ldsm_x4_t(vf, Vs + v_frag + 16 * kk * LD + 16 * np);
        mma(acc[2 * np], lo, vf[0], vf[1]);
        mma(acc[2 * np + 1], lo, vf[2], vf[3]);
        mma(acc[2 * np], hi, vf[0], vf[1]);
        mma(acc[2 * np + 1], hi, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
  store_o<HD>(acc, l, o, b, h, Sq, Hq, row0, t, out_bf16);
}

// ---------------------------------------------------------------------------
// hd 64, 128, 256: wgmma, the four warps one warpgroup

// A [rows][hd] tile in shared memory as hd / 64 regions of [rows][64]:
// rows of 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8) (the 128-byte swizzle wgmma's descriptors name), regions
// 1024-byte aligned. The element offset of (r, col):
__device__ __forceinline__ int swizzled(int r, int col, int rows) {
  return (col >> 6) * rows * 64 + r * 64 +
         ((((col >> 3) & 7) ^ (r & 7)) << 3) + (col & 7);
}

// a shared-memory matrix descriptor, 128-byte swizzle: the start address,
// the leading and stride byte offsets (16-byte units). K-major (Q, K): 8
// rows of 128 bytes an 8 x 64 atom, atoms 1024 bytes apart (stride), the
// k16 step at +32 bytes inside a row. MN-major (V): 64 values of d a row,
// rows (keys) 128 bytes apart, 8-key groups 1024 bytes apart (stride),
// 64-wide regions of d `lbo` apart (leading)
__device__ __forceinline__ uint64_t sdesc(const bf16* p, uint32_t lbo) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keep the compiler from moving register reads or writes across a
// wgmma's issue and wait
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define WG_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d += A B, m64n64k16, A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(a), "l"(b), "r"(1));
}
// d += A B, m64n32k16, A and B from shared memory (K-major both)
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}"
      : WG_D8(0), WG_D8(8)
      : "l"(a), "l"(b), "r"(1));
}
// d += A B, m64n64k16, A from registers (each warp its 16 rows, the
// m16n8k16 layout), B from shared memory MN-major (transposed)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
#undef WG_D8

template <int HD>
__global__ void __launch_bounds__(NW * 32, min_blocks<HD>())
flash_bf16_wgmma_kernel(const bf16* __restrict__ q,
                        const bf16* __restrict__ k,
                        const bf16* __restrict__ v, void* __restrict__ o,
                        int Sq, int Sk, int Hq, int group,
                        long long qsb, long long qss, long long qsh,
                        long long ksb, long long kss, long long ksh,
                        long long vsb, long long vss, long long vsh,
                        int causal, int window, float softcap, float scale,
                        int out_bf16) {
  using tf32x3::cp_async_commit;
  using tf32x3::cp_async_wait;
  constexpr int BK = kv_tile<HD>();
  constexpr int KS = HD / 16;   // 16-wide steps over hd in S = Q K^T
  constexpr int NS = BK / 8;    // 8-key accumulator tiles of S
  constexpr int KP = BK / 16;   // 16-key steps of O += P V
  constexpr int ND = HD / 8;    // 8-wide accumulator tiles of O
  constexpr int NR = HD / 64;   // 64-wide regions of hd
  constexpr int THREADS = NW * 32;
  constexpr int CHUNKS = HD / 8;  // 16-byte units in a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // 1024-byte aligned for the swizzle: Q [BQ][HD], then [2][K, V][BK][HD]
  bf16* Qs = reinterpret_cast<bf16*>(
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023));
  bf16* KV = Qs + BQ * HD;

  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest first
  const int row0 = q_lo + 16 * warp + g;  // wgmma gives warp w rows 16w..
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + (h / group) * ksh;
  const bf16* vb = v + b * vsb + (h / group) * vsh;
  int t_begin, t_end;
  kv_range(q_lo, Sk, BK, causal, window, t_begin, t_end);

  auto stage = [&](int tile, int buf) {
    bf16* Ks = KV + buf * 2 * BK * HD;
    bf16* Vs = Ks + BK * HD;
    for (int c = threadIdx.x; c < BK * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
      const int s = tile * BK + r;
      const bool in = s < Sk;  // rows past Sk are zero-filled
      const long long sr = in ? s : 0;
      cp16(Ks + swizzled(r, col, BK), kb + sr * kss + col, in);
      cp16(Vs + swizzled(r, col, BK), vb + sr * vss + col, in);
    }
    cp_async_commit();
  };

  float m[2] = {NEG_INF, NEG_INF};  // running max of rows row0, row0+8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float acc[ND][4];                 // O: NR wgmma accumulators of 32
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nd][i] = 0.f;

  if (t_begin < t_end) {
    // Q's tile (rows past Sq zero-filled), committed with the first kv tile
    for (int c = threadIdx.x; c < BQ * CHUNKS; c += THREADS) {
      const int r = c / CHUNKS, col = 8 * (c % CHUNKS);
      const int s = q_lo + r;
      const bool in = s < Sq;
      const long long sr = in ? s : 0;
      cp16(Qs + swizzled(r, col, BQ), qb + sr * qss + col, in);
    }
    stage(t_begin, 0);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    const int buf = (tile - t_begin) & 1;
    if (tile + 1 < t_end) {
      stage(tile + 1, buf ^ 1);  // in flight while this tile is computed
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // cp.async wrote through the generic proxy; wgmma reads through the
    // async one
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // this tile's K and V are in shared memory
    const bf16* Ks = KV + buf * 2 * BK * HD;
    const bf16* Vs = Ks + BK * HD;

    // S = Q K^T: accumulator tile j covers keys 8j..8j+7
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
    auto& sd = reinterpret_cast<float(&)[NS * 4]>(s);
    hold(sd);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // column 16kk of Q and K: region kk / 4, 32 bytes a step inside it
      const uint64_t da = sdesc(Qs + (kk >> 2) * BQ * 64 + 16 * (kk & 3), 16);
      const uint64_t db = sdesc(Ks + (kk >> 2) * BK * 64 + 16 * (kk & 3), 16);
      if constexpr (BK == 64)
        wgmma_ss64(sd, da, db);
      else
        wgmma_ss32(sd, da, db);
    }
    wg_commit();
    wg_wait0();
    hold(sd);

    float corr[2];
    online_softmax(s, m, l, corr, row0, t, q_lo, tile * BK, BK, Sk, causal,
                   window, softcap, scale);
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nd][i] *= corr[i >> 1];

    // O += P V: P's terms of every 16-key step first (the registers a
    // wgmma reads must hold until its wait), then lo V and hi V for each
    // step and 64-wide region of d; B = V MN-major, step kk 16 keys
    // (2048 bytes) in
    uint32_t hi[KP][4], lo[KP][4];
#pragma unroll
    for (int kk = 0; kk < KP; ++kk) p_terms(s, kk, hi[kk], lo[kk]);
    auto& ad = reinterpret_cast<float(&)[NR][32]>(acc);
#pragma unroll
    for (int nr = 0; nr < NR; ++nr) hold(ad[nr]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < KP; ++kk)
#pragma unroll
      for (int nr = 0; nr < NR; ++nr) {
        const uint64_t dv = sdesc(Vs + nr * BK * 64 + 16 * kk * 64,
                                  BK * 64 * sizeof(bf16));
        wgmma_rs64(ad[nr], lo[kk], dv);
        wgmma_rs64(ad[nr], hi[kk], dv);
      }
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nr = 0; nr < NR; ++nr) hold(ad[nr]);
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }
  store_o<HD>(acc, l, o, b, h, Sq, Hq, row0, t, out_bf16);
}

template <int HD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, void* o,
                   int B, int Sq, int Sk, int Hq, int Hkv,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   int causal, int window, float softcap, float scale,
                   int out_bf16, cudaStream_t stream) {
  using Kernel = void (*)(const bf16*, const bf16*, const bf16*, void*, int,
                          int, int, int, long long, long long, long long,
                          long long, long long, long long, long long,
                          long long, long long, int, int, float, float, int);
  Kernel kernel;
  if constexpr (uses_wgmma<HD>())
    kernel = flash_bf16_wgmma_kernel<HD>;
  else
    kernel = flash_bf16_kernel<HD>;
  constexpr size_t smem = smem_bytes<HD>();
  if constexpr (smem > 48 * 1024) {  // past the default limit: hd 128, 256
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  kernel<<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, Sq, Sk, Hq, Hq / Hkv, qsb, qss, qsh, ksb, kss, ksh,
      vsb, vss, vsh, causal, window, softcap, scale, out_bf16);
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] bf16 with unit stride on hd and the
// given element strides on batch, sequence and head, all multiples of 8,
// 16-byte aligned; o [B,Sq,Hq,hd] contiguous, fp32 or (out_bf16) bf16.
// Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_bf16_fwd(
    const void* q, const void* k, const void* v, void* o,
    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, int window, float softcap, float scale, int out_bf16,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* qh = static_cast<const bf16*>(q);
  const bf16* kh = static_cast<const bf16*>(k);
  const bf16* vh = static_cast<const bf16*>(v);
#define FLASH_CASE(D)                                                       \
  case D:                                                                   \
    return launch<D>(qh, kh, vh, o, B, Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb, \
                     kss, ksh, vsb, vss, vsh, causal, window, softcap,      \
                     scale, out_bf16, st);
  switch (hd) {
    FLASH_CASE(16)
    FLASH_CASE(32)
    FLASH_CASE(64)
    FLASH_CASE(128)
    FLASH_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
