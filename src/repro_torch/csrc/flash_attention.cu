// Flash-attention forward for Hopper (sm_90a), fp32-accurate, by hand.
//
// Replaces: src/repro/kernels/attention/kernel.py, flash_attention_pallas
// (kernel body _flash_kernel), the Pallas TPU kernel that the JAX ViT/BERT
// run under `use_pallas`. Same function: online-softmax attention with
// fp32 accumulation, causal mask, sliding window, logit softcap and GQA,
// skipping kv tiles that are masked whole. In the port it runs the
// ViT/BERT forwards (non-causal, hd 64) and the decoder LMs' prefill and
// feature forwards under `use_pallas` (causal, the layer's window, the
// logit softcap, GQA; gemma2-2b at hd 256) on fp32 inputs, where the JAX
// LMs take their plain dense or blockwise attention, which computes the
// same function. bf16 inputs no longer reach it: the wrapper sends them
// to flash_attention_bf16.cu, read in place; any other type is copied to
// fp32 for this kernel.
//
// What bounds it on this card: operations and bytes about equally. At the
// DeiT-tiny main-path shape q,k,v [16,197,3,64] one launch does
// 4*B*H*Sq*Sk*hd = 0.48 GFLOP and must move q, k, v in and o out, 9.7 MB.
// The parity tolerance (rtol 2e-4, atol 2e-5) needs fp32 accuracy, which
// one TF32 product (10 mantissa bits) does not give; three do (3xTF32,
// tf32x3.cuh). At the published 495 TFLOP/s of TF32 tensor cores the
// three products take 2.9 us, the bytes 2.9 us at 3.35 TB/s; the fp32
// CUDA cores (67 TFLOP/s) alone would need 7.1 us. At gemma2-2b's
// prefill, causal over 512 keys with hd 256, operations bound it.
//
// Design: both products run on the tensor cores as 3xTF32 mma.sync
// m16n8k8. One block per (batch*q-head, 64-row q tile); each warp owns
// 16 query rows, loads its Q fragments once, splits them into big and
// small TF32 parts and keeps them in registers for the whole kv loop. K
// and V tiles of 32 keys go to shared memory by cp.async into two buffers:
// the next tile's copy is issued before this tile's products. A row
// pitch of hd+4 words makes every fragment load free of bank conflicts
// (a warp reads K at rows g, columns t and V at rows 2t, 2t+1, columns
// g: its 32 lanes fall on 32 banks for each hd built). S =
// Q K^T stays in accumulator registers; the online softmax's row max and
// row sum are taken across the quad of lanes that share a row
// (__shfl_xor_sync 1, 2; the sum only once, at the end), in fp32 with the
// accurate expf. O += P V takes P straight from those registers: its
// columns are where the A operand wants them once the key order inside
// each 8-key step is permuted, and V's rows are read in the same order
// (tf32x3::acc_key), so no shuffle, no shared memory and no block barrier
// lie between the two products. q, k and v are read in place from
// [B, S, H, hd] through their strides; the kv head is h / (Hq / Hkv).
// Keys are masked by the true Sk, so a ragged last tile (197 = 6*32 + 5)
// needs no padding: its missing rows are zero-filled by cp.async. A block
// is 4 warps (64 query rows), which beat 2 warps (32 rows, 336 blocks) at
// the main-path shape (PERF.md). wgmma and TMA are for a later version.
//
// hd 256 (gemma2): the split Q fragments would take 2 * hd/8 * 4 = 256
// registers a thread beside O's 128 accumulators, past the 255 a thread
// may have, so ptxas would spill. At hd 256 only, Q's 64 x hd tile stays
// in shared memory (pitch hd+4, conflict-free for A's fragments: a warp
// reads rows g, g+8 at columns t, t+4, banks 4g + t), copied by cp.async
// with the first K/V tile, and each warp loads and splits its fragments
// for one 8-column step at a time, reused over the tile's 4 key steps.
// Shared memory: Q 64 x 260 x 4 = 66.6 KB beside K and V's 133.1 KB,
// 199.7 KB of the 227 KB a block may have: one block an SM. The sums
// run in the same order as from registers; the other head dims are
// built from the code as it was.

#include <cuda_runtime.h>

#include "tf32x3.cuh"

namespace {

constexpr float NEG_INF = -1e30f;  // the reference's mask value
// keys per kv tile: at 197 keys, 32 wastes 27 padded keys where 64 would
// waste 59, and keeps the score registers and shared memory small
constexpr int BK = 32;
constexpr int NW = 4;  // warps per block, 16 query rows each

// hd 256 keeps Q in shared memory, the others in registers (header)
template <int HD>
__host__ __device__ constexpr bool q_in_smem() {
  return HD >= 256;
}

template <int HD>
constexpr size_t smem_bytes() {
  // [buf][K, V][BK][HD + 4], then Q's [16 NW][HD + 4] where it is kept
  return sizeof(float) * (2 * 2 * BK + (q_in_smem<HD>() ? 16 * NW : 0)) *
         (HD + 4);
}

template <int HD>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Sk, int Hq, int group,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int window, float softcap, float scale) {
  using namespace tf32x3;
  constexpr int BQ = 16 * NW;        // query rows per block
  constexpr int LD = HD + 4;         // shared-memory row pitch
  constexpr int KD = HD / 8;         // 8-wide steps over hd
  constexpr int KN = BK / 8;         // 8-key steps over a tile
  constexpr int THREADS = NW * 32;
  constexpr bool QS = q_in_smem<HD>();
  extern __shared__ float smem[];    // [2 buffers][K, V][BK][LD], [Q]
  float* Qs = smem + 2 * 2 * BK * LD;  // [BQ][LD], used where QS

  const int warp = threadIdx.x / 32;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q_lo = blockIdx.y * BQ;
  // this lane's rows: row0 in c0/c1 of every tile, row0 + 8 in c2/c3
  const int row0 = q_lo + 16 * warp + lane_g();
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  // this warp's Q fragments, split once: A[m][d] = q[q_lo + 16 warp + m][d]
  // (in shared memory instead where QS)
  uint32_t qbig[QS ? 1 : KD][4], qsmall[QS ? 1 : KD][4];
  if constexpr (!QS) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int s = q_lo + 16 * warp + a_row(i);
        const float x = s < Sq ? qb[s * qss + 8 * kd + a_col(i)] : 0.f;
        split(x, qbig[kd][i], qsmall[kd][i]);
      }
  }

  // kv tiles this block needs: the same skip tests as the TPU kernel,
  // taken on the block's indices, so every thread runs the same loop
  const int nk = (Sk + BK - 1) / BK;
  int t_end = nk, t_begin = 0;
  if (causal) t_end = min(nk, (q_lo + BQ - 1) / BK + 1);
  if (window) t_begin = max(q_lo - window + 1, 0) / BK;

  auto stage = [&](int tile, int buf) {
    float* Ks = smem + buf * 2 * BK * LD;
    float* Vs = Ks + BK * LD;
    for (int c = threadIdx.x; c < BK * HD / 4; c += THREADS) {
      const int r = c / (HD / 4), col = 4 * (c % (HD / 4));
      const int s = tile * BK + r;
      const bool in = s < Sk;  // rows past Sk are zero-filled
      const long long sr = in ? s : 0;
      cp_async<16>(Ks + r * LD + col, kb + sr * kss + col, in);
      cp_async<16>(Vs + r * LD + col, vb + sr * vss + col, in);
    }
    cp_async_commit();
  };
  // Q's tile, rows past Sq zero-filled; committed with the first K/V tile
  auto stage_q = [&]() {
    for (int c = threadIdx.x; c < BQ * HD / 4; c += THREADS) {
      const int r = c / (HD / 4), col = 4 * (c % (HD / 4));
      const int s = q_lo + r;
      const bool in = s < Sq;
      const long long sr = in ? s : 0;
      cp_async<16>(Qs + r * LD + col, qb + sr * qss + col, in);
    }
  };

  float m[2] = {NEG_INF, NEG_INF};  // running max of rows row0, row0+8
  float l[2] = {0.f, 0.f};          // this lane's share of the row sums
  float acc[KD][4];                 // O, 16 x hd, as KD accumulator tiles
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[kd][i] = 0.f;

  if (t_begin < t_end) {
    if constexpr (QS) stage_q();
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
    __syncthreads();  // this tile's K and V are in shared memory
    const float* Ks = smem + buf * 2 * BK * LD;
    const float* Vs = Ks + BK * LD;

    // S = Q K^T: B[d][key] = K[key][d], n-tile kn covers keys 8kn..8kn+7
    float s[KN][4];
    if constexpr (QS) {
      // one 8-column step of Q at a time, over the tile's 4 key steps;
      // each s[kn] still sums over kd in ascending order
#pragma unroll
      for (int kn = 0; kn < KN; ++kn)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[kn][i] = 0.f;
      const float* Qw = Qs + 16 * warp * LD;
#pragma unroll 2
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t abig[4], asmall[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(Qw[a_row(i) * LD + 8 * kd + a_col(i)], abig[i], asmall[i]);
#pragma unroll
        for (int kn = 0; kn < KN; ++kn) {
          uint32_t bbig[2], bsmall[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            split(Ks[(8 * kn + b_col()) * LD + 8 * kd + b_row(i)], bbig[i],
                  bsmall[i]);
          mma3(s[kn], abig, asmall, bbig, bsmall);
        }
      }
    } else {
#pragma unroll
      for (int kn = 0; kn < KN; ++kn) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[kn][i] = 0.f;
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          uint32_t bbig[2], bsmall[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            split(Ks[(8 * kn + b_col()) * LD + 8 * kd + b_row(i)], bbig[i],
                  bsmall[i]);
          mma3(s[kn], qbig[kd], qsmall[kd], bbig, bsmall);
        }
      }
    }

    // online softmax over this tile's keys, rows row0 (c0, c1) and
    // row0 + 8 (c2, c3)
    const int k_lo = tile * BK;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int kn = 0; kn < KN; ++kn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = row0 + 8 * (i >> 1);
        const int kp = k_lo + 8 * kn + c_col(i);
        float x = s[kn][i] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool live = kp < Sk;
        if (causal) live = live && kp <= qp;
        if (window) live = live && (qp - kp) < window;
        s[kn][i] = live ? x : NEG_INF;
        mx[i >> 1] = fmaxf(mx[i >> 1], s[kn][i]);
      }
    float corr[2];
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
    for (int kn = 0; kn < KN; ++kn)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[kn][i] = expf(s[kn][i] - m[i >> 1]);
        l[i >> 1] += s[kn][i];
      }
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[kd][i] *= corr[i >> 1];

    // O += P V, k over the tile's keys: A = P from the S registers in the
    // permuted key order, B[key][d] = V[key][d] read in the same order
#pragma unroll
    for (int kn = 0; kn < KN; ++kn) {
      uint32_t pbig[4], psmall[4];
      const float pa[4] = {s[kn][0], s[kn][2], s[kn][1], s[kn][3]};
#pragma unroll
      for (int i = 0; i < 4; ++i) split(pa[i], pbig[i], psmall[i]);
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t bbig[2], bsmall[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          split(Vs[(8 * kn + acc_key(b_row(i))) * LD + 8 * kd + b_col()],
                bbig[i], bsmall[i]);
        mma3(acc[kd], pbig, psmall, bbig, bsmall);
      }
    }
    __syncthreads();  // every warp is done with `buf` before it is refilled
  }

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
    float* orow = o + ((static_cast<long long>(b) * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
      *reinterpret_cast<float2*>(orow + 8 * kd + c_col(2 * r)) =
          make_float2(acc[kd][2 * r] / denom, acc[kd][2 * r + 1] / denom);
  }
}

template <int HD>
cudaError_t launch(const float* q, const float* k, const float* v, float* o,
                   int B, int Sq, int Sk, int Hq, int Hkv,
                   long long qsb, long long qss, long long qsh,
                   long long ksb, long long kss, long long ksh,
                   long long vsb, long long vss, long long vsh,
                   int causal, int window, float softcap, float scale,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  if constexpr (smem > 48 * 1024) {  // past the default limit: hd 128, 256
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  constexpr int BQ = 16 * NW;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<HD><<<grid, NW * 32, smem, stream>>>(
      q, k, v, o, Sq, Sk, Hq, Hq / Hkv, qsb, qss, qsh, ksb, kss, ksh,
      vsb, vss, vsh, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] fp32 with unit stride on hd and the
// given element strides on batch, sequence and head; k and v (and q at
// hd 256) 16-byte aligned with strides that are multiples of 4; o [B,Sq,Hq,hd] fp32
// contiguous. Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_fwd(
    const float* q, const float* k, const float* v, float* o,
    int B, int Sq, int Sk, int Hq, int Hkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, int window, float softcap, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FLASH_CASE(D)                                                       \
  case D:                                                                   \
    return launch<D>(q, k, v, o, B, Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb,    \
                     kss, ksh, vsb, vss, vsh, causal, window, softcap,      \
                     scale, st);
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
