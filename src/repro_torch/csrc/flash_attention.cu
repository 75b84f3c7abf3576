// Flash-attention forward for Hopper (sm_90a), fp32, by hand.
//
// Replaces: src/repro/kernels/attention/kernel.py, flash_attention_pallas
// (kernel body _flash_kernel), the Pallas TPU kernel that the JAX ViT/BERT
// run under `use_pallas`. Same function: online-softmax attention with
// fp32 accumulation, causal mask, sliding window, logit softcap and GQA,
// skipping kv tiles that are masked whole.
//
// What bounds it on this card: operations. At the DeiT-tiny main-path
// shape q,k,v [16,197,3,64] one launch does 4*B*H*Sq*Sk*hd = 0.48 GFLOP
// and must move q, k, v in and o out, 9.7 MB. Against the published
// peaks (67 TFLOP/s fp32 on the CUDA cores, 3.35 TB/s) that is 7.1 us of
// arithmetic and 2.9 us of memory. The reference computes in full fp32 and
// the parity tolerance (rtol 2e-4, atol 2e-5) depends on it, so the
// products stay fp32 FMAs: no TF32 and no tensor cores in this version.
//
// Design: one block per (batch*q-head, 64-row q tile), 256 threads as a
// 16x16 grid. The q tile stays in shared memory; the loop walks 64-row kv
// tiles staged in shared memory. Each thread holds a 4x4 register tile of
// scores (rows 4*ty.., keys tx+16*j), so every shared-memory load feeds
// four FMAs; the row max and row sum of the online softmax are reduced
// across the 16 threads of a row group with warp shuffles, and each thread
// keeps the running max, sum and its 4 x hd/16 slice of the accumulator in
// registers. q, k and v are read in place from [B, S, H, hd] through their
// strides (no transposing copy); the kv head is h / (Hq / Hkv). Keys are
// masked by the true Sk, so a ragged last tile (197 = 3*64 + 5) needs no
// padding. Row pitches are padded by one float so that column reads are
// free of bank conflicts. Tiles are loaded synchronously: cp.async/TMA
// double buffering and wgmma are for a later version.

#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per kv tile
constexpr int THREADS = 256;   // 16 x 16
constexpr float NEG_INF = -1e30f;  // the reference's mask value

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (BQ * (HD + 1) + BK * (HD + 1) + BK * HD + BQ * (BK + 1));
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 int Sq, int Sk, int Hq, int group,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 int causal, int window, float softcap, float scale) {
  constexpr int QK_LD = HD + 1;
  constexpr int P_LD = BK + 1;
  constexpr int CPT = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;              // [BQ][QK_LD]
  float* Ks = Qs + BQ * QK_LD;   // [BK][QK_LD]
  float* Vs = Ks + BK * QK_LD;   // [BK][HD]
  float* Ps = Vs + BK * HD;      // [BQ][P_LD]

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / Hq, h = blockIdx.x % Hq;
  const int q_lo = blockIdx.y * BQ;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / group) * ksh;
  const float* vb = v + b * vsb + (h / group) * vsh;

  for (int i = tid; i < BQ * HD; i += THREADS) {
    const int r = i / HD, c = i % HD, s = q_lo + r;
    Qs[r * QK_LD + c] = s < Sq ? qb[s * qss + c] : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m[a] = NEG_INF;
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[a][c] = 0.f;
  }

  const int nk = (Sk + BK - 1) / BK;
  for (int t = 0; t < nk; ++t) {
    const int k_lo = t * BK;
    // the same skip test as the TPU kernel; it depends on the block's
    // indices only, so every thread takes the same branch
    if (causal && k_lo > q_lo + BQ - 1) break;  // later tiles are dead too
    if (window && k_lo + BK - 1 < q_lo - window + 1) continue;

    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int i = tid; i < BK * HD; i += THREADS) {
      const int r = i / HD, c = i % HD, s = k_lo + r;
      const bool in = s < Sk;
      Ks[r * QK_LD + c] = in ? kb[s * kss + c] : 0.f;
      Vs[r * HD + c] = in ? vb[s * vss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[a][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = Qs[(4 * ty + a) * QK_LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * QK_LD + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[a][j] = fmaf(qv[a], kv[j], s[a][j]);
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int qp = q_lo + 4 * ty + a;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k_lo + tx + 16 * j;
        float x = s[a][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        bool live = kp < Sk;
        if (causal) live = live && kp <= qp;
        if (window) live = live && (qp - kp) < window;
        s[a][j] = live ? x : NEG_INF;
        mx = fmaxf(mx, s[a][j]);
      }
      // the 16 threads of a row group are lanes 0-15 or 16-31 of a warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[a][j] - m_new);
        Ps[(4 * ty + a) * P_LD + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[a] = l[a] * corr + rs;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[a][c] *= corr;
      m[a] = m_new;
    }
    __syncthreads();  // Ps complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = Ps[(4 * ty + a) * P_LD + j];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[j * HD + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) acc[a][c] = fmaf(pv[a], vv, acc[a][c]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int s = q_lo + 4 * ty + a;
    if (s >= Sq) continue;
    const float denom = fmaxf(l[a], 1e-30f);
    float* orow = o + ((static_cast<long long>(b) * Sq + s) * Hq + h) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = acc[a][c] / denom;
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
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + BQ - 1) / BQ);
  flash_fwd_kernel<HD><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, Sq, Sk, Hq, Hq / Hkv, qsb, qss, qsh, ksb, kss, ksh,
      vsb, vss, vsh, causal, window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B,Sq,Hq,hd], k/v [B,Sk,Hkv,hd] fp32 with unit stride on hd and the
// given element strides on batch, sequence and head; o [B,Sq,Hq,hd] fp32
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
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_CASE
}
