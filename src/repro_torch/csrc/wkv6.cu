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
// 3.35 TB/s. Its ~5n^2 operations per token and head (r.S, the decay and
// the outer product) are 1.7 GFLOP, 25 us at the published 67 TFLOP/s
// fp32. In practice it is bound by latency: the time loop is sequential
// and there are only B*H = 160 blocks of n = 64 threads, about one block
// of two warps per SM, so little is in flight to hide each step's
// dependent FMA chain and the next token's loads.
//
// Design: the TPU kernel keeps S in VMEM across a sequential time grid in
// blocks of up to 512 tokens and pads T with logw = 0, k = 0. Here one
// block owns one (b, h) and runs the whole time loop itself, so nothing
// is padded and the loop ends at the true T. Thread j keeps column j of S
// in registers (n floats). Each step a thread stages its own channel of
// (r, k, exp(logw), r*u*k) as one float4 in shared memory, one barrier
// later every thread reads all n of them as 16-byte broadcasts and updates
// its column. The staging buffer is double-buffered, so one barrier per
// step suffices, and the next token's inputs are loaded into registers
// before the step's arithmetic, so the loads are in flight while it runs.
// Inputs are read in place from the [B, T, H, n] layout (consecutive
// threads read consecutive channels), with no transpose. Everything is
// fp32 with the accurate expf (no fast math): the parity limit against
// the exact recurrence is rtol/atol 1e-4. No atomics: two launches on the
// same inputs agree bit for bit.

#include <cuda_runtime.h>

namespace {

template <int N>
__global__ void __launch_bounds__(N)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ logw,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ o, float* __restrict__ s_out, int T, int H) {
  __shared__ float4 stage[2][N];
  const int j = threadIdx.x;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const long long row = static_cast<long long>(H) * N;  // stride of t
  const long long base = static_cast<long long>(b) * T * row +
                         static_cast<long long>(h) * N + j;
  const long long s_base = static_cast<long long>(blockIdx.x) * N * N + j;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 ? s0[s_base + i * N] : 0.f;
  const float uj = u[h * N + j];

  float rn = 0.f, kn = 0.f, vn = 0.f, wn = 0.f;
  if (T > 0) {
    rn = r[base]; kn = k[base]; vn = v[base]; wn = logw[base];
  }
  for (int t = 0; t < T; ++t) {
    const float vj = vn;
    stage[t & 1][j] = make_float4(rn, kn, expf(wn), rn * uj * kn);
    __syncthreads();
    if (t + 1 < T) {  // the next token's loads overlap this step
      const long long at = base + (t + 1) * row;
      rn = r[at]; kn = k[at]; vn = v[at]; wn = logw[at];
    }
    float acc = 0.f, ruk = 0.f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float4 c = stage[t & 1][i];  // (r_i, k_i, w_i, r_i u_i k_i)
      acc = fmaf(c.x, S[i], acc);
      ruk += c.w;
      S[i] = fmaf(c.z, S[i], c.y * vj);
    }
    o[base + t * row] = fmaf(ruk, vj, acc);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) s_out[s_base + i * N] = S[i];
}

template <int N>
cudaError_t launch(const float* r, const float* k, const float* v,
                   const float* logw, const float* u, const float* s0,
                   float* o, float* s_out, int B, int T, int H,
                   cudaStream_t stream) {
  wkv6_kernel<N><<<B * H, N, 0, stream>>>(r, k, v, logw, u, s0, o, s_out,
                                          T, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C interface for ctypes. All tensors fp32, contiguous: r, k, v,
// logw and o [B, T, H, n]; u [H, n]; s0 (may be null) and s_out
// [B, H, n, n]. Returns the CUDA error of the launch (0 on success);
// cudaErrorInvalidValue for an n other than 16, 32 or 64.
extern "C" int wkv6_fwd(const float* r, const float* k, const float* v,
                        const float* logw, const float* u, const float* s0,
                        float* o, float* s_out, int B, int T, int H, int n,
                        cudaStream_t stream) {
  if (B <= 0 || H <= 0 || T < 0) return cudaErrorInvalidValue;
  switch (n) {
    case 16: return launch<16>(r, k, v, logw, u, s0, o, s_out, B, T, H, stream);
    case 32: return launch<32>(r, k, v, logw, u, s0, o, s_out, B, T, H, stream);
    case 64: return launch<64>(r, k, v, logw, u, s0, o, s_out, B, T, H, stream);
    default: return cudaErrorInvalidValue;
  }
}
