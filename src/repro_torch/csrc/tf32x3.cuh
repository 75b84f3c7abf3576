// fp32-accurate products on Hopper's tensor cores: the 3xTF32 step over
// mma.sync m16n8k8, its fragment layouts, and the cp.async staging both
// kernels use. Included by flash_attention.cu and cka_terms.cu, and by
// wkv6.cu for its cp.async helpers alone.
//
// A TF32 operand keeps 10 of fp32's 23 mantissa bits. Each fp32 operand a
// is split into big = tf32(a) (round to nearest, ties away: cvt.rna) and
// small = tf32(a - big), which together hold a to about 2^-22. A product
// a*b is then summed as small_a*big_b + big_a*small_b + big_a*big_b in the
// fp32 accumulator; the dropped small_a*small_b is below 2^-22 of |a*b|.
// Each partial product of two TF32 values is exact in fp32, so the result
// is as accurate as an fp32 FMA chain to within a few ulps, at three
// tensor-core products per fp32 product. This is the scheme of CUTLASS's
// OpMultiplyAddFastF32.

#pragma once

#include <cstdint>

namespace tf32x3 {

// ---------------------------------------------------------------------------
// the split

__device__ __forceinline__ uint32_t to_tf32(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return r;
}

__device__ __forceinline__ void split(float a, uint32_t& big,
                                      uint32_t& small) {
  big = to_tf32(a);
  small = to_tf32(a - __uint_as_float(big));
}

// ---------------------------------------------------------------------------
// m16n8k8 fragments (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32).
// Lane = 4 * g + t with g = lane / 4 (0..7) and t = lane % 4 (0..3).
//
// A, 16 x 8 (m x k), four registers: a[i] holds A[a_row(i)][a_col(i)]
//   a0 (g, t)   a1 (g+8, t)   a2 (g, t+4)   a3 (g+8, t+4)
// B, 8 x 8 (k x n), two registers: b[i] holds B[b_row(i)][b_col()]
//   b0 (t, g)   b1 (t+4, g)
// C and D, 16 x 8 (m x n), four fp32: c[i] holds C[c_row(i)][c_col(i)]
//   c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
__device__ __forceinline__ int a_row(int i) { return lane_g() + 8 * (i & 1); }
__device__ __forceinline__ int a_col(int i) { return lane_t() + 4 * (i >> 1); }
__device__ __forceinline__ int b_row(int i) { return lane_t() + 4 * i; }
__device__ __forceinline__ int b_col() { return lane_g(); }
__device__ __forceinline__ int c_row(int i) { return lane_g() + 8 * (i >> 1); }
__device__ __forceinline__ int c_col(int i) { return 2 * lane_t() + (i & 1); }

// An accumulator tile used again as the A operand of the next product
// (flash attention's P in O += P V). Its columns sit at 2t and 2t+1 of a
// thread, where A wants t and t+4; rather than move values between lanes,
// the product's k index is permuted: A column t is taken to be key 2t and
// column t+4 key 2t+1. Then a = (c0, c2, c1, c3), and B's row k must be
// read from key acc_key(k) of the tile (b0: key 2t, b1: key 2t+1). The
// sum over k is the same sum in another order.
__device__ __forceinline__ int acc_key(int k) {
  return k < 4 ? 2 * k : 2 * (k - 4) + 1;
}

// d += a * b on the tensor cores, TF32 operands, fp32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a * b to fp32 accuracy from split operands, the two small
// products first, as CUTLASS orders them
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4],
                                     const uint32_t (&b_big)[2],
                                     const uint32_t (&b_small)[2]) {
  mma(d, a_small, b_big);
  mma(d, a_big, b_small);
  mma(d, a_big, b_big);
}

// ---------------------------------------------------------------------------
// cp.async staging (global -> shared, bypassing registers)

// copy `bytes` (4 or 16, the size of the aligned unit) from src to dst,
// or write zeros there when `in` is false; src is then not read
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool in) {
  static_assert(BYTES == 4 || BYTES == 16, "cp.async copies 4 or 16 bytes");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = in ? BYTES : 0;
  if (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(d), "l"(src), "r"(n) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace tf32x3
