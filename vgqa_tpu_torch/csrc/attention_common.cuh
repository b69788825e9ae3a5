// Device helpers shared by the attention kernels (flash_attention.cu: K3's
// forward; flash_train.cu: K3's backward; the Hopper kernels of K2, K4 and
// K5 take the bf16 pairs, quad reductions and ex2): bf16 pairs, mma.sync
// m16n8k16, quad reductions, ex2, cp.async and ldmatrix.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace vgqa_attn {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ldp(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ __forceinline__ uint32_t pk(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16 row) * b (16x8 col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float qmax(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float qsum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// 2^x in one MUFU instruction (flushes subnormal results to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A fragments (16 rows x D dims) of rows r0/r1 (r1 = r0 + 8)
template <int D>
__device__ __forceinline__ void load_q(uint32_t (&a)[D / 16][4], const bf16* base, long long ld,
                                       int r0, int r1, bool v0, bool v1, int t) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = v0 ? ldp(base + r0 * ld + c) : 0u;
    a[ks][1] = v1 ? ldp(base + r1 * ld + c) : 0u;
    a[ks][2] = v0 ? ldp(base + r0 * ld + c + 8) : 0u;
    a[ks][3] = v1 ? ldp(base + r1 * ld + c + 8) : 0u;
  }
}

// 16-byte (or `bytes`-byte) asynchronous copy; an invalid source zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Rows [r0, r0 + rows) of one head (D bf16 at stride ld) into a
// [rows][D + 8] tile, asynchronously; rows at or past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long ld, int r0,
                                          int L, int rows = 64) {
  for (int i = threadIdx.x; i < rows * (D / 8); i += blockDim.x) {
    const int j = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const bool ok = r0 + j < L;
    cp_async16(tile + j * (D + 8) + c8, ok ? base + (long long)(r0 + j) * ld + c8 : base, ok);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// S (16 x 8*NT) = A (16 x D) * B^T, B rows [8*NT][D + 8] in shared memory
template <int D, int NT>
__device__ __forceinline__ void mma_rows(float (&s)[NT][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* B, int g, int t) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* brow = B + (8 * j + g) * (D + 8) + 2 * t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma16816(s[j], a[ks], ldp(brow + ks * 16), ldp(brow + ks * 16 + 8));
  }
}

// acc (16 x D) += P (16 x 8*NT, accumulator layout, rounded to bf16) * V,
// V rows [8*NT][D + 8] in shared memory; one ldmatrix.x4.trans gives the B
// fragments of two 8-dim column tiles
template <int D, int NT>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const float (&P)[NT][4],
                                        const bf16* V, int lane) {
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    const uint32_t a[4] = {pk(P[2 * kk][0], P[2 * kk][1]), pk(P[2 * kk][2], P[2 * kk][3]),
                           pk(P[2 * kk + 1][0], P[2 * kk + 1][1]),
                           pk(P[2 * kk + 1][2], P[2 * kk + 1][3])};
    const bf16* vrow = V + (16 * kk + (m & 1) * 8 + r) * (D + 8) + (m >> 1) * 8;
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_trans(b, vrow + np * 16);
      mma16816(acc[2 * np], a, b[0], b[1]);
      mma16816(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

}  // namespace vgqa_attn
