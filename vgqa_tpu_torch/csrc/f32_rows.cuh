// Float32 attention with one query row per thread (FFMA, nothing rounded),
// shared by K2's f32 kernel (kernels.cu: window_attn_f32_kernel) and K3's
// f32 forward (flash_attention.cu: train_fwd_f32_kernel).
//
// A block of QT threads owns QT query rows of one (batch row, head); each
// thread holds its q and output accumulator in registers (D + D floats).
// Keys and values stream through shared memory in chunks of F32_KC = 32
// (every thread reads the same key row: a broadcast), and the softmax is
// online (running max and sum in f32). What the two kernels do apart is a
// policy object `pol`:
//   pol.stage(k0)        all threads, once the chunk's K and V are staged:
//                        the chunk's key terms into the policy's shared memory;
//   pol.keep(k0)         active threads: the chunk's keep bits (bit j for key
//                        k0 + j; ~0u without dropout);
//   pol.logit(dot, j)    the logit of key k0 + j from its dot product with q;
//   Pol::expb(x)         the exponential in the logits' base (e or 2).
// A dropped key still counts in the softmax sum, as in the JAX kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vgqa_f32 {

constexpr int F32_KC = 32;     // keys per streamed chunk (one keep-bit word)

template <int D, int QT, class Pol>
__device__ __forceinline__ void row_attention(const float* kb, long long k_row,
                                              const float* vb, long long v_row, int Lk,
                                              const float (&q)[D], float (&o)[D], float& m,
                                              float& l, bool active, Pol& pol) {
  __shared__ __align__(16) float Kc[F32_KC][D];
  __shared__ __align__(16) float Vc[F32_KC][D];
  const int tid = threadIdx.x;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = 0.f;
  m = -INFINITY;
  l = 0.f;

  for (int k0 = 0; k0 < Lk; k0 += F32_KC) {
    __syncthreads();                    // the previous chunk is consumed
    for (int i = tid; i < F32_KC * (D / 4); i += QT) {
      const int j = i / (D / 4), c4 = (i % (D / 4)) * 4;
      const bool ok = k0 + j < Lk;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(&Kc[j][c4]) =
          ok ? *reinterpret_cast<const float4*>(kb + (k0 + j) * k_row + c4) : z;
      *reinterpret_cast<float4*>(&Vc[j][c4]) =
          ok ? *reinterpret_cast<const float4*>(vb + (k0 + j) * v_row + c4) : z;
    }
    pol.stage(k0);
    __syncthreads();
    if (!active) continue;

    const uint32_t keep = pol.keep(k0);
    float s[F32_KC];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < F32_KC; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 kv = *reinterpret_cast<const float4*>(&Kc[j][d]);
        dot = fmaf(q[d], kv.x, dot);
        dot = fmaf(q[d + 1], kv.y, dot);
        dot = fmaf(q[d + 2], kv.z, dot);
        dot = fmaf(q[d + 3], kv.w, dot);
      }
      s[j] = pol.logit(dot, j);
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float c = Pol::expb(m - mn);
    l *= c;
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] *= c;
#pragma unroll
    for (int j = 0; j < F32_KC; ++j) {
      float pj = Pol::expb(s[j] - mn);
      l += pj;
      if (!(keep >> j & 1u)) pj = 0.f;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        const float4 vv = *reinterpret_cast<const float4*>(&Vc[j][d]);
        o[d] = fmaf(pj, vv.x, o[d]);
        o[d + 1] = fmaf(pj, vv.y, o[d + 1]);
        o[d + 2] = fmaf(pj, vv.z, o[d + 2]);
        o[d + 3] = fmaf(pj, vv.w, o[d + 3]);
      }
    }
    m = mn;
  }
}

}  // namespace vgqa_f32
