// Serving attention forward, behind a plain C interface: the port of
// vgqa_tpu/ops/pallas/flash_attention.py (K4 flash_attention / flash_mha,
// Pallas _flash_kernel; K5 flash_gqa_causal, Pallas _flash_gqa_causal_kernel).
//
// One kernel template, attn_fwd_kernel<D, CAUSAL>, instantiated for K4 at
// D = 64 (non-causal) and K5 at D = 128 (causal): a block of 4 warps owns
// one (batch row, query head, tile of 64 queries); each warp holds 16 query
// rows as mma.sync A fragments, keys and values stream through shared memory
// in blocks of 64 rows, double-buffered with cp.async (the next block loads
// while the current one computes), S = q k^T and P V run on the tensor cores
// (m16n8k16, bf16 in, f32 accumulate; V's fragments come from its row-major
// tile through ldmatrix.trans) and the softmax is online (running max and
// sum in f32), so neither the [Lq, Lk] logits nor the probabilities reach
// device memory and any key length fits. P is rounded to bf16 as the P V
// operand, as the Pallas kernels do on the TPU.
//
// Operands are addressed by strides, so the callers pass views:
//   q[b, h, i, d] = q + b*q_sb + h*q_sh + i*q_sl + d   (d contiguous)
//   k[b, hk, j, d], v likewise with hk = h / group (GQA: no repeat of K/V)
//   out[b, h, i, d] likewise.
// Rows must be 16-byte aligned (the loads move 8 bf16 at a time).
//
// K4 (CAUSAL = false): keys whose mask byte is 0 get -1e30 (finite, as in
// Pallas); keys past Lk do not exist (-inf). A row whose keys are all masked
// therefore averages V over its Lk keys.
// K5 (CAUSAL = true): query row i sits at position q_offset + i; a key j is
// masked (-1e30) when j > q_offset + i or j >= length, where length is read
// from device memory (no host sync). Key blocks past the tile's causal
// frontier, and past length when length >= 1, are never read: with
// length >= 1 key 0 is valid for every row, so the skipped keys would only
// have added exact zeros.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int AWARPS = 4;
constexpr int AQT = 16 * AWARPS;      // query rows per block
constexpr int AKB = 64;               // keys per streamed block
constexpr float A_NEG = -1e30f;

// shared memory: two stages of K and V tiles [64][D + 8] and the key flags
template <int D>
constexpr int smem_bytes() { return 2 * 2 * AKB * (D + 8) * 2 + 2 * AKB; }

struct AttnParams {
  const bf16* q; const bf16* k; const bf16* v; bf16* out;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  const unsigned char* mask;   // K4: [B, Lk], nonzero = attend, or null
  const int* length;           // K5: valid keys, on the device
  int group, Lq, Lk, q_offset;
  float scale;
};

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(valid ? 16 : 0));
}

// Rows [r0, r0 + 64) of one head into a [64][D + 8] tile, asynchronously;
// rows at or past L are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* rows, const bf16* base, long long ld, int r0,
                                          int L) {
  for (int i = threadIdx.x; i < AKB * (D / 8); i += blockDim.x) {
    const int j = i / (D / 8), c8 = (i % (D / 8)) * 8;
    const bool ok = r0 + j < L;
    cp_async16(rows + j * (D + 8) + c8, ok ? base + (long long)(r0 + j) * ld + c8 : base, ok);
  }
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// 16x64 S tile = A (16 x D) * B^T, B rows [64][D + 8] in shared memory
template <int D>
__device__ __forceinline__ void mma_rows(float (&s)[8][4], const uint32_t (&a)[D / 16][4],
                                         const bf16* B, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* brow = B + (8 * j + g) * (D + 8) + 2 * t;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      mma16816(s[j], a[ks], ldp(brow + ks * 16), ldp(brow + ks * 16 + 8));
  }
}

// acc (16 x D) += P (16 x 64, accumulator layout) * V, V rows [64][D + 8];
// one ldmatrix.x4.trans gives the B fragments of two 8-dim column tiles
template <int D>
__device__ __forceinline__ void mma_acc(float (&acc)[D / 8][4], const float (&P)[8][4],
                                        const bf16* V, int lane) {
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
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

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(AWARPS * 32) attn_fwd_kernel(AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                  // [2][64][D + 8]
  bf16* Vs = Ks + 2 * AKB * (D + 8);                         // [2][64][D + 8]
  unsigned char* kf = smem + 2 * 2 * AKB * (D + 8) * 2;     // [2][64] K4 key flags
  const int b = blockIdx.x, h = blockIdx.y, tile = blockIdx.z;
  const int hk = h / p.group;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = tile * AQT + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < p.Lq, v1 = r1 < p.Lq, active = tile * AQT + warp * 16 < p.Lq;

  int kend = p.Lk, len = p.Lk;
  if (CAUSAL) {
    len = *p.length;
    const int last = min(tile * AQT + AQT, p.Lq);          // exclusive query row bound
    kend = min(p.q_offset + last, p.Lk);
    if (len >= 1) kend = min(kend, len);
  }
  const int qp0 = p.q_offset + r0, qp1 = p.q_offset + r1;
  const int nblk = (kend + AKB - 1) / AKB;

  // stage key block `blk` into buffer `buf`: K and V rows by cp.async, the
  // key flags (K4: 0 attend, 1 masked, 2 past Lk) by plain loads
  auto stage = [&](int blk, int buf) {
    const int k0 = blk * AKB;
    load_tile<D>(Ks + buf * AKB * (D + 8), kb, p.k_sl, k0, p.Lk);
    load_tile<D>(Vs + buf * AKB * (D + 8), vb, p.v_sl, k0, p.Lk);
    asm volatile("cp.async.commit_group;\n" ::);
    if (!CAUSAL) {
      for (int j = threadIdx.x; j < AKB; j += blockDim.x) {
        const int gj = k0 + j;
        unsigned char f = 2;
        if (gj < p.Lk) f = (p.mask && !p.mask[(long long)b * p.Lk + gj]) ? 1 : 0;
        kf[buf * AKB + j] = f;
      }
    }
  };
  stage(0, 0);

  uint32_t qa[D / 16][4];
  load_q<D>(qa, qb, p.q_sl, r0, r1, v0, v1, t);
  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int blk = 0; blk < nblk; ++blk) {
    const int buf = blk & 1, k0 = blk * AKB;
    if (blk + 1 < nblk) {
      stage(blk + 1, buf ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();                    // block `blk` has landed for every thread
    if (active) {
      float s[8][4];
      mma_rows<D>(s, qa, Ks + buf * AKB * (D + 8), g, t);
      float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int cl = 8 * j + 2 * t + (e & 1);
          float x;
          if (CAUSAL) {
            const int c = k0 + cl, qp = e < 2 ? qp0 : qp1;
            x = c >= p.Lk ? -INFINITY : ((c > qp || c >= len) ? A_NEG : s[j][e] * p.scale);
          } else {
            const int f = kf[buf * AKB + cl];
            x = f == 0 ? s[j][e] * p.scale : (f == 1 ? A_NEG : -INFINITY);
          }
          s[j][e] = x;
        }
        mb0 = fmaxf(mb0, fmaxf(s[j][0], s[j][1]));
        mb1 = fmaxf(mb1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m0, qmax(mb0)), mn1 = fmaxf(m1, qmax(mb1));
      const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= c0; o[i][1] *= c0; o[i][2] *= c1; o[i][3] *= c1;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = expf(s[j][e] - (e < 2 ? mn0 : mn1));
          if (e < 2) l0 += x; else l1 += x;
          s[j][e] = x;
        }
      }
      m0 = mn0;
      m1 = mn1;
      mma_acc<D>(o, s, Vs + buf * AKB * (D + 8), lane);
    }
    __syncthreads();                    // buffer `buf` is free for block blk + 2
  }
  if (!active) return;
  l0 = qsum(l0);
  l1 = qsum(l1);
  const float s0 = 1.f / fmaxf(l0, 1e-30f), s1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (v0) *reinterpret_cast<uint32_t*>(ob + r0 * p.o_sl + nt * 8 + 2 * t) =
        pk(o[nt][0] * s0, o[nt][1] * s0);
    if (v1) *reinterpret_cast<uint32_t*>(ob + r1 * p.o_sl + nt * 8 + 2 * t) =
        pk(o[nt][2] * s1, o[nt][3] * s1);
  }
}

template <int D, bool CAUSAL>
int launch_d(const AttnParams& p, dim3 grid, cudaStream_t st) {
  static bool configured = false;     // the dynamic shared memory limit, set once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<D, CAUSAL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  attn_fwd_kernel<D, CAUSAL><<<grid, AWARPS * 32, smem_bytes<D>(), st>>>(p);
  return (int)cudaGetLastError();
}

// the two instances on the QA path: K4 at the InternViT head dim 64, K5 at
// the LLM head dim 128
constexpr int K4_D = 64, K5_D = 128;

}  // namespace

extern "C" {

// K4: out[b, i, h*D + d] = softmax_j(q k^T * scale, mask) v over the heads
// packed in the channel dim of q/k/v rows; D = 64.
int vgqa_flash_mha(const void* q, const void* k, const void* v, void* out,
                   const unsigned char* mask, int B, int Lq, int Lk, int H, int D,
                   long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                   long long v_sb, long long v_sl, long long o_sb, long long o_sl, float scale,
                   void* stream) {
  if (D != K4_D || B < 1 || H < 1 || Lq < 1 || Lk < 1 || H > 65535 ||
      (Lq + AQT - 1) / AQT > 65535)
    return (int)cudaErrorInvalidValue;
  AttnParams p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
               q_sb, (long long)D, q_sl, k_sb, (long long)D, k_sl, v_sb, (long long)D, v_sl,
               o_sb, (long long)D, o_sl, mask, nullptr, 1, Lq, Lk, 0, scale};
  return launch_d<K4_D, false>(p, dim3(B, H, (Lq + AQT - 1) / AQT),
                               reinterpret_cast<cudaStream_t>(stream));
}

// K5: causal GQA prefill attention, q [H, Lq, D] (strides q_sh, q_sl),
// k/v [Hkv, S, D], out [H, Lq, D], D = 128; query head h reads KV head
// h / (H / Hkv).
int vgqa_flash_gqa_causal(const void* q, const void* k, const void* v, void* out,
                          const int* length, int H, int Hkv, int Lq, int S, int D, int q_offset,
                          long long q_sh, long long q_sl, long long k_sh, long long k_sl,
                          long long v_sh, long long v_sl, long long o_sh, long long o_sl,
                          float scale, void* stream) {
  if (D != K5_D || H < 1 || Hkv < 1 || H % Hkv || Lq < 1 || S < 1 || q_offset < 0 ||
      H > 65535 || (Lq + AQT - 1) / AQT > 65535)
    return (int)cudaErrorInvalidValue;
  AttnParams p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
               0, q_sh, q_sl, 0, k_sh, k_sl, 0, v_sh, v_sl, 0, o_sh, o_sl,
               nullptr, length, H / Hkv, Lq, S, q_offset, scale};
  return launch_d<K5_D, true>(p, dim3(1, H, (Lq + AQT - 1) / AQT),
                              reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
