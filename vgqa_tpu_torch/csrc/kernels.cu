// Hand-written Hopper kernels of vgqa_tpu_torch, behind a plain C interface.
//
// Built by vgqa_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Kernels:
//   window_attn_kernel  per-(window, head, query tile) masked softmax
//                       attention on the tensor cores (mma.sync, online
//                       softmax); serves window_attention (the port of
//                       vgqa_tpu/ops/pallas/window_attention.py:window_attention)
//                       and the attention phase of swin_block_canvas.
//   ln_rows_kernel      row LayerNorm that can gather its rows through a
//                       row map (window tokens read straight from the rolled
//                       canvas) and zero padded tokens.
//   gemm_bf16_kernel    tiled bf16 GEMM on the tensor cores (WMMA 16x16x16,
//                       f32 accumulation, cp.async 3-stage ring) with fused
//                       epilogues: bias, exact erf GELU, DropPath gate,
//                       residual add, and the scatter of window tokens back
//                       to canvas rows.
// Float32 forms of the same chain (the JAX block at float32, whose bf16
// rounding points are no-ops there), all arithmetic in FFMA:
//   window_attn_f32_kernel  one thread per query row, keys and values streamed
//                       through shared memory in chunks of 32, online softmax
//                       (vgqa_f32::row_attention, f32_rows.cuh, shared with
//                       K3's f32 forward);
//   ln_rows_kernel<float>;
//   gemm_f32_kernel     128x128x8 block tiles, 8x8 outputs per thread,
//                       register-prefetched double buffer, the same epilogues
//                       (gemm_epilogue<T>) with every rounding an identity.
// On an H100 the f32 chain is bound by its FFMA products (67 TFLOP/s
// outside the tensor cores, against 989 for bf16): single-pass TF32 would
// not be float32, and 3xTF32 is later work.
// swin_block_canvas (the port of vgqa_tpu/ops/pallas/swin_block.py:
// swin_block_canvas) chains ln_rows -> gemm(qkv) -> window_attn ->
// gemm(proj + residual) -> ln_rows -> gemm(fc1 + GELU) -> gemm(fc2 +
// residual + scatter); swin_block_fused (the port of swin_block_fused in the
// same file) runs the same chain on partitioned windows with null (identity)
// row maps; see vgqa_tpu_torch/ops/kernels/swin_block.py.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "f32_rows.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;

// element type T (bf16 or float) to and from f32; rnd<T> rounds through T
// (an identity for float: the JAX kernel's rounding points at f32)
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <typename T> __device__ __forceinline__ float rnd(float x) { return to_f(from_f<T>(x)); }

// 8 consecutive elements: one 16-byte access for bf16, two for float
template <typename T> struct alignas(16) Pack8 { T v[8]; };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Windowed attention on the tensor cores. One block per (window w, head h,
// tile of 64 query rows), 4 warps of 16 rows each. K [Npad][40] and V^T
// [32][Npad+8] of that window and head sit in shared memory as bf16 (the
// paddings make every fragment load bank-conflict free). Each warp walks
// the keys in blocks of 64: S = Q K^T by mma.sync m16n8k16 (bf16 in, f32
// accumulate) stays in registers, gets scale, bias and masks, and an
// online softmax (running row max and sum in f32, flash-attention style)
// turns it into P, which feeds P V as the A operand straight from the S
// registers. Neither S nor P ever reaches memory.
// ---------------------------------------------------------------------------
constexpr int WA_D = 32;      // head dim
constexpr int WA_WARPS = 4;
constexpr int WA_QT = 16 * WA_WARPS;   // query rows per block
constexpr int WA_KB = 64;     // keys per online-softmax step
constexpr int WA_KLD = WA_D + 8;       // bf16 row stride of K in smem
constexpr int WA_MAX_TOKENS = 1024;    // 150 KB of shared memory at 1024

template <typename T>
struct WAParamsT {
  const T* q; const T* k; const T* v; T* out;
  long long q_win, q_row, k_win, k_row, v_win, v_row, o_win, o_row;
  const T* bias;            // [H, N, N] or null
  const int* region;        // [n_region, N] or null; window w uses row w % n_region
  int n_region;
  const float* key_valid;   // [n_kvalid, N] or null; > 0 = attendable key
  int n_kvalid;
  int N;
  float scale;
};
using WAParams = WAParamsT<bf16>;

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a (16x16, row) * b (16x8, col); bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__global__ void __launch_bounds__(WA_WARPS * 32)
window_attn_kernel(WAParams p) {
  extern __shared__ __align__(16) unsigned char wa_smem[];
  const int N = p.N;
  const int Npad = (N + WA_KB - 1) / WA_KB * WA_KB;
  const int VLD = Npad + 8;
  bf16* Ks = reinterpret_cast<bf16*>(wa_smem);           // [Npad][WA_KLD]
  bf16* Vt = Ks + Npad * WA_KLD;                          // [WA_D][VLD]
  float* kadd = reinterpret_cast<float*>(Vt + WA_D * VLD);  // [Npad] additive key mask
  int* kreg = reinterpret_cast<int*>(kadd + Npad);        // [Npad] region ids

  const long long w = blockIdx.x;
  const int h = blockIdx.y;
  const bf16* kb = p.k + w * p.k_win + h * WA_D;
  const bf16* vb = p.v + w * p.v_win + h * WA_D;
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < Npad * (WA_D / 8); i += blockDim.x) {
    const int j = i / (WA_D / 8), c8 = (i % (WA_D / 8)) * 8;
    uint4 kv = zero4, vv = zero4;
    if (j < N) {
      kv = *reinterpret_cast<const uint4*>(kb + j * p.k_row + c8);
      vv = *reinterpret_cast<const uint4*>(vb + j * p.v_row + c8);
    }
    *reinterpret_cast<uint4*>(Ks + j * WA_KLD + c8) = kv;
    const bf16* ve = reinterpret_cast<const bf16*>(&vv);
#pragma unroll
    for (int e = 0; e < 8; ++e) Vt[(c8 + e) * VLD + j] = ve[e];
  }
  for (int j = threadIdx.x; j < Npad; j += blockDim.x) {
    float a = -INFINITY;     // keys past N drop out of the softmax
    int r = 0;
    if (j < N) {
      a = 0.f;
      if (p.key_valid && !(p.key_valid[(w % p.n_kvalid) * N + j] > 0.f)) a = NEG_INF;
      if (p.region) r = p.region[(w % p.n_region) * N + j];
    }
    kadd[j] = a;
    kreg[j] = r;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.z * WA_QT + warp * 16;
  if (q0 >= N) return;
  const int r0 = q0 + g, r1 = q0 + g + 8;
  const bool v0 = r0 < N, v1 = r1 < N;

  const bf16* qb = p.q + w * p.q_win + h * WA_D;
  uint32_t qa[2][4];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = v0 ? ld_pair(qb + r0 * p.q_row + c) : 0u;
    qa[ks][1] = v1 ? ld_pair(qb + r1 * p.q_row + c) : 0u;
    qa[ks][2] = v0 ? ld_pair(qb + r0 * p.q_row + c + 8) : 0u;
    qa[ks][3] = v1 ? ld_pair(qb + r1 * p.q_row + c + 8) : 0u;
  }
  const int rq0 = v0 ? kreg[r0] : 0, rq1 = v1 ? kreg[r1] : 0;
  const bf16* bias0 = (p.bias && v0) ? p.bias + ((long long)h * N + r0) * N : nullptr;
  const bf16* bias1 = (p.bias && v1) ? p.bias + ((long long)h * N + r1) * N : nullptr;

  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < Npad; k0 += WA_KB) {
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* krow = Ks + (k0 + 8 * j + g) * WA_KLD + 2 * t;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma_bf16(s[j], qa[ks], ld_pair(krow + ks * 16), ld_pair(krow + ks * 16 + 8));
    }
    float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * p.scale + kadd[c];
        if (p.region && kreg[c] != (e < 2 ? rq0 : rq1)) x += NEG_INF;
        const bf16* brow = e < 2 ? bias0 : bias1;
        if (brow && c < N) x += __bfloat162float(brow[c]);
        s[j][e] = x;
      }
      mb0 = fmaxf(mb0, fmaxf(s[j][0], s[j][1]));
      mb1 = fmaxf(mb1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, quad_max(mb0)), mn1 = fmaxf(m1, quad_max(mb1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i][0] *= c0; o[i][1] *= c0; o[i][2] *= c1; o[i][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - mn0); s[j][1] = expf(s[j][1] - mn0);
      s[j][2] = expf(s[j][2] - mn1); s[j][3] = expf(s[j][3] - mn1);
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* vrow = Vt + (nt * 8 + g) * VLD + k0 + 16 * kk + 2 * t;
        mma_bf16(o[nt], a, ld_pair(vrow), ld_pair(vrow + 8));
      }
    }
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  bf16* ob = p.out + w * p.o_win + h * WA_D + 2 * t;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (v0) *reinterpret_cast<uint32_t*>(ob + r0 * p.o_row + nt * 8) =
        pack_bf16(o[nt][0] / l0, o[nt][1] / l0);
    if (v1) *reinterpret_cast<uint32_t*>(ob + r1 * p.o_row + nt * 8) =
        pack_bf16(o[nt][2] / l1, o[nt][3] / l1);
  }
}

int launch_window_attn(const WAParams& p, int W, int H, cudaStream_t stream) {
  const int Npad = (p.N + WA_KB - 1) / WA_KB * WA_KB;
  const size_t smem = (size_t)Npad * WA_KLD * 2 + (size_t)WA_D * (Npad + 8) * 2
                      + (size_t)Npad * 8;
  cudaError_t e = cudaFuncSetAttribute(window_attn_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(W, H, (p.N + WA_QT - 1) / WA_QT);
  window_attn_kernel<<<grid, WA_WARPS * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Windowed attention in float32 (FFMA): vgqa_f32::row_attention (f32_rows.cuh)
// with one block per (window w, head h, tile of 128 query rows). Each chunk
// of 32 keys brings its additive key mask, region ids and the [128][32] tile
// of the rel-pos bias (loaded row-coalesced, read without bank conflicts
// through the 33-float row stride); logits in base e, as in the bf16 kernel.
// Nothing is rounded.
// ---------------------------------------------------------------------------
constexpr int WF_QT = 128;    // query rows per block (one per thread)
constexpr int WF_KC = vgqa_f32::F32_KC;

struct WindowF32Terms {        // K2's key terms: bias + region + key mask
  struct { const float* bias; const int* region; const float* key_valid;
           int n_region, n_kvalid, N; float scale; } p;     // the fields read here
  long long w;
  int h, row0, rq;
  float (*Bc)[WF_KC + 1];
  float* kadd;
  int* kreg;

  __device__ void stage(int k0) {
    const int tid = threadIdx.x, N = p.N;
    if (tid < WF_KC) {
      const int j = k0 + tid;
      float a = -INFINITY;     // keys past N drop out of the softmax
      int rg = 0;
      if (j < N) {
        a = 0.f;
        if (p.key_valid && !(p.key_valid[(w % p.n_kvalid) * N + j] > 0.f)) a = NEG_INF;
        if (p.region) rg = p.region[(w % p.n_region) * N + j];
      }
      kadd[tid] = a;
      kreg[tid] = rg;
    }
    if (p.bias)
      for (int i = tid; i < WF_QT * WF_KC; i += WF_QT) {
        const int rr = i / WF_KC, c = i % WF_KC;
        const int br = row0 + rr, bc = k0 + c;
        Bc[rr][c] = (br < N && bc < N) ? p.bias[((long long)h * N + br) * N + bc] : 0.f;
      }
  }
  __device__ uint32_t keep(int) const { return ~0u; }
  __device__ float logit(float dot, int j) const {
    float x = dot * p.scale + kadd[j];
    if (p.region && kreg[j] != rq) x += NEG_INF;
    if (p.bias) x += Bc[threadIdx.x][j];
    return x;
  }
  static __device__ float expb(float x) { return expf(x); }
};

__global__ void __launch_bounds__(WF_QT)
window_attn_f32_kernel(WAParamsT<float> p) {
  __shared__ float Bc[WF_QT][WF_KC + 1];
  __shared__ float kadd[WF_KC];
  __shared__ int kreg[WF_KC];
  const int N = p.N;
  const long long w = blockIdx.x;
  const int h = blockIdx.y, tid = threadIdx.x;
  const int row0 = blockIdx.z * WF_QT, r = row0 + tid;
  const bool valid = r < N;

  float q[WA_D], o[WA_D];
  const float* qr = p.q + w * p.q_win + (long long)(valid ? r : 0) * p.q_row + h * WA_D;
#pragma unroll
  for (int d = 0; d < WA_D; d += 4) {
    const float4 x = valid ? *reinterpret_cast<const float4*>(qr + d)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
  }
  const int rq = (valid && p.region) ? p.region[(w % p.n_region) * N + r] : 0;
  WindowF32Terms terms{{p.bias, p.region, p.key_valid, p.n_region, p.n_kvalid, N, p.scale},
                       w, h, row0, rq, Bc, kadd, kreg};
  // every row computes, those past N on a zero q: ptxas allocates more
  // registers to the loop when it is skipped for them, and the kernel runs slower
  float m, l;
  vgqa_f32::row_attention<WA_D, WF_QT>(p.k + w * p.k_win + h * WA_D, p.k_row,
                                       p.v + w * p.v_win + h * WA_D, p.v_row, N, q, o, m, l,
                                       true, terms);
  if (!valid) return;
  float* orow = p.out + w * p.o_win + (long long)r * p.o_row + h * WA_D;
#pragma unroll
  for (int d = 0; d < WA_D; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(o[d] / l, o[d + 1] / l, o[d + 2] / l, o[d + 3] / l);
}

// ---------------------------------------------------------------------------
// Row LayerNorm over bf16 or float rows, one warp per row, two-pass f32
// statistics. Row m reads source row rowmap[m] (or m), is multiplied by
// valid[m % n_valid] when given, and is written densely at row m.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void ln_rows_kernel(const T* __restrict__ x, const int* __restrict__ rowmap,
                               const T* __restrict__ gamma, const T* __restrict__ beta,
                               const float* __restrict__ valid, int n_valid,
                               T* __restrict__ out, int M, int C, float eps) {
  const long long m = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const long long src = (rowmap ? (long long)rowmap[m] : m) * C;
  const T* xr = x + src;
  float s = 0.f;
  for (int c = lane; c < C; c += 32) s += to_f(xr[c]);
  const float mean = warp_sum(s) / C;
  float v = 0.f;
  for (int c = lane; c < C; c += 32) {
    const float d = to_f(xr[c]) - mean;
    v += d * d;
  }
  const float r = rsqrtf(warp_sum(v) / C + eps);
  const float vm = valid ? valid[m % n_valid] : 1.f;
  T* orow = out + m * C;
  for (int c = lane; c < C; c += 32) {
    const float y = (to_f(xr[c]) - mean) * r * to_f(gamma[c]) + to_f(beta[c]);
    orow[c] = from_f<T>(y * vm);
  }
}

// ---------------------------------------------------------------------------
// out = epilogue(A[M, K] @ W[N, K]^T): A row-major, W in nn.Linear layout
// (one row per output column). Block tile 128x128x32, 8 warps in a 2x4
// grid, each warp 64x32 = 4x2 WMMA bf16 fragments with f32 accumulators.
// Tiles stream into a 3-stage shared-memory ring with cp.async, so the
// loads of tile k+2 overlap the products of tile k. The grid walks the N
// tiles fastest, so the blocks that share an A row tile run together and
// read it from L2. The accumulator tile then goes through shared memory so
// that the epilogue walks rows with consecutive threads on consecutive
// 8-column groups (coalesced 16-byte stores, also for the canvas scatter).
// ---------------------------------------------------------------------------
constexpr int GB_M = 128, GB_N = 128, GB_K = 32, G_STAGES = 3;
constexpr int GA_LD = GB_K + 8;     // bf16 elements; multiple of 8 for WMMA
constexpr int GC_LD = GB_N + 4;     // f32 elements; multiple of 4 for WMMA
constexpr int G_STAGE_ELEMS = (GB_M + GB_N) * GA_LD;
constexpr int G_SMEM_BYTES =
    G_STAGES * G_STAGE_ELEMS * 2 > GB_M * GC_LD * 4 ? G_STAGES * G_STAGE_ELEMS * 2
                                                    : GB_M * GC_LD * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;     // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" :: "n"(N)); }

enum EpiMode {
  EPI_BIAS = 0,           // out[m] = bf16(bf16(acc) + bias)
  EPI_GELU = 1,           // out[m] = bf16(gelu(acc + bias))
  EPI_RES_GATHER = 2,     // out[m] = res[rowmap[m]] + gate * bf16(bf16(acc) + bias)
  EPI_RES_SCATTER = 3,    // out[rowmap[m]] = res[m] + gate * bf16(bf16(acc) + bias)
};

template <typename T>
struct GemmParamsT {
  const T* A; long long lda;
  const T* W; long long ldw;
  const T* bias;             // [N] or null
  T* out; long long ldo;
  const T* res; long long ldr;
  const int* rowmap;
  const float* gates;        // [B, 2] DropPath branch gates or null
  int gate_col;
  long long rows_per_sample; // rows of one sample (gate row = m / rows_per_sample)
  int M, N, K, mode;
};
using GemmParams = GemmParamsT<bf16>;

// The fused epilogue of both GEMMs over the block's f32 accumulator tile Cs
// [GB_M][GC_LD] (rows m0.., columns n0..): 8 consecutive columns per thread
// and step, 16-byte loads and stores (the wrapper guarantees N, ldo and ldr
// are multiples of 8). rnd<T> places the bf16 rounding points of the JAX
// kernel; at float they are identities.
template <typename T>
__device__ __forceinline__ void gemm_epilogue(const GemmParamsT<T>& p, const float* Cs,
                                              long long m0, int n0, int tid) {
  for (int e = tid; e < GB_M * GB_N / 8; e += 256) {
    const int r = e / (GB_N / 8), c = (e % (GB_N / 8)) * 8;
    const long long m = m0 + r;
    const int n = n0 + c;
    if (m >= p.M || n >= p.N) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(Cs + r * GC_LD + c);
    const float4 a1 = *reinterpret_cast<const float4*>(Cs + r * GC_LD + c + 4);
    const float acc[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[8];
    if (p.bias) {
      const Pack8<T> bv = *reinterpret_cast<const Pack8<T>*>(p.bias + n);
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = to_f(bv.v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) b[i] = 0.f;
    }
    Pack8<T> ov;
    long long dst = m * p.ldo + n;
    if (p.mode == EPI_BIAS) {
#pragma unroll
      for (int i = 0; i < 8; ++i) ov.v[i] = from_f<T>(rnd<T>(acc[i]) + b[i]);
    } else if (p.mode == EPI_GELU) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float t = acc[i] + b[i];
        ov.v[i] = from_f<T>(0.5f * t * (1.f + erff(t * 0.70710678118654752f)));
      }
    } else {
      const float g = p.gates ? rnd<T>(p.gates[(m / p.rows_per_sample) * 2 + p.gate_col]) : 1.f;
      long long src = m * p.ldr + n;
      if (p.rowmap) {         // a null map is the identity (swin_block_fused)
        if (p.mode == EPI_RES_GATHER) src = (long long)p.rowmap[m] * p.ldr + n;
        else dst = (long long)p.rowmap[m] * p.ldo + n;
      }
      const Pack8<T> xv = *reinterpret_cast<const Pack8<T>*>(p.res + src);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float t = rnd<T>(rnd<T>(acc[i]) + b[i]);
        if (p.gates) t = rnd<T>(t * g);
        ov.v[i] = from_f<T>(to_f(xv.v[i]) + t);
      }
    }
    *reinterpret_cast<Pack8<T>*>(p.out + dst) = ov;
  }
}

__global__ void __launch_bounds__(256)
gemm_bf16_kernel(GemmParams p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char g_smem[];
  bf16* ring = reinterpret_cast<bf16*>(g_smem);       // stage s: A [GB_M][GA_LD], W [GB_N][GA_LD]
  float* Cs = reinterpret_cast<float*>(g_smem);       // [GB_M][GC_LD], after the k loop

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * GB_N;
  const long long m0 = (long long)blockIdx.y * GB_M;
  const int KT = (p.K + GB_K - 1) / GB_K;

  auto load_tile = [&](int stage, int kt) {
    bf16* As = ring + stage * G_STAGE_ELEMS;
    bf16* Bs = As + GB_M * GA_LD;
    const int k0 = kt * GB_K;
#pragma unroll
    for (int i = 0; i < 2; ++i) {           // 512 16-byte chunks of A, 512 of W
      const int c = tid + i * 256;
      const int r = c / (GB_K / 8), col = (c % (GB_K / 8)) * 8;
      const bool ka = k0 + col < p.K;
      const long long gm = m0 + r;
      cp_async16(As + r * GA_LD + col, gm < p.M && ka ? p.A + gm * p.lda + k0 + col : p.A,
                 gm < p.M && ka);
      const int gn = n0 + r;
      cp_async16(Bs + r * GA_LD + col,
                 gn < p.N && ka ? p.W + (long long)gn * p.ldw + k0 + col : p.W, gn < p.N && ka);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < G_STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<G_STAGES - 2>();
    __syncthreads();                        // tile kt landed; stage (kt-1) is free
    if (kt + G_STAGES - 1 < KT) load_tile((kt + G_STAGES - 1) % G_STAGES, kt + G_STAGES - 1);
    cp_async_commit();
    const bf16* As = ring + (kt % G_STAGES) * G_STAGE_ELEMS;
    const bf16* Bs = As + GB_M * GA_LD;
#pragma unroll
    for (int kk = 0; kk < GB_K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * GA_LD + kk, GA_LD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * GA_LD + kk, GA_LD);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                          // the ring is reused as Cs below

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * GC_LD + wn * 32 + j * 16, acc[i][j],
                              GC_LD, wmma::mem_row_major);
  __syncthreads();

  gemm_epilogue<bf16>(p, Cs, m0, n0, tid);
}

// ---------------------------------------------------------------------------
// out = epilogue(A[M, K] @ W[N, K]^T) in float32 on the FFMA units. Block
// tile 128x128, k-step 8, 256 threads of 8x8 outputs each (rows ty*4 + i
// and 64 + ty*4 + i, columns tx*4 + j and 64 + tx*4 + j, so that every
// shared-memory read is a conflict-free float4). The A and W tiles are
// stored transposed ([k][row]) in a double buffer; the next k-step's tiles
// are fetched into registers while the current one computes, so one
// __syncthreads per k-step suffices. The accumulators then go through the
// shared Cs tile into the same epilogue as the bf16 GEMM.
// ---------------------------------------------------------------------------
constexpr int FB_K = 8;
constexpr int F_LD = GB_M + 4;      // row stride of a transposed tile [k][row] (floats)
constexpr int F_SMEM_BYTES = 2 * 2 * FB_K * F_LD * 4 > GB_M * GC_LD * 4
                                 ? 2 * 2 * FB_K * F_LD * 4 : GB_M * GC_LD * 4;

__global__ void __launch_bounds__(256)
gemm_f32_kernel(GemmParamsT<float> p) {
  extern __shared__ __align__(128) unsigned char g_smem[];
  float* As = reinterpret_cast<float*>(g_smem);      // [2][FB_K][F_LD]
  float* Ws = As + 2 * FB_K * F_LD;                    // [2][FB_K][F_LD]
  float* Cs = reinterpret_cast<float*>(g_smem);      // [GB_M][GC_LD], after the k loop

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * GB_N;
  const long long m0 = (long long)blockIdx.y * GB_M;
  const int KT = (p.K + FB_K - 1) / FB_K;
  // this thread's share of a tile: row lr, k offset lk (4 floats of A, 4 of W)
  const int lr = tid / 2, lk = (tid % 2) * 4;
  const long long gm = m0 + lr;
  const int gn = n0 + lr;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  auto fetch = [&](int kt, float4& a, float4& w) {
    const int k = kt * FB_K + lk;      // K % 4 == 0: k < K covers k .. k + 3
    a = (gm < p.M && k < p.K) ? *reinterpret_cast<const float4*>(p.A + gm * p.lda + k) : zero;
    w = (gn < p.N && k < p.K) ? *reinterpret_cast<const float4*>(p.W + (long long)gn * p.ldw + k)
                              : zero;
  };
  auto put = [&](int buf, const float4& a, const float4& w) {
    float* as = As + buf * FB_K * F_LD + lk * F_LD + lr;
    float* ws = Ws + buf * FB_K * F_LD + lk * F_LD + lr;
    as[0] = a.x; as[F_LD] = a.y; as[2 * F_LD] = a.z; as[3 * F_LD] = a.w;
    ws[0] = w.x; ws[F_LD] = w.y; ws[2 * F_LD] = w.z; ws[3 * F_LD] = w.w;
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  float4 ra, rw;
  fetch(0, ra, rw);
  put(0, ra, rw);
  __syncthreads();
  for (int kt = 0; kt < KT; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < KT) fetch(kt + 1, ra, rw);
    const float* as = As + buf * FB_K * F_LD;
    const float* ws = Ws + buf * FB_K * F_LD;
#pragma unroll
    for (int k = 0; k < FB_K; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * F_LD + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * F_LD + 64 + ty * 4);
      const float4 w0 = *reinterpret_cast<const float4*>(ws + k * F_LD + tx * 4);
      const float4 w1 = *reinterpret_cast<const float4*>(ws + k * F_LD + 64 + tx * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    if (kt + 1 < KT) put(buf ^ 1, ra, rw);
    __syncthreads();      // buffer buf ^ 1 is written; buffer buf is consumed
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = (i < 4 ? 0 : 64) + ty * 4 + (i & 3);
    *reinterpret_cast<float4*>(Cs + r * GC_LD + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(Cs + r * GC_LD + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();
  gemm_epilogue<float>(p, Cs, m0, n0, tid);
}

template <typename T>
int launch_gemm(const GemmParamsT<T>& p, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  const long long m_tiles = ((long long)p.M + GB_M - 1) / GB_M;
  if (m_tiles > 65535 || (F32 && p.K % 4)) return (int)cudaErrorInvalidValue;
  dim3 grid((p.N + GB_N - 1) / GB_N, (unsigned)m_tiles);
  cudaError_t e;
  if constexpr (F32) {
    e = cudaFuncSetAttribute(gemm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             F_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    gemm_f32_kernel<<<grid, 256, F_SMEM_BYTES, stream>>>(p);
  } else {
    e = cudaFuncSetAttribute(gemm_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             G_SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    gemm_bf16_kernel<<<grid, 256, G_SMEM_BYTES, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ln_rows(const void* x, const int* rowmap, const void* gamma, const void* beta,
                   const float* valid, int n_valid, void* out, int M, int C, float eps,
                   void* stream) {
  const int threads = 256;
  const long long blocks = ((long long)M * 32 + threads - 1) / threads;
  ln_rows_kernel<T><<<(unsigned)blocks, threads, 0, reinterpret_cast<cudaStream_t>(stream)>>>(
      (const T*)x, rowmap, (const T*)gamma, (const T*)beta, valid, n_valid, (T*)out, M, C, eps);
  return (int)cudaGetLastError();
}

template <typename T>
GemmParamsT<T> gemm_params(const void* A, long long lda, const void* W, long long ldw,
                           const void* bias, void* out, long long ldo, int M, int N, int K,
                           int mode, const void* res, long long ldr, const int* rowmap,
                           const float* gates, int gate_col, long long rows_per_sample) {
  return GemmParamsT<T>{(const T*)A, lda, (const T*)W, ldw, (const T*)bias, (T*)out, ldo,
                        (const T*)res, ldr, rowmap, gates, gate_col, rows_per_sample,
                        M, N, K, mode};
}

}  // namespace

extern "C" {

// q, k, v, out and bias are bfloat16; head dim 32
int vgqa_window_attention(const void* q, const void* k, const void* v, void* out,
                          int W, int N, int H,
                          long long q_win, long long q_row, long long k_win, long long k_row,
                          long long v_win, long long v_row, long long o_win, long long o_row,
                          const void* bias, const int* region, int n_region,
                          const float* key_valid, int n_kvalid, float scale, void* stream) {
  if (N < 1 || N > WA_MAX_TOKENS) return (int)cudaErrorInvalidValue;
  WAParams p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
             q_win, q_row, k_win, k_row, v_win, v_row, o_win, o_row,
             (const bf16*)bias, region, n_region, key_valid, n_kvalid, N, scale};
  return launch_window_attn(p, W, H, reinterpret_cast<cudaStream_t>(stream));
}

// the same in float32 (q, k, v, out and bias float; any N >= 1)
int vgqa_window_attention_f32(const void* q, const void* k, const void* v, void* out,
                              int W, int N, int H,
                              long long q_win, long long q_row, long long k_win, long long k_row,
                              long long v_win, long long v_row, long long o_win, long long o_row,
                              const void* bias, const int* region, int n_region,
                              const float* key_valid, int n_kvalid, float scale, void* stream) {
  if (N < 1 || H > 65535 || (N + WF_QT - 1) / WF_QT > 65535) return (int)cudaErrorInvalidValue;
  WAParamsT<float> p{(const float*)q, (const float*)k, (const float*)v, (float*)out,
                     q_win, q_row, k_win, k_row, v_win, v_row, o_win, o_row,
                     (const float*)bias, region, n_region, key_valid, n_kvalid, N, scale};
  dim3 grid(W, H, (N + WF_QT - 1) / WF_QT);
  window_attn_f32_kernel<<<grid, WF_QT, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

int vgqa_ln_rows(const void* x, const int* rowmap, const void* gamma, const void* beta,
                 const float* valid, int n_valid, void* out, int M, int C, float eps,
                 void* stream) {
  return launch_ln_rows<bf16>(x, rowmap, gamma, beta, valid, n_valid, out, M, C, eps, stream);
}

int vgqa_ln_rows_f32(const void* x, const int* rowmap, const void* gamma, const void* beta,
                     const float* valid, int n_valid, void* out, int M, int C, float eps,
                     void* stream) {
  return launch_ln_rows<float>(x, rowmap, gamma, beta, valid, n_valid, out, M, C, eps, stream);
}

int vgqa_gemm_bf16(const void* A, long long lda, const void* W, long long ldw, const void* bias,
                   void* out, long long ldo, int M, int N, int K, int mode,
                   const void* res, long long ldr, const int* rowmap,
                   const float* gates, int gate_col, long long rows_per_sample, void* stream) {
  return launch_gemm(gemm_params<bf16>(A, lda, W, ldw, bias, out, ldo, M, N, K, mode, res, ldr,
                                       rowmap, gates, gate_col, rows_per_sample),
                     reinterpret_cast<cudaStream_t>(stream));
}

// the same in float32 (A, W, bias, res and out float; K % 4 == 0)
int vgqa_gemm_f32(const void* A, long long lda, const void* W, long long ldw, const void* bias,
                  void* out, long long ldo, int M, int N, int K, int mode,
                  const void* res, long long ldr, const int* rowmap,
                  const float* gates, int gate_col, long long rows_per_sample, void* stream) {
  return launch_gemm(gemm_params<float>(A, lda, W, ldw, bias, out, ldo, M, N, K, mode, res, ldr,
                                        rowmap, gates, gate_col, rows_per_sample),
                     reinterpret_cast<cudaStream_t>(stream));
}

}  // extern "C"
