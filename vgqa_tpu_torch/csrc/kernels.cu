// Hand-written kernels of vgqa_tpu_torch, behind a plain C interface.
//
// Built by vgqa_tpu_torch/ops/kernels/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// and loaded with ctypes. Every entry point launches on the stream it is
// given, allocates nothing, and returns cudaGetLastError() (0 = launched).
//
// Kernels of K1's chain (swin_block_canvas, the port of
// vgqa_tpu/ops/pallas/swin_block.py:swin_block_canvas, and swin_block_fused,
// the same chain on partitioned windows with null (identity) row maps; see
// vgqa_tpu_torch/ops/kernels/swin_block.py): ln_rows -> gemm(qkv) ->
// window attention -> gemm(proj + residual) -> ln_rows -> gemm(fc1 + GELU)
// -> gemm(fc2 + residual + scatter). The GEMMs are gemm_sm90.cu's (bf16 and
// 3xTF32), the bf16 attention window_attn_sm90.cu's. Here:
//   ln_rows_kernel      row LayerNorm (bf16 or float) that can gather its
//                       rows through a row map (window tokens read straight
//                       from the rolled canvas) and zero padded tokens.
//   window_attn_f32_kernel  K2 and K1's attention phase in float32 (the JAX
//                       kernel at float32, whose bf16 rounding points are
//                       no-ops there), all arithmetic in FFMA: one thread per
//                       query row, keys and values streamed through shared
//                       memory in chunks of 32, online softmax
//                       (vgqa_f32::row_attention, f32_rows.cuh, shared with
//                       K3's f32 forward). Bound on an H100 by the FFMA rate
//                       (67 TFLOP/s); its 3xTF32 form is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "f32_rows.cuh"

using bf16 = __nv_bfloat16;

namespace {

constexpr float NEG_INF = -1e30f;

// element type T (bf16 or float) to and from f32
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

constexpr int WA_D = 32;      // head dim

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

// ---------------------------------------------------------------------------
// Windowed attention in float32 (FFMA): vgqa_f32::row_attention (f32_rows.cuh)
// with one block per (window w, head h, tile of 128 query rows). Each chunk
// of 32 keys brings its additive key mask, region ids and the [128][32] tile
// of the rel-pos bias (loaded row-coalesced, read without bank conflicts
// through the 33-float row stride); logits in base e.
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
// valid[m % n_valid] when given, and is written densely at row m. C = 32
// CPL (K1's head dim is 32, so C = 32 heads), and each lane reads its CPL
// elements (lane + 32 i) once into registers, all loads in flight together.
// ---------------------------------------------------------------------------
template <typename T, int CPL>
__global__ void ln_rows_kernel(const T* __restrict__ x, const int* __restrict__ rowmap,
                               const T* __restrict__ gamma, const T* __restrict__ beta,
                               const float* __restrict__ valid, int n_valid,
                               T* __restrict__ out, int M, int C, float eps) {
  const long long m = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (m >= M) return;
  const T* xr = x + (rowmap ? (long long)rowmap[m] : m) * C;
  const float vm = valid ? valid[m % n_valid] : 1.f;
  T* orow = out + m * C;
  float v[CPL];
#pragma unroll
  for (int i = 0; i < CPL; ++i) v[i] = to_f(xr[lane + 32 * i]);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) s += v[i];
  const float mean = warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const float d = v[i] - mean;
    q += d * d;
  }
  const float r = rsqrtf(warp_sum(q) / C + eps);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    const int c = lane + 32 * i;
    const float y = (v[i] - mean) * r * to_f(gamma[c]) + to_f(beta[c]);
    orow[c] = from_f<T>(y * vm);
  }
}

template <typename T>
int launch_ln_rows(const void* x, const int* rowmap, const void* gamma, const void* beta,
                   const float* valid, int n_valid, void* out, int M, int C, float eps,
                   void* stream) {
  const int threads = 256;
  const long long blocks = ((long long)M * 32 + threads - 1) / threads;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const T* xt = (const T*)x;
  const T* gt = (const T*)gamma;
  const T* bt = (const T*)beta;
  T* ot = (T*)out;
#define VGQA_LN(CPL)                                                                         \
  ln_rows_kernel<T, CPL><<<(unsigned)blocks, threads, 0, st>>>(xt, rowmap, gt, bt, valid,    \
                                                               n_valid, ot, M, C, eps)
  // the heads of Video Swin-T/S (3, 6, 12, 24) and -B (4, 8, 16, 32), and
  // the card tests' 1 and 2
  switch (C % 32 ? 0 : C / 32) {
    case 1: VGQA_LN(1); break;
    case 2: VGQA_LN(2); break;
    case 3: VGQA_LN(3); break;
    case 4: VGQA_LN(4); break;
    case 6: VGQA_LN(6); break;
    case 8: VGQA_LN(8); break;
    case 12: VGQA_LN(12); break;
    case 16: VGQA_LN(16); break;
    case 24: VGQA_LN(24); break;
    case 32: VGQA_LN(32); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef VGQA_LN
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K2 in float32: q, k, v, out and bias float; head dim 32; any N >= 1
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

}  // extern "C"
