// Differentiable attention with in-kernel probability dropout (K3), behind a
// plain C interface: the port of vgqa_tpu/ops/pallas/flash_train.py
// (flash_mha_train; Pallas _fwd_kernel and _bwd_kernel).
//
// Layout: q/out/dout/dq are [W, Lq, H*32] and k/v/dk/dv [W, Lk, H*32],
// contiguous, heads packed in the channel dim; the folded batch row of
// (w, h) is w*H + h, as in the JAX wrapper's fold. key_mask [W, Lk] (uint8,
// nonzero = attend) or null. lse and delta are f32 [W*H, Lq].
//
// Kernels (one block of 4 warps per (w, h, tile of 64 rows); mma.sync
// m16n8k16 bf16 with f32 accumulation; keys stream through shared memory
// in blocks of 64, so any sequence length fits):
//   flash_fwd_kernel    S = q k^T * scale, masked keys -1e30, online softmax,
//                       lse = m + log(l), O = (dropped P) V / l.
//   flash_delta_kernel  delta = rowsum(dO * O) with O as stored (bf16).
//   flash_dq_kernel     recomputes P = exp(S - lse) and dP = dO v^T per key
//                       block; dS = P (dP - delta) scale; dq = dS k.
//   flash_dkv_kernel    per key tile, loops over query blocks: dv = Pw^T dO,
//                       dk = dS^T q. No atomics: every output element has
//                       one writer, so results do not vary between runs.
// Dropout: keep(row, i, j) is a pure function of (seed + row, i, j):
// Philox4x32-10 keyed by (seed + row, 0), counter (i, j, 0, 0); the top 24
// bits of the first output word >= thresh keep the element (thresh =
// ceil(rate * 2^24) in f32, the threshold of the Pallas _keep_mask). The
// forward and both backward kernels regenerate the same mask, and the plain
// PyTorch version (ops/kernels/flash_train.py:keep_mask) draws the same
// bits with integer tensor ops.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int FD = 32;                 // head dim
constexpr int FWARPS = 4;
constexpr int FQT = 16 * FWARPS;       // rows (queries or keys) per block
constexpr int FKB = 64;                // keys (or queries) per streamed block
constexpr int FLD = FD + 8;            // row stride of [row][d] tiles (bf16)
constexpr int FTLD = FKB + 8;          // row stride of [d][row] tiles (bf16)
constexpr float F_NEG = -1e30f;

struct FlashParams {
  const bf16* q; const bf16* k; const bf16* v;
  const bf16* o; const bf16* dout;
  bf16* out; bf16* dq; bf16* dk; bf16* dv;
  float* lse; float* delta;
  const unsigned char* mask;   // [W, Lk] or null
  int W, Lq, Lk, H;
  float scale;
  unsigned int seed;           // int32 seed as its bit pattern
  unsigned int thresh;         // keep iff (bits >> 8) >= thresh
  int dropout;                 // 0: rate 0, no mask drawn
  float inv_keep;              // 1 / (1 - rate)
};

__device__ __forceinline__ uint32_t philox_word(uint32_t key, uint32_t i, uint32_t j) {
  uint32_t c0 = i, c1 = j, c2 = 0u, c3 = 0u, k0 = key, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c0), lo0 = 0xD2511F53u * c0;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c2), lo1 = 0xCD9E8D57u * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return c0;
}

__device__ __forceinline__ bool keep_elem(const FlashParams& p, uint32_t row, int i, int j) {
  return (philox_word(p.seed + row, (uint32_t)i, (uint32_t)j) >> 8) >= p.thresh;
}

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

// A fragments (16 rows x 32 dims) of rows r0/r1 of a [L, C] row block
__device__ __forceinline__ void load_a(uint32_t (&a)[2][4], const bf16* base, long long ld,
                                       int r0, int r1, bool v0, bool v1, int t) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const int c = ks * 16 + 2 * t;
    a[ks][0] = v0 ? ldp(base + r0 * ld + c) : 0u;
    a[ks][1] = v1 ? ldp(base + r1 * ld + c) : 0u;
    a[ks][2] = v0 ? ldp(base + r0 * ld + c + 8) : 0u;
    a[ks][3] = v1 ? ldp(base + r1 * ld + c + 8) : 0u;
  }
}

// Cooperative load of rows [r0, r0 + 64) of a [L, C] block (one head) into
// a [64][FLD] tile (when rows != null) and its transpose [FD][FTLD] (when
// tr != null); rows at or past L are zero.
__device__ __forceinline__ void load_tile(bf16* rows, bf16* tr, const bf16* base, long long ld,
                                          int r0, int L) {
  const uint4 zero4 = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < FKB * (FD / 8); i += blockDim.x) {
    const int j = i / (FD / 8), c8 = (i % (FD / 8)) * 8;
    uint4 x = zero4;
    if (r0 + j < L) x = *reinterpret_cast<const uint4*>(base + (long long)(r0 + j) * ld + c8);
    if (rows) *reinterpret_cast<uint4*>(rows + j * FLD + c8) = x;
    if (tr) {
      const bf16* xe = reinterpret_cast<const bf16*>(&x);
#pragma unroll
      for (int e = 0; e < 8; ++e) tr[(c8 + e) * FTLD + j] = xe[e];
    }
  }
}

// key flags of keys [k0, k0 + 64): 0 attend, 1 masked (-1e30), 2 past Lk
__device__ __forceinline__ void load_flags(unsigned char* kf, const FlashParams& p, int w, int k0) {
  for (int j = threadIdx.x; j < FKB; j += blockDim.x) {
    const int gj = k0 + j;
    unsigned char f = 2;
    if (gj < p.Lk) f = (p.mask && !p.mask[(long long)w * p.Lk + gj]) ? 1 : 0;
    kf[j] = f;
  }
}

// 16x64 S tile = A (16 x 32) * B^T, B rows [64][FLD] in shared memory
__device__ __forceinline__ void mma_rows(float (&s)[8][4], const uint32_t (&a)[2][4],
                                         const bf16* B, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    const bf16* brow = B + (8 * j + g) * FLD + 2 * t;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      mma16816(s[j], a[ks], ldp(brow + ks * 16), ldp(brow + ks * 16 + 8));
  }
}

// acc (16 x 32) += P (16 x 64, accumulator layout) * B, B^T rows [FD][FTLD]
__device__ __forceinline__ void mma_acc(float (&acc)[4][4], const float (&P)[8][4],
                                        const bf16* Bt, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pk(P[2 * kk][0], P[2 * kk][1]), pk(P[2 * kk][2], P[2 * kk][3]),
                           pk(P[2 * kk + 1][0], P[2 * kk + 1][1]),
                           pk(P[2 * kk + 1][2], P[2 * kk + 1][3])};
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const bf16* brow = Bt + (nt * 8 + g) * FTLD + 16 * kk + 2 * t;
      mma16816(acc[nt], a, ldp(brow), ldp(brow + 8));
    }
  }
}

__device__ __forceinline__ void store_rows(bf16* base, long long ld, const float (&acc)[4][4],
                                           int r0, int r1, bool v0, bool v1, int t, float s0,
                                           float s1) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    if (v0) *reinterpret_cast<uint32_t*>(base + r0 * ld + nt * 8 + 2 * t) =
        pk(acc[nt][0] * s0, acc[nt][1] * s0);
    if (v1) *reinterpret_cast<uint32_t*>(base + r1 * ld + nt * 8 + 2 * t) =
        pk(acc[nt][2] * s1, acc[nt][3] * s1);
  }
}

__global__ void __launch_bounds__(FWARPS * 32) flash_fwd_kernel(FlashParams p) {
  __shared__ __align__(16) bf16 Ks[FKB * FLD];
  __shared__ __align__(16) bf16 Vt[FD * FTLD];
  __shared__ unsigned char kf[FKB];
  const int w = blockIdx.x, h = blockIdx.y;
  const long long C = (long long)p.H * FD;
  const uint32_t row = (uint32_t)w * p.H + h;
  const bf16* qb = p.q + (long long)w * p.Lq * C + h * FD;
  const bf16* kb = p.k + (long long)w * p.Lk * C + h * FD;
  const bf16* vb = p.v + (long long)w * p.Lk * C + h * FD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.z * FQT + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < p.Lq, v1 = r1 < p.Lq, active = blockIdx.z * FQT + warp * 16 < p.Lq;

  uint32_t qa[2][4];
  load_a(qa, qb, C, r0, r1, v0, v1, t);
  float o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < p.Lk; k0 += FKB) {
    __syncthreads();                    // the previous block's tiles are consumed
    load_tile(Ks, nullptr, kb, C, k0, p.Lk);
    load_tile(nullptr, Vt, vb, C, k0, p.Lk);
    load_flags(kf, p, w, k0);
    __syncthreads();
    if (!active) continue;

    float s[8][4];
    mma_rows(s, qa, Ks, g, t);
    float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int f = kf[8 * j + 2 * t + (e & 1)];
        s[j][e] = f == 0 ? s[j][e] * p.scale : (f == 1 ? F_NEG : -INFINITY);
      }
      mb0 = fmaxf(mb0, fmaxf(s[j][0], s[j][1]));
      mb1 = fmaxf(mb1, fmaxf(s[j][2], s[j][3]));
    }
    const float mn0 = fmaxf(m0, qmax(mb0)), mn1 = fmaxf(m1, qmax(mb1));
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      o[i][0] *= c0; o[i][1] *= c0; o[i][2] *= c1; o[i][3] *= c1;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = expf(s[j][e] - (e < 2 ? mn0 : mn1));
        if (e < 2) l0 += x; else l1 += x;
        const int c = k0 + 8 * j + 2 * t + (e & 1);
        if (p.dropout && c < p.Lk && !keep_elem(p, row, e < 2 ? r0 : r1, c)) x = 0.f;
        s[j][e] = x;
      }
    }
    m0 = mn0;
    m1 = mn1;
    mma_acc(o, s, Vt, g, t);
  }
  if (!active) return;
  l0 = qsum(l0);
  l1 = qsum(l1);
  bf16* ob = p.out + (long long)w * p.Lq * C + h * FD;
  store_rows(ob, C, o, r0, r1, v0, v1, t, p.inv_keep / fmaxf(l0, 1e-30f),
             p.inv_keep / fmaxf(l1, 1e-30f));
  if (t == 0) {
    float* lrow = p.lse + (long long)row * p.Lq;
    if (v0) lrow[r0] = m0 + logf(l0);
    if (v1) lrow[r1] = m1 + logf(l1);
  }
}

// one warp per (row, query): delta = sum_d dO * O, both as stored
__global__ void flash_delta_kernel(FlashParams p) {
  const long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= (long long)p.W * p.H * p.Lq) return;
  const long long row = idx / p.Lq;
  const int i = (int)(idx % p.Lq);
  const long long w = row / p.H, h = row % p.H;
  const long long off = (w * p.Lq + i) * p.H * FD + h * FD + lane;
  float x = __bfloat162float(p.o[off]) * __bfloat162float(p.dout[off]);
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  if (lane == 0) p.delta[idx] = x;
}

__global__ void __launch_bounds__(FWARPS * 32) flash_dq_kernel(FlashParams p) {
  __shared__ __align__(16) bf16 Ks[FKB * FLD];
  __shared__ __align__(16) bf16 Vs[FKB * FLD];
  __shared__ __align__(16) bf16 Kt[FD * FTLD];
  __shared__ unsigned char kf[FKB];
  const int w = blockIdx.x, h = blockIdx.y;
  const long long C = (long long)p.H * FD;
  const uint32_t row = (uint32_t)w * p.H + h;
  const bf16* qb = p.q + (long long)w * p.Lq * C + h * FD;
  const bf16* db = p.dout + (long long)w * p.Lq * C + h * FD;
  const bf16* kb = p.k + (long long)w * p.Lk * C + h * FD;
  const bf16* vb = p.v + (long long)w * p.Lk * C + h * FD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.z * FQT + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < p.Lq, v1 = r1 < p.Lq, active = blockIdx.z * FQT + warp * 16 < p.Lq;

  uint32_t qa[2][4], da[2][4];
  load_a(qa, qb, C, r0, r1, v0, v1, t);
  load_a(da, db, C, r0, r1, v0, v1, t);
  const float* lrow = p.lse + (long long)row * p.Lq;
  const float* drow = p.delta + (long long)row * p.Lq;
  const float lse0 = v0 ? lrow[r0] : 0.f, lse1 = v1 ? lrow[r1] : 0.f;
  const float dl0 = v0 ? drow[r0] : 0.f, dl1 = v1 ? drow[r1] : 0.f;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int k0 = 0; k0 < p.Lk; k0 += FKB) {
    __syncthreads();
    load_tile(Ks, Kt, kb, C, k0, p.Lk);
    load_tile(Vs, nullptr, vb, C, k0, p.Lk);
    load_flags(kf, p, w, k0);
    __syncthreads();
    if (!active) continue;

    float s[8][4], dp[8][4];
    mma_rows(s, qa, Ks, g, t);
    mma_rows(dp, da, Vs, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);
        const int f = kf[cl];
        float ds = 0.f;
        if (f != 2) {
          const float x = f == 0 ? s[j][e] * p.scale : F_NEG;
          const float P = expf(x - (e < 2 ? lse0 : lse1));
          float d = dp[j][e];
          if (p.dropout) d = keep_elem(p, row, e < 2 ? r0 : r1, k0 + cl) ? d * p.inv_keep : 0.f;
          ds = P * (d - (e < 2 ? dl0 : dl1)) * p.scale;
        }
        s[j][e] = ds;
      }
    }
    mma_acc(acc, s, Kt, g, t);
  }
  if (!active) return;
  store_rows(p.dq + (long long)w * p.Lq * C + h * FD, C, acc, r0, r1, v0, v1, t, 1.f, 1.f);
}

__global__ void __launch_bounds__(FWARPS * 32) flash_dkv_kernel(FlashParams p) {
  __shared__ __align__(16) bf16 Qs[FKB * FLD];
  __shared__ __align__(16) bf16 Ds[FKB * FLD];
  __shared__ __align__(16) bf16 Qt[FD * FTLD];
  __shared__ __align__(16) bf16 Dt[FD * FTLD];
  __shared__ float lse_s[FKB], delta_s[FKB];
  const int w = blockIdx.x, h = blockIdx.y;
  const long long C = (long long)p.H * FD;
  const uint32_t row = (uint32_t)w * p.H + h;
  const bf16* qb = p.q + (long long)w * p.Lq * C + h * FD;
  const bf16* db = p.dout + (long long)w * p.Lq * C + h * FD;
  const bf16* kb = p.k + (long long)w * p.Lk * C + h * FD;
  const bf16* vb = p.v + (long long)w * p.Lk * C + h * FD;
  const float* lrow = p.lse + (long long)row * p.Lq;
  const float* drow = p.delta + (long long)row * p.Lq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.z * FQT + warp * 16 + g, r1 = r0 + 8;    // key rows
  const bool v0 = r0 < p.Lk, v1 = r1 < p.Lk, active = blockIdx.z * FQT + warp * 16 < p.Lk;
  const bool m0 = v0 && p.mask && !p.mask[(long long)w * p.Lk + r0];
  const bool m1 = v1 && p.mask && !p.mask[(long long)w * p.Lk + r1];

  uint32_t ka[2][4], va[2][4];
  load_a(ka, kb, C, r0, r1, v0, v1, t);
  load_a(va, vb, C, r0, r1, v0, v1, t);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int q0 = 0; q0 < p.Lq; q0 += FKB) {
    __syncthreads();
    load_tile(Qs, Qt, qb, C, q0, p.Lq);
    load_tile(Ds, Dt, db, C, q0, p.Lq);
    for (int i = threadIdx.x; i < FKB; i += blockDim.x) {
      const bool in = q0 + i < p.Lq;
      lse_s[i] = in ? lrow[q0 + i] : INFINITY;    // P = 0 for queries past Lq
      delta_s[i] = in ? drow[q0 + i] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    float st[8][4], dpt[8][4];
    mma_rows(st, ka, Qs, g, t);      // S^T: keys x queries
    mma_rows(dpt, va, Ds, g, t);     // dP^T
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = 8 * j + 2 * t + (e & 1);
        const bool valid = e < 2 ? v0 : v1;
        float P = 0.f, d = 0.f;
        if (valid) {
          const float x = (e < 2 ? m0 : m1) ? F_NEG : st[j][e] * p.scale;
          P = expf(x - lse_s[cl]);
          d = dpt[j][e];
        }
        float pw = P;
        if (p.dropout && valid && q0 + cl < p.Lq) {
          if (keep_elem(p, row, q0 + cl, e < 2 ? r0 : r1)) {
            d *= p.inv_keep;
            pw *= p.inv_keep;
          } else {
            d = 0.f;
            pw = 0.f;
          }
        }
        st[j][e] = P * (d - delta_s[cl]) * p.scale;   // dS^T
        dpt[j][e] = pw;                                // Pw^T
      }
    }
    mma_acc(dv, dpt, Dt, g, t);
    mma_acc(dk, st, Qt, g, t);
  }
  if (!active) return;
  const long long off = (long long)w * p.Lk * C + h * FD;
  store_rows(p.dk + off, C, dk, r0, r1, v0, v1, t, 1.f, 1.f);
  store_rows(p.dv + off, C, dv, r0, r1, v0, v1, t, 1.f, 1.f);
}

FlashParams make_params(const void* q, const void* k, const void* v, const void* o,
                        const void* dout, void* out, void* dq, void* dk, void* dv, float* lse,
                        float* delta, const unsigned char* mask, int W, int Lq, int Lk, int H,
                        float scale, int seed, unsigned int thresh, int dropout,
                        float inv_keep) {
  return FlashParams{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
                     (const bf16*)dout, (bf16*)out, (bf16*)dq, (bf16*)dk, (bf16*)dv,
                     lse, delta, mask, W, Lq, Lk, H, scale, (unsigned int)seed, thresh,
                     dropout, inv_keep};
}

}  // namespace

extern "C" {

// out = attention(q, k, v) with dropout, lse [W*H, Lq]
int vgqa_flash_train_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                         const unsigned char* mask, int W, int Lq, int Lk, int H, float scale,
                         int seed, unsigned int thresh, int dropout, float inv_keep,
                         void* stream) {
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  FlashParams p = make_params(q, k, v, nullptr, nullptr, out, nullptr, nullptr, nullptr, lse,
                              nullptr, mask, W, Lq, Lk, H, scale, seed, thresh, dropout,
                              inv_keep);
  dim3 grid(W, H, (Lq + FQT - 1) / FQT);
  flash_fwd_kernel<<<grid, FWARPS * 32, 0, reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// dq, dk, dv from (q, k, v, o, dout, lse); delta [W*H, Lq] f32 is scratch
int vgqa_flash_train_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, float* delta,
                         const unsigned char* mask, void* dq, void* dk, void* dv, int W, int Lq,
                         int Lk, int H, float scale, int seed, unsigned int thresh, int dropout,
                         float inv_keep, void* stream) {
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  FlashParams p = make_params(q, k, v, o, dout, nullptr, dq, dk, dv, const_cast<float*>(lse),
                              delta, mask, W, Lq, Lk, H, scale, seed, thresh, dropout, inv_keep);
  const long long warps = (long long)W * H * Lq;
  flash_delta_kernel<<<(unsigned)((warps * 32 + 255) / 256), 256, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_dq_kernel<<<dim3(W, H, (Lq + FQT - 1) / FQT), FWARPS * 32, 0, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_dkv_kernel<<<dim3(W, H, (Lk + FQT - 1) / FQT), FWARPS * 32, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
