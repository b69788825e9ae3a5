// K3's attention forward, behind a plain C interface: the forward of
// vgqa_tpu/ops/pallas/flash_train.py (K3 flash_mha_train, Pallas
// _fwd_kernel; its backward is flash_train.cu), bf16 and float32. K4
// flash_mha and K5 flash_gqa_causal have their own Hopper kernels,
// flash_mha_sm90.cu and flash_gqa_sm90.cu.
//
// The bf16 kernel, attn_fwd_kernel<32, MODE_K3>: a block of 4 warps owns
// one (batch row, head, tile of 64 queries); each warp holds 16 query rows
// as mma.sync A fragments, keys and values stream through shared memory in
// blocks of 64 rows, double-buffered with cp.async (the next block loads
// while the current one computes), S = q k^T and P V run on the tensor cores
// (m16n8k16, bf16 in, f32 accumulate; V's fragments come from its row-major
// tile through ldmatrix.trans) and the softmax is online (running max and
// sum in f32), so neither the [Lq, Lk] logits nor the probabilities reach
// device memory. P is rounded to bf16 as the P V operand, as the Pallas
// kernel does on the TPU.
//
// Operands are addressed by strides:
//   q[b, h, i, d] = q + b*q_sb + h*q_sh + i*q_sl + d   (d contiguous)
//   k[b, hk, j, d], v likewise with hk = h / group (group 1 here)
//   out[b, h, i, d] likewise.
// Rows must be 16-byte aligned (the loads move 8 bf16 at a time).
//
// K3 (MODE_K3): keys whose mask byte is 0 get -1e30 (finite, as in Pallas),
// keys past Lk do not exist (-inf); on the packed [W, L, H*32] layout, with the
// logits in base 2 (log2(e) folded into the scale, one ex2 per element),
// lse = m + log(l) written in natural log to [W*H, Lq], and dropout: the
// keep decision of (folded row b = w*H + h, query i, key j) is word (j mod 4)
// of Philox4x32-10 with key (seed + b, 0) and counter (i, j / 4, 0, 0), kept
// when its top 24 bits are >= thresh. In the accumulator layout the lanes
// 2u and 2u + 1 of a quad hold the four keys of one group for rows r0 and
// r1, so each lane draws one call (row r0 or r1) per group and the two
// exchange their words' keep bits by one shuffle: one call per four
// elements. The kernel writes the decisions as bits ([W*H, Lq, ceil(Lk/32)]
// uint32, bit j % 32 of word j / 32, zero past Lk), which the backward
// reads, so the mask is drawn once per training step. l sums the kept and
// the dropped probabilities; out = (kept P) V / l / (1 - rate).

#include "attention_common.cuh"
#include "f32_rows.cuh"

using namespace vgqa_attn;

namespace {

// the template's one instance; the value is part of the kernel's name,
// attn_fwd_kernel<32, 2>, which chip_k4.py --sass compares across trees
constexpr int MODE_K3 = 2;
constexpr int AWARPS = 4;
constexpr int AQT = 16 * AWARPS;      // query rows per block
constexpr int AKB = 64;               // keys per streamed block
constexpr float A_NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

constexpr int K3_MAX_LK = 1024;        // K3's keys (supported_seq); its key terms stay resident

// shared memory: two stages of K and V tiles [64][D + 8], then K3's key
// terms (a float2 per key of the row, written once)
template <int D, int MODE>
constexpr int smem_bytes() {
  return 2 * 2 * AKB * (D + 8) * 2 + K3_MAX_LK * 8;
}

struct AttnParams {
  const bf16* q; const bf16* k; const bf16* v; bf16* out;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  const unsigned char* mask;   // K3: [B, Lk], nonzero = attend, or null
  // length and q_offset are unused: they keep the parameter block's layout,
  // on which K3's compiled code (its SASS, compared by chip_k4.py --sass)
  // depends
  const int* length;
  int group, Lq, Lk, q_offset;
  float scale;
  // K3 only
  float* lse;                  // [B*H, Lq]
  uint32_t* bits;              // [B*H, Lq, ceil(Lk/32)] keep bits, when dropout
  uint32_t seed, thresh;       // keep iff (word >> 8) >= thresh
  int dropout;                 // 0: rate 0, nothing drawn
  float inv_keep;              // 1 / (1 - rate)
};

// Philox4x32-10 (Random123), counter (c0, c1, 0, 0), key (key, 0)
__device__ __forceinline__ uint4 philox4(uint32_t key, uint32_t c0, uint32_t c1) {
  uint32_t c2 = 0u, c3 = 0u, k0 = key, k1 = 0u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    const unsigned long long p0 = (unsigned long long)0xD2511F53u * c0;
    const unsigned long long p1 = (unsigned long long)0xCD9E8D57u * c2;
    c0 = (uint32_t)(p1 >> 32) ^ c1 ^ k0;
    c1 = (uint32_t)p1;
    c2 = (uint32_t)(p0 >> 32) ^ c3 ^ k1;
    c3 = (uint32_t)p0;
  }
  return make_uint4(c0, c1, c2, c3);
}

__device__ __forceinline__ uint32_t keep_nibble(uint4 w, uint32_t thresh) {
  return (uint32_t)((w.x >> 8) >= thresh) | ((uint32_t)((w.y >> 8) >= thresh) << 1) |
         ((uint32_t)((w.z >> 8) >= thresh) << 2) | ((uint32_t)((w.w >> 8) >= thresh) << 3);
}

template <int D, int MODE>
__global__ void __launch_bounds__(AWARPS * 32) attn_fwd_kernel(AttnParams p) {
  static_assert(MODE == MODE_K3, "K3's forward is the one instance");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                  // [2][64][D + 8]
  bf16* Vs = Ks + 2 * AKB * (D + 8);                         // [2][64][D + 8]
  unsigned char* kf = smem + 2 * 2 * AKB * (D + 8) * 2;
  // K3: logit x = fma(s, kt.x, kt.y) of key j with kt = kterm[j]: (scale
  // log2(e), 0) attended, (0, -1e30) masked, (0, -inf) past Lk
  float2* kterm = reinterpret_cast<float2*>(kf);
  const int b = blockIdx.x, h = blockIdx.y, tile = blockIdx.z;
  const int hk = h / p.group;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + hk * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + hk * p.v_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int r0 = tile * AQT + warp * 16 + g, r1 = r0 + 8;
  const bool v0 = r0 < p.Lq, v1 = r1 < p.Lq, active = tile * AQT + warp * 16 < p.Lq;

  const int nblk = (p.Lk + AKB - 1) / AKB;
  // the folded row, the scale in base 2, the row this lane draws for
  const uint32_t frow = (uint32_t)b * gridDim.y + h;
  const float scale = p.scale * LOG2E;
  const int drow = (t & 1) ? r1 : r0;
  const int nw = (p.Lk + 31) / 32;

  // key flag (0 attend, 1 masked, 2 past Lk) of key gj
  auto flag = [&](int gj) -> unsigned char {
    if (gj >= p.Lk) return 2;
    return (p.mask && !p.mask[(long long)b * p.Lk + gj]) ? 1 : 0;
  };
  // stage key block `blk` into buffer `buf`: K and V rows by cp.async
  auto stage = [&](int blk, int buf) {
    const int k0 = blk * AKB;
    load_tile<D>(Ks + buf * AKB * (D + 8), kb, p.k_sl, k0, p.Lk);
    load_tile<D>(Vs + buf * AKB * (D + 8), vb, p.v_sl, k0, p.Lk);
    cp_async_commit();
  };
  stage(0, 0);
  // every key's term once (one load latency per block, not one per key block)
  for (int j = threadIdx.x; j < nblk * AKB; j += blockDim.x) {
    const unsigned char f = flag(j);
    kterm[j] = f == 0 ? make_float2(scale, 0.f)
                      : make_float2(0.f, f == 1 ? A_NEG : -INFINITY);
  }

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
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                    // block `blk` has landed for every thread
    if (active) {
      // K3 dropout: this lane's call per group (row drow, keys 8j + 4u ..
      // + 3 of the block), one nibble per j; the quad partner (lane ^ 1)
      // holds the other row of the same groups
      uint32_t kr0 = 0u, kr1 = 0u;
      if (p.dropout) {
        const uint32_t u = t >> 1;
        uint32_t own = 0u;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          own |= keep_nibble(philox4(p.seed + frow, (uint32_t)drow,
                                     (uint32_t)(k0 >> 2) + 2 * j + u), p.thresh) << (4 * j);
        const uint32_t other = __shfl_xor_sync(0xffffffffu, own, 1);
        // bit 4j + (e & 1) of kr0 / kr1: this lane's keys (at 2 (t & 1)
        // and + 1 in their group) of rows r0 / r1
        kr0 = ((t & 1) ? other : own) >> (2 * (t & 1));
        kr1 = ((t & 1) ? own : other) >> (2 * (t & 1));
        // the row's bits of this block: groups 2j + u at nibble 2j + u of
        // words k0/32 (j < 4) and k0/32 + 1; lanes t and t ^ 2 share a row
        uint32_t w_lo = 0u, w_hi = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          w_lo |= ((own >> (4 * j)) & 0xFu) << (4 * (2 * j + u));
          w_hi |= ((own >> (4 * (j + 4))) & 0xFu) << (4 * (2 * j + u));
        }
        w_lo |= __shfl_xor_sync(0xffffffffu, w_lo, 2);
        w_hi |= __shfl_xor_sync(0xffffffffu, w_hi, 2);
        const int wg = k0 / 32 + (int)u;
        if (drow < p.Lq && wg < nw) {
          uint32_t word = u ? w_hi : w_lo;
          const int nb = p.Lk - wg * 32;
          if (nb < 32) word &= (1u << nb) - 1u;
          p.bits[((long long)frow * p.Lq + drow) * nw + wg] = word;
        }
      }

      float s[8][4];
      mma_rows<D, 8>(s, qa, Ks + buf * AKB * (D + 8), g, t);
      float mb0 = -INFINITY, mb1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // the terms of this lane's two keys in one 16-byte load
        const float4 kt2 = *reinterpret_cast<const float4*>(kterm + k0 + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = (e & 1) ? fmaf(s[j][e], kt2.z, kt2.w) : fmaf(s[j][e], kt2.x, kt2.y);
        mb0 = fmaxf(mb0, fmaxf(s[j][0], s[j][1]));
        mb1 = fmaxf(mb1, fmaxf(s[j][2], s[j][3]));
      }
      const float mn0 = fmaxf(m0, qmax(mb0)), mn1 = fmaxf(m1, qmax(mb1));
      const float c0 = ex2(m0 - mn0);
      const float c1 = ex2(m1 - mn1);
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
          float x = ex2(s[j][e] - (e < 2 ? mn0 : mn1));
          if (e < 2) l0 += x; else l1 += x;
          if (p.dropout && !((e < 2 ? kr0 : kr1) & (1u << (4 * j + (e & 1)))))
            x = 0.f;
          s[j][e] = x;
        }
      }
      m0 = mn0;
      m1 = mn1;
      mma_acc<D, 8>(o, s, Vs + buf * AKB * (D + 8), lane);
    }
    __syncthreads();                    // buffer `buf` is free for block blk + 2
  }
  if (!active) return;
  l0 = qsum(l0);
  l1 = qsum(l1);
  const float keep = p.inv_keep;
  const float s0 = keep / fmaxf(l0, 1e-30f), s1 = keep / fmaxf(l1, 1e-30f);
  bf16* ob = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (v0) *reinterpret_cast<uint32_t*>(ob + r0 * p.o_sl + nt * 8 + 2 * t) =
        pk(o[nt][0] * s0, o[nt][1] * s0);
    if (v1) *reinterpret_cast<uint32_t*>(ob + r1 * p.o_sl + nt * 8 + 2 * t) =
        pk(o[nt][2] * s1, o[nt][3] * s1);
  }
  if (t == 0) {
    // natural log; a row whose keys are all masked keeps lse = -1e30 (as
    // -1e30 + log(l) rounds in f32), which the backward reads back as such
    float* lrow = p.lse + (long long)frow * p.Lq;
    if (v0) lrow[r0] = m0 <= 0.5f * A_NEG ? A_NEG : m0 * LN2 + logf(l0);
    if (v1) lrow[r1] = m1 <= 0.5f * A_NEG ? A_NEG : m1 * LN2 + logf(l1);
  }
}

template <int D, int MODE>
int launch_d(const AttnParams& p, dim3 grid, cudaStream_t st) {
  static bool configured = false;     // the dynamic shared memory limit, set once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attn_fwd_kernel<D, MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<D, MODE>());
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  attn_fwd_kernel<D, MODE><<<grid, AWARPS * 32, smem_bytes<D, MODE>(), st>>>(p);
  return (int)cudaGetLastError();
}

// K3's head dim: the grounding encoder's
constexpr int K3_D = 32;

// ---------------------------------------------------------------------------
// K3's forward in float32 (the JAX kernel at f32, where its bf16 rounding
// points are no-ops): FFMA only, nothing rounded. vgqa_f32::row_attention
// (f32_rows.cuh, shared with K2's f32 kernel) with one block per (w, h,
// tile of 128 queries), one thread per query row; each chunk of 32 keys
// brings its key terms (TrainF32Terms) and, under dropout, its keep bits. The logits are
// in base 2 as in the bf16 instance, and the keep decisions are the same
// function: key j of (folded row b, query i) is word j mod 4 of the Philox
// call with key (seed + b, 0) and counter (i, j / 4), so each thread draws
// 8 calls per chunk (one per four keys, as the bf16 kernel) and writes the
// chunk's 32 decisions as one word of the same bit layout. At [512, 418,
// 32] this is 64 FFMA per query-key pair: ~0.17 ms at the card's 67 TFLOP/s
// outside the tensor cores, against ~0.02 ms of bytes.
// ---------------------------------------------------------------------------
constexpr int F3_QT = 128;     // queries per block, one per thread
constexpr int F3_KC = vgqa_f32::F32_KC;   // keys per streamed chunk (one keep-bit word)

struct Train32Params {
  const float* q; const float* k; const float* v; float* out;
  float* lse; uint32_t* bits; const unsigned char* mask;
  int Lq, Lk, H;
  float scale;
  uint32_t seed, thresh;
  int dropout;
  float inv_keep;
};

struct TrainF32Terms {         // K3's key terms and keep bits
  Train32Params p;
  int w, i;
  uint32_t frow;
  float scale2;
  int nw;
  float2* kt_s;

  __device__ void stage(int k0) {
    const int tid = threadIdx.x;
    if (tid < F3_KC) {
      // logit x = fma(s, kt.x, kt.y): (scale log2(e), 0) attended, (0,
      // -1e30) masked, (0, -inf) past Lk
      const int j = k0 + tid;
      float2 kt = make_float2(scale2, 0.f);
      if (j >= p.Lk) kt = make_float2(0.f, -INFINITY);
      else if (p.mask && !p.mask[(long long)w * p.Lk + j]) kt = make_float2(0.f, A_NEG);
      kt_s[tid] = kt;
    }
  }
  __device__ uint32_t keep(int k0) const {
    if (!p.dropout) return ~0u;
    uint32_t keep = 0u;
#pragma unroll
    for (int c = 0; c < F3_KC / 4; ++c)
      keep |= keep_nibble(philox4(p.seed + frow, (uint32_t)i, (uint32_t)(k0 >> 2) + c),
                          p.thresh) << (4 * c);
    const int nb = p.Lk - k0;
    if (nb < 32) keep &= (1u << nb) - 1u;
    p.bits[((long long)frow * p.Lq + i) * nw + k0 / 32] = keep;
    return keep;
  }
  __device__ float logit(float dot, int j) const {
    const float2 kt = kt_s[j];
    return fmaf(dot, kt.x, kt.y);
  }
  static __device__ float expb(float x) { return ex2(x); }
};

__global__ void __launch_bounds__(F3_QT) train_fwd_f32_kernel(Train32Params p) {
  __shared__ float2 kt_s[F3_KC];
  const int w = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int i = blockIdx.z * F3_QT + tid;
  const bool active = i < p.Lq;
  const long long C = (long long)p.H * K3_D;
  const uint32_t frow = (uint32_t)w * p.H + h;

  float q[K3_D], o[K3_D];
  const float* qr = p.q + ((long long)w * p.Lq + (active ? i : 0)) * C + h * K3_D;
#pragma unroll
  for (int d = 0; d < K3_D; d += 4) {
    const float4 x = active ? *reinterpret_cast<const float4*>(qr + d)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    q[d] = x.x; q[d + 1] = x.y; q[d + 2] = x.z; q[d + 3] = x.w;
  }
  TrainF32Terms terms{p, w, i, frow, p.scale * LOG2E, (p.Lk + 31) / 32, kt_s};
  float m, l;
  vgqa_f32::row_attention<K3_D, F3_QT>(p.k + (long long)w * p.Lk * C + h * K3_D, C,
                                       p.v + (long long)w * p.Lk * C + h * K3_D, C, p.Lk,
                                       q, o, m, l, active, terms);
  if (!active) return;
  const float sc = p.inv_keep / fmaxf(l, 1e-30f);
  float* orow = p.out + ((long long)w * p.Lq + i) * C + h * K3_D;
#pragma unroll
  for (int d = 0; d < K3_D; d += 4)
    *reinterpret_cast<float4*>(orow + d) =
        make_float4(o[d] * sc, o[d + 1] * sc, o[d + 2] * sc, o[d + 3] * sc);
  // natural log; a row whose keys are all masked keeps lse = -1e30
  p.lse[(long long)frow * p.Lq + i] = m <= 0.5f * A_NEG ? A_NEG : m * LN2 + logf(l);
}


}  // namespace

extern "C" {

// K3 forward: q [W, Lq, H*32], k/v [W, Lk, H*32], out like q (contiguous);
// lse [W*H, Lq] f32; bits [W*H, Lq, ceil(Lk/32)] uint32 when dropout, else
// unused; mask [W, Lk] uint8 or null.
int vgqa_flash_train_fwd(const void* q, const void* k, const void* v, void* out, float* lse,
                         void* bits, const unsigned char* mask, int W, int Lq, int Lk, int H,
                         float scale, int seed, unsigned int thresh, int dropout,
                         float inv_keep, void* stream) {
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || Lk > K3_MAX_LK || H > 65535 ||
      (Lq + AQT - 1) / AQT > 65535 || (dropout && !bits))
    return (int)cudaErrorInvalidValue;
  const long long C = (long long)H * K3_D;
  AttnParams p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
               (long long)Lq * C, (long long)K3_D, C, (long long)Lk * C, (long long)K3_D, C,
               (long long)Lk * C, (long long)K3_D, C, (long long)Lq * C, (long long)K3_D, C,
               mask, nullptr, 1, Lq, Lk, 0, scale,
               lse, (uint32_t*)bits, (uint32_t)seed, thresh, dropout, inv_keep};
  return launch_d<K3_D, MODE_K3>(p, dim3(W, H, (Lq + AQT - 1) / AQT),
                                 reinterpret_cast<cudaStream_t>(stream));
}

// K3 forward in float32: the same operands and layout as
// vgqa_flash_train_fwd with float q/k/v/out; keep bits equal to the bf16
// kernel's for the same (seed, W, H, Lq, Lk, rate).
int vgqa_flash_train_fwd_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                             void* bits, const unsigned char* mask, int W, int Lq, int Lk, int H,
                             float scale, int seed, unsigned int thresh, int dropout,
                             float inv_keep, void* stream) {
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || Lk > K3_MAX_LK || H > 65535 ||
      (Lq + F3_QT - 1) / F3_QT > 65535 || (dropout && !bits))
    return (int)cudaErrorInvalidValue;
  Train32Params p{(const float*)q, (const float*)k, (const float*)v, (float*)out, lse,
                  (uint32_t*)bits, mask, Lq, Lk, H, scale, (uint32_t)seed, thresh, dropout,
                  inv_keep};
  train_fwd_f32_kernel<<<dim3(W, H, (Lq + F3_QT - 1) / F3_QT), F3_QT, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
