// Backward of the differentiable attention with in-kernel probability
// dropout (K3), behind a plain C interface: the port of the backward of
// vgqa_tpu/ops/pallas/flash_train.py (flash_mha_train; Pallas _bwd_kernel).
// The forward is attn_fwd_kernel<32, MODE_K3> in flash_attention.cu.
// flash_bwd_f32_kernel below is the float32 form (FFMA, nothing rounded).
//
// Layout: q/o/dout/dq are [W, Lq, H*32] and k/v/dk/dv [W, Lk, H*32],
// contiguous, heads packed in the channel dim; the folded batch row of
// (w, h) is w*H + h, as in the JAX wrapper's fold. key_mask [W, Lk] (uint8,
// nonzero = attend) or null. lse is f32 [W*H, Lq] (natural log); bits the
// forward's keep bits [W*H, Lq, ceil(Lk/32)] (bit j % 32 of word j / 32 is
// key j's keep decision), read only when dropout is on.
//
// One launch, one pass, no atomics. A block of 8 warps owns one key tile of
// 128 keys of one (w, h) and keeps its K and V rows as mma.sync A fragments
// and its dk and dv in registers; the ceil(Lk / 128) <= 8 key tiles of a
// (w, h) form one thread-block cluster. Each block:
//   1. computes delta = rowsum(dO * O) (O as stored) for its share of the
//      queries, and after a cluster barrier copies the others' shares
//      through distributed shared memory;
//   2. walks the query blocks of 64 (q and dO tiles and the tile's keep
//      bits double-buffered with cp.async), and per block recomputes
//      S^T = K q^T and dP^T = V dO^T once on the tensor cores, takes
//      P = 2^(S^T scale log2(e) - lse log2(e)) and the keep bits, forms
//      dS = P (dP kept / (1 - rate) - delta) scale, accumulates
//      dv += Pw^T dO and dk += dS^T q (Pw = kept P / (1 - rate); the
//      second operands through ldmatrix.trans from the row-major tiles), and
//      writes dS^T (bf16, as Pallas rounds it) to shared memory, where the
//      block's warps form dq = dS K for the 64 queries on the tensor cores
//      into the block's own f32 partial [Lq, 32] in shared memory;
//   3. after a cluster barrier sums, for its share of the queries, the
//      cluster's partials in the fixed order of the key tiles and writes
//      dq once. Every output element has one writer and one summation
//      order, so the results are bit-equal between runs.
// Masked keys get -1e30 and keys past Lk do not exist, as in the forward; a
// row whose keys are all masked has lse = -1e30, and P = 1 for its keys.
// 128-key tiles measured faster than 64-key tiles of 4 warps at L = 124
// and 418 on the H100 (PERF.md).
//
// What bounds it on an H100: the bytes (q, k, v, O, dO and lse in, dq, dk
// and dv out: 33 us at [512, 418, 32]) and, beside them, the exponentials:
// one per query-key pair, 89.5 M at [512, 418, 32], ~21 us on the SFUs (16
// per SM per clock); the five 32-deep products per pair (S, dP, dv, dk,
// dq) are ~29 us of dense bf16. The kernel therefore keeps the logits,
// probabilities, mask and dS out of device memory, computes each
// exponential once, and draws no random numbers.

#include <cooperative_groups.h>

#include "attention_common.cuh"

namespace cg = cooperative_groups;
using namespace vgqa_attn;

namespace {

constexpr int FD = 32;                 // head dim
constexpr int NW = 8;                  // warps per block, 16 key rows each
constexpr int KT = 16 * NW;            // keys per block (its key tile)
constexpr int KW = KT / 32;            // keep-bit words per query of a key tile
constexpr int QB = 64;                 // queries per streamed block
constexpr int TLD = FD + 8;            // row stride of [row][d] tiles (bf16)
constexpr int SLD = QB + 8;            // row stride of the dS^T tile [key][query] (bf16)
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr float F_NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct BwdParams {
  const bf16* q; const bf16* k; const bf16* v; const bf16* o; const bf16* dout;
  bf16* dq; bf16* dk; bf16* dv;
  const float* lse;
  const uint32_t* bits;        // keep bits, when dropout
  const unsigned char* mask;   // [W, Lk] or null
  int W, Lq, Lk, H;
  float scale;
  int dropout;
  float inv_keep;
};

// shared memory of a block (bytes), in the order the kernel lays it out
constexpr int SM_K = KT * TLD * 2;             // K rows (dq's B operand)
constexpr int SM_QD = 2 * 2 * QB * TLD * 2;    // q, dO: 2 stages each
constexpr int SM_DS = KT * SLD * 2;            // dS^T
constexpr int SM_BITS = 2 * KW * QB * 4;       // keep bits: 2 stages
int smem_bytes(int Lq) {                       // + lse, delta [lq_pad] and the dq partial
  const int lq_pad = (Lq + QB - 1) / QB * QB;
  return SM_K + SM_QD + SM_DS + SM_BITS + 2 * lq_pad * 4 + Lq * FD * 4;
}

// the f32 dq partial [Lq][32] is swizzled in units of 8 floats so that the
// fragment stores of a half warp fall on distinct banks
__device__ __forceinline__ int dq_at(int q, int d) { return q * FD + (d ^ ((q & 3) << 3)); }

__global__ void __launch_bounds__(NW * 32, 2) flash_bwd_kernel(BwdParams p, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);                            // [KT][TLD]
  bf16* Qs = reinterpret_cast<bf16*>(smem + SM_K);                    // [2][QB][TLD]
  bf16* Os = Qs + 2 * QB * TLD;                                        // [2][QB][TLD] dO
  bf16* dSs = reinterpret_cast<bf16*>(smem + SM_K + SM_QD);           // [KT][SLD]
  uint32_t* bits_s = reinterpret_cast<uint32_t*>(smem + SM_K + SM_QD + SM_DS);
  const int lq_pad = (p.Lq + QB - 1) / QB * QB;
  float* lse_s = reinterpret_cast<float*>(bits_s + 2 * KW * QB);      // [lq_pad] base 2
  float* delta_s = lse_s + lq_pad;                                     // [lq_pad]
  float* dq_part = delta_s + lq_pad;                                   // [Lq][32] swizzled

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = ntiles > 1 ? (int)cluster.block_rank() : 0;   // the key tile
  const int frow = blockIdx.x / ntiles;                           // w*H + h
  const int w = frow / p.H, h = frow % p.H;
  const long long C = (long long)p.H * FD;
  const bf16* qb = p.q + (long long)w * p.Lq * C + h * FD;
  const bf16* ob = p.o + (long long)w * p.Lq * C + h * FD;
  const bf16* db = p.dout + (long long)w * p.Lq * C + h * FD;
  const bf16* kb = p.k + (long long)w * p.Lk * C + h * FD;
  const bf16* vb = p.v + (long long)w * p.Lk * C + h * FD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int key0 = rank * KT;
  const int r0 = key0 + warp * 16 + g, r1 = r0 + 8;               // this lane's key rows
  const bool v0 = r0 < p.Lk, v1 = r1 < p.Lk;
  const bool m0 = v0 && p.mask && !p.mask[(long long)w * p.Lk + r0];
  const bool m1 = v1 && p.mask && !p.mask[(long long)w * p.Lk + r1];
  // logit (base 2) x = fma(S^T, kt.x, kt.y) of key row r0 / r1: (scale
  // log2(e), 0) attended, (0, -1e30) masked, (0, -inf) past Lk (P = 0)
  const float scale2 = p.scale * LOG2E;
  const float2 kt0 = !v0 ? make_float2(0.f, -INFINITY)
                         : (m0 ? make_float2(0.f, F_NEG) : make_float2(scale2, 0.f));
  const float2 kt1 = !v1 ? make_float2(0.f, -INFINITY)
                         : (m1 ? make_float2(0.f, F_NEG) : make_float2(scale2, 0.f));
  const int nw = (p.Lk + 31) / 32;
  const int nqb = lq_pad / QB;
  const uint32_t* brow = p.dropout ? p.bits + (long long)frow * p.Lq * nw : nullptr;

  // stage query block `qi` into buffer `buf`: q and dO rows, keep bits
  auto stage = [&](int qi, int buf) {
    const int q0 = qi * QB;
    load_tile<FD>(Qs + buf * QB * TLD, qb, C, q0, p.Lq);
    load_tile<FD>(Os + buf * QB * TLD, db, C, q0, p.Lq);
    if (p.dropout) {
      for (int i = threadIdx.x; i < KW * QB; i += blockDim.x) {
        const int wi = i / QB, qq = i % QB, word = key0 / 32 + wi;
        const bool ok = q0 + qq < p.Lq && word < nw;
        cp_async4(bits_s + (buf * KW + wi) * QB + qq,
                  ok ? brow + (long long)(q0 + qq) * nw + word : brow, ok);
      }
    }
    cp_async_commit();
  };
  load_tile<FD>(Ks, kb, C, key0, p.Lk, KT);
  stage(0, 0);

  // 1. lse in base 2 for every query (+inf past Lq: P = 0 there), and
  // delta for this block's share of the queries, 4 threads per query
  for (int i = threadIdx.x; i < lq_pad; i += blockDim.x) {
    float l = INFINITY;
    if (i < p.Lq) {
      l = p.lse[(long long)frow * p.Lq + i];
      l = l <= 0.5f * F_NEG ? F_NEG : l * LOG2E;
    }
    lse_s[i] = l;
    if (i >= p.Lq) delta_s[i] = 0.f;
  }
  const int share = (p.Lq + ntiles - 1) / ntiles;
  const int s_lo = rank * share, s_hi = min(p.Lq, s_lo + share);
  for (int base = s_lo; base < s_hi; base += blockDim.x / 4) {
    const int i = base + threadIdx.x / 4, c8 = (threadIdx.x & 3) * 8;
    float x = 0.f;
    if (i < s_hi) {
      const uint4 ov = *reinterpret_cast<const uint4*>(ob + (long long)i * C + c8);
      const uint4 gv = *reinterpret_cast<const uint4*>(db + (long long)i * C + c8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 of = __bfloat1622float2(o2[e]), df = __bfloat1622float2(d2[e]);
        x += of.x * df.x + of.y * df.y;
      }
    }
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    if (i < s_hi && (threadIdx.x & 3) == 0) delta_s[i] = x;
  }
  if (ntiles > 1) {
    cluster.sync();                       // every share of delta is written
    for (int i = threadIdx.x; i < p.Lq; i += blockDim.x) {
      const int owner = i / share;
      if (owner != rank) delta_s[i] = cluster.map_shared_rank(delta_s, owner)[i];
    }
  }

  uint32_t ka[FD / 16][4], va[FD / 16][4];
  load_q<FD>(ka, kb, C, r0, r1, v0, v1, t);
  load_q<FD>(va, vb, C, r0, r1, v0, v1, t);
  float dk[FD / 8][4], dv[FD / 8][4];
#pragma unroll
  for (int i = 0; i < FD / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  // this lane's keep bits: word (warp / 2) of the tile's keys, bit of r0
  const int kwi = (warp * 16) / 32, kbit = (warp & 1) * 16 + g;
  // dq = dS K: warp `warp` forms queries 16 (warp % 4) .. + 16, dims
  // 16 (warp / 4) .. + 16
  const int dq_row = (warp & 3) * 16, dq_np = warp >> 2;

  for (int qi = 0; qi < nqb; ++qi) {
    const int buf = qi & 1, q0 = qi * QB;
    if (qi + 1 < nqb) {
      stage(qi + 1, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();      // block qi has landed; dS^T of block qi - 1 is consumed
    const bf16* Qt = Qs + buf * QB * TLD;
    const bf16* Ot = Os + buf * QB * TLD;
    const uint32_t* bt = bits_s + (buf * KW + kwi) * QB;

    // 2. two halves of 32 queries: S^T, dP^T -> P, Pw, dS -> dv, dk, dS^T
#pragma unroll
    for (int hq = 0; hq < 2; ++hq) {
      float st[4][4], dpt[4][4];
      mma_rows<FD, 4>(st, ka, Qt + hq * 32 * TLD, g, t);
      mma_rows<FD, 4>(dpt, va, Ot + hq * 32 * TLD, g, t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ql = hq * 32 + 8 * j + 2 * t;              // local query of e = 0, 2
        const float2 l2 = *reinterpret_cast<const float2*>(lse_s + q0 + ql);
        const float2 d2 = *reinterpret_cast<const float2*>(delta_s + q0 + ql);
        uint2 kw = make_uint2(~0u, ~0u);                     // rate 0: all kept, inv_keep 1
        if (p.dropout) kw = *reinterpret_cast<const uint2*>(bt + ql);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse2 = (e & 1) ? l2.y : l2.x, dl = (e & 1) ? d2.y : d2.x;
          const float2 kt = e < 2 ? kt0 : kt1;
          const float P = ex2(fmaf(st[j][e], kt.x, kt.y) - lse2);
          const bool keep = ((e & 1) ? kw.y : kw.x) >> (kbit + (e < 2 ? 0 : 8)) & 1u;
          const float kp = keep ? p.inv_keep : 0.f;
          st[j][e] = P * (dpt[j][e] * kp - dl) * p.scale;    // dS^T
          dpt[j][e] = P * kp;                                // Pw^T
        }
      }
      mma_acc<FD, 4>(dv, dpt, Ot + hq * 32 * TLD, lane);
      mma_acc<FD, 4>(dk, st, Qt + hq * 32 * TLD, lane);
      const int kl = warp * 16 + g;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = hq * 32 + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dSs + kl * SLD + c) = pk(st[j][0], st[j][1]);
        *reinterpret_cast<uint32_t*>(dSs + (kl + 8) * SLD + c) = pk(st[j][2], st[j][3]);
      }
    }
    __syncthreads();                      // dS^T of block qi is complete

    // dq (64 queries x 32 dims) = dS (64 x KT) K (KT x 32): A from dS^T and
    // B from the K rows, both through ldmatrix.trans
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int mi = lane >> 3, rr = lane & 7;
#pragma unroll
    for (int ks = 0; ks < KT / 16; ++ks) {
      uint32_t a[4], b[4];
      ldsm_x4_trans(a, dSs + (ks * 16 + (mi >> 1) * 8 + rr) * SLD + dq_row + (mi & 1) * 8);
      ldsm_x4_trans(b, Ks + (16 * ks + (mi & 1) * 8 + rr) * TLD + (mi >> 1) * 8 + dq_np * 16);
      mma16816(acc[0], a, b[0], b[1]);
      mma16816(acc[1], a, b[2], b[3]);
    }
    const int qa0 = q0 + dq_row + g, qa1 = qa0 + 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int d = (dq_np * 2 + i) * 8 + 2 * t;
      if (qa0 < p.Lq) *reinterpret_cast<float2*>(dq_part + dq_at(qa0, d)) =
          make_float2(acc[i][0], acc[i][1]);
      if (qa1 < p.Lq) *reinterpret_cast<float2*>(dq_part + dq_at(qa1, d)) =
          make_float2(acc[i][2], acc[i][3]);
    }
  }

  // dk, dv of this lane's key rows
  const long long koff = (long long)w * p.Lk * C + h * FD;
#pragma unroll
  for (int nt = 0; nt < FD / 8; ++nt) {
    const int c = nt * 8 + 2 * t;
    if (v0) {
      *reinterpret_cast<uint32_t*>(p.dk + koff + r0 * C + c) = pk(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<uint32_t*>(p.dv + koff + r0 * C + c) = pk(dv[nt][0], dv[nt][1]);
    }
    if (v1) {
      *reinterpret_cast<uint32_t*>(p.dk + koff + r1 * C + c) = pk(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<uint32_t*>(p.dv + koff + r1 * C + c) = pk(dv[nt][2], dv[nt][3]);
    }
  }

  // 3. dq of this block's share of the queries: the key tiles' partials
  // added in rank order, 4 dims per thread
  if (ntiles > 1) cluster.sync(); else __syncthreads();
  bf16* dqb = p.dq + (long long)w * p.Lq * C + h * FD;
  for (int idx = threadIdx.x; idx < (s_hi - s_lo) * (FD / 4); idx += blockDim.x) {
    const int i = s_lo + idx / (FD / 4), d = (idx % (FD / 4)) * 4;
    float4 v[MAX_CLUSTER];
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < ntiles) {
        const float* part = ntiles > 1 ? cluster.map_shared_rank(dq_part, c) : dq_part;
        v[c] = *reinterpret_cast<const float4*>(part + dq_at(i, d));
      }
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int c = 0; c < MAX_CLUSTER; ++c) {
      if (c < ntiles) {
        s.x += v[c].x; s.y += v[c].y; s.z += v[c].z; s.w += v[c].w;
      }
    }
    uint2 out = make_uint2(pk(s.x, s.y), pk(s.z, s.w));
    *reinterpret_cast<uint2*>(dqb + (long long)i * C + d) = out;
  }
  if (ntiles > 1) cluster.sync();         // peers read this block's partial until here
}

// ---------------------------------------------------------------------------
// The backward in float32 (the JAX kernel at f32): FFMA only, nothing
// rounded, one launch with no atomics. Blocks of 128 threads take one of
// two roles for a folded row b = w*H + h:
//   key blocks (ceil(Lk / 128) per b): a thread owns key j, holds k_j, v_j,
//     dk_j and dv_j in registers, and walks every query (q and dO rows
//     streamed through shared memory in chunks of 32, lse and delta for all
//     queries in shared memory, the keep word of (i, j / 32) one broadcast
//     load per warp): S, dP -> P, dS -> dv += Pw dO, dk += dS q;
//   query blocks (ceil(Lq / 128) per b): a thread owns query i, holds q_i,
//     dO_i and dq_i, and walks every key (k and v rows streamed in chunks
//     of 32 with their key terms): S, dP -> dS -> dq += dS k.
// So S and dP are formed twice per pair (once in each role): 224 FFMA per
// query-key pair, ~0.6 ms at [512, 418, 32] at 67 TFLOP/s, against ~0.03
// ms of bytes. Each output element has one writer.
// ---------------------------------------------------------------------------
constexpr int B32_T = 128;          // keys or queries per block, one per thread
constexpr int B32_C = 32;           // rows per streamed chunk
constexpr int B32_MAX_LQ = 1024;

struct Bwd32Params {
  const float* q; const float* k; const float* v; const float* o; const float* dout;
  float* dq; float* dk; float* dv;
  const float* lse;
  const uint32_t* bits;        // keep bits, when dropout
  const unsigned char* mask;   // [W, Lk] or null
  int Lq, Lk, H;
  float scale;
  int dropout;
  float inv_keep;
  int nkb, nqb;                // key blocks and query blocks per folded row
};

__device__ __forceinline__ void load_row32(float (&r)[FD], const float* src, bool ok) {
#pragma unroll
  for (int d = 0; d < FD; d += 4) {
    const float4 x = ok ? *reinterpret_cast<const float4*>(src + d)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    r[d] = x.x; r[d + 1] = x.y; r[d + 2] = x.z; r[d + 3] = x.w;
  }
}

__device__ __forceinline__ float dot32(const float (&a)[FD], const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < FD; d += 4) {
    const float4 x = *reinterpret_cast<const float4*>(b + d);
    s = fmaf(a[d], x.x, s);
    s = fmaf(a[d + 1], x.y, s);
    s = fmaf(a[d + 2], x.z, s);
    s = fmaf(a[d + 3], x.w, s);
  }
  return s;
}

__device__ __forceinline__ void axpy32(float (&y)[FD], float a, const float* x) {
#pragma unroll
  for (int d = 0; d < FD; d += 4) {
    const float4 v = *reinterpret_cast<const float4*>(x + d);
    y[d] = fmaf(a, v.x, y[d]);
    y[d + 1] = fmaf(a, v.y, y[d + 1]);
    y[d + 2] = fmaf(a, v.z, y[d + 2]);
    y[d + 3] = fmaf(a, v.w, y[d + 3]);
  }
}

__device__ __forceinline__ void store_row32(float* dst, const float (&r)[FD]) {
#pragma unroll
  for (int d = 0; d < FD; d += 4)
    *reinterpret_cast<float4*>(dst + d) = make_float4(r[d], r[d + 1], r[d + 2], r[d + 3]);
}

// lse in base 2 (a row whose keys are all masked keeps -1e30)
__device__ __forceinline__ float lse_base2(float l) {
  return l <= 0.5f * F_NEG ? F_NEG : l * LOG2E;
}

__global__ void __launch_bounds__(B32_T) flash_bwd_f32_kernel(Bwd32Params p) {
  __shared__ __align__(16) float X[B32_C][FD];    // q or k rows of the chunk
  __shared__ __align__(16) float Y[B32_C][FD];    // dO or v rows of the chunk
  __shared__ float2 kt_s[B32_C];                  // key terms (query role)
  __shared__ float lse_s[B32_MAX_LQ];             // base 2 (key role)
  __shared__ float delta_s[B32_MAX_LQ];           // (key role)
  const int per_row = p.nkb + p.nqb;
  const int frow = blockIdx.x / per_row, role = blockIdx.x % per_row;
  const int w = frow / p.H, h = frow % p.H, tid = threadIdx.x;
  const long long C = (long long)p.H * FD;
  const long long qoff = (long long)w * p.Lq * C + h * FD;
  const long long koff = (long long)w * p.Lk * C + h * FD;
  const float scale2 = p.scale * LOG2E;
  const int nw = (p.Lk + 31) / 32;
  const uint32_t* brow = p.dropout ? p.bits + (long long)frow * p.Lq * nw : nullptr;

  if (role < p.nkb) {
    // ---- key role: dk, dv of key j ----
    // lse (base 2) and delta = rowsum(dO * O) of every query
    for (int i = tid; i < p.Lq; i += B32_T) {
      float orow[FD], grow[FD];
      load_row32(orow, p.o + qoff + i * C, true);
      load_row32(grow, p.dout + qoff + i * C, true);
      float x = 0.f;
#pragma unroll
      for (int d = 0; d < FD; ++d) x = fmaf(orow[d], grow[d], x);
      delta_s[i] = x;
      lse_s[i] = lse_base2(p.lse[(long long)frow * p.Lq + i]);
    }
    const int j = role * B32_T + tid;
    const bool kv = j < p.Lk;
    float kr[FD], vr[FD], dk[FD], dv[FD];
    load_row32(kr, p.k + koff + (kv ? j : 0) * C, kv);
    load_row32(vr, p.v + koff + (kv ? j : 0) * C, kv);
#pragma unroll
    for (int d = 0; d < FD; ++d) dk[d] = dv[d] = 0.f;
    const bool masked = kv && p.mask && !p.mask[(long long)w * p.Lk + j];
    const float2 kt = masked ? make_float2(0.f, F_NEG) : make_float2(scale2, 0.f);
    for (int q0 = 0; q0 < p.Lq; q0 += B32_C) {
      __syncthreads();                  // the previous chunk is consumed
      for (int e = tid; e < B32_C * (FD / 4); e += B32_T) {
        const int r = e / (FD / 4), c4 = (e % (FD / 4)) * 4;
        const bool ok = q0 + r < p.Lq;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&X[r][c4]) =
            ok ? *reinterpret_cast<const float4*>(p.q + qoff + (q0 + r) * C + c4) : z;
        *reinterpret_cast<float4*>(&Y[r][c4]) =
            ok ? *reinterpret_cast<const float4*>(p.dout + qoff + (q0 + r) * C + c4) : z;
      }
      __syncthreads();
      if (!kv) continue;
      const int nq = min(B32_C, p.Lq - q0);
      for (int r = 0; r < nq; ++r) {
        const int i = q0 + r;
        const float P = ex2(fmaf(dot32(kr, X[r]), kt.x, kt.y) - lse_s[i]);
        const float dp = dot32(vr, Y[r]);
        float kp = p.inv_keep;
        if (p.dropout && !(brow[(long long)i * nw + j / 32] >> (j % 32) & 1u)) kp = 0.f;
        const float ds = P * (dp * kp - delta_s[i]) * p.scale;
        axpy32(dv, P * kp, Y[r]);
        axpy32(dk, ds, X[r]);
      }
    }
    if (kv) {
      store_row32(p.dk + koff + j * C, dk);
      store_row32(p.dv + koff + j * C, dv);
    }
  } else {
    // ---- query role: dq of query i ----
    const int i = (role - p.nkb) * B32_T + tid;
    const bool qv = i < p.Lq;
    float qr[FD], dor[FD], dq[FD];
    load_row32(qr, p.q + qoff + (qv ? i : 0) * C, qv);
    load_row32(dor, p.dout + qoff + (qv ? i : 0) * C, qv);
    float delta = 0.f, lse2 = 0.f;
    if (qv) {
      float ov[FD];
      load_row32(ov, p.o + qoff + i * C, true);
#pragma unroll
      for (int d = 0; d < FD; ++d) delta = fmaf(ov[d], dor[d], delta);
      lse2 = lse_base2(p.lse[(long long)frow * p.Lq + i]);
    }
#pragma unroll
    for (int d = 0; d < FD; ++d) dq[d] = 0.f;
    for (int k0 = 0; k0 < p.Lk; k0 += B32_C) {
      __syncthreads();                  // the previous chunk is consumed
      for (int e = tid; e < B32_C * (FD / 4); e += B32_T) {
        const int r = e / (FD / 4), c4 = (e % (FD / 4)) * 4;
        const bool ok = k0 + r < p.Lk;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        *reinterpret_cast<float4*>(&X[r][c4]) =
            ok ? *reinterpret_cast<const float4*>(p.k + koff + (k0 + r) * C + c4) : z;
        *reinterpret_cast<float4*>(&Y[r][c4]) =
            ok ? *reinterpret_cast<const float4*>(p.v + koff + (k0 + r) * C + c4) : z;
      }
      if (tid < B32_C) {
        const int j = k0 + tid;
        float2 kt = make_float2(scale2, 0.f);
        if (j >= p.Lk) kt = make_float2(0.f, -INFINITY);
        else if (p.mask && !p.mask[(long long)w * p.Lk + j]) kt = make_float2(0.f, F_NEG);
        kt_s[tid] = kt;
      }
      __syncthreads();
      if (!qv) continue;
      const uint32_t word = p.dropout ? brow[(long long)i * nw + k0 / 32] : ~0u;
      const int nk = min(B32_C, p.Lk - k0);
      for (int r = 0; r < nk; ++r) {
        const float2 kt = kt_s[r];
        const float P = ex2(fmaf(dot32(qr, X[r]), kt.x, kt.y) - lse2);
        const float dp = dot32(dor, Y[r]);
        const float kp = (word >> r & 1u) ? p.inv_keep : 0.f;
        axpy32(dq, P * (dp * kp - delta) * p.scale, X[r]);
      }
    }
    if (qv) store_row32(p.dq + qoff + i * C, dq);
  }
}

}  // namespace

extern "C" {

// dq, dk, dv from (q, k, v, o, dout, lse, keep bits); one launch of
// ceil(Lk / 128) * W * H blocks, each (w, h)'s key tiles one cluster.
int vgqa_flash_train_bwd(const void* q, const void* k, const void* v, const void* o,
                         const void* dout, const float* lse, const void* bits,
                         const unsigned char* mask, void* dq, void* dk, void* dv, int W, int Lq,
                         int Lk, int H, float scale, int dropout, float inv_keep,
                         void* stream) {
  const int ntiles = (Lk + KT - 1) / KT;
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || Lq > 1024 || ntiles > MAX_CLUSTER ||
      (long long)W * H * ntiles > 2147483647LL || (dropout && !bits))
    return (int)cudaErrorInvalidValue;
  BwdParams p{(const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)o,
              (const bf16*)dout, (bf16*)dq, (bf16*)dk, (bf16*)dv, lse,
              (const uint32_t*)bits, mask, W, Lq, Lk, H, scale, dropout, inv_keep};
  static unsigned long long ready = 0;    // devices whose shared memory limit is set
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64 || !(ready >> device & 1ull)) {
    e = cudaFuncSetAttribute(flash_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes(1024));
    if (e != cudaSuccess) return (int)e;
    if (device < 64) ready |= 1ull << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ntiles * W * H);
  cfg.blockDim = dim3(NW * 32);
  cfg.dynamicSmemBytes = smem_bytes(Lq);
  cfg.stream = reinterpret_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ntiles;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = ntiles > 1 ? 1 : 0;      // one key tile: an ordinary launch
  return (int)cudaLaunchKernelEx(&cfg, flash_bwd_kernel, p, ntiles);
}

// The backward in float32: the operands of vgqa_flash_train_bwd as float
// (lse and bits as there); one launch of W * H * (ceil(Lk / 128) +
// ceil(Lq / 128)) blocks.
int vgqa_flash_train_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const float* lse, const void* bits,
                             const unsigned char* mask, void* dq, void* dk, void* dv, int W,
                             int Lq, int Lk, int H, float scale, int dropout, float inv_keep,
                             void* stream) {
  const int nkb = (Lk + B32_T - 1) / B32_T, nqb = (Lq + B32_T - 1) / B32_T;
  if (W < 1 || H < 1 || Lq < 1 || Lk < 1 || Lq > B32_MAX_LQ ||
      (long long)W * H * (nkb + nqb) > 2147483647LL || (dropout && !bits))
    return (int)cudaErrorInvalidValue;
  Bwd32Params p{(const float*)q, (const float*)k, (const float*)v, (const float*)o,
                (const float*)dout, (float*)dq, (float*)dk, (float*)dv, lse,
                (const uint32_t*)bits, mask, Lq, Lk, H, scale, dropout, inv_keep, nkb, nqb};
  flash_bwd_f32_kernel<<<(unsigned)((long long)W * H * (nkb + nqb)), B32_T, 0,
                         reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
