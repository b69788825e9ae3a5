// K4 flash_mha for Hopper (sm_90a), behind a plain C interface: the port of
// vgqa_tpu/ops/pallas/flash_attention.py:flash_attention / flash_mha (Pallas
// _flash_kernel). Per (batch row b, head h) of q/k/v, heads packed in the
// channel dim of each token row:
//
//     out = softmax(q k^T * scale + key term) v,  key term 0 or -1e30
//
// Its caller is the InternViT attention: 24 layers x 4 vision chunks per
// 32-frame chat, each at q/k/v [8 tiles, 1025, 16 x 64] as strided views of
// the fused qkv projection (row stride 3 x 1024 channels), with no mask.
//
// What bounds it on an H100: the products (34.4 GFLOP per call, 0.035 ms
// at the dense bf16 rate) and, as much, the exponentials (134.5 M per call,
// ~0.032 ms on the SFUs), against 17 MB of bytes (0.005 ms). So the design
// keeps the tensor cores and the SFUs busy together and spends nothing else:
//
// - A block owns 192 query rows of one (b, h): three consumer warpgroups of
//   64 rows each, and a producer warpgroup that hands most of its registers
//   to them (setmaxnreg). Three warpgroups hide the softmax's latencies
//   better than two (0.099 against 0.120 ms per call, chip_k4.py).
// - The producer loads the Q rows once and streams K/V tiles of 128 keys
//   through a 3-stage ring in shared memory by TMA (cp.async.bulk.tensor,
//   128-byte swizzle, rows past L zero-filled by the hardware), each stage
//   guarded by a "full" mbarrier (TMA bytes) and an "empty" one (consumer
//   arrivals). q/k/v are addressed by 3-D tensor maps [B][L][H*64] with the
//   views' strides, so the qkv slices are read in place.
// - S = Q K^T is four wgmma m64n128k16 per tile with both operands from the
//   swizzled tiles (K-major descriptors); O += P V is eight wgmma m64n64k16
//   with P from registers (bf16, the mma.sync A-fragment layout, which the
//   S accumulator layout gives directly) and V from its tile as an MN-major
//   operand (the transpose flag), so V is never transposed.
// - The softmax is online in base 2: scale * log2(e) is folded into the
//   exponent's FFMA and each probability is one ex2.approx; the row max and
//   sum are f32 and reduce over the quad of lanes that holds a row; O is
//   rescaled only when a row max of the warp moved.
// - Two compile-time variants: maskless (no per-logit mask work: the ViT
//   path) and masked (the producer warp writes each stage's per-key term, 0
//   or -1e30, into shared memory beside the tile). Only the last key tile
//   checks Lk (its keys past Lk get -inf and drop out); a last tile of at
//   most 16 keys (L = 1025 ends in one) takes n16 products and 16
//   exponentials per row instead of 128.
// - Each consumer warpgroup keeps two products in flight: at key tile t it
//   issues S_t = Q K_t^T and then O += P_{t-1} V_{t-1}, waits for S_t only,
//   and computes the softmax of tile t in place while the P V product
//   runs; then it releases the stage of tile t - 1, rescales O and packs
//   P_t to bf16 (a 3-stage ring, so the producer's loads run two tiles
//   ahead). The warpgroups take turns, in a ring of named barriers, to
//   issue their products, so one's exponentials run while another's
//   products hold the tensor cores.
//
// Masked keys get -1e30, so a row whose keys are all masked averages V over
// its Lk keys (keys past Lk do not exist). P is rounded to bf16 as the P V
// operand, as the Pallas kernel does, and the output is bf16.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "attention_common.cuh"
#include "sm90_common.cuh"

using namespace vgqa_attn;
using namespace vgqa_sm90;

namespace {

constexpr int K4_D = 64;                       // head dim
constexpr int K4_WG = 3;                       // consumer warpgroups
constexpr int K4_QT = 64 * K4_WG;              // query rows per block
constexpr int K4_KT = 128;                     // keys per tile
constexpr int K4_STAGES = 3;
constexpr int K4_THREADS = 128 * (K4_WG + 1);  // + the producer warpgroup
constexpr int K4_TILE = 128 * K4_D * 2;        // bytes of a 128-row K or V tile
constexpr int K4_QWG = 64 * K4_D * 2;          // bytes of one warpgroup's 64 query rows
// registers per thread after setmaxnreg: the producer's few, the rest to
// the consumers (a multiple of 8, at most 240)
constexpr int K4_PRODUCER_REGS = 24;
constexpr int K4_CONSUMER_REGS =
    ((65536 - 128 * K4_PRODUCER_REGS) / (128 * K4_WG) / 8 * 8) > 240
        ? 240 : ((65536 - 128 * K4_PRODUCER_REGS) / (128 * K4_WG) / 8 * 8);
constexpr float K4_NEG = -1e30f;
constexpr float K4_LOG2E = 1.4426950408889634f;

// shared memory from a 1024-byte aligned base: Q, then per stage K and V,
// the key terms [stage][128] and the barriers
constexpr int OFF_Q = 0;
constexpr int OFF_KV = K4_WG * K4_QWG;         // stage s: K at + 2 s K4_TILE, V at + K4_TILE
constexpr int OFF_TERM = OFF_KV + K4_STAGES * 2 * K4_TILE;
constexpr int OFF_BAR = OFF_TERM + K4_STAGES * K4_KT * 4;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * K4_STAGES + 1) + 1024;   // + alignment slack

struct MhaParams {
  bf16* out;
  long long o_sb, o_sl;
  const unsigned char* mask;   // [B, Lk], nonzero = attend (masked variant)
  int Lq, Lk, ntiles;
  float scale2;                // scale * log2(e)
};

template <bool MASKED>
__global__ void __launch_bounds__(K4_THREADS, 1)
flash_mha_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, MhaParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  float* terms = reinterpret_cast<float*>(sbase + OFF_TERM);       // [stage][128]
  const uint32_t bar_full = base + OFF_BAR;                        // [stage]
  const uint32_t bar_empty = bar_full + 8 * K4_STAGES;             // [stage]
  const uint32_t bar_q = bar_empty + 8 * K4_STAGES;
  const int tile = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K4_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 32);                // the producer's first warp (+ TMA bytes)
      mbar_init(bar_empty + 8 * s, 128 * K4_WG);      // every consumer thread
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * K4_WG) {
    // ---- producer warpgroup: its registers go to the consumers; its
    // first warp loads Q once, then K/V tiles through the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(K4_PRODUCER_REGS) : "memory");
    if (warp != 4 * K4_WG) return;
    if (lane == 0) {
      mbar_expect_tx(bar_q, K4_WG * K4_QWG);
      for (int w = 0; w < K4_WG; ++w)
        tma_load(base + OFF_Q + w * K4_QWG, &tq, bar_q, h * K4_D, tile * K4_QT + 64 * w, b);
    }
    for (int t = 0; t < p.ntiles; ++t) {
      const int s = t % K4_STAGES;
      if (t >= K4_STAGES) mbar_wait(bar_empty + 8 * s, ((t / K4_STAGES) - 1) & 1);
      if (MASKED) {
        for (int e = lane; e < K4_KT; e += 32) {
          const int key = t * K4_KT + e;
          terms[s * K4_KT + e] =
              (key < p.Lk && !p.mask[(long long)b * p.Lk + key]) ? K4_NEG : 0.f;
        }
        __syncwarp();
      }
      if (lane == 0) {
        const uint32_t kv = base + OFF_KV + s * 2 * K4_TILE;
        mbar_expect_tx(bar_full + 8 * s, 2 * K4_TILE);
        tma_load(kv, &tk, bar_full + 8 * s, h * K4_D, t * K4_KT, b);
        tma_load(kv + K4_TILE, &tv, bar_full + 8 * s, h * K4_D, t * K4_KT, b);
      } else {
        mbar_arrive(bar_full + 8 * s);
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: query rows 64 wg .. 64 wg + 63 of the tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(K4_CONSUMER_REGS) : "memory");
  const int wg = warp / 4, g = lane >> 2, q4 = lane & 3;
  const int row0 = tile * K4_QT + wg * 64 + (warp % 4) * 16 + g, row1 = row0 + 8;
  // ping-pong: the warpgroups take turns, in a ring, to issue their products
  // (named barrier 1 + wg: wait for my turn, issue, hand the turn to the
  // next), so one's softmax runs while another's products hold the tensor
  // cores; the last warpgroup hands the first its first turn, and skips the
  // hand-over after its last issue (nobody waits for it)
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory"); };
  auto hand_over = [&](bool last) {
    if (!(last && wg == K4_WG - 1))
      asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (wg + 1) % K4_WG) : "memory");
  };
  if (wg == K4_WG - 1) hand_over(false);
  if (tile * K4_QT + wg * 64 >= p.Lq) {       // no row of this warpgroup exists
    for (int t = 0; t < p.ntiles; ++t) {      // its turns and stage releases, no products
      mbar_wait(bar_full + 8 * (t % K4_STAGES), (t / K4_STAGES) & 1);
      my_turn();
      hand_over(false);
      mbar_arrive(bar_empty + 8 * (t % K4_STAGES));
    }
    my_turn();
    hand_over(true);
    return;
  }
  const uint64_t qdesc = sw128_desc(base + OFF_Q + wg * K4_QWG);
  float s[64], o[32];                         // a short tile's S is s[0 .. 7]
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t pp[8][4];                           // P of the tile whose P V is next
  const float scale2 = p.scale2;
  // a tile's key blocks of 8: 16 (128 keys), or 2 for a last tile of at
  // most 16 keys (L = 1025 ends in one key: n16 products, 16 exponentials)
  constexpr std::integral_constant<int, 16> full_tile{};
  constexpr std::integral_constant<int, 2> short_tile{};
  constexpr std::true_type last_tile{};
  constexpr std::false_type inner_tile{};

  auto k_addr = [&](int t) { return base + OFF_KV + (t % K4_STAGES) * 2 * K4_TILE; };
  // S = Q K_t^T: four k-steps of 16 dims (32 bytes along the swizzled rows)
  auto issue_s = [&](auto nb_tag, int t) {
    const uint64_t kdesc = sw128_desc(k_addr(t));
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < K4_D / 16; ++kk) {
      if constexpr (decltype(nb_tag)::value == 16)
        wgmma_ss<128>(s, qdesc + 2 * kk, kdesc + 2 * kk, kk);
      else
        wgmma_ss<16>(*reinterpret_cast<float(*)[8]>(s), qdesc + 2 * kk,
                           kdesc + 2 * kk, kk);
    }
    wgmma_commit();
    fence_regs(s);
  };
  // O += P V_t: one k-step per 16 keys (16 rows of 128 bytes of the V tile)
  auto issue_pv = [&](auto nb_tag, int t) {
    const uint64_t vdesc = sw128_desc(k_addr(t) + K4_TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < decltype(nb_tag)::value / 2; ++kk)
      wgmma_rs<64>(o, pp[kk], vdesc + kk * (2048 >> 4));
    wgmma_commit();
    fence_regs(o);
    fence_regs(pp);
  };
  // the online softmax of tile t (S landed), while the previous P V product
  // may still be in flight: the logits in base 2 (one FFMA with the max
  // folded in for the maskless variant), the probabilities in place in S;
  // returns the rescale of the old rows. Only the last tile (LAST, a
  // compile-time tag) checks Lk.
  auto softmax = [&](auto last_tag, auto nb_tag, int t, float& c0, float& c1) {
    constexpr bool LAST = decltype(last_tag)::value;
    constexpr int NB = decltype(nb_tag)::value;
    const int kbase = t * K4_KT + 2 * q4;
    const float* tm = terms + (t % K4_STAGES) * K4_KT + 2 * q4;
    // element (j, e): maskless, S (the scale goes into the exponent's FFMA);
    // masked, S scale log2(e) + the key's term; keys past Lk -inf
    auto logit = [&](int j, int e) {
      float x = s[4 * j + e];
      if (MASKED) x = fmaf(x, scale2, tm[8 * j + (e & 1)]);
      if (LAST && kbase + 8 * j + (e & 1) >= p.Lk) x = -INFINITY;
      return x;
    };
    float a0[4], a1[4];                       // four chains per row, not one of 16
#pragma unroll
    for (int c = 0; c < 4; ++c) a0[c] = a1[c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a0[j & 3] = fmaxf(a0[j & 3], fmaxf(logit(j, 0), logit(j, 1)));
      a1[j & 3] = fmaxf(a1[j & 3], fmaxf(logit(j, 2), logit(j, 3)));
    }
    float mx0 = qmax(fmaxf(fmaxf(a0[0], a0[1]), fmaxf(a0[2], a0[3])));
    float mx1 = qmax(fmaxf(fmaxf(a1[0], a1[1]), fmaxf(a1[2], a1[3])));
    if (!MASKED) {
      mx0 *= scale2;
      mx1 *= scale2;
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    const float nb0 = -mn0, nb1 = -mn1;
    const float sc = MASKED ? 1.f : scale2;
    float r0[2] = {0.f, 0.f}, r1[2] = {0.f, 0.f};    // two partial sums per row
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float p0 = ex2(fmaf(logit(j, 0), sc, nb0)), p1 = ex2(fmaf(logit(j, 1), sc, nb0));
      const float p2 = ex2(fmaf(logit(j, 2), sc, nb1)), p3 = ex2(fmaf(logit(j, 3), sc, nb1));
      r0[j & 1] += p0 + p1;
      r1[j & 1] += p2 + p3;
      s[4 * j] = p0; s[4 * j + 1] = p1; s[4 * j + 2] = p2; s[4 * j + 3] = p3;
    }
    l0 = l0 * c0 + (r0[0] + r0[1]);
    l1 = l1 * c1 + (r1[0] + r1[1]);
    m0 = mn0;
    m1 = mn1;
  };
  // P (in S) rounded to bf16 pairs in the A-fragment layout: keys 16 kk ..
  // + 15 are the accumulator's column blocks 2 kk and 2 kk + 1
  auto pack = [&](auto nb_tag) {
#pragma unroll
    for (int kk = 0; kk < decltype(nb_tag)::value / 2; ++kk) {
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int j = 2 * kk + hb;
        pp[kk][2 * hb] = pk(s[4 * j], s[4 * j + 1]);
        pp[kk][2 * hb + 1] = pk(s[4 * j + 2], s[4 * j + 3]);
      }
    }
  };
  // one step t >= 1: S_t and P_{t-1} V_{t-1} (a full tile) in flight
  // together, the softmax of S_t overlapping the P V product; then the
  // stage of tile t - 1 is released, O rescaled and P_t packed
  auto step = [&](auto last_tag, auto nb_tag, int t) {
    mbar_wait(bar_full + 8 * (t % K4_STAGES), (t / K4_STAGES) & 1);
    my_turn();
    issue_s(nb_tag, t);
    issue_pv(full_tile, t - 1);
    hand_over(false);
    wgmma_wait1();
    fence_regs(s);
    float c0, c1;
    softmax(last_tag, nb_tag, t, c0, c1);
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pp);
    mbar_arrive(bar_empty + 8 * ((t - 1) % K4_STAGES));
    // rescale O, unless no row max of the warp moved (most tiles past the first)
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j] *= c0; o[4 * j + 1] *= c0; o[4 * j + 2] *= c1; o[4 * j + 3] *= c1;
      }
    }
    pack(nb_tag);
  };
  // the last product, P_t V_t
  auto last_pv = [&](auto nb_tag, int t) {
    my_turn();
    issue_pv(nb_tag, t);
    hand_over(true);
    wgmma_wait0();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * (t % K4_STAGES));
  };

  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  my_turn();
  issue_s(full_tile, 0);
  hand_over(false);
  wgmma_wait0();
  fence_regs(s);
  const int n = p.ntiles;
  {
    float c0, c1;                             // O is still 0: nothing to rescale
    if (n == 1) softmax(last_tile, full_tile, 0, c0, c1);
    else softmax(inner_tile, full_tile, 0, c0, c1);
    pack(full_tile);
  }
  for (int t = 1; t < n - 1; ++t) step(inner_tile, full_tile, t);
  if (n == 1) {
    last_pv(full_tile, 0);
  } else if (p.Lk - (n - 1) * K4_KT <= 16) {  // a last tile of at most 16 keys
    step(last_tile, short_tile, n - 1);
    last_pv(short_tile, n - 1);
  } else {
    step(last_tile, full_tile, n - 1);
    last_pv(full_tile, n - 1);
  }

  l0 = qsum(l0);
  l1 = qsum(l1);
  const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
  bf16* ob = p.out + b * p.o_sb + h * K4_D + 2 * q4;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (row0 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_sl + 8 * j) = pk(o[4 * j] * i0, o[4 * j + 1] * i0);
    if (row1 < p.Lq)
      *reinterpret_cast<uint32_t*>(ob + row1 * p.o_sl + 8 * j) =
          pk(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
  }
}

// a [B][L][C] bf16 tensor map (channels contiguous, strides in elements),
// boxes of [1][box_rows][64] with the 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int C, int L, int B, long long row,
              long long batch, int box_rows) {
  return make_map_3d(map, ptr, {C, L, B}, row, batch, {K4_D, box_rows, 1},
                     CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool MASKED>
int launch_mha(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const MhaParams& p, dim3 grid, cudaStream_t st) {
  static bool configured = false;     // the dynamic shared memory limit, set once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_mha_sm90_kernel<MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  flash_mha_sm90_kernel<MASKED><<<grid, K4_THREADS, SMEM_BYTES, st>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: out[b, i, h*D + d] = softmax_j(q k^T * scale, mask) v over the heads
// packed in the channel dim of q/k/v rows; D = 64. Strides in elements,
// multiples of 8, and 16-byte aligned bases (the tensor maps' rules).
int vgqa_flash_mha(const void* q, const void* k, const void* v, void* out,
                   const unsigned char* mask, int B, int Lq, int Lk, int H, int D,
                   long long q_sb, long long q_sl, long long k_sb, long long k_sl,
                   long long v_sb, long long v_sl, long long o_sb, long long o_sl, float scale,
                   void* stream) {
  if (D != K4_D || B < 1 || H < 1 || Lq < 1 || Lk < 1 || B > 65535 || H > 65535 ||
      (q_sl | k_sl | v_sl) % 8 || (B > 1 && (q_sb | k_sb | v_sb) % 8) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const int C = H * K4_D;
  if (!make_map(&tq, q, C, Lq, B, q_sl, q_sb, 64) ||
      !make_map(&tk, k, C, Lk, B, k_sl, k_sb, K4_KT) ||
      !make_map(&tv, v, C, Lk, B, v_sl, v_sb, K4_KT))
    return (int)cudaErrorInvalidValue;
  MhaParams p{(bf16*)out, o_sb, o_sl, mask, Lq, Lk, (Lk + K4_KT - 1) / K4_KT, scale * K4_LOG2E};
  const dim3 grid((Lq + K4_QT - 1) / K4_QT, H, B);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  return mask ? launch_mha<true>(tq, tk, tv, p, grid, st)
              : launch_mha<false>(tq, tk, tv, p, grid, st);
}

}  // extern "C"
