// K5 flash_gqa_causal for Hopper (sm_90a), behind a plain C interface: the
// port of vgqa_tpu/ops/pallas/flash_attention.py:flash_gqa_causal (Pallas
// _flash_gqa_causal_kernel). Causal grouped-query attention of one prefill
// chunk against the KV cache: query head h of q [H, Lq, 128] (query row i at
// position q_offset + i) reads KV head h / G (G = H / Hkv) of k/v [Hkv, S,
// 128]; key j is masked (-1e30) where j > q_offset + i or j >= length, with
// length read from device memory (no host sync). P is rounded to bf16 as the
// P V operand; out = (P V) / max(l, 1e-30), bf16.
//
// Its caller is every LLM prefill (qa/llm.py): 32 layers x 9 chunks of
// Lq = 1024 at S = 9216 per 32-frame request, H = 32, Hkv = 8, q a strided
// [H, Lq, 128] view of the [Lq, H, 128] projection and out the same view of
// an [Lq, H, 128] buffer.
//
// What bounds it on an H100: the products (22.4 ms per prefill at 989
// TFLOP/s dense bf16); the exponentials (43.4 G ex2, 10.4 ms on the SFUs)
// and the bytes are below them. Written on K4's pipeline (flash_mha_sm90.cu,
// whose device helpers it shares through sm90_common.cuh) at D = 128:
//
// - A block owns, for one KV head, 2 x 64 / G query positions of all G query
//   heads of its group: two consumer warpgroups of 64 rows each (at G = 4,
//   16 positions x 4 heads), row r of a warpgroup being position r / G and
//   head r mod G. So each K/V tile in shared memory feeds 128 rows of one
//   causal frontier: at the last chunk of the 32-frame prefill the blocks
//   read 1.14 GB of K/V from L2, where blocks of 64 rows of one head would
//   read 2.28 GB. A producer warp (its warpgroup hands its registers to
//   the consumers: 240 each) loads Q once and streams K/V tiles of 128 keys
//   through a 3-stage ring by TMA (3-D tensor maps over the strided views:
//   q by (d, h, i), so one box takes the G heads of 64 / G positions; the
//   caches by (d, j, hk); 128-byte swizzle, each 256-byte row as two 64-dim
//   halves; keys past S zero-filled by the hardware).
// - S = Q K^T is eight wgmma m64n128k16 per tile (four per 64-dim half),
//   O += P V sixteen m64n64k16 (two 64-dim halves of O) with P from
//   registers and V as an MN-major operand. Each warpgroup keeps S_t and
//   P_{t-1} V_{t-1} in flight together and the two take turns to issue their
//   products, so one's softmax runs while the other's products hold the
//   tensor cores (FlashAttention-3's shape at D = 128).
// - Causal and length work only where they can act: key tiles wholly at or
//   below the block's first position and below length take no compare (one
//   FFMA and one ex2.approx per logit, scale * log2(e) folded in); only the
//   tiles that hold the diagonal, length or S compare. Tiles past the
//   block's last position, length and S are never loaded.
// - The heaviest query tiles start first: blockIdx.y counts from the last
//   query tile down, the KV heads run along blockIdx.x.
//
// With length >= 1 key 0 is valid for every row, so the skipped keys would
// only have added exact zeros; with length < 1 every key is masked and each
// row averages V over all S keys, as the plain version does.

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

constexpr int K5_D = 128;                       // head dim
constexpr int K5_WG = 2;                        // consumer warpgroups
constexpr int K5_KT = 128;                      // keys per tile
constexpr int K5_STAGES = 3;
constexpr int K5_THREADS = 128 * (K5_WG + 1);   // + the producer warpgroup
constexpr int K5_HALF = K5_KT * 64 * 2;         // 16 KB: one 64-dim half of a K or V tile
constexpr int K5_QHALF = 64 * 64 * 2;           // 8 KB: one 64-dim half of a warpgroup's rows
constexpr int K5_PRODUCER_REGS = 24;
constexpr int K5_CONSUMER_REGS =
    ((65536 - 128 * K5_PRODUCER_REGS) / (128 * K5_WG) / 8 * 8) > 240
        ? 240 : ((65536 - 128 * K5_PRODUCER_REGS) / (128 * K5_WG) / 8 * 8);
constexpr float K5_NEG = -1e30f;
constexpr float K5_LOG2E = 1.4426950408889634f;

// shared memory from a 1024-byte aligned base: Q [wg][half][64][64], then
// per stage K lo, K hi, V lo, V hi [128][64], then the barriers
constexpr int OFF_Q = 0;
constexpr int OFF_KV = K5_WG * 2 * K5_QHALF;
constexpr int OFF_BAR = OFF_KV + K5_STAGES * 4 * K5_HALF;
constexpr int SMEM_BYTES = OFF_BAR + 8 * (2 * K5_STAGES + 1) + 1024;   // 230,456 bytes

struct GqaParams {
  bf16* out;
  long long o_sh, o_sl;
  const int* length;           // valid keys, on the device
  int Lq, S, q_offset, log2g, n_qtiles;
  float scale2;                // scale * log2(e)
};

__global__ void __launch_bounds__(K5_THREADS, 1)
flash_gqa_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv, GqaParams p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bar_full = base + OFF_BAR;                        // [stage]
  const uint32_t bar_empty = bar_full + 8 * K5_STAGES;             // [stage]
  const uint32_t bar_q = bar_empty + 8 * K5_STAGES;
  const int hk = blockIdx.x;
  const int G = 1 << p.log2g, RP = 64 >> p.log2g;                  // RP positions per warpgroup
  const int i0 = (p.n_qtiles - 1 - blockIdx.y) * 2 * RP;           // the block's first query row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // the keys the block reads, and the first key tile that needs a compare
  const int len = *p.length;
  const int pmax = p.q_offset + min(i0 + 2 * RP, p.Lq) - 1;        // its last row's position
  const int kend = len >= 1 ? min(min(pmax + 1, len), p.S) : p.S;
  const int ntiles = (kend + K5_KT - 1) / K5_KT;
  // keys [0, kfree) are at or below every row's position, below length and S
  const int kfree = len >= 1 ? min(min(p.q_offset + i0, len - 1), p.S - 1) + 1 : 0;
  const int t_mask = kfree / K5_KT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K5_STAGES; ++s) {
      mbar_init(bar_full + 8 * s, 1);                  // the producer (+ TMA bytes)
      mbar_init(bar_empty + 8 * s, 128 * K5_WG);       // every consumer thread
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * K5_WG) {
    // ---- producer warpgroup: its registers go to the consumers; one
    // thread loads Q once, then K/V tiles through the ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(K5_PRODUCER_REGS) : "memory");
    if (warp != 4 * K5_WG || lane != 0) return;
    mbar_expect_tx(bar_q, K5_WG * 2 * K5_QHALF);
    for (int w = 0; w < K5_WG; ++w)
      for (int hf = 0; hf < 2; ++hf)
        tma_load(base + OFF_Q + (2 * w + hf) * K5_QHALF, &tq, bar_q, 64 * hf, hk * G,
                 i0 + w * RP);
    for (int t = 0; t < ntiles; ++t) {
      const int s = t % K5_STAGES;
      if (t >= K5_STAGES) mbar_wait(bar_empty + 8 * s, ((t / K5_STAGES) - 1) & 1);
      const uint32_t kv = base + OFF_KV + s * 4 * K5_HALF;
      mbar_expect_tx(bar_full + 8 * s, 4 * K5_HALF);
      tma_load(kv, &tk, bar_full + 8 * s, 0, t * K5_KT, hk);
      tma_load(kv + K5_HALF, &tk, bar_full + 8 * s, 64, t * K5_KT, hk);
      tma_load(kv + 2 * K5_HALF, &tv, bar_full + 8 * s, 0, t * K5_KT, hk);
      tma_load(kv + 3 * K5_HALF, &tv, bar_full + 8 * s, 64, t * K5_KT, hk);
    }
    return;
  }

  // ---- consumer warpgroup wg: rows ib .. ib + RP - 1 of the chunk, G heads each ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(K5_CONSUMER_REGS) : "memory");
  const int wg = warp / 4, g = lane >> 2, q4 = lane & 3;
  const int ib = i0 + wg * RP;
  const int r0 = (warp % 4) * 16 + g, r1 = r0 + 8;                 // the thread's rows
  const int i_r0 = ib + (r0 >> p.log2g), i_r1 = ib + (r1 >> p.log2g);
  const int pos0 = p.q_offset + i_r0, pos1 = p.q_offset + i_r1;
  // the warpgroups take turns, in a ring, to issue their products (as K4)
  auto my_turn = [&]() { asm volatile("bar.sync %0, 256;\n" :: "r"(1 + wg) : "memory"); };
  auto hand_over = [&](bool last) {
    if (!(last && wg == K5_WG - 1))
      asm volatile("bar.arrive %0, 256;\n" :: "r"(1 + (wg + 1) % K5_WG) : "memory");
  };
  if (wg == K5_WG - 1) hand_over(false);
  if (ib >= p.Lq) {                             // no row of this warpgroup exists
    for (int t = 0; t < ntiles; ++t) {          // its turns and stage releases, no products
      mbar_wait(bar_full + 8 * (t % K5_STAGES), (t / K5_STAGES) & 1);
      my_turn();
      hand_over(false);
      mbar_arrive(bar_empty + 8 * (t % K5_STAGES));
    }
    my_turn();
    hand_over(true);
    return;
  }
  const uint64_t qd0 = sw128_desc(base + OFF_Q + (2 * wg) * K5_QHALF);
  const uint64_t qd1 = sw128_desc(base + OFF_Q + (2 * wg + 1) * K5_QHALF);
  float s[64], o[64];                           // O: dims 0-63 in o[0..31], 64-127 in o[32..63]
#pragma unroll
  for (int i = 0; i < 64; ++i) s[i] = o[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  uint32_t pp[8][4];                            // P of the tile whose P V is next
  const float scale2 = p.scale2;
  constexpr std::true_type masked_tile{};
  constexpr std::false_type free_tile{};

  auto kv_addr = [&](int t) { return base + OFF_KV + (t % K5_STAGES) * 4 * K5_HALF; };
  // S = Q K_t^T: eight k-steps of 16 dims, four per 64-dim half (32 bytes
  // apart along the swizzled 128-byte rows)
  auto issue_s = [&](int t) {
    const uint64_t kd0 = sw128_desc(kv_addr(t)), kd1 = sw128_desc(kv_addr(t) + K5_HALF);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss<128>(s, (kk < 4 ? qd0 : qd1) + 2 * (kk & 3), (kk < 4 ? kd0 : kd1) + 2 * (kk & 3),
                    kk);
    wgmma_commit();
    fence_regs(s);
  };
  // O += P V_t: per 16 keys (2,048 bytes of each V half) one product per half
  auto issue_pv = [&](int t) {
    const uint64_t vd0 = sw128_desc(kv_addr(t) + 2 * K5_HALF);
    const uint64_t vd1 = sw128_desc(kv_addr(t) + 3 * K5_HALF);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(o), pp[kk], vd0 + kk * (2048 >> 4));
      wgmma_rs<64>(*reinterpret_cast<float(*)[32]>(o + 32), pp[kk], vd1 + kk * (2048 >> 4));
    }
    wgmma_commit();
    fence_regs(o);
    fence_regs(pp);
  };
  // the online softmax of tile t in base 2, probabilities in place in S;
  // returns the rescale of the old rows. A free tile folds scale2 into the
  // exponent's FFMA (the max is taken on S); a masked tile first writes
  // each logit: S scale2, -1e30 past the row's position or length, -inf past S.
  auto softmax = [&](auto masked_tag, int t, float& c0, float& c1) {
    constexpr bool MASKED = decltype(masked_tag)::value;
    if (MASKED) {
      const int kb = t * K5_KT + 2 * q4;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 8 * j + (e & 1), pos = e < 2 ? pos0 : pos1;
          s[4 * j + e] = key >= p.S ? -INFINITY
                                    : (key > pos || key >= len) ? K5_NEG : s[4 * j + e] * scale2;
        }
      }
    }
    float a0[4], a1[4];                         // four chains per row
#pragma unroll
    for (int c = 0; c < 4; ++c) a0[c] = a1[c] = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      a0[j & 3] = fmaxf(a0[j & 3], fmaxf(s[4 * j], s[4 * j + 1]));
      a1[j & 3] = fmaxf(a1[j & 3], fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
    float r0s[2] = {0.f, 0.f}, r1s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s[4 * j] = ex2(fmaf(s[4 * j], sc, nb0));
      s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], sc, nb0));
      s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], sc, nb1));
      s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], sc, nb1));
      r0s[j & 1] += s[4 * j] + s[4 * j + 1];
      r1s[j & 1] += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * c0 + (r0s[0] + r0s[1]);
    l1 = l1 * c1 + (r1s[0] + r1s[1]);
    m0 = mn0;
    m1 = mn1;
  };
  // P (in S) rounded to bf16 pairs in the A-fragment layout: keys 16 kk ..
  // + 15 are the accumulator's column blocks 2 kk and 2 kk + 1
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int j = 2 * kk + hb;
        pp[kk][2 * hb] = pk(s[4 * j], s[4 * j + 1]);
        pp[kk][2 * hb + 1] = pk(s[4 * j + 2], s[4 * j + 3]);
      }
    }
  };
  // one step t >= 1: S_t and P_{t-1} V_{t-1} in flight together, the
  // softmax of S_t overlapping the P V product; then the stage of tile t - 1
  // is released, O rescaled and P_t packed
  auto step = [&](auto masked_tag, int t) {
    mbar_wait(bar_full + 8 * (t % K5_STAGES), (t / K5_STAGES) & 1);
    my_turn();
    issue_s(t);
    issue_pv(t - 1);
    hand_over(false);
    wgmma_wait1();
    fence_regs(s);
    float c0, c1;
    softmax(masked_tag, t, c0, c1);
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pp);
    mbar_arrive(bar_empty + 8 * ((t - 1) % K5_STAGES));
    // rescale O, unless no row max of the warp moved
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        o[4 * j] *= c0; o[4 * j + 1] *= c0; o[4 * j + 2] *= c1; o[4 * j + 3] *= c1;
      }
    }
    pack();
  };

  mbar_wait(bar_q, 0);
  mbar_wait(bar_full, 0);
  my_turn();
  issue_s(0);
  hand_over(false);
  wgmma_wait0();
  fence_regs(s);
  {
    float c0, c1;                               // O is still 0: nothing to rescale
    if (t_mask == 0) softmax(masked_tile, 0, c0, c1);
    else softmax(free_tile, 0, c0, c1);
    pack();
  }
  for (int t = 1; t < ntiles; ++t) {
    if (t < t_mask) step(free_tile, t);
    else step(masked_tile, t);
  }
  my_turn();                                    // the last product, P V of the last tile
  issue_pv(ntiles - 1);
  hand_over(true);
  wgmma_wait0();
  fence_regs(o);
  mbar_arrive(bar_empty + 8 * ((ntiles - 1) % K5_STAGES));

  l0 = qsum(l0);
  l1 = qsum(l1);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int hq0 = (hk << p.log2g) + (r0 & (G - 1)), hq1 = (hk << p.log2g) + (r1 & (G - 1));
  bf16* ob0 = p.out + hq0 * p.o_sh + (long long)i_r0 * p.o_sl + 2 * q4;
  bf16* ob1 = p.out + hq1 * p.o_sh + (long long)i_r1 * p.o_sl + 2 * q4;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* oj = o + 32 * hf + 4 * j;
      if (i_r0 < p.Lq)
        *reinterpret_cast<uint32_t*>(ob0 + 64 * hf + 8 * j) = pk(oj[0] * inv0, oj[1] * inv0);
      if (i_r1 < p.Lq)
        *reinterpret_cast<uint32_t*>(ob1 + 64 * hf + 8 * j) = pk(oj[2] * inv1, oj[3] * inv1);
    }
  }
}

}  // namespace

extern "C" {

// K5: causal GQA prefill attention, q [H, Lq, 128] (strides q_sh, q_sl in
// elements), k/v [Hkv, S, 128], out [H, Lq, 128]; query head h reads KV head
// h / (H / Hkv), H / Hkv a power of two up to 64. Strides multiples of 8,
// channel-contiguous rows, 16-byte aligned bases (the tensor maps' rules).
int vgqa_flash_gqa_causal(const void* q, const void* k, const void* v, void* out,
                          const int* length, int H, int Hkv, int Lq, int S, int D, int q_offset,
                          long long q_sh, long long q_sl, long long k_sh, long long k_sl,
                          long long v_sh, long long v_sl, long long o_sh, long long o_sl,
                          float scale, void* stream) {
  if (D != K5_D || H < 1 || Hkv < 1 || H % Hkv || Lq < 1 || S < 1 || q_offset < 0 ||
      Hkv > 65535 || (q_sh | q_sl | k_sh | k_sl | v_sh | v_sl) % 8 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  const int G = H / Hkv;
  int log2g = 0;
  while ((1 << log2g) < G) ++log2g;
  if ((1 << log2g) != G || G > 64) return (int)cudaErrorInvalidValue;
  const int RP = 64 / G;
  const int n_qtiles = (Lq + 2 * RP - 1) / (2 * RP);
  if (n_qtiles > 65535) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  if (!make_map_3d(&tq, q, {K5_D, H, Lq}, q_sh, q_sl, {64, G, RP}, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&tk, k, {K5_D, S, Hkv}, k_sl, k_sh, {64, K5_KT, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_3d(&tv, v, {K5_D, S, Hkv}, v_sl, v_sh, {64, K5_KT, 1},
                   CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;     // the dynamic shared memory limit, set once
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_gqa_sm90_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const GqaParams p{(bf16*)out, o_sh, o_sl, length, Lq, S, q_offset, log2g, n_qtiles,
                    scale * K5_LOG2E};
  flash_gqa_sm90_kernel<<<dim3(Hkv, n_qtiles), K5_THREADS, SMEM_BYTES,
                          reinterpret_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return (int)cudaGetLastError();
}

}  // extern "C"
