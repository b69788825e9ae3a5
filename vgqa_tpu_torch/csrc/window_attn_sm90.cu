// K2 window_attention for Hopper (sm_90a), behind a plain C interface: the
// port of vgqa_tpu/ops/pallas/window_attention.py:window_attention (Pallas
// _body). Per row w of q/k/v [W, N, H*32] and head h:
//
//     out[w, :, h] = softmax(scale q_h k_h^T + keyterm[w mod n_kvalid]
//                            + bias[h] + regionterm[w mod n_region]) v_h
//
// keyterm 0 for a valid key, -1e30 for a masked one (so a row whose keys are
// all masked averages V over its N keys), -inf past N; bias the rel-pos bias
// [H, N, N] (bf16); regionterm -1e30 where the key's SW-MSA region id
// differs from the query's. P is rounded to bf16 as the P V operand (as the
// Pallas kernel does); the output is bf16.
//
// Its callers: the cross-modal encoder's self-attention (models/layers.py),
// 6 calls per V = 2 serving forward at W = 128 rows, N = 124 (224 px) or 418
// (420 px) tokens, 8 heads of 32, q/k/v the [W, N, 256] outputs of three
// projections and key_valid [W, N] (the key-term form); and K1's attention
// phase (ops/kernels/swin_block.py), 12 calls per forward at windows of
// N = 392 tokens, 3-24 heads, with the bias and, in the shifted blocks, the
// region ids (the terms form, TERMS below).
//
// What bounds the key-term form on an H100 at N = 418: the exponentials. 178.9 M ex2 per
// call take 0.0428 ms on the SFUs (16 per SM per clock), above the bytes
// (110 MB, 0.0328 ms) and the products (22.9 GFLOP, 0.023 ms).
//
// A sibling of K4 (flash_mha_sm90.cu), not a template of it: both take the
// helpers of sm90_common.cuh (mbarriers, TMA, wgmma descriptors and forms),
// but at D = 32 the whole K and V of a (window, head) fit in shared memory
// (26.8 KB each at N = 418), so this kernel loads them once and streams
// nothing: no ring, no producer warp, no stage release, which K4's unbounded
// key range needs. So:
//
// - A block owns one (w, h) and all N of its query rows: two warpgroups take
//   the 64-row query tiles in turn (warpgroup g takes tiles g, g + 2, ...).
//   N = 418 is 7 tiles (448 rows; 30 padding rows, 6.7%): one warpgroup does
//   4 passes, the other 3. N = 124 is 2 tiles (4 padding rows): one each.
//   Two blocks fit on an SM (86 KB of shared memory and 128 registers a
//   thread at N = 418), so four warpgroups share its SFUs.
// - Thread 0 starts every load at once: for each 64-row index j the TMA
//   boxes Q_j, K_j and V_j (64-byte swizzle, rows past N zero-filled by the
//   hardware) on mbarrier j, so the first products wait for the first 12 KB
//   only. The key terms of the row (w mod n_kvalid) go into shared memory
//   meanwhile, one float per key, written once per block.
// - S = Q K^T is two wgmma k16 steps (32 bytes apart along the 64-byte rows)
//   at n64 per key tile of 64 keys; O += P V is m64n32k16 with P from
//   registers and V as an MN-major operand (+1,024 bytes per 16 keys).
// - The last key tile takes its products at the smallest multiple of 8 that
//   covers it (n40 at N = 418, whose last tile holds 34 keys; n64 at 124,
//   60 keys), and its exponentials at that width, in accumulator registers
//   of its own: the kernel is compiled for each of the 8 widths and the
//   host picks one.
// - The softmax is online in base 2: one FFMA per logit folds scale *
//   log2(e) and the key term, one ex2.approx per probability; O is rescaled
//   only when a row max of the warp moved. At key tile t a warpgroup issues
//   S_t and P_{t-1} V_{t-1} together and computes the softmax of tile t
//   while the P V product runs (as K4 does).
// - The terms form (bias or region ids given) is its own instantiation
//   (TERMS): the region id of every key sits in shared memory beside the
//   key terms, and each thread keeps its two rows' ids. The bias [H, N, N]
//   (L2-resident: 0.9-7.4 MB per stage) reaches each warpgroup as TMA
//   boxes of its 64 query rows x 64 keys (128-byte swizzle, zero-filled
//   past N; rows padded to a multiple of 8 keys by the host) in a slot of
//   its own: at each key tile the warpgroup reads the box's (row, key
//   pair) elements in the accumulator's layout into registers, and one
//   thread then loads the next box of its sequence into the slot, a whole
//   key tile ahead of its use. Each logit then takes a second FFMA (bias *
//   log2(e)) and a compare-and-select (region). Two blocks per SM, as for
//   the key-term form (128 registers, 107 KB of shared memory at N = 392).

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

constexpr int K2_D = 32;                        // head dim
constexpr int K2_WG = 2;                        // warpgroups per block
constexpr int K2_THREADS = 128 * K2_WG;
constexpr int K2_T = 64;                        // rows of a query tile = keys of a key tile
constexpr int K2_TILE = K2_T * K2_D * 2;        // 4,096 bytes
constexpr int K2_MAX_TILES = 16;                // N <= 1024: 197 KB of shared memory
constexpr int K2_BIAS = K2_T * K2_T * 2;        // 8,192 bytes: a warpgroup's bias box
constexpr float K2_NEG = -1e30f;
constexpr float K2_LOG2E = 1.4426950408889634f;

// shared memory from a 1024-byte aligned base: Q [nt][64][32], K and V
// likewise, (terms form) a bias box per warpgroup, the key terms [nt * 64],
// (terms form) the keys' region ids [nt * 64], one mbarrier per 64-row
// index and (terms form) one per bias box
__host__ __device__ constexpr int k2_smem_bytes(int nt, bool terms) {
  return 3 * nt * K2_TILE + (terms ? K2_WG * K2_BIAS : 0) + nt * K2_T * 4 * (terms ? 2 : 1) +
         8 * (nt + (terms ? K2_WG : 0)) + 1024;   // + alignment slack
}

struct K2Params {
  bf16* out;
  long long o_win, o_row;
  const float* key_valid;      // [n_kvalid, N], > 0 = attendable key, or null
  int n_kvalid, N, nt;
  float scale2;                // scale * log2(e)
  const bf16* bias;            // [H, N, ldb] or null (terms form; read through the map tb)
  const int* region;           // [n_region, N] or null (terms form)
  int n_region;
};

// NBT: 8-key blocks of the last key tile (1 .. 8); TERMS: the form with a
// bias or region ids
template <int NBT, bool TERMS>
__global__ void __launch_bounds__(K2_THREADS, 2)
window_attn_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap tb, K2Params p) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const int nt = p.nt, N = p.N;
  const uint32_t q_s = base, k_s = base + nt * K2_TILE, v_s = base + 2 * nt * K2_TILE;
  const uint32_t b_s = base + 3 * nt * K2_TILE;                   // [K2_WG] bias boxes (TERMS)
  const int terms_off = 3 * nt * K2_TILE + (TERMS ? K2_WG * K2_BIAS : 0);
  float* terms = reinterpret_cast<float*>(sbase + terms_off);
  int* kreg = reinterpret_cast<int*>(terms + nt * K2_T);            // [nt * 64] (TERMS)
  const uint32_t bar = base + terms_off + nt * K2_T * 4 * (TERMS ? 2 : 1);   // [nt]
  const uint32_t bbar = bar + 8 * nt;                              // [K2_WG] (TERMS)
  const int w = blockIdx.x, h = blockIdx.y;

  if (threadIdx.x == 0) {
    for (int j = 0; j < nt; ++j) mbar_init(bar + 8 * j, 1);
    if (TERMS)
      for (int g2 = 0; g2 < K2_WG; ++g2) mbar_init(bbar + 8 * g2, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int j = 0; j < nt; ++j) {
      mbar_expect_tx(bar + 8 * j, 3 * K2_TILE);
      tma_load(q_s + j * K2_TILE, &tq, bar + 8 * j, h * K2_D, j * K2_T, w);
      tma_load(k_s + j * K2_TILE, &tk, bar + 8 * j, h * K2_D, j * K2_T, w);
      tma_load(v_s + j * K2_TILE, &tv, bar + 8 * j, h * K2_D, j * K2_T, w);
    }
  }
  const float* kv = p.key_valid ? p.key_valid + (long long)(w % p.n_kvalid) * N : nullptr;
  for (int j = threadIdx.x; j < nt * K2_T; j += K2_THREADS)
    terms[j] = j >= N ? -INFINITY : (kv && !(kv[j] > 0.f)) ? K2_NEG : 0.f;
  if (TERMS) {
    const int* rg = p.region ? p.region + (long long)(w % p.n_region) * N : nullptr;
    for (int j = threadIdx.x; j < nt * K2_T; j += K2_THREADS)
      kreg[j] = (rg && j < N) ? rg[j] : 0;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, g = lane >> 2, q4 = lane & 3;
  const float scale2 = p.scale2;
  constexpr std::integral_constant<int, 8> full_tile{};
  constexpr std::integral_constant<int, NBT> last_tile{};

  float s[32], o[16];                           // S of a full key tile; O (64 x 32)
  uint32_t pp[4][4];                            // P of the tile whose P V is next
  float m0, m1, l0, l1;
  uint64_t qdesc;
  // terms form: this thread's two query rows (their region ids) and the
  // bias of a key tile in the accumulator layout: bb[r][j] holds keys
  // 8 j + 2 q4, + 1 of row r as a bf16 pair, read from the warpgroup's bias
  // box; the box's next load (the warpgroup's next (query tile, key tile))
  // is issued as soon as every thread has read it
  int rq0 = 0, rq1 = 0;
  uint32_t bb[2][8];
  const bool has_bias = TERMS && p.bias != nullptr;
  const uint32_t my_box = b_s + wg * K2_BIAS, my_bar = bbar + 8 * wg;
  int bias_loads = 0;                           // boxes of this warpgroup consumed so far
  auto issue_box = [&](int qt_, int t_) {       // one thread of the warpgroup
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    mbar_expect_tx(my_bar, K2_BIAS);
    tma_load(my_box, &tb, my_bar, t_ * K2_T, qt_ * K2_T, h);
  };
  if (has_bias && threadIdx.x % 128 == 0 && wg < nt) issue_box(wg, 0);
  auto read_bias = [&](auto nb_tag, int qt_, int t) {
    constexpr int NB = decltype(nb_tag)::value;
    if constexpr (TERMS) {
      if (!has_bias) return;
      mbar_wait(my_bar, bias_loads & 1);
      ++bias_loads;
      const unsigned char* box = sbase + (my_box - base);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = (warp % 4) * 16 + g + 8 * r;            // 128-byte rows, swizzled
#pragma unroll
        for (int j = 0; j < NB; ++j)
          bb[r][j] = *reinterpret_cast<const uint32_t*>(
              box + row * 128 + (((j ^ (row & 7)) << 4) | (4 * q4)));
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");   // the box is read
      if (threadIdx.x % 128 == 0) {
        if (t + 1 < nt) issue_box(qt_, t + 1);
        else if (qt_ + K2_WG < nt) issue_box(qt_ + K2_WG, 0);
      }
    }
  };

  // the registers a tile of NB key blocks uses: S's accumulators (a narrow
  // last tile has its own, st: on the full tiles' registers, or with the
  // fences holding all of S, ptxas serialises its wgmma for lack of
  // registers), and the P fragments of its P V product. Only these are
  // fenced around the asynchronous products.
  float st[4 * NBT];
  auto s_of = [&](auto nb_tag) -> auto& {
    if constexpr (decltype(nb_tag)::value == 8) return s;
    else return st;
  };
  auto p_of = [&](auto nb_tag) -> auto& {
    return *reinterpret_cast<uint32_t(*)[(decltype(nb_tag)::value + 1) / 2][4]>(pp);
  };
  // S = Q K_t^T at n = 8 NB: two k-steps of 16 dims (32 bytes along the rows)
  auto issue_s = [&](auto nb_tag, int t) {
    constexpr int NB = decltype(nb_tag)::value;
    const uint64_t kdesc = sw64_desc(k_s + t * K2_TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_ss<8 * NB>(s_of(nb_tag), qdesc + 2 * kk, kdesc + 2 * kk, kk);
    wgmma_commit();
    fence_regs(s_of(nb_tag));
  };
  // O += P V_t: one k-step per 16 keys (16 rows of 64 bytes of the V tile)
  auto issue_pv = [&](auto nb_tag, int t) {
    constexpr int NB = decltype(nb_tag)::value;
    const uint64_t vdesc = sw64_desc(v_s + t * K2_TILE);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < (NB + 1) / 2; ++kk) wgmma_rs<32>(o, pp[kk], vdesc + kk * (1024 >> 4));
    wgmma_commit();
    fence_regs(o);
    fence_regs(p_of(nb_tag));
  };
  // the online softmax of key tile t: logits in base 2, x = S scale2 + term
  // (one FFMA), probabilities in place in S; returns the rescale of the old
  // rows
  auto softmax = [&](auto nb_tag, int t, float& c0, float& c1) {
    constexpr int NB = decltype(nb_tag)::value;
    auto& S = s_of(nb_tag);
    const float* tm = terms + t * K2_T + 2 * q4;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      const float2 k2 = *reinterpret_cast<const float2*>(tm + 8 * j);
      S[4 * j] = fmaf(S[4 * j], scale2, k2.x);
      S[4 * j + 1] = fmaf(S[4 * j + 1], scale2, k2.y);
      S[4 * j + 2] = fmaf(S[4 * j + 2], scale2, k2.x);
      S[4 * j + 3] = fmaf(S[4 * j + 3], scale2, k2.y);
      if constexpr (TERMS) {
        if (p.region) {                         // another region: + -1e30
          const int2 kr = *reinterpret_cast<const int2*>(kreg + t * K2_T + 2 * q4 + 8 * j);
          S[4 * j] += kr.x != rq0 ? K2_NEG : 0.f;
          S[4 * j + 1] += kr.y != rq0 ? K2_NEG : 0.f;
          S[4 * j + 2] += kr.x != rq1 ? K2_NEG : 0.f;
          S[4 * j + 3] += kr.y != rq1 ? K2_NEG : 0.f;
        }
        if (has_bias) {                         // + bias * log2(e)
          const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb[0][j]));
          const float2 b1 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bb[1][j]));
          S[4 * j] = fmaf(b0.x, K2_LOG2E, S[4 * j]);
          S[4 * j + 1] = fmaf(b0.y, K2_LOG2E, S[4 * j + 1]);
          S[4 * j + 2] = fmaf(b1.x, K2_LOG2E, S[4 * j + 2]);
          S[4 * j + 3] = fmaf(b1.y, K2_LOG2E, S[4 * j + 3]);
        }
      }
    }
    float a0[2] = {-INFINITY, -INFINITY}, a1[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      a0[j & 1] = fmaxf(a0[j & 1], fmaxf(S[4 * j], S[4 * j + 1]));
      a1[j & 1] = fmaxf(a1[j & 1], fmaxf(S[4 * j + 2], S[4 * j + 3]));
    }
    // every key tile holds a key below N, so the new maxima are finite
    const float mn0 = fmaxf(m0, qmax(fmaxf(a0[0], a0[1])));
    const float mn1 = fmaxf(m1, qmax(fmaxf(a1[0], a1[1])));
    c0 = ex2(m0 - mn0);
    c1 = ex2(m1 - mn1);
    float r0[2] = {0.f, 0.f}, r1[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      S[4 * j] = ex2(S[4 * j] - mn0);
      S[4 * j + 1] = ex2(S[4 * j + 1] - mn0);
      S[4 * j + 2] = ex2(S[4 * j + 2] - mn1);
      S[4 * j + 3] = ex2(S[4 * j + 3] - mn1);
      r0[j & 1] += S[4 * j] + S[4 * j + 1];
      r1[j & 1] += S[4 * j + 2] + S[4 * j + 3];
    }
    l0 = l0 * c0 + (r0[0] + r0[1]);
    l1 = l1 * c1 + (r1[0] + r1[1]);
    m0 = mn0;
    m1 = mn1;
  };
  // P (in S) rounded to bf16 pairs in the A-fragment layout: keys 16 kk ..
  // + 15 are the accumulator's column blocks 2 kk and 2 kk + 1; a block past
  // the tile's width is 0
  auto pack = [&](auto nb_tag) {
    constexpr int NB = decltype(nb_tag)::value;
    auto& S = s_of(nb_tag);
#pragma unroll
    for (int kk = 0; kk < (NB + 1) / 2; ++kk) {
#pragma unroll
      for (int hb = 0; hb < 2; ++hb) {
        const int j = 2 * kk + hb;
        pp[kk][2 * hb] = j < NB ? pk(S[4 * j], S[4 * j + 1]) : 0u;
        pp[kk][2 * hb + 1] = j < NB ? pk(S[4 * j + 2], S[4 * j + 3]) : 0u;
      }
    }
  };
  auto rescale = [&](float c0, float c1) {
    if (!__all_sync(0xffffffffu, c0 == 1.f && c1 == 1.f)) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[4 * j] *= c0; o[4 * j + 1] *= c0; o[4 * j + 2] *= c1; o[4 * j + 3] *= c1;
      }
    }
  };
  // one step t >= 1: S_t and P_{t-1} V_{t-1} (a full tile) in flight
  // together, the softmax of S_t overlapping the P V product
  auto step = [&](auto nb_tag, int qt_, int t) {
    read_bias(nb_tag, qt_, t);
    mbar_wait(bar + 8 * t, 0);
    issue_s(nb_tag, t);
    issue_pv(full_tile, t - 1);
    wgmma_wait1();
    fence_regs(s_of(nb_tag));
    float c0, c1;
    softmax(nb_tag, t, c0, c1);
    wgmma_wait0();
    fence_regs(o);
    fence_regs(pp);
    rescale(c0, c1);
    pack(nb_tag);
  };
  auto first = [&](auto nb_tag, int qt_) {
    read_bias(nb_tag, qt_, 0);
    mbar_wait(bar, 0);
    issue_s(nb_tag, 0);
    wgmma_wait0();
    fence_regs(s_of(nb_tag));
    float c0, c1;                               // O is still 0: nothing to rescale
    softmax(nb_tag, 0, c0, c1);
    pack(nb_tag);
  };
  auto last_pv = [&](auto nb_tag, int t) {
    issue_pv(nb_tag, t);
    wgmma_wait0();
    fence_regs(o);
  };

  for (int qt = wg; qt < nt; qt += K2_WG) {   // query tile qt
    mbar_wait(bar + 8 * qt, 0);
    qdesc = sw64_desc(q_s + qt * K2_TILE);
#pragma unroll
    for (int i = 0; i < 16; ++i) o[i] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
    if constexpr (TERMS) {
      const int r0 = qt * K2_T + (warp % 4) * 16 + g, r1 = r0 + 8;
      rq0 = r0 < N ? kreg[r0] : 0;
      rq1 = r1 < N ? kreg[r1] : 0;
    }
    if (nt == 1) {
      first(last_tile, qt);
      last_pv(last_tile, 0);
    } else {
      first(full_tile, qt);
      for (int t = 1; t < nt - 1; ++t) step(full_tile, qt, t);
      step(last_tile, qt, nt - 1);
      last_pv(last_tile, nt - 1);
    }
    l0 = qsum(l0);
    l1 = qsum(l1);
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    const int row0 = qt * K2_T + (warp % 4) * 16 + g, row1 = row0 + 8;
    bf16* ob = p.out + (long long)w * p.o_win + h * K2_D + 2 * q4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (row0 < N)
        *reinterpret_cast<uint32_t*>(ob + row0 * p.o_row + 8 * j) =
            pk(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (row1 < N)
        *reinterpret_cast<uint32_t*>(ob + row1 * p.o_row + 8 * j) =
            pk(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

template <int NBT, bool TERMS>
int launch_form(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
                const CUtensorMap& tb, const K2Params& p, dim3 grid, cudaStream_t st) {
  static bool configured = false;     // set once: the dynamic shared memory limit, and
  if (!configured) {                  // all of L1 as shared memory (two blocks per SM)
    cudaError_t e = cudaFuncSetAttribute(window_attn_sm90_kernel<NBT, TERMS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         k2_smem_bytes(K2_MAX_TILES, TERMS));
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(window_attn_sm90_kernel<NBT, TERMS>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  window_attn_sm90_kernel<NBT, TERMS>
      <<<grid, K2_THREADS, k2_smem_bytes(p.nt, TERMS), st>>>(tq, tk, tv, tb, p);
  return (int)cudaGetLastError();
}

template <int NBT>
int launch_nbt(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
               const CUtensorMap& tb, const K2Params& p, dim3 grid, cudaStream_t st) {
  return (p.bias || p.region) ? launch_form<NBT, true>(tq, tk, tv, tb, p, grid, st)
                              : launch_form<NBT, false>(tq, tk, tv, tb, p, grid, st);
}

}  // namespace

extern "C" {

// K2: q/k/v [W, N, H*32] bf16 (strides in elements, multiples of 8,
// channel-contiguous rows, 16-byte aligned bases), out likewise, key_valid
// [n_kvalid, N] float or null (row w reads row w % n_kvalid), bias [H, N, N]
// bf16 with rows of ldb elements (ldb >= N, a multiple of 8; 16-byte aligned
// base) or null, region [n_region, N] int32 or null (row w reads w % n_region).
int vgqa_window_attention_sm90(const void* q, const void* k, const void* v, void* out,
                               int W, int N, int H,
                               long long q_win, long long q_row, long long k_win,
                               long long k_row, long long v_win, long long v_row,
                               long long o_win, long long o_row,
                               const float* key_valid, int n_kvalid, const void* bias,
                               long long ldb, const int* region, int n_region, float scale,
                               void* stream) {
  const int nt = (N + K2_T - 1) / K2_T;
  if (W < 1 || H < 1 || N < 1 || nt > K2_MAX_TILES || H > 65535 || n_kvalid < 1 ||
      n_region < 1 || (bias && (ldb < N || ldb % 8 || (uintptr_t)bias % 16)) ||
      (q_row | k_row | v_row) % 8 || (W > 1 && (q_win | k_win | v_win) % 8) ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const long long C = (long long)H * K2_D;
  if (!make_map_3d(&tq, q, {C, N, W}, q_row, q_win, {K2_D, K2_T, 1}, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_3d(&tk, k, {C, N, W}, k_row, k_win, {K2_D, K2_T, 1}, CU_TENSOR_MAP_SWIZZLE_64B) ||
      !make_map_3d(&tv, v, {C, N, W}, v_row, v_win, {K2_D, K2_T, 1}, CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  // the bias [H][N][ldb] as boxes of 64 rows x 64 keys (keys past ldb and
  // rows past N read as zeros; the host pads keys N .. ldb - 1 with zeros)
  CUtensorMap tb = tq;
  if (bias && !make_map_3d(&tb, bias, {ldb, N, H}, ldb, (long long)N * ldb, {K2_T, K2_T, 1},
                           CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const K2Params p{(bf16*)out, o_win, o_row, key_valid, n_kvalid, N, nt, scale * K2_LOG2E,
                   (const bf16*)bias, region, n_region};
  const dim3 grid(W, H);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch ((N - (nt - 1) * K2_T + 7) / 8) {      // 8-key blocks of the last key tile
    case 1: return launch_nbt<1>(tq, tk, tv, tb, p, grid, st);
    case 2: return launch_nbt<2>(tq, tk, tv, tb, p, grid, st);
    case 3: return launch_nbt<3>(tq, tk, tv, tb, p, grid, st);
    case 4: return launch_nbt<4>(tq, tk, tv, tb, p, grid, st);
    case 5: return launch_nbt<5>(tq, tk, tv, tb, p, grid, st);
    case 6: return launch_nbt<6>(tq, tk, tv, tb, p, grid, st);
    case 7: return launch_nbt<7>(tq, tk, tv, tb, p, grid, st);
    default: return launch_nbt<8>(tq, tk, tv, tb, p, grid, st);
  }
}

}  // extern "C"
