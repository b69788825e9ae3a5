// K1's four linear layers for Hopper (sm_90a), behind a plain C interface:
// the qkv, proj, fc1 and fc2 products of swin_block_canvas / swin_block_fused
// (the port of vgqa_tpu/ops/pallas/swin_block.py: _compute_block and _tail),
//
//     out = epilogue(A[M, K] @ W[N, K]^T)
//
// with A the block's token rows and W in nn.Linear layout, both K-major, and
// one of four fused epilogues (bias; bias + exact erf GELU; bias, DropPath
// gate and the residual read through a row map; the same with the output
// scattered through a row map). In bf16 every product is a wgmma m64nNk16;
// in float32 a 3xTF32 product (below).
//
// What bounds it on an H100: at Swin-T's stages 0-1 (C = 96, 192) every
// layer is bound by its bytes (32-154 flop per byte, under the card's ridge
// of ~295), and there the epilogue's stores are most of the layer's bytes;
// at stages 2-3 the products. So:
//
// - One warp-specialized kernel: a producer warpgroup (one thread of it
//   issues; its registers go to the consumers by setmaxnreg) streams A
//   through a ring of k-steps in shared memory by TMA (64-byte rows, 64-byte
//   swizzle: a k-step is 32 bf16 or 16 float, and K = 96 is three of them,
//   with no padding), each slot of one to four k-steps guarded by a "full"
//   mbarrier (TMA bytes) and an "empty" one (every consumer thread
//   arrives); two consumer warpgroups take 64 rows each of a 128-row tile.
// - The N tile (BN = 32, 64, 96, 128, 144 or 192) divides N exactly (96 for
//   every layer at stages 0-1): no product is computed for a column that
//   does not exist. A tile's products are BN / WN wgmma of width WN (96,
//   64, 48 or 32) per k16 (bf16) or k8 (tf32) step.
// - Where W's BN rows of all K fit in shared memory beside the ring, W
//   stays resident: it is loaded once per block, and the grid is
//   persistent over the M tiles of its N tile. Elsewhere each ring slot
//   carries W's k-steps beside A's (re-read from L2 per tile). The host's
//   plan (ops/kernels/swin_block.gemm_plan) decides, and gives the
//   byte-bound layers (stages 0-1) two blocks per SM.
// - The epilogue applies bias, GELU or gate in the accumulator registers,
//   stages 32 rows at a time per warpgroup in shared memory, and moves
//   whole rows to device memory in 16-byte chunks (through the row map,
//   adding the residual row): at stages 0-1 these stores are most of the
//   layer's bytes, and stores of two columns from the accumulator layout
//   ran at a fifth of the card's rate. Meanwhile the producer loads the next
//   tile's k-steps into the ring, and the stores are fire-and-forget. The
//   rounding points are the JAX kernel's: bf16 after the product, after the
//   bias and after the gate.
//
// 3xTF32 (float32): W is split on the host, once per weight, into W_hi
// (rounded to tf32, the low 13 bits zero) and W_lo = W - W_hi (exact in f32;
// the tensor cores read its top 19 bits). Each A k-step is split in shared
// memory after its TMA load: every consumer thread rounds its share of the
// warpgroup's 64 rows to A_hi in place and writes A_lo beside it, then
// fences the async proxy before the warpgroup's products read both. The
// product is A_hi W_hi + A_hi W_lo + A_lo W_hi with f32 accumulation, about
// 2^-21 of each term (A_lo W_lo, about 2^-22, is dropped).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

using namespace vgqa_sm90;

namespace {

using bf16 = __nv_bfloat16;

constexpr int G_BM = 128;                    // rows of an M tile: two warpgroups of 64
constexpr int G_ROWB = 64;                   // bytes of a k-step row (the swizzle span)
constexpr int G_ATILE = G_BM * G_ROWB;       // 8,192 bytes of A per k-step
constexpr int G_WGA = 64 * G_ROWB;           // one warpgroup's 64 rows of it
constexpr int G_THREADS = 3 * 128;           // two consumer warpgroups + the producer's
constexpr int G_PRODUCER_REGS = 24;          // after setmaxnreg; the rest go to the consumers
constexpr int G_SMEM_MAX = 232448;           // an H100 block's shared memory
constexpr int G_SMEM_MAX2 = 115712;          // each of two blocks on an SM (233,472 - 2 x 1,024)

enum EpiMode {
  EPI_BIAS = 0,           // out[m] = T(T(acc) + bias)
  EPI_GELU = 1,           // out[m] = T(gelu(acc + bias))
  EPI_RES_GATHER = 2,     // out[m] = res[rowmap[m]] + T(gate * T(T(acc) + bias))
  EPI_RES_SCATTER = 3,    // out[rowmap[m]] = res[m] + T(gate * T(T(acc) + bias))
};

template <typename T>
struct GemmParams {
  const T* bias;             // [N] or null
  T* out; long long ldo;
  const T* res; long long ldr;
  const int* rowmap;         // null: the identity
  const float* gates;        // [B, 2] DropPath branch gates or null
  int gate_col;
  long long rows_per_sample; // gate row = m / rows_per_sample
  int M, N, mode;
  int ksteps, kps, n_tiles, m_tiles, stages, resident;
};

// shared memory of a plan (the host's ops/kernels/swin_block.gemm_plan
// computes the same): 1,024 bytes of alignment slack, the A ring of
// `stages` slots of `kps` k-steps (and its lo halves in float32), W (all
// k-steps when resident, else those of each slot; hi and lo in float32),
// the N tile's bias (f32), the epilogue's staging rows (32 per warpgroup)
// and the mbarriers
__host__ __device__ constexpr int gemm_smem_bytes(bool f32, int bn, int stages, int kps,
                                                  int resident, int ksteps) {
  return 1024 + stages * kps * G_ATILE * (f32 ? 2 : 1) +
         (resident ? ksteps : stages * kps) * bn * G_ROWB * (f32 ? 2 : 1) + 4 * bn +
         2 * 32 * (bn * (f32 ? 4 : 2) + 16) + 8 * (2 * stages + 1);
}

__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<bf16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }

__device__ __forceinline__ void st2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// x rounded to tf32 (nearest, ties away from zero), the low 13 bits zero
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// the epilogue's value of one accumulator before any residual: the output
// itself (bias, GELU), or the gated branch that the residual is added to
// (exact in T: every step is rounded to T)
template <typename T>
__device__ __forceinline__ float epi_value(int mode, bool gated, float acc, float b, float g) {
  if (mode == EPI_BIAS) return rnd<T>(acc) + b;
  if (mode == EPI_GELU) {
    const float t = acc + b;
    return 0.5f * t * (1.f + erff(t * 0.70710678118654752f));
  }
  float t = rnd<T>(rnd<T>(acc) + b);
  if (gated) t = rnd<T>(t * g);
  return t;
}

// 16 bytes of T: residual r + branch t, rounded to T
template <typename T> __device__ __forceinline__ uint4 add16(uint4 r, uint4 t);
template <> __device__ __forceinline__ uint4 add16<bf16>(uint4 r, uint4 t) {
  uint4 o;
  const __nv_bfloat162* rp = reinterpret_cast<const __nv_bfloat162*>(&r);
  const __nv_bfloat162* tp = reinterpret_cast<const __nv_bfloat162*>(&t);
  __nv_bfloat162* op = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 a = __bfloat1622float2(rp[k]), b = __bfloat1622float2(tp[k]);
    op[k] = __floats2bfloat162_rn(a.x + b.x, a.y + b.y);
  }
  return o;
}
template <> __device__ __forceinline__ uint4 add16<float>(uint4 r, uint4 t) {
  return make_uint4(__float_as_uint(__uint_as_float(r.x) + __uint_as_float(t.x)),
                    __float_as_uint(__uint_as_float(r.y) + __uint_as_float(t.y)),
                    __float_as_uint(__uint_as_float(r.z) + __uint_as_float(t.z)),
                    __float_as_uint(__uint_as_float(r.w) + __uint_as_float(t.w)));
}

// F32: 3xTF32 on float operands; else bf16. A tile is NSUB products of
// width WN (BN = WN * NSUB columns). MINB: blocks per SM (2 for the
// byte-bound layers' narrow tiles, whose epilogue then has twice the warps).
template <bool F32, int WN, int NSUB, int MINB>
__global__ void __launch_bounds__(G_THREADS, MINB)
gemm_sm90_kernel(const __grid_constant__ CUtensorMap ta,
                 const __grid_constant__ CUtensorMap tw,
                 const __grid_constant__ CUtensorMap twl,
                 GemmParams<typename std::conditional<F32, float, bf16>::type> p) {
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int BN = WN * NSUB;
  constexpr int BKE = G_ROWB / (int)sizeof(T);          // elements of a k-step
  constexpr int WK = BN * G_ROWB;                        // bytes of W's k-step (hi or lo)
  constexpr int CPR = BN * (int)sizeof(T) / 16;          // 16-byte chunks of an output row
  constexpr int STG_PITCH = BN * (int)sizeof(T) + 16;    // staging row (+16: fewer conflicts)
  constexpr int STG_WG = 32 * STG_PITCH;                 // a warpgroup's 32 staged rows
  constexpr int ITER = (32 * CPR + 127) / 128;           // chunks per thread and round
  // the consumers' registers after setmaxnreg: what the block holds at
  // launch (the launch bounds' cap per thread: 168 for one block per SM, 80
  // for two) less the producer warpgroup's, a multiple of 8, at most 240;
  // asking for more than the block holds would wait forever
  constexpr int LAUNCH_REGS = 65536 / (G_THREADS * MINB) / 8 * 8;
  constexpr int CONSUMER_REGS =
      (G_THREADS * LAUNCH_REGS - 128 * G_PRODUCER_REGS) / 256 / 8 * 8 > 240
          ? 240 : (G_THREADS * LAUNCH_REGS - 128 * G_PRODUCER_REGS) / 256 / 8 * 8;
  static_assert(128 * G_PRODUCER_REGS + 256 * CONSUMER_REGS <= G_THREADS * LAUNCH_REGS,
                "setmaxnreg would ask for more registers than the block holds");
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* sbase = smem_raw + (base - raw);
  const int S = p.stages, KS = p.ksteps, KPS = p.kps, NB = KS / KPS;
  const int ASLOT = KPS * G_ATILE;                                 // bytes of A per slot
  const uint32_t a_s = base;                                       // [S] A (hi)
  const uint32_t alo_s = a_s + S * ASLOT;                          // [S] A lo (F32)
  const uint32_t w_s = a_s + S * ASLOT * (F32 ? 2 : 1);            // W hi
  const int w_steps = p.resident ? KS : S * KPS;
  const uint32_t wlo_s = w_s + w_steps * WK;                       // W lo (F32)
  const uint32_t bias_s = w_s + w_steps * WK * (F32 ? 2 : 1);      // [BN] f32
  const uint32_t stg_s = bias_s + 4 * BN;                          // [2][32][STG_PITCH]
  const uint32_t bar_full = stg_s + 2 * STG_WG;                    // [S]
  const uint32_t bar_empty = bar_full + 8 * S;                     // [S]
  const uint32_t bar_w = bar_empty + 8 * S;
  float* sbias = reinterpret_cast<float*>(sbase + (bias_s - base));
  const int nt = blockIdx.x % p.n_tiles, n0 = nt * BN;
  const int mt0 = blockIdx.x / p.n_tiles, mstride = gridDim.x / p.n_tiles;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(bar_full + 8 * s, 1);             // the producer's expect_tx (+ TMA bytes)
      mbar_init(bar_empty + 8 * s, 256);          // every consumer thread
    }
    mbar_init(bar_w, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int c = threadIdx.x; c < BN; c += G_THREADS)
    sbias[c] = p.bias ? to_float(p.bias[n0 + c]) : 0.f;
  __syncthreads();

  if (warp >= 8) {
    // ---- producer warpgroup: its registers go to the consumers; one
    // thread loads W once (resident), then slots of KPS k-steps of A (and
    // W) ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(G_PRODUCER_REGS) : "memory");
    if (warp != 8 || lane != 0) return;
    constexpr int WBYTES = WK * (F32 ? 2 : 1);
    if (p.resident) {
      mbar_expect_tx(bar_w, KS * WBYTES);
      for (int ks = 0; ks < KS; ++ks) {
        tma_load(w_s + ks * WK, &tw, bar_w, ks * BKE, n0, 0);
        if (F32) tma_load(wlo_s + ks * WK, &twl, bar_w, ks * BKE, n0, 0);
      }
    }
    int it = 0;
    for (int mt = mt0; mt < p.m_tiles; mt += mstride) {
      for (int kb = 0; kb < NB; ++kb, ++it) {
        const int s = it % S;
        if (it >= S) mbar_wait(bar_empty + 8 * s, ((it / S) - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, KPS * (G_ATILE + (p.resident ? 0 : WBYTES)));
        for (int i = 0; i < KPS; ++i) {
          const int ks = kb * KPS + i;
          tma_load(a_s + s * ASLOT + i * G_ATILE, &ta, bar_full + 8 * s, ks * BKE, mt * G_BM, 0);
          if (!p.resident) {
            tma_load(w_s + (s * KPS + i) * WK, &tw, bar_full + 8 * s, ks * BKE, n0, 0);
            if (F32) tma_load(wlo_s + (s * KPS + i) * WK, &twl, bar_full + 8 * s, ks * BKE, n0, 0);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroup wg: rows 64 wg .. 64 wg + 63 of each M tile ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS) : "memory");
  const int wg = warp / 4, g = lane >> 2, q4 = lane & 3;
  const int tid = threadIdx.x % 128;
  float acc[NSUB][WN / 2];
#pragma unroll
  for (int s = 0; s < NSUB; ++s)
#pragma unroll
    for (int i = 0; i < WN / 2; ++i) acc[s][i] = 0.f;
  if (p.resident) mbar_wait(bar_w, 0);

  // the products of one slot s (k-steps kb * KPS ..): per k-step two k16
  // (bf16) or k8 (tf32) steps, 32 bytes apart along the 64-byte rows
  auto issue = [&](int s, int kb) {
    wgmma_fence();
    for (int i = 0; i < KPS; ++i) {
      const uint32_t a_addr = a_s + s * ASLOT + i * G_ATILE + wg * G_WGA;
      const uint32_t w_addr = w_s + (p.resident ? kb * KPS + i : s * KPS + i) * WK;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint64_t ad = sw64_desc(a_addr) + 2 * kk;
        const int accumulate = (kb == 0 && i == 0 && kk == 0) ? 0 : 1;
#pragma unroll
        for (int j = 0; j < NSUB; ++j) {
          const uint64_t wd = sw64_desc(w_addr + j * WN * G_ROWB) + 2 * kk;
          if constexpr (F32) {
            const uint64_t wld = sw64_desc(w_addr + (wlo_s - w_s) + j * WN * G_ROWB) + 2 * kk;
            const uint64_t ald = sw64_desc(a_addr + (alo_s - a_s)) + 2 * kk;
            wgmma_tf32<WN>(acc[j], ad, wd, accumulate);
            wgmma_tf32<WN>(acc[j], ad, wld, 1);
            wgmma_tf32<WN>(acc[j], ald, wd, 1);
          } else {
            wgmma_ss<WN>(acc[j], ad, wd, accumulate);
          }
        }
      }
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
  };

  const T* res = p.res;
  T* out = p.out;
  int it = 0;
  for (int mt = mt0; mt < p.m_tiles; mt += mstride) {
    for (int kb = 0; kb < NB; ++kb, ++it) {
      const int s = it % S;
      mbar_wait(bar_full + 8 * s, (it / S) & 1);
      if constexpr (F32) {
        // this warpgroup's 64 rows of the slot's k-steps: A_hi in place,
        // A_lo beside it (the same swizzled positions), then the async
        // proxy may read both
        for (int i = 0; i < KPS; ++i) {
          float4* ah = reinterpret_cast<float4*>(sbase + (a_s - base) + s * ASLOT +
                                                 i * G_ATILE + wg * G_WGA);
          float4* al = reinterpret_cast<float4*>(sbase + (alo_s - base) + s * ASLOT +
                                                 i * G_ATILE + wg * G_WGA);
#pragma unroll
          for (int e = tid; e < G_WGA / 16; e += 128) {
            const float4 x = ah[e];
            const float4 h = make_float4(tf32_hi(x.x), tf32_hi(x.y), tf32_hi(x.z), tf32_hi(x.w));
            ah[e] = h;
            al[e] = make_float4(x.x - h.x, x.y - h.y, x.z - h.z, x.w - h.w);
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
      issue(s, kb);
      if (kb > 0) {                   // the previous slot's products are done
        wgmma_wait1();
#pragma unroll
        for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
        mbar_arrive(bar_empty + 8 * ((it - 1) % S));
      }
    }
    wgmma_wait0();
#pragma unroll
    for (int j = 0; j < NSUB; ++j) fence_regs(acc[j]);
    mbar_arrive(bar_empty + 8 * ((it - 1) % S));

    // ---- the epilogue, in two rounds of 32 of the warpgroup's 64 rows
    // (h = 0: rows 16 w + g, h = 1: rows 16 w + g + 8 of warp w): the
    // accumulators get their bias, GELU or gate in registers and go to the
    // warpgroup's staging tile in shared memory as T (the JAX kernel's
    // rounding points); then each thread moves 16-byte chunks of whole rows
    // to device memory (through the row map; adding the residual row) ----
    const long long row0 = (long long)mt * G_BM + wg * 64;
    unsigned char* stg = sbase + (stg_s - base) + wg * STG_WG;
    const bool resid = p.mode >= EPI_RES_GATHER;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // this thread's chunks of the round: the residual's are loaded first,
      // so that their latency runs under the staging below
      uint4 rres[ITER];
      if (resid) {
#pragma unroll
        for (int i = 0; i < ITER; ++i) {
          const int e = tid + 128 * i, r = e / CPR, ch = e % CPR;
          const long long mm = row0 + (r / 8) * 16 + r % 8 + 8 * h;
          if (e < 32 * CPR && mm < p.M) {
            const long long src =
                (p.rowmap && p.mode == EPI_RES_GATHER ? (long long)p.rowmap[mm] : mm) * p.ldr;
            rres[i] = *reinterpret_cast<const uint4*>(res + src + n0 + ch * (16 / (int)sizeof(T)));
          }
        }
      }
      const int sr = (warp % 4) * 8 + g;                    // staging row
      const long long m = row0 + (warp % 4) * 16 + g + 8 * h;
      float gate = 1.f;
      if (resid && p.gates && m < p.M)
        gate = rnd<T>(p.gates[(m / p.rows_per_sample) * 2 + p.gate_col]);
      T* srow = reinterpret_cast<T*>(stg + sr * STG_PITCH);
#pragma unroll
      for (int j = 0; j < NSUB; ++j) {
#pragma unroll
        for (int c = 0; c < WN / 8; ++c) {
          const int col = j * WN + 8 * c + 2 * q4;
          const float2 b = *reinterpret_cast<const float2*>(sbias + col);
          const bool gated = p.gates != nullptr;
          st2(srow + col, epi_value<T>(p.mode, gated, acc[j][4 * c + 2 * h], b.x, gate),
              epi_value<T>(p.mode, gated, acc[j][4 * c + 2 * h + 1], b.y, gate));
        }
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");
#pragma unroll
      for (int i = 0; i < ITER; ++i) {
        const int e = tid + 128 * i, r = e / CPR, ch = e % CPR;
        const long long mm = row0 + (r / 8) * 16 + r % 8 + 8 * h;
        if (e >= 32 * CPR || mm >= p.M) continue;
        const long long dst =
            (p.rowmap && p.mode == EPI_RES_SCATTER ? (long long)p.rowmap[mm] : mm) * p.ldo;
        uint4 v = *reinterpret_cast<const uint4*>(stg + r * STG_PITCH + ch * 16);
        if (resid) v = add16<T>(rres[i], v);
        *reinterpret_cast<uint4*>(out + dst + n0 + ch * (16 / (int)sizeof(T))) = v;
      }
      asm volatile("bar.sync %0, 128;\n" :: "r"(3 + wg) : "memory");
    }
  }
}

// the tiles the kernel is compiled for: N tile, wgmma width, blocks per SM
// (the host's plan space, ops/kernels/swin_block.GEMM_BNS / GEMM_WN; the
// card tests hold it against vgqa_gemm_sm90_tiles)
struct GTile { int bn, wn, bps; };
constexpr GTile G_TILES[] = {{32, 32, 2}, {64, 64, 2}, {96, 96, 2},
                             {32, 32, 1}, {64, 64, 1}, {96, 96, 1},
                             {128, 64, 1}, {144, 48, 1}, {192, 96, 1}};
constexpr int G_NTILES = sizeof(G_TILES) / sizeof(G_TILES[0]);
static_assert(G_NTILES == 9, "launch_gemm's switch names every tile");

int find_tile(int bn, int bps) {
  for (int i = 0; i < G_NTILES; ++i)
    if (G_TILES[i].bn == bn && G_TILES[i].bps == bps) return i;
  return -1;
}

template <bool F32, int WN, int NSUB, int MINB>
int launch_bn(const CUtensorMap& ta, const CUtensorMap& tw, const CUtensorMap& twl,
              const GemmParams<typename std::conditional<F32, float, bf16>::type>& p, int grid,
              int smem, cudaStream_t st) {
  static bool configured = false;     // set once: the dynamic shared memory limit, and
  if (!configured) {                  // all of L1 as shared memory (two blocks per SM)
    cudaError_t e = cudaFuncSetAttribute(gemm_sm90_kernel<F32, WN, NSUB, MINB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         MINB == 2 ? G_SMEM_MAX2 : G_SMEM_MAX);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(gemm_sm90_kernel<F32, WN, NSUB, MINB>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  gemm_sm90_kernel<F32, WN, NSUB, MINB><<<grid, G_THREADS, smem, st>>>(ta, tw, twl, p);
  return (int)cudaGetLastError();
}

template <bool F32>
int launch_gemm(const void* A, long long lda, const void* W, const void* W_lo, long long ldw,
                const void* bias, void* out, long long ldo, int M, int N, int K, int mode,
                const void* res, long long ldr, const int* rowmap, const float* gates,
                int gate_col, long long rows_per_sample, int bn, int stages, int kps,
                int resident, int bps, int grid, void* stream) {
  using T = typename std::conditional<F32, float, bf16>::type;
  constexpr int BKE = G_ROWB / (int)sizeof(T);
  constexpr int ALIGN = 16 / (int)sizeof(T);       // elements of 16 bytes
  const int ksteps = K / BKE;
  const int n_tiles = bn > 0 ? N / bn : 0;
  const int m_tiles = (M + G_BM - 1) / G_BM;
  const int smem = gemm_smem_bytes(F32, bn, stages, kps, resident, ksteps);
  if (M < 1 || bn < 1 || N % bn || K < BKE || K % BKE || kps < 1 || ksteps % kps ||
      lda % ALIGN || ldw % ALIGN || ldo % ALIGN || ldr % ALIGN || stages < 2 ||
      find_tile(bn, bps) < 0 ||
      smem > (bps == 2 ? G_SMEM_MAX2 : G_SMEM_MAX) || grid < n_tiles || grid % n_tiles ||
      mode < EPI_BIAS || mode > EPI_RES_SCATTER || (mode >= EPI_RES_GATHER && !res) || (F32 && !W_lo) ||
      ((uintptr_t)A | (uintptr_t)W | (uintptr_t)W_lo | (uintptr_t)out | (uintptr_t)res) % 16)
    return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type =
      F32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta, tw, twl;
  if (!make_map_3d(&ta, A, {K, M, 1}, lda, 0, {BKE, G_BM, 1}, CU_TENSOR_MAP_SWIZZLE_64B, type) ||
      !make_map_3d(&tw, W, {K, N, 1}, ldw, 0, {BKE, bn, 1}, CU_TENSOR_MAP_SWIZZLE_64B, type) ||
      !make_map_3d(&twl, F32 ? W_lo : W, {K, N, 1}, ldw, 0, {BKE, bn, 1},
                   CU_TENSOR_MAP_SWIZZLE_64B, type))
    return (int)cudaErrorInvalidValue;
  const GemmParams<T> p{(const T*)bias, (T*)out, ldo, (const T*)res, ldr, rowmap, gates,
                        gate_col, rows_per_sample, M, N, mode, ksteps, kps,
                        n_tiles, m_tiles, stages, resident};
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define VGQA_TILE(I)                                                                    \
  case I:                                                                               \
    return launch_bn<F32, G_TILES[I].wn, G_TILES[I].bn / G_TILES[I].wn, G_TILES[I].bps>( \
        ta, tw, twl, p, grid, smem, st)
  switch (find_tile(bn, bps)) {
    VGQA_TILE(0); VGQA_TILE(1); VGQA_TILE(2); VGQA_TILE(3); VGQA_TILE(4);
    VGQA_TILE(5); VGQA_TILE(6); VGQA_TILE(7); VGQA_TILE(8);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VGQA_TILE
}

}  // namespace

extern "C" {

// K1's linear layer: out = epilogue(A[M, K] @ W[N, K]^T) in bf16 (A, W,
// bias, res, out bf16) on the plan (bn, stages, kps, resident, bps, grid)
// that ops/kernels/swin_block.gemm_plan chose; W_lo is unused. Strides in
// elements; A's and W's rows 16-byte aligned; K % 32 == 0, N % bn == 0.
int vgqa_gemm_sm90(const void* A, long long lda, const void* W, const void* W_lo,
                   long long ldw, const void* bias, void* out, long long ldo, int M, int N,
                   int K, int mode, const void* res, long long ldr, const int* rowmap,
                   const float* gates, int gate_col, long long rows_per_sample, int bn,
                   int stages, int kps, int resident, int bps, int grid, void* stream) {
  return launch_gemm<false>(A, lda, W, W_lo, ldw, bias, out, ldo, M, N, K, mode, res, ldr,
                            rowmap, gates, gate_col, rows_per_sample, bn, stages, kps, resident,
                            bps, grid, stream);
}

// the same in float32 as 3xTF32: A, bias, res, out float; W = W_hi and W_lo
// its tf32 split ([N, K] each, same stride); K % 16 == 0
int vgqa_gemm_sm90_f32(const void* A, long long lda, const void* W, const void* W_lo,
                       long long ldw, const void* bias, void* out, long long ldo, int M, int N,
                       int K, int mode, const void* res, long long ldr, const int* rowmap,
                       const float* gates, int gate_col, long long rows_per_sample, int bn,
                       int stages, int kps, int resident, int bps, int grid, void* stream) {
  return launch_gemm<true>(A, lda, W, W_lo, ldw, bias, out, ldo, M, N, K, mode, res, ldr,
                           rowmap, gates, gate_col, rows_per_sample, bn, stages, kps, resident,
                           bps, grid, stream);
}

// the host's plan checks: the tiles compiled ({bn, wn, bps} triples into
// out, at most cap of them; returns how many there are), a plan's shared
// memory bytes, and the most a block may take at bps blocks per SM
int vgqa_gemm_sm90_tiles(int* out, int cap) {
  for (int i = 0; i < G_NTILES && i < cap; ++i) {
    out[3 * i] = G_TILES[i].bn;
    out[3 * i + 1] = G_TILES[i].wn;
    out[3 * i + 2] = G_TILES[i].bps;
  }
  return G_NTILES;
}

int vgqa_gemm_sm90_smem_bytes(int f32, int bn, int stages, int kps, int resident,
                              int ksteps) {
  return gemm_smem_bytes(f32 != 0, bn, stages, kps, resident, ksteps);
}

int vgqa_gemm_sm90_smem_max(int bps) { return bps == 2 ? G_SMEM_MAX2 : G_SMEM_MAX; }

}  // extern "C"
