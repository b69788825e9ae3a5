// Weight-only int4 group-wise matmul for decode (K6), behind a plain C
// interface: the port of vgqa_tpu/ops/pallas/int4_matmul.py (int4_matmul,
// Pallas _int4_kernel).
//
//   y[m, n] = bf16( sum_j scale[j, n] * sum_{k in group j} x[m, k] * w[k, n] )
//
// with the split-half pack of qa/quant.quantize_kernel_int4: packed[k, n]
// (int8, [K/2, N], N contiguous) holds row k's weight in its low nibble and
// row K/2 + k's in its high nibble; group j covers rows [j*g, (j+1)*g), so
// packed row k belongs to group k / g in the low half and n_g/2 + k / g in
// the high half. x is bf16 [M, K] (M <= 64), scale f32 [n_g, N].
//
// What bounds it on an H100: at decode (M = 1 or 2) a packed byte feeds
// four multiply-adds, far below the card's ~295 operations per byte, so the
// bound is the packed bytes plus the scales (3.5 GB per 32-layer token,
// 1.1 ms at 3.35 TB/s). The design keeps the SM's instruction issue off
// that path:
//
// * Tensor cores do the contraction. Each warp owns a strip of 16*NT
//   columns and treats the weight as the A operand of mma.sync.m16n8k16
//   (rows = 16 columns of N, depth = 16 packed rows) and x as B (8 rows of
//   M per m-tile; at M <= 8 the unused rows are zeros). The low and high
//   nibbles of one byte are two A operands against two B operands (x's
//   columns k and K/2 + k). Which of the 16 columns an A row stands for,
//   and which packed row a depth slot stands for, is free: lane (gid, t)
//   reads 2*NT adjacent bytes of packed rows 2t, 2t+1, 2t+8, 2t+9 of the
//   16-row step, and n-tile i takes byte 2i for A row gid and byte 2i+1 for
//   row gid+8. So a lane's bytes are contiguous in memory and no byte is
//   read twice.
// * Nibbles become bf16 without integer-to-float conversions: one
//   __byte_perm pairs the bytes of two rows, and for each of the four
//   (column, nibble) pairs one shift and one and-xor (lop3) make
//   0x4300 | (u ^ 8) = 136 + u in each bf16 half; one bf16x2 subtraction of
//   136 gives the signed nibble u exactly. Two values per 32-bit operation.
// * Each warp streams its strip through a private 4-stage shared-memory
//   ring filled by 16-byte cp.async (L1 bypassed), three 16-row steps ahead
//   of the tensor cores: the packed rows, x's 16 columns of both halves for
//   the step (rows below M only), and at a group's last step the group's
//   two scale rows. No global load sits on the step's dependency chain;
//   each lane's copy addresses are computed once; rows are padded so that
//   the lanes' reads back are free of bank conflicts. (Deeper rings, 6 or 8
//   stages, measured slower on the H100: fewer blocks fit on an SM.)
// * Every group keeps its own f32 partial per nibble half, and at the
//   group's end total = total + part_lo * scale_lo + part_hi * scale_hi,
//   as the Pallas kernel does; the output is rounded to bf16 once. A step
//   holds gcd(g, 16) packed rows (16 for the trees' g = 128), the rest of
//   its depth slots zero, so the kernel takes every group size the gate
//   admits (g = 1, 2, 4, 8, or any divisor of K/2 below 512); x's columns
//   of such steps are copied element by element.
// * The grid fills the card: a block is wk warps (4 where the groups allow)
//   on one strip and wk consecutive runs of kg groups; the launch plan
//   (ops/kernels/int4_matmul.py, _plan) takes strips of 64 columns (NT = 4)
//   and narrows them for small N; at M <= 8 it picks kg so that the grid
//   fits on the card at once (4 blocks per SM), past 8 rows, where a warp
//   holds twice the fragments, the fewest blocks from one per SM up. Every
//   plan was timed on the H100 to choose these rules (chip_k6.py). At M > 8
//   all m-tiles of a strip live in one warp (NT * MT <= 8 bounds the f32
//   fragments), so each packed byte is read once for any M <= 64.
// * Split-K is deterministic and stays on chip: the blocks that share a
//   strip (its chunks, at most 8) form one thread-block cluster. Each warp
//   leaves its sums in its own ring; after one cluster barrier every block
//   reads, for its slice of the strip, all warps' sums of all the cluster's
//   blocks through distributed shared memory (all loads issued before the
//   adds) and adds them in (chunk, warp) order. No partials go to device
//   memory, no counters are kept, and a strip of one chunk is an ordinary
//   launch.
//
// wgmma is not used: at M <= 64 the product sits below the card's
// ops-per-byte line, and mma.sync keeps each warp's strip independent (no
// warpgroup-wide tiles of 64 rows of M, which decode does not have).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include <cooperative_groups.h>

namespace cg = cooperative_groups;

using bf16 = __nv_bfloat16;

namespace {

constexpr int I4_MAX_WARPS = 4;
constexpr int I4_MAX_CLUSTER = 8;     // the portable cluster size: chunks per strip

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the low nibbles of bytes 0 and 2 of v, sign-extended, as bf16x2 (byte 0's
// in the low half): 0x4300 | (u ^ 8) is the bf16 of 136 + u
__device__ __forceinline__ uint32_t nib2(uint32_t v) {
  uint32_t r = (v & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 h, k;
  const uint32_t c136 = 0x43084308u;
  memcpy(&h, &r, 4);
  memcpy(&k, &c136, 4);
  h = __hsub2(h, k);
  memcpy(&r, &h, 4);
  return r;
}

// this lane's 2*NT bytes of one packed row of the stage, as 32-bit words
template <int NT>
__device__ __forceinline__ void lds_row(uint32_t (&w)[NT >= 2 ? NT / 2 : 1], const uint8_t* p) {
  if constexpr (NT == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (NT == 2) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// Shared memory of one warp: its ring of stages. A stage holds 16 packed
// rows, x's 16 columns of both halves, and the scale rows of the group
// that ends at this step. After the loop the ring holds the warp's sums.
template <int NT, int MT>
struct I4Smem {
  static constexpr int STAGES = 4;                        // ring depth (a power of 2)
  static constexpr int CW = 16 * NT;                      // columns per strip
  static constexpr int S = NT == 1 ? CW + 32 : CW + 16;   // weight row pitch: conflict-free reads
  static constexpr int XP = 80;                           // x row pitch (2 halves x 16 bf16 + pad)
  static constexpr int WBYTES = 16 * S;
  static constexpr int XBYTES = 8 * MT * XP;
  static constexpr int STAGE = WBYTES + XBYTES + 2 * CW * 4;
  static constexpr int WARP = STAGES * STAGE;
  static_assert(WARP >= 8 * MT * CW * 4, "the ring holds the warp's sums");
  static constexpr int bytes(int wk) { return wk * WARP; }
};

// Block (strip bx, chunk by) of wk warps: warp w contracts the low-half
// groups [(by*wk + w)*kg, +kg) (and their high-half twins) for the strip's
// 16*NT columns and all rows of x (MT m-tiles of 8). The chunks of a strip
// form one thread-block cluster (1 x chunks), which adds its warps' sums
// through distributed shared memory.
template <int NT, int MT>
__global__ void __launch_bounds__(32 * I4_MAX_WARPS) int4_matmul_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ packed,
    const float* __restrict__ scale, bf16* __restrict__ y, int M, int K, int N, int g, int kg) {
  using L = I4Smem<NT, MT>;
  constexpr int NW = NT >= 2 ? NT / 2 : 1;        // 32-bit words per lane per packed row
  constexpr int CW = L::CW, S = L::S, XP = L::XP, STAGES = L::STAGES;
  constexpr int RSTEP = 32 / NT;                  // rows between a lane's copies of one step
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane >> 2, t = lane & 3;
  const int wk = blockDim.x / 32, chunks = gridDim.y;
  // a step holds sr = gcd(g, 16) packed rows in its first depth slots
  // (zeros in the rest), so no step straddles two groups
  const int sr = (g & -g) < 16 ? (g & -g) : 16, spg = g / sr;
  const int K2 = K / 2, n2 = K2 / g;
  const int col0 = blockIdx.x * CW;                      // the strip
  const bool vec = N % 16 == 0;
  const int r0 = (blockIdx.y * wk + warp) * kg * g;      // the warp's first packed row
  const int steps = kg * spg;
  const int rows = M < 8 * MT ? M : 8 * MT;
  uint8_t* wsm = smem + warp * L::WARP;

  // this lane's copies, fixed but for the step: packed row lane / NT (+ k
  // RSTEP), 16 bytes at column 16 (lane % NT); x row lane / 4 (+ 8k),
  // half and 8 columns by lane % 4
  const int wr = lane / NT, wq = lane % NT;
  const bool wok = wr < 16 && col0 + 16 * wq < N;
  const int8_t* wsrc = packed + (wok ? (long long)(r0 + wr) * N + col0 + 16 * wq : 0);
  const int xm = lane / 4, xh = (lane / 2) % 2, xq = lane % 2;
  const bf16* xsrc = x + (long long)(xm < rows ? xm : 0) * K + xh * K2 + r0 + 8 * xq;

  // step u: packed rows [r0 + sr u, +sr) and x's columns of both halves
  // into stage u % STAGES (rows and columns past sr zero-filled); at a
  // group's last step (us == spg - 1) also that group's scale rows
  auto issue = [&](int u, int us) {
    uint8_t* dst = wsm + (u & (STAGES - 1)) * L::STAGE;
    const int row = r0 + sr * u;
    if (vec) {
#pragma unroll
      for (int k = 0; k < (NT >= 2 ? NT / 2 : 1); ++k)
        if (NT >= 2 || lane < 16) {
          const bool ok = wok && wr + k * RSTEP < sr;
          cp_async16(dst + (wr + k * RSTEP) * S + 16 * wq,
                     ok ? wsrc + (long long)(sr * u + k * RSTEP) * N : packed, ok);
        }
    } else {                                     // rows not 16-byte aligned: byte copies
      const long long rb = (long long)row * N;
      for (int b = lane; b < 16 * CW; b += 32) {
        const int r = b / CW, cc = b % CW, col = col0 + cc;
        dst[r * S + cc] = r < sr && col < N ? (uint8_t)packed[rb + (long long)r * N + col] : 0;
      }
    }
    if (sr == 16) {
#pragma unroll
      for (int k = 0; k < MT; ++k) {             // (m, half, 8 columns) for m < M
        const int m = xm + 8 * k;
        if (m < rows)
          cp_async16(dst + L::WBYTES + m * XP + 32 * xh + 16 * xq,
                     xsrc + (long long)8 * k * K + 16 * u, true);
      }
    } else {                                     // groups of fewer than 16 rows: element copies
      for (int i = lane; i < rows * 32; i += 32) {
        const int m = i / 32, h = (i / 16) % 2, c = i % 16;
        reinterpret_cast<bf16*>(dst + L::WBYTES + m * XP + 32 * h)[c] =
            c < sr ? x[(long long)m * K + h * K2 + row + c] : __float2bfloat16(0.f);
      }
    }
    if (us == spg - 1) {
      float* sdst = reinterpret_cast<float*>(dst + L::WBYTES + L::XBYTES);
      const int j = row / g;
      if (vec) {
        for (int c = lane; c < CW / 2; c += 32) {  // two rows of CW floats, 4 per copy
          const int hh = c / (CW / 4), q = c % (CW / 4), col = col0 + 4 * q;
          const bool ok = col < N;
          cp_async16(sdst + hh * CW + 4 * q,
                     scale + (ok ? (long long)(j + hh * n2) * N + col : 0), ok);
        }
      } else {
        for (int c = lane; c < 2 * CW; c += 32) {
          const int hh = c / CW, col = col0 + c % CW;
          sdst[c] = col < N ? scale[(long long)(j + hh * n2) * N + col] : 0.f;
        }
      }
    }
  };

  float tot[NT][MT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) tot[i][mt][e] = 0.f;
  float part[2][NT][MT][4];

  int ius = 0;                                   // (u + STAGES - 1) % spg for the issue
#pragma unroll
  for (int u = 0; u < STAGES - 1; ++u) {
    if (u < steps) issue(u, ius);
    asm volatile("cp.async.commit_group;\n" ::);
    if (++ius == spg) ius = 0;
  }

  int us = 0;                                    // u % spg
  for (int u = 0; u < steps; ++u) {
    if (us == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < NT; ++i)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][i][mt][e] = 0.f;
    }
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
    __syncwarp();
    if (u + STAGES - 1 < steps) issue(u + STAGES - 1, ius);
    asm volatile("cp.async.commit_group;\n" ::);
    if (++ius == spg) ius = 0;

    const uint8_t* stage = wsm + (u & (STAGES - 1)) * L::STAGE;
    const uint8_t* tile = stage + gid * 2 * NT;
    uint32_t w[4][NW];                            // rows 2t, 2t+1, 2t+8, 2t+9
    lds_row<NT>(w[0], tile + (2 * t) * S);
    lds_row<NT>(w[1], tile + (2 * t + 1) * S);
    lds_row<NT>(w[2], tile + (2 * t + 8) * S);
    lds_row<NT>(w[3], tile + (2 * t + 9) * S);

    uint32_t b[2][MT][2];                         // x rows mt*8 + gid, depth slots 2t.., 2t+8..
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok = mt * 8 + gid < M;          // rows past M are zeros
        const uint8_t* xr = stage + L::WBYTES + (mt * 8 + gid) * XP + 32 * h + 4 * t;
        b[h][mt][0] = ok ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        b[h][mt][1] = ok ? *reinterpret_cast<const uint32_t*>(xr + 16) : 0u;
      }

#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const unsigned sel = (i & 1) ? 0x7632u : 0x5410u;   // bytes 2i, 2i+1 of two rows
      const uint32_t ab = __byte_perm(w[0][i / 2], w[1][i / 2], sel);
      const uint32_t cd = __byte_perm(w[2][i / 2], w[3][i / 2], sel);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int sh = 4 * h;
        const uint32_t a[4] = {nib2(ab >> sh), nib2(ab >> (8 + sh)), nib2(cd >> sh),
                               nib2(cd >> (8 + sh))};
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma16816(part[h][i][mt], a, b[h][mt][0], b[h][mt][1]);
      }
    }

    if (us == spg - 1) {                          // group done: scale and add
      const float* sl = reinterpret_cast<const float*>(stage + L::WBYTES + L::XBYTES) + gid * 2 * NT;
#pragma unroll
      for (int i = 0; i < NT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {             // A rows gid (column 2i), gid+8 (2i+1)
          const float lo = sl[2 * i + (e >> 1)], hi = sl[CW + 2 * i + (e >> 1)];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            tot[i][mt][e] = tot[i][mt][e] + part[0][i][mt][e] * lo + part[1][i][mt][e] * hi;
        }
    }
    if (++us == spg) us = 0;
  }

  // the warp's sums into its own ring (free now): red[m][c], c = column - col0
  __syncwarp();
  float* red = reinterpret_cast<float*>(wsm);
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(mt * 8 + 2 * t + (e & 1)) * CW + gid * 2 * NT + 2 * i + (e >> 1)] = tot[i][mt][e];

  // every block of the cluster (the strip's chunks) adds all warps' sums,
  // chunk by chunk and warp by warp in order, for its slice of the strip
  // (one chunk: no cluster, the block's own shared memory)
  cg::cluster_group cluster = cg::this_cluster();
  if (chunks > 1) cluster.sync(); else __syncthreads();
  // all of an element's loads are issued before its adds (one round trip
  // through the cluster), then added in the fixed order
  for (int idx = blockIdx.y * blockDim.x + threadIdx.x; idx < rows * CW;
       idx += chunks * blockDim.x) {
    const int m = idx / CW, n = col0 + idx % CW;
    float v[I4_MAX_CLUSTER][I4_MAX_WARPS];
#pragma unroll
    for (int c = 0; c < I4_MAX_CLUSTER; ++c) {
      const float* peer = c >= chunks ? nullptr
                          : chunks > 1 ? cluster.map_shared_rank(reinterpret_cast<float*>(smem), c)
                                       : reinterpret_cast<float*>(smem);
#pragma unroll
      for (int wi = 0; wi < I4_MAX_WARPS; ++wi)
        v[c][wi] = (c < chunks && wi < wk) ? peer[wi * (L::WARP / 4) + idx] : 0.f;
    }
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < I4_MAX_CLUSTER; ++c)
#pragma unroll
      for (int wi = 0; wi < I4_MAX_WARPS; ++wi)
        if (c < chunks && wi < wk) s += v[c][wi];
    if (n < N) y[(long long)m * N + n] = __float2bfloat16(s);
  }
  if (chunks > 1) cluster.sync();                // peers read this block's sums until here
}

template <int NT, int MT>
int launch(dim3 grid, int wk, cudaStream_t st, const bf16* x, const int8_t* packed,
           const float* scale, bf16* y, int M, int K, int N, int g, int kg) {
  static unsigned long long ready = 0;           // devices whose shared memory limit is set
  const int bytes = I4Smem<NT, MT>::bytes(wk);
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  if (device >= 64 || !(ready >> device & 1ull)) {
    e = cudaFuncSetAttribute(int4_matmul_kernel<NT, MT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             I4Smem<NT, MT>::bytes(I4_MAX_WARPS));
    if (e != cudaSuccess) return (int)e;
    if (device < 64) ready |= 1ull << device;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(32 * wk);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = grid.y;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;             // one chunk: an ordinary launch
  return (int)cudaLaunchKernelEx(&cfg, int4_matmul_kernel<NT, MT>, x, packed, scale, y, M, K, N,
                                 g, kg);
}

}  // namespace

extern "C" {

// y [M, N] bf16 = x [M, K] bf16 @ dequant4(packed [K/2, N], scale [n_g, N]),
// on the launch plan (nt, wk, kg) of ops/kernels/int4_matmul.py:_plan: a
// grid of ceil(N / (16 nt)) strips x chunks = (n_g / 2) / (wk kg) blocks,
// each strip's chunks one cluster (at most 8). x, packed and scale are
// contiguous and 16-byte aligned.
int vgqa_int4_matmul(const void* x, const void* packed, const float* scale, void* y, int M,
                     int K, int N, int n_g, int nt, int wk, int kg, void* stream) {
  if (M < 1 || M > 64 || K < 2 || K % 2 || N < 1 || n_g < 2 || n_g % 2 || (K / 2) % (n_g / 2))
    return (int)cudaErrorInvalidValue;
  const int n2 = n_g / 2, g = (K / 2) / n2;
  const int mt = M <= 8 ? 1 : (M <= 16 ? 2 : (M <= 32 ? 4 : 8));
  if (!(nt == 1 || nt == 2 || nt == 4) || nt * mt > 8 ||
      !(wk == 1 || wk == 2 || wk == 4) || kg < 1 || n2 % (wk * kg) || n2 / (wk * kg) > 8)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + 16 * nt - 1) / (16 * nt), n2 / (wk * kg));
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = (const bf16*)x;
  const int8_t* pb = (const int8_t*)packed;
  bf16* yb = (bf16*)y;
#define I4_CASE(NT_, MT_) \
  if (nt == NT_ && mt == MT_) return launch<NT_, MT_>(grid, wk, st, xb, pb, scale, yb, M, K, N, g, kg);
  I4_CASE(4, 1) I4_CASE(2, 1) I4_CASE(1, 1)
  I4_CASE(4, 2) I4_CASE(2, 2) I4_CASE(1, 2)
  I4_CASE(2, 4) I4_CASE(1, 4)
  I4_CASE(1, 8)
#undef I4_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
