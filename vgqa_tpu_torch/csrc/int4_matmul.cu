// Weight-only int4 group-wise matmul for decode (K6), behind a plain C
// interface: the port of vgqa_tpu/ops/pallas/int4_matmul.py (int4_matmul,
// Pallas _int4_kernel).
//
//   y[m, n] = sum_j scale[j, n] * sum_{k in group j} x[m, k] * w[k, n]
//
// with the split-half pack of qa/quant.quantize_kernel_int4: packed[k, n]
// (int8, [K/2, N], N contiguous) holds row k's weight in its low nibble and
// row K/2 + k's in its high nibble, both sign-extended by arithmetic shifts;
// group j covers rows [j*g, (j+1)*g), so packed row k belongs to group
// k / g in the low half and n_g/2 + k / g in the high half. x is bf16
// [M, K] (contiguous), scale f32 [n_g, N].
//
// At decode (M = 1 or 2) the work is two multiply-adds per packed byte, so
// the bound is the bytes of the packed weights (K*N/2) plus the scales. The
// design keeps every weight byte read once and coalesced: a thread owns 4
// adjacent columns (one 32-bit load per packed row, a warp reads 128
// contiguous bytes), 128 threads cover 512 columns, and the contraction is
// split in slices of `kch` packed rows (a divisor of g), so that enough
// loads are in flight to cover the memory latency. A block holds up to 4
// such groups of 128 threads on consecutive slices; each stages its x rows
// (both halves) in shared memory, accumulates the low- and high-nibble
// sums in f32 registers for MT rows of x and applies its two group scales,
// and the groups add their sums in shared memory in a fixed order. The
// block writes that sum to an f32 scratch [chunks, M, N]. The last block of
// a (column tile, row tile) to finish, found by an arrival counter, adds
// that tile's chunks in a fixed order and rounds to bf16: one launch per
// product, and the result does not depend on the order in which the blocks
// ran. Grouping the slices in a block cuts the scratch and the last block's
// reads 4-fold. The counters live in a buffer the caller keeps zeroed
// between calls on a stream; the last block resets its own. The nibbles
// are unpacked in registers, so no dequantized weight reaches memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

using bf16 = __nv_bfloat16;

namespace {

constexpr int I4_LANES = 128;                     // threads per column group
constexpr int I4_COLS = 4;                        // columns per thread
constexpr int I4_BN = I4_LANES * I4_COLS;         // columns per block
constexpr int I4_MAX_GROUPS = 4;                  // K slices per block
constexpr int I4_MAX_SPAN = 512;                  // packed rows per block, at most

// Block (column tile bx, chunk kc, row tile bz) of G = blockDim.x / 128
// groups: group j contracts packed rows [kc*G*kch + j*kch, + kch) for 512
// columns and MT rows of x, scales its sums by its row group's scales, and
// the groups add their results in shared memory in the order j = 0..G-1.
// The block writes that sum as chunk kc's partial; the last block of the
// (bx, bz) tile to arrive adds the tile's chunks, group j taking chunks
// j, j + G, ..., and the groups' sums again in the order j = 0..G-1.
template <int MT>
__global__ void __launch_bounds__(I4_LANES * I4_MAX_GROUPS) int4_matmul_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ packed,
    const float* __restrict__ scale, float* __restrict__ partial, unsigned* __restrict__ arrivals,
    bf16* __restrict__ y, int M, int K, int N, int g, int kch) {
  __shared__ float sm[MT * 2 * I4_MAX_SPAN];      // the x slice, then the group sums
  __shared__ bool last;
  float(*xs)[2][I4_MAX_SPAN] = reinterpret_cast<float(*)[2][I4_MAX_SPAN]>(sm);
  float* red = sm;                                 // [MT][I4_BN] once xs is consumed
  const int G = blockDim.x / I4_LANES, grp_id = threadIdx.x / I4_LANES;
  const int lane = threadIdx.x % I4_LANES;
  const int K2 = K / 2, ng2 = K2 / g, chunks = gridDim.y, span = G * kch;
  const int kc = blockIdx.y, kb = kc * span;      // block rows [kb, kb + span)
  const int kg = grp_id * kch;                    // this group's rows, from kb
  const int sg = (kb + kg) / g;                   // their low-half scale row
  const int m0 = blockIdx.z * MT;
  const int n0 = blockIdx.x * I4_BN + lane * I4_COLS;
  const long long MN = (long long)M * N;
  const bool vec = (N % 4 == 0);                  // n0 % 4 == 0 too: aligned vector access
  const bool cols = n0 < N;

  for (int i = threadIdx.x; i < MT * 2 * span; i += blockDim.x) {
    const int mm = i / (2 * span), rest = i % (2 * span), half = rest / span, kk = rest % span;
    const int m = m0 + mm;
    xs[mm][half][kk] =
        m < M ? __bfloat162float(x[(long long)m * K + half * K2 + kb + kk]) : 0.f;
  }
  __syncthreads();

  float acc[MT][I4_COLS];                         // this group's scaled sums
  if (cols) {
    float acch[MT][I4_COLS];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm)
#pragma unroll
      for (int c = 0; c < I4_COLS; ++c) acc[mm][c] = acch[mm][c] = 0.f;

    const int8_t* prow = packed + (long long)(kb + kg) * N + n0;
#pragma unroll 8
    for (int kk = 0; kk < kch; ++kk) {
      int b[I4_COLS];
      if (vec) {
        const uint32_t word = __ldg(reinterpret_cast<const uint32_t*>(prow + (long long)kk * N));
#pragma unroll
        for (int c = 0; c < I4_COLS; ++c) b[c] = (int)(int8_t)((word >> (8 * c)) & 0xFFu);
      } else {
#pragma unroll
        for (int c = 0; c < I4_COLS; ++c)
          b[c] = n0 + c < N ? (int)__ldg(prow + (long long)kk * N + c) : 0;
      }
#pragma unroll
      for (int c = 0; c < I4_COLS; ++c) {
        const float wl = (float)((int)((unsigned)b[c] << 28) >> 28);   // low nibble, sign-extended
        const float wh = (float)(b[c] >> 4);          // high nibble, arithmetic shift
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          acc[mm][c] = fmaf(xs[mm][0][kg + kk], wl, acc[mm][c]);
          acch[mm][c] = fmaf(xs[mm][1][kg + kk], wh, acch[mm][c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < I4_COLS; ++c) {
      const int n = min(n0 + c, N - 1);
      const float sl = scale[(long long)sg * N + n], sh = scale[(long long)(ng2 + sg) * N + n];
#pragma unroll
      for (int mm = 0; mm < MT; ++mm) acc[mm][c] = acc[mm][c] * sl + acch[mm][c] * sh;
    }
  }
  __syncthreads();                                // xs is consumed: sm becomes red

  // red[mm][lane*4 + c] = sum over the groups, in order, of acc[mm][c]
  auto add_groups = [&](const float (&a)[MT][I4_COLS]) {
    for (int j = 0; j < G; ++j) {
      if (grp_id == j && cols) {
#pragma unroll
        for (int mm = 0; mm < MT; ++mm)
#pragma unroll
          for (int c = 0; c < I4_COLS; ++c) {
            float* r = red + mm * I4_BN + lane * I4_COLS + c;
            *r = j == 0 ? a[mm][c] : *r + a[mm][c];
          }
      }
      __syncthreads();
    }
  };
  add_groups(acc);
  if (grp_id == 0 && cols) {
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      const int m = m0 + mm;
      if (m >= M) break;
#pragma unroll
      for (int c = 0; c < I4_COLS; ++c)
        if (n0 + c < N) partial[kc * MN + (long long)m * N + n0 + c] = red[mm * I4_BN + lane * I4_COLS + c];
    }
  }

  // arrival: this block's partial is visible device-wide before the count
  // rises; the block that brings the count to `chunks` reduces the tile
  __threadfence();
  __syncthreads();
  const int tile = blockIdx.z * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last = atomicAdd(&arrivals[tile], 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // loads go through L2 (__ldcg), where the other blocks' writes are
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
#pragma unroll
    for (int c = 0; c < I4_COLS; ++c) acc[mm][c] = 0.f;
  if (cols) {
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      const int m = m0 + mm;
      if (m >= M) break;
      if (vec) {                                  // one 16-byte load per chunk
        const float4* src = reinterpret_cast<const float4*>(partial + (long long)m * N + n0);
#pragma unroll 8
        for (int k = grp_id; k < chunks; k += G) {
          const float4 v = __ldcg(src + k * (MN / 4));
          acc[mm][0] += v.x; acc[mm][1] += v.y; acc[mm][2] += v.z; acc[mm][3] += v.w;
        }
      } else {
#pragma unroll
        for (int c = 0; c < I4_COLS; ++c) {
          if (n0 + c >= N) break;
          const float* src = partial + (long long)m * N + n0 + c;
          for (int k = grp_id; k < chunks; k += G) acc[mm][c] += __ldcg(src + k * MN);
        }
      }
    }
  }
  add_groups(acc);
  if (grp_id == 0 && cols) {
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      const int m = m0 + mm;
      if (m >= M) break;
#pragma unroll
      for (int c = 0; c < I4_COLS; ++c)
        if (n0 + c < N) y[(long long)m * N + n0 + c] = __float2bfloat16(red[mm * I4_BN + lane * I4_COLS + c]);
    }
  }
  if (threadIdx.x == 0) arrivals[tile] = 0u;     // zero again for the next call
}

template <int MT>
void launch_mt(dim3 grid, int groups, cudaStream_t st, const bf16* x, const int8_t* packed,
               const float* scale, float* partial, unsigned* arrivals, bf16* y, int M, int K,
               int N, int g, int kch) {
  int4_matmul_kernel<MT><<<grid, I4_LANES * groups, 0, st>>>(x, packed, scale, partial, arrivals,
                                                             y, M, K, N, g, kch);
}

}  // namespace

extern "C" {

// y [M, N] bf16 = x [M, K] bf16 @ dequant4(packed [K/2, N], scale [n_g, N]);
// partial is f32 scratch of at least (K/2 / kch) * M * N elements, arrivals a zeroed
// uint32 buffer of at least vgqa_int4_matmul_tiles(M, N) entries (zero
// again when the launch has run).
int vgqa_int4_matmul_tiles(int M, int N) {
  const int mt = M >= 8 ? 8 : (M >= 4 ? 4 : (M >= 2 ? 2 : 1));
  return ((N + I4_BN - 1) / I4_BN) * ((M + mt - 1) / mt);
}

int vgqa_int4_matmul(const void* x, const void* packed, const float* scale, void* y,
                     float* partial, unsigned* arrivals, int M, int K, int N, int n_g, int kch,
                     void* stream) {
  if (M < 1 || K < 2 || K % 2 || N < 1 || n_g < 2 || n_g % 2 || (K / 2) % (n_g / 2))
    return (int)cudaErrorInvalidValue;
  const int g = (K / 2) / (n_g / 2);
  if (kch < 1 || kch > I4_MAX_SPAN || g % kch) return (int)cudaErrorInvalidValue;
  int groups = 1;                                 // K slices per block: 4, 2 or 1
  while (groups < I4_MAX_GROUPS && ((K / 2) / kch) % (2 * groups) == 0 &&
         2 * groups * kch <= I4_MAX_SPAN)
    groups *= 2;
  const int mt = M >= 8 ? 8 : (M >= 4 ? 4 : (M >= 2 ? 2 : 1));
  const int chunks = (K / 2) / (kch * groups);
  if (chunks > 65535 || (M + mt - 1) / mt > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + I4_BN - 1) / I4_BN, chunks, (M + mt - 1) / mt);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bf16* xb = (const bf16*)x;
  const int8_t* pb = (const int8_t*)packed;
  bf16* yb = (bf16*)y;
  switch (mt) {
    case 8: launch_mt<8>(grid, groups, st, xb, pb, scale, partial, arrivals, yb, M, K, N, g, kch); break;
    case 4: launch_mt<4>(grid, groups, st, xb, pb, scale, partial, arrivals, yb, M, K, N, g, kch); break;
    case 2: launch_mt<2>(grid, groups, st, xb, pb, scale, partial, arrivals, yb, M, K, N, g, kch); break;
    default: launch_mt<1>(grid, groups, st, xb, pb, scale, partial, arrivals, yb, M, K, N, g, kch); break;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
