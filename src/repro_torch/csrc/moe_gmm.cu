// Grouped expert SwiGLU FFN over the static-capacity buffer, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/moe_gmm.py
// (moe_gmm_pallas, body _kernel):
//   out[e] = (silu(x[e] Wg[e]) * (x[e] Wu[e])) Wd[e]
//   x [E, T, D]; Wg/Wu [E, D, F]; Wd [E, F, D] -> out [E, T, D]
// with g and u accumulated in f32, h rounded to x's dtype, and the
// down-projection accumulated in f32 and rounded to the output dtype.
//
// Both variants run the FFN in two passes. The Pallas tiling keeps a
// [bt, D] f32 accumulator resident across a sequential F grid axis; that is
// ~9 MiB, it does not fit in a Hopper block's 227 KB of shared memory, and
// Hopper blocks run unordered so nothing can carry across them. So:
//   1. gate/up: A = x, B = Wg and Wu, epilogue h = silu(g) * u rounded to
//      x's dtype (the Pallas numerics), written to a scratch [E, T, F];
//   2. down: A = h, B = Wd, epilogue rounds the f32 sum to the output dtype.
//
// What bounds it on this card, by regime:
//   - Decode (T a few rows per expert: 8 slots x capacity 1) is a weight
//     stream, 2*T flops per weight element against the card's ~295 flops a
//     byte: bytes bound it. But the buffer comes from a scatter into zeros,
//     so an expert that no token reached holds only zero rows and gives
//     exact zeros (silu(0)*0 = 0, 0*Wd = 0); 8 tokens at top-8 reach ~57 of
//     deepseek-v3's 256 experts. The bound of the needed work is the reached
//     experts' weights, and the design never streams the others.
//   - Training (T = 384-768 rows per expert) is above the ridge: at T = 768
//     the operations (6*E*T*D*F) bound it, and the tensor cores are reached
//     only through wgmma fed from shared memory. The capacity rows fill as a
//     prefix, so about a third of the token tiles are zero there too.
//
// Tensor-core variant (bf16, D and F multiples of 8: TMA's 16-byte
// strides), three kernels a call:
//   0. moe_gmm_active_kernel reads x once per (expert, token tile) until it
//      meets a nonzero element (-0 counts as zero). A tile that has none is
//      dead: the same block writes its rows of out as zeros, so every row of
//      out is written and no later pass touches it. The last block to finish
//      (a ticket counter) compacts the live tiles into an ordered work list
//      on the device and adds the tiles and experts skipped to a counter
//      that the wrapper owns. Nothing is read back to the host.
//   1, 2. moe_gmm_wgmma_kernel<ROWS, GATED, N>, the gated pass and the down
//      pass: persistent blocks (one per SM) walk the work items, each item
//      a (live tile, weight tile) pair, so a dead tile never streams its
//      expert's weights. A block is one producer warp and two consumer
//      warpgroups. The producer issues cp.async.bulk.tensor (TMA) loads of
//      the weight boxes and the x (or h) tile into a ring of stages, with a
//      full and an empty mbarrier per stage, and runs ahead across items,
//      so the ring stays full through every epilogue. The consumers issue
//      wgmma.mma_async (bf16 in, f32 sums) straight from the ring, one
//      group in flight, and release a stage when its group is done. Every
//      box is 64 bf16 wide (128 bytes) with TMA's 128-byte swizzle, which
//      the wgmma descriptors name; TMA fills rows past T and columns past F
//      or D with zeros, and the epilogue masks them.
//   Two tile plans, chosen from T by the wrapper's tile_plan:
//   - SWAP (T <= 256, decode and prefill): the weights are the M rows, 64
//     per warpgroup (MN-major A), and the tokens the N columns (K-major B),
//     N the power of two >= T: one item holds every token of its expert, so
//     each weight element leaves HBM once. Gated: warpgroup 0 takes Wg and
//     1 takes Wu for the same 64 columns of F; 1 hands u to 0 through
//     shared memory, which writes h. Down: each takes 64 columns of D. At
//     decode a stage is 16 KB of weights and the ring holds 8 stages: 128
//     KB of loads in flight per SM. (Two boxes a warpgroup, 256-byte runs
//     of each weight row, gained about 1 % on dense deepseek-v3 and jamba,
//     less on their routed buffers, and lost on granite: one box.)
//   - ROWS (T > 256, training): the tokens are the M rows, 128 per item (64
//     per warpgroup, K-major A) and the weight columns are N (MN-major B):
//     128 columns of F for g and u at once, 256 columns of D down. Items are
//     ordered tile by tile with the weight tiles inner, so the token tiles of
//     one expert run side by side in one wave and share each weight tile
//     through L2: the weights leave HBM about once, not ceil(T/128) times.
//   On the host the maps come from a table keyed by pointer and shape (the
//   weights recur, and the caching allocator hands x and h the same
//   addresses), and each kernel's shared-memory size is set once per
//   device: decode calls are host-bound.
//
// CUDA-core variant (f32, and shapes the tensor-core variant does not take;
// moe_gemm_kernel): a block owns one expert, a tile of 8 rows and 128
// output columns. Each lane streams its own 4 columns of B straight from
// HBM into registers (one 8-byte load per row of B in bf16, 16 bytes in
// f32: 256-512 byte runs per warp and row, four rows loaded ahead of their
// FMAs) and keeps the 8 rows' sums in registers, so every weight element is
// loaded once per row tile and used for 8 FMAs. The block's 8 rows of A are
// staged in shared memory as f32 [k][8], so one row of B meets its 8 x
// values in two broadcast 16-byte shared loads. The 8 warps split the
// reduction depth and add their partial sums up in shared memory at the
// end. With T <= 8 the weights stream exactly once; larger T re-reads them
// once per 8-row tile. Any T, D and F; in f32 it reaches 84 % of the HBM
// rate, and f32 must not go through TF32 tensor cores (see PERF.md).
#include <cuda.h>            // CUtensorMap and its enums; the encoder comes from dlsym
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <dlfcn.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int R = 8;          // rows (tokens) per block
constexpr int NW = 8;         // warps per block, splitting the depth
constexpr int NT = 32 * NW;   // threads per block
constexpr int CPL = 4;        // output columns per lane
constexpr int BN = 32 * CPL;  // output columns per block
constexpr int KC = 1024;      // depth of the x chunk staged in shared memory
constexpr int U = 4;          // weight rows loaded ahead of their FMAs

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// CPL contiguous elements of one row of B as f32, lanes past n read as 0;
// one vector load when the row and the columns are aligned to the pack.
template <typename T>
struct alignas(sizeof(T) * CPL) Pack {
  T v[CPL];
};

template <typename T>
__device__ __forceinline__ void load_cols(const T* p, int avail, bool vec, float* w) {
  if (vec) {
    const Pack<T> pk = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
    for (int c = 0; c < CPL; ++c) w[c] = to_f(pk.v[c]);
  } else {
#pragma unroll
    for (int c = 0; c < CPL; ++c) w[c] = c < avail ? to_f(p[c]) : 0.f;
  }
}

// C[e] (m x n) = A[e] (m x k) times B0[e] (k x n) [and B1[e]], row-major.
// GATED: C = round(silu(A B0) * (A B1)); else C = round(A B0).
template <typename T, bool GATED>
__global__ void __launch_bounds__(NT)
moe_gemm_kernel(const T* __restrict__ a, const T* __restrict__ b0,
                const T* __restrict__ b1, T* __restrict__ c, int m, int k, int n) {
  constexpr int NB = GATED ? 2 : 1;
  constexpr int X_FLOATS = KC * R, RED_FLOATS = NW * R * BN;
  constexpr int SMEM_FLOATS = X_FLOATS > RED_FLOATS ? X_FLOATS : RED_FLOATS;
  static_assert(SMEM_FLOATS * 4 <= 48 * 1024, "static shared memory limit");
  // x chunk as f32 [KC][R] during the loop, then one matrix's partial sums
  __shared__ __align__(16) float smem[SMEM_FLOATS];

  const int m0 = blockIdx.x * R;
  const int n0 = blockIdx.y * BN;
  const int e = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = n0 + CPL * lane;
  const int avail = n - col;                  // columns of this lane in range
  const bool has0 = avail > 0;
  const bool vec = avail >= CPL && n % CPL == 0;
  const int rows = min(R, m - m0);

  const T* ae = a + ((size_t)e * m + m0) * k;
  const T* bs[2] = {b0 + (size_t)e * k * n + col,
                    GATED ? b1 + (size_t)e * k * n + col : nullptr};

  float acc[NB][R][CPL] = {};
  for (int c0 = 0; c0 < k; c0 += KC) {
    const int kn = min(KC, k - c0);
    __syncthreads();                                   // previous chunk read
    for (int i = threadIdx.x; i < R * kn; i += NT) {   // coalesced along k
      const int r = i / kn, kk = i % kn;
      smem[kk * R + r] = r < rows ? to_f(ae[(size_t)r * k + c0 + kk]) : 0.f;
    }
    __syncthreads();
    if (!has0) continue;
    const int per = (kn + NW - 1) / NW;
    const int kb = warp * per, ke = min(kn, kb + per);
    for (int kk = kb; kk < ke; kk += U) {
      float w[U][NB][CPL];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < NB; ++j) {
          if (kk + u < ke)
            load_cols(bs[j] + (size_t)(c0 + kk + u) * n, avail, vec, w[u][j]);
          else
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc) w[u][j][cc] = 0.f;
        }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (kk + u >= ke) break;
        const float4 xa = *reinterpret_cast<const float4*>(&smem[(kk + u) * R]);
        const float4 xb = *reinterpret_cast<const float4*>(&smem[(kk + u) * R + 4]);
        const float xv[R] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < NB; ++j)
#pragma unroll
            for (int cc = 0; cc < CPL; ++cc) acc[j][r][cc] += xv[r] * w[u][j][cc];
      }
    }
  }
  // add the warps' partial sums, one matrix at a time
  constexpr int PER_T = (R * BN + NT - 1) / NT;       // outputs per thread
  float sum[NB][PER_T];
  float* red = smem;                                   // [NW][R][BN]
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    __syncthreads();                                   // smem free
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int cc = 0; cc < CPL; ++cc)
        red[(warp * R + r) * BN + CPL * lane + cc] = acc[j][r][cc];
    __syncthreads();
#pragma unroll
    for (int q = 0; q < PER_T; ++q) {
      const int i = threadIdx.x + q * NT;
      float s = 0.f;
      if (i < R * BN) {
#pragma unroll
        for (int w = 0; w < NW; ++w) s += red[w * R * BN + i];
      }
      sum[j][q] = s;
    }
  }

  T* ce = c + ((size_t)e * m + m0) * n;
#pragma unroll
  for (int q = 0; q < PER_T; ++q) {
    const int i = threadIdx.x + q * NT;
    const int r = i / BN, cc = i % BN;
    if (i >= R * BN || r >= rows || n0 + cc >= n) continue;
    float out = sum[0][q];
    if constexpr (GATED) out = out / (1.f + expf(-out)) * sum[NB - 1][q];
    ce[(size_t)r * n + n0 + cc] = from_f<T>(out);
  }
}

template <typename T>
int launch(const void* x, const void* wg, const void* wu, const void* wd,
           void* h, void* out, int e, int t, int d, int f, cudaStream_t s) {
  const dim3 block(NT);
  const dim3 grid_up((t + R - 1) / R, (f + BN - 1) / BN, e);
  moe_gemm_kernel<T, true><<<grid_up, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<T*>(h), t, d, f);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_down((t + R - 1) / R, (d + BN - 1) / BN, e);
  moe_gemm_kernel<T, false><<<grid_down, block, 0, s>>>(
      static_cast<const T*>(h), static_cast<const T*>(wd), nullptr,
      static_cast<T*>(out), t, f, d);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// tensor-core variant, bf16: TMA rings feeding wgmma, dead tiles skipped
// ---------------------------------------------------------------------------
namespace hop {

using bf16 = __nv_bfloat16;
constexpr int BK = 64;                  // depth of a stage: one 128-byte swizzle row
constexpr int NCW = 8;                  // consumer warps: two warpgroups
constexpr int NTHR = 32 * NCW + 32;     // and one producer warp
constexpr int BOX = 64 * BK * 2;        // one 64 x 64 bf16 TMA box: 8 KB
constexpr int ROW_TILE = 128;           // token rows of a ROWS item
constexpr int SMEM_LIMIT = 232448;      // dynamic shared memory a block may use
constexpr int MAX_STAGES = 8;
constexpr int ACTIVE_THREADS = 256;     // moe_gmm_active_kernel's block

// Shared memory of one kernel: the ring of stages (weight boxes, then the
// x or h tile), the u hand-over of the SWAP gated pass, the barriers. A SWAP
// item gives each warpgroup one 64-column weight box.
template <bool ROWS, bool GATED, int N>
struct Cfg {
  static_assert(N % 8 == 0 && N <= 256, "wgmma takes N from 8 to 256");
  static constexpr int WBOXES = ROWS ? (GATED ? 2 : 1) * (N / 64) : 2;
  static constexpr int ACT = (ROWS ? ROW_TILE : N) * BK * 2;
  static constexpr int STAGE = WBOXES * BOX + ACT;     // a multiple of 1024
  static constexpr int XCHG = (!ROWS && GATED) ? (N / 2) * 128 * 4 : 0;
  static constexpr int BARS = 2 * MAX_STAGES * 8;
  static constexpr int FIT = (SMEM_LIMIT - 1024 - BARS - XCHG) / STAGE;
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;
  static constexpr int SMEM = 1024 + STAGES * STAGE + XCHG + BARS;  // 1024: alignment
  // output columns of an item: SWAP gated 64 of F, SWAP down 2 x 64 of D
  static constexpr int COLS = ROWS ? N : (GATED ? 64 : 128);
  static_assert(STAGES >= 2, "the ring needs two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// TMA: box at coordinates (c0 innermost, c1, c2) of a 3-d map into shared
// memory at dst; completion counts its bytes on the mbarrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1.
// K-major (8 rows of 128 bytes a swizzle atom): SBO 1024 between 8-row
// groups, LBO unused (1). MN-major (64 MN elements a 128-byte row, K down
// the rows): SBO 1024 between groups of 8 K rows, LBO between 64-wide
// MN boxes.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// keeps the compiler from moving accesses of the sums across a wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], bf16 in, f32 sums; A and B read from
// shared memory through descriptors; TA / TB = 1 for an MN-major operand.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da, uint64_t db,
                                      int scale_d) {
  if constexpr (N == 8) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, %4, %5, p, 1, 1, %7, %8;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
          "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
          "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
          "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  } else if constexpr (N == 256) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
        "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
        "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, "
        "%109, %110, %111, %112, %113, %114, %115, %116, %117, %118, "
        "%119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
          "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
          "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
          "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
          "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
          "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
          "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
          "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
          "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
          "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
          "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
          "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
          "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
          "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
          "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
          "+f"(d[126]), "+f"(d[127])
        : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
  }
}

// Pass 0. One block per (expert, token tile of tile_rows rows). work:
// [0] the ticket, [1] the live tile count, [2, 2 + n_tiles) each tile's
// flag, then the live tiles in order. skipped[0] += dead tiles,
// skipped[1] += experts with no live tile.
__global__ void __launch_bounds__(ACTIVE_THREADS)
moe_gmm_active_kernel(const bf16* __restrict__ x, bf16* __restrict__ out, int* work,
                      unsigned long long* skipped, int e, int t, int d, int tile_rows,
                      int ntt) {
  const int tile = blockIdx.x, n_tiles = gridDim.x;
  const int ex = tile / ntt, r0 = (tile % ntt) * tile_rows;
  const int rows = min(tile_rows, t - r0);
  const size_t off = ((size_t)ex * t + r0) * d;
  const size_t n16 = (size_t)rows * d / 8;            // 16-byte pieces, D % 8 == 0
  const uint4* src = reinterpret_cast<const uint4*>(x + off);
  constexpr int U = 4;                                // pieces a thread reads per round
  int live = 0;
  for (size_t i0 = 0; i0 < n16; i0 += (size_t)U * ACTIVE_THREADS) {
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t i = i0 + (size_t)u * ACTIVE_THREADS + threadIdx.x;
      if (i < n16) {
        const uint4 v = src[i];
        bits |= v.x | v.y | v.z | v.w;
      }
    }
    // any bit but the two bf16 sign bits: -0 is a zero
    live = __syncthreads_or((bits & 0x7FFF7FFFu) != 0);
    if (live) break;                                  // the same for every thread
  }
  if (!live) {
    uint4* dst = reinterpret_cast<uint4*>(out + off);
    for (size_t i = threadIdx.x; i < n16; i += ACTIVE_THREADS) dst[i] = make_uint4(0, 0, 0, 0);
  }

  int* flags = work + 2;
  __shared__ int s_last, s_dead;
  __shared__ int s_warp[ACTIVE_THREADS / 32];
  if (threadIdx.x == 0) {
    flags[tile] = live;
    s_dead = 0;
    __threadfence();                                  // the flag before the ticket
    s_last = atomicAdd(work, 1) == n_tiles - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // the last block: the live tiles in order, a block-wide prefix count
  const volatile int* vflags = flags;
  int* list = work + 2 + n_tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int c0 = 0; c0 < n_tiles; c0 += ACTIVE_THREADS) {
    const int i = c0 + threadIdx.x;
    const int f = i < n_tiles ? vflags[i] : 0;
    const unsigned ballot = __ballot_sync(0xFFFFFFFFu, f);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < ACTIVE_THREADS / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (f) list[base + before + __popc(ballot & ((1u << lane) - 1))] = i;
    base += total;
    __syncthreads();                                  // s_warp is read
  }
  int dead = 0;
  for (int x_e = threadIdx.x; x_e < e; x_e += ACTIVE_THREADS) {
    int any = 0;
    for (int j = 0; j < ntt; ++j) any |= vflags[x_e * ntt + j];
    dead += !any;
  }
  atomicAdd(&s_dead, dead);
  __syncthreads();
  if (threadIdx.x == 0) {
    work[1] = base;
    atomicAdd(&skipped[0], (unsigned long long)(n_tiles - base));
    atomicAdd(&skipped[1], (unsigned long long)s_dead);
  }
}

// Passes 1 and 2: C[e] (t x m) = A[e] (t x k) W[e] (k x m), row-major;
// GATED: C = bf16(silu(A W0) * (A W1)), else C = bf16(A W0). act_map reads
// A, w0_map and w1_map the weights (w1_map = w0_map in the down pass).
template <bool ROWS, bool GATED, int N>
__global__ void __launch_bounds__(NTHR, 1)
moe_gmm_wgmma_kernel(const __grid_constant__ CUtensorMap act_map,
                     const __grid_constant__ CUtensorMap w0_map,
                     const __grid_constant__ CUtensorMap w1_map, bf16* __restrict__ c,
                     const int* __restrict__ work, int n_tiles, int ntt, int t, int k,
                     int m) {
  using C = Cfg<ROWS, GATED, N>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;       // the swizzle wants 1024
  float* xchg = reinterpret_cast<float*>(smem_raw + (ring - raw) + C::STAGES * C::STAGE);
  const uint32_t full0 = ring + C::STAGES * C::STAGE + C::XCHG;
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                    // the producer's expect_tx
      mbar_init(empty0 + 8 * s, NCW);                 // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int live = work[1];
  const int* list = work + 2 + n_tiles;
  const int nwt = (m + C::COLS - 1) / C::COLS;        // weight tiles per live tile
  const int items = live * nwt;
  const int nk = (k + BK - 1) / BK;

  if (warp == NCW) {                                  // the producer warp
    if (lane == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = blockIdx.x; it < items; it += gridDim.x) {
        const int tile = list[it / nwt], col0 = (it % nwt) * C::COLS;
        const int ex = tile / ntt, row0 = (tile % ntt) * ROW_TILE;
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(empty0 + 8 * stage, phase ^ 1);   // first round passes
          const uint32_t st = ring + stage * C::STAGE, fb = full0 + 8 * stage;
          const int k0 = kt * BK;
          mbar_expect_tx(fb, C::STAGE);
          if constexpr (ROWS) {
#pragma unroll
            for (int b = 0; b < N / 64; ++b) {
              tma_load(st + b * BOX, &w0_map, fb, col0 + 64 * b, k0, ex);
              if constexpr (GATED)
                tma_load(st + (N / 64 + b) * BOX, &w1_map, fb, col0 + 64 * b, k0, ex);
            }
            tma_load(st + C::WBOXES * BOX, &act_map, fb, k0, row0, ex);
          } else {        // gated: Wg, then Wu of the same columns; down: 2 x 64
            tma_load(st, &w0_map, fb, col0, k0, ex);
            tma_load(st + BOX, &w1_map, fb, GATED ? col0 : col0 + 64, k0, ex);
            tma_load(st + C::WBOXES * BOX, &act_map, fb, k0, 0, ex);
          }
          if (++stage == C::STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // the consumer warpgroups
  constexpr int ACC = N / 2;                          // sums a thread holds per product
  constexpr int NACC = ROWS && GATED ? 2 : 1;        // ROWS gated: g and u
  const int grp = warp >> 2, wq = warp & 3, tig = tid & 127;
  float acc[NACC][ACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a)
#pragma unroll
    for (int r = 0; r < ACC; ++r) acc[a][r] = 0.f;
  int stage = 0;
  uint32_t phase = 0;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int tile = list[it / nwt], col0 = (it % nwt) * C::COLS;
    const int ex = tile / ntt, row0 = (tile % ntt) * ROW_TILE;
    int prev = 0;
    for (int kt = 0; kt < nk; ++kt) {
      mbar_wait(full0 + 8 * stage, phase);
      const uint32_t st = ring + stage * C::STAGE;
      const uint32_t act = st + C::WBOXES * BOX;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < BK / 16; ++j) {             // k16 steps: +32 B K-major,
        const int sc = (kt | j) != 0;                 // +16 rows of 128 B MN-major
        if constexpr (ROWS) {
          const uint64_t da = desc(act + grp * 64 * 128 + j * 32, 16, 1024);
          wgmma<N, 0, 1>(acc[0], da, desc(st + j * 2048, BOX, 1024), sc);
          if constexpr (GATED)
            wgmma<N, 0, 1>(acc[NACC - 1], da,
                           desc(st + (N / 64) * BOX + j * 2048, BOX, 1024), sc);
        } else {
          wgmma<N, 1, 0>(acc[0], desc(st + grp * BOX + j * 2048, BOX, 1024),
                         desc(act + j * 32, 16, 1024), sc);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();                                // the previous stage is read
      if (kt > 0 && lane == 0) mbar_arrive(empty0 + 8 * prev);
      prev = stage;
      if (++stage == C::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty0 + 8 * prev);
#pragma unroll
    for (int a = 0; a < NACC; ++a) fence_regs(acc[a]);

    // sum r of a thread: row (M) wq*16 + lane/4 + 8*((r/2)%2), column (N)
    // 8*(r/4) + 2*(lane%4) + r%2, within its warpgroup's 64 x N
    if constexpr (ROWS) {
      const int rbase = row0 + grp * 64 + wq * 16 + (lane >> 2);
      const int cbase = col0 + 2 * (lane & 3);
#pragma unroll
      for (int r = 0; r < ACC; r += 2) {
        const int row = rbase + 8 * ((r >> 1) & 1), col = cbase + 8 * (r >> 2);
        if (row < t && col < m) {                     // m even: col + 1 < m too
          float v0 = acc[0][r], v1 = acc[0][r + 1];
          if constexpr (GATED) {
            v0 = v0 / (1.f + expf(-v0)) * acc[NACC - 1][r];
            v1 = v1 / (1.f + expf(-v1)) * acc[NACC - 1][r + 1];
          }
          *reinterpret_cast<__nv_bfloat162*>(c + ((size_t)ex * t + row) * m + col) =
              __floats2bfloat162_rn(v0, v1);
        }
      }
    } else {
      // gated: group 1's box holds u for group 0's columns col0 + 64;
      // down: group g's box is columns col0 + 64 g
      const int mbase = wq * 16 + (lane >> 2), nbase = 2 * (lane & 3);
      if constexpr (GATED) {
        if (grp == 1) {
#pragma unroll
          for (int r = 0; r < ACC; ++r) xchg[r * 128 + tig] = acc[0][r];
        }
        bar_sync(1, 256);
        if (grp == 0) {
#pragma unroll
          for (int r = 0; r < ACC; ++r) {
            const int n = 8 * (r >> 2) + nbase + (r & 1);
            const int col = col0 + mbase + 8 * ((r >> 1) & 1);
            const float g = acc[0][r];
            if (n < t && col < m)
              c[((size_t)ex * t + n) * m + col] =
                  __float2bfloat16(g / (1.f + expf(-g)) * xchg[r * 128 + tig]);
          }
        }
        bar_sync(2, 256);                             // xchg is free again
      } else {
#pragma unroll
        for (int r = 0; r < ACC; ++r) {
          const int n = 8 * (r >> 2) + nbase + (r & 1);
          const int col = col0 + 64 * grp + mbase + 8 * ((r >> 1) & 1);
          if (n < t && col < m)
            c[((size_t)ex * t + n) * m + col] = __float2bfloat16(acc[0][r]);
        }
      }
    }
  }
}

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded, so
// that the library links against nothing but the CUDA runtime.
using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeFn encoder() {
  static EncodeFn fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (!lib) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib) fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// 3-d map of a row-major bf16 [batch, rows, inner] tensor in boxes of
// [1, box_rows, 64], 128-byte swizzle, zeros outside the tensor.
int make_map(CUtensorMap* map, const void* p, int inner, int rows, int batch,
             int box_rows) {
  const EncodeFn enc = encoder();
  if (!enc) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)inner * 2, (cuuint64_t)inner * rows * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(p),
                         dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// make_map through a table. A map is a pure function of make_map's
// arguments; a layer's weights are the same tensors call after call, and
// the caching allocator hands x and h the same addresses again, so the
// maps are kept per host thread in a direct-mapped table keyed by all of
// those arguments: a hit is the map make_map would encode, whatever was
// freed or allocated since; a miss encodes and takes the slot.
constexpr int MAP_SLOTS = 256;
struct MapSlot {
  CUtensorMap map;
  const void* p;
  int inner, rows, batch, box_rows;
};

int cached_map(CUtensorMap* map, const void* p, int inner, int rows, int batch,
               int box_rows) {
  thread_local MapSlot slots[MAP_SLOTS] = {};
  const uint64_t h = (reinterpret_cast<uintptr_t>(p) >> 4) * 0x9E3779B97F4A7C15ull;
  MapSlot& slot = slots[h >> 56];                     // the top 8 bits: 256 slots
  if (slot.p == p && slot.inner == inner && slot.rows == rows && slot.batch == batch &&
      slot.box_rows == box_rows) {
    *map = slot.map;
    return cudaSuccess;
  }
  const int err = make_map(map, p, inner, rows, batch, box_rows);
  if (err == cudaSuccess) slot = MapSlot{*map, p, inner, rows, batch, box_rows};
  return err;
}

// One pass: its shared-memory size is set once per kernel and device (a
// bit per device; a device past 31 sets it on every call).
template <bool ROWS, bool GATED, int N>
int launch_pass(const CUtensorMap& a, const CUtensorMap& w0, const CUtensorMap& w1,
                void* c, const int* work, int n_tiles, int ntt, int t, int k, int m,
                int sms, cudaStream_t s) {
  using C = Cfg<ROWS, GATED, N>;
  static std::atomic<unsigned> ready{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (!(ready.load(std::memory_order_relaxed) & bit)) {
    err = cudaFuncSetAttribute(moe_gmm_wgmma_kernel<ROWS, GATED, N>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    ready.fetch_or(bit, std::memory_order_relaxed);
  }
  const long long most = (long long)n_tiles * ((m + C::COLS - 1) / C::COLS);
  const int grid = (int)(most < sms ? most : sms);    // persistent: a block per SM
  moe_gmm_wgmma_kernel<ROWS, GATED, N><<<grid, NTHR, C::SMEM, s>>>(
      a, w0, w1, static_cast<bf16*>(c), work, n_tiles, ntt, t, k, m);
  return cudaGetLastError();
}

template <bool ROWS, int NG, int ND>
int launch_passes(const CUtensorMap (&maps)[5], void* h, void* out, const int* work,
                  int n_tiles, int ntt, int t, int d, int f, int sms, cudaStream_t s) {
  // maps: x, Wg, Wu, h, Wd
  const int err = launch_pass<ROWS, true, NG>(maps[0], maps[1], maps[2], h, work, n_tiles,
                                              ntt, t, d, f, sms, s);
  if (err != cudaSuccess) return err;
  return launch_pass<ROWS, false, ND>(maps[3], maps[4], maps[4], out, work, n_tiles, ntt,
                                      t, f, d, sms, s);
}

// rows: the ROWS plan (tile_rows = ROW_TILE); else SWAP with N = n tokens
// and tile_rows = T. Everything is queued on s; nothing waits for the card.
int launch(const void* x, const void* wg_, const void* wu, const void* wd, void* h,
           void* out, int* work, unsigned long long* skipped, int e, int t, int d, int f,
           int rows, int n, int tile_rows, int ntt, int sms, cudaStream_t s) {
  const int n_tiles = e * ntt;
  cudaError_t err = cudaMemsetAsync(work, 0, sizeof(int), s);   // the ticket
  if (err != cudaSuccess) return err;
  moe_gmm_active_kernel<<<n_tiles, ACTIVE_THREADS, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<bf16*>(out), work, skipped, e, t, d,
      tile_rows, ntt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int act_rows = rows ? ROW_TILE : n;
  CUtensorMap maps[5];
  const int st[5] = {cached_map(&maps[0], x, d, t, e, act_rows),
                     cached_map(&maps[1], wg_, f, d, e, BK),
                     cached_map(&maps[2], wu, f, d, e, BK),
                     cached_map(&maps[3], h, f, t, e, act_rows),
                     cached_map(&maps[4], wd, d, f, e, BK)};
  for (int i = 0; i < 5; ++i)
    if (st[i] != cudaSuccess) return st[i];
#define PASSES(ROWS, NG, ND) \
  launch_passes<ROWS, NG, ND>(maps, h, out, work, n_tiles, ntt, t, d, f, sms, s)
  if (rows) return PASSES(true, 128, 256);
  switch (n) {
    case 8: return PASSES(false, 8, 8);
    case 16: return PASSES(false, 16, 16);
    case 32: return PASSES(false, 32, 32);
    case 64: return PASSES(false, 64, 64);
    case 128: return PASSES(false, 128, 128);
    case 256: return PASSES(false, 256, 256);
  }
#undef PASSES
  return cudaErrorInvalidValue;
}

}  // namespace hop

struct KernelEntry {
  const char* name;
  const void* fn;
};

#define WG_ENTRIES(ROWS, NG, ND, TAG)                                                 \
  {"moe_gmm_wgmma<" TAG ",gated," #NG ">",                                            \
   (const void*)hop::moe_gmm_wgmma_kernel<ROWS, true, NG>},                            \
  {"moe_gmm_wgmma<" TAG ",down," #ND ">",                                             \
   (const void*)hop::moe_gmm_wgmma_kernel<ROWS, false, ND>}

const KernelEntry kKernels[] = {
    {"moe_gemm<f32,gated>", (const void*)moe_gemm_kernel<float, true>},
    {"moe_gemm<f32,down>", (const void*)moe_gemm_kernel<float, false>},
    {"moe_gemm<bf16,gated>", (const void*)moe_gemm_kernel<__nv_bfloat16, true>},
    {"moe_gemm<bf16,down>", (const void*)moe_gemm_kernel<__nv_bfloat16, false>},
    {"moe_gmm_active", (const void*)hop::moe_gmm_active_kernel},
    WG_ENTRIES(false, 8, 8, "swap"), WG_ENTRIES(false, 16, 16, "swap"),
    WG_ENTRIES(false, 32, 32, "swap"), WG_ENTRIES(false, 64, 64, "swap"),
    WG_ENTRIES(false, 128, 128, "swap"), WG_ENTRIES(false, 256, 256, "swap"),
    WG_ENTRIES(true, 128, 256, "rows"),
};
#undef WG_ENTRIES

}  // namespace

extern "C" {

// CUDA-core variant. dtype: 0 = float32, 1 = bfloat16. h is an [E, T, F]
// scratch of that dtype. Returns cudaGetLastError() after the launches (0
// on success).
int moe_gmm_launch(const void* x, const void* wg, const void* wu,
                   const void* wd, void* h, void* out, int e, int t, int d,
                   int f, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, wg, wu, wd, h, out, e, t, d, f, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, wg, wu, wd, h, out, e, t, d, f, s);
  return cudaErrorInvalidValue;
}

// Tensor-core variant, bfloat16 only, D and F multiples of 8 and every
// pointer 16-byte aligned. work: 2 + 2 * e * ntt int32 of scratch;
// skipped: the wrapper's two int64 counters (tiles, experts), added to.
// (rows, n, tile_rows, ntt) is the wrapper's tile plan for T; sms the
// card's multiprocessor count (the persistent grid).
int moe_gmm_wgmma_launch(const void* x, const void* wg, const void* wu,
                         const void* wd, void* h, void* out, void* work,
                         void* skipped, int e, int t, int d, int f, int rows, int n,
                         int tile_rows, int ntt, int sms, void* stream) {
  if (d % 8 || f % 8) return cudaErrorInvalidValue;
  return hop::launch(x, wg, wu, wd, h, out, static_cast<int*>(work),
                    static_cast<unsigned long long*>(skipped), e, t, d, f, rows, n,
                    tile_rows, ntt, sms, static_cast<cudaStream_t>(stream));
}

// The library's kernels: their number, and each one's name, registers per
// thread and local memory per thread in bytes (spills and stack).
int kernel_count() { return sizeof(kKernels) / sizeof(kKernels[0]); }

int kernel_attributes(int i, const char** name, int* regs, int* local_bytes) {
  if (i < 0 || i >= kernel_count()) return cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  const cudaError_t err = cudaFuncGetAttributes(&attr, kKernels[i].fn);
  if (err != cudaSuccess) return err;
  *name = kKernels[i].name;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  return 0;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
